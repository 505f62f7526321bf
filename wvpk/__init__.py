"""wvpk: a GPU-native WavPack decode framework (JAX/XLA, one CUDA kernel).

Built from scratch against the structural survey of the reference C# decoder
(SURVEY.md). Host Python handles container/metadata parsing; all
sample-domain math (entropy decode, decorrelation, CRC, fixup, PCM pack)
runs on device over a (block, channel, sample) layout.
"""

__version__ = "0.1.0"
