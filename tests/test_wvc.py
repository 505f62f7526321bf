"""Hybrid-lossless (.wvc correction file) tests — beyond reference
parity: the reference parses ID_WVC_BITSTREAM (UnpackUtils.cs:93-108)
but "will not handle correction files" (WavPackUtils.cs:31). wvpk
implements libwavpack's semantics: the main stream stays a normal
hybrid (lossy) stream, the correction stream carries one minimal-binary
code per error_limit-quantized word over the narrowed interval, and
decode adds corrections after the decorr chain; the wv header crc
covers the lossy reconstruction, the wvc header crc the exact samples.
"""
import os

import numpy as np
import pytest

from wvpk import api, consts
from wvpk.container import parse_blocks
from wvpk.container.blocks import pair_wvc
from wvpk.encode import encode
from wvpk.engine import decode_states
from wvpk.ref.oracle import decode_block
from wvpk.testgen.encoder import EncodeSpec, encode_blocks


def _sig(n, ch, seed=0, scale=900):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = 4000 * np.sin(t / 13.0)
    return (base[:, None] + rng.normal(0, scale, (n, ch))).astype(np.int32)


def _roundtrip_oracle(pcm, spec):
    sink = []
    wv = b"".join(encode_blocks(pcm, spec, wvc_sink=sink))
    blks = parse_blocks(wv)
    paired = pair_wvc(blks, b"".join(sink))
    assert paired == len(blks)
    outs = [decode_block(b.state) for b in blks]
    assert not any(r.crc_error or r.mute_error for r in outs)
    assert all(r.wvc_applied for r in outs)
    out = np.concatenate([r.samples for r in outs])
    return out, wv


@pytest.mark.parametrize("case", [
    dict(),                                        # stereo joint
    dict(joint=False),
    dict(mono=True),
    dict(hybrid_bitrate=True),
    dict(hybrid_bitrate=True, hybrid_balance=True, bitrate_delta=2),
    dict(terms=(18, 18, -3, 2, 17), deltas=(2,) * 5),
    dict(bytes_stored=3, bitrate=700, hybrid_bitrate=True),
])
def test_oracle_exact_roundtrip(case):
    case = dict(case)
    mono = case.pop("mono", False)
    scale = 60000 if case.get("bytes_stored") == 3 else 900
    pcm = _sig(5000, 1 if mono else 2, seed=1, scale=scale)
    kw = dict(hybrid=True, wvc=True, mono=mono, joint=not mono,
              bitrate=420, block_samples=1500)
    kw.update(case)
    spec = EncodeSpec(**kw)
    out, _ = _roundtrip_oracle(pcm, spec)
    np.testing.assert_array_equal(out, pcm)


def test_oracle_silence_and_zero_runs():
    pcm = _sig(6000, 2, seed=2)
    pcm[1000:3500] = 0     # forces zero-run escapes mid-block
    spec = EncodeSpec(hybrid=True, wvc=True, joint=True, bitrate=400,
                      block_samples=1024)
    out, _ = _roundtrip_oracle(pcm, spec)
    np.testing.assert_array_equal(out, pcm)


def test_lossy_decode_of_wvc_stream_unchanged():
    """The main stream must decode standalone (no correction file) as a
    normal hybrid stream with clean header CRCs."""
    pcm = _sig(4000, 2, seed=3)
    spec = EncodeSpec(hybrid=True, wvc=True, joint=True, bitrate=400,
                      block_samples=1000)
    sink = []
    wv = b"".join(encode_blocks(pcm, spec, wvc_sink=sink))
    outs = [decode_block(b.state) for b in parse_blocks(wv)]
    assert not any(r.crc_error or r.mute_error for r in outs)
    assert not any(r.wvc_applied for r in outs)
    out = np.concatenate([r.samples for r in outs])
    err = np.abs(out.astype(np.int64) - pcm).max()
    assert 0 < err < 2048    # lossy, but bounded by the error limit


def test_device_matches_oracle_and_source():
    pcm = _sig(9000, 2, seed=4)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=2048)
    blks = parse_blocks(wv)
    assert pair_wvc(blks, wvc) == len(blks)
    states = [b.state for b in blks]
    dev = decode_states(states)
    assert not any(r.crc_error or r.mute_error for r in dev)
    assert all(r.wvc_applied for r in dev)
    out = np.concatenate([r.samples for r in dev])
    np.testing.assert_array_equal(out, pcm)
    for r, st in zip(dev, states):
        o = decode_block(st)
        assert r.crc == o.crc and r.crc_wvc == o.crc_wvc


def test_device_mono_and_bitrate_modes():
    for kw in (dict(), dict(hybrid_bitrate=False)):
        pcm = _sig(5000, 1, seed=5)[:, 0]
        wv, wvc = encode(pcm, hybrid=True, bitrate=380, wvc=True,
                         block_samples=1200)
        blks = parse_blocks(wv)
        assert pair_wvc(blks, wvc) == len(blks)
        dev = decode_states([b.state for b in blks])
        assert not any(r.crc_error for r in dev)
        out = np.concatenate([r.samples for r in dev])[:, 0]
        np.testing.assert_array_equal(out, pcm)


def test_corrupt_wvc_flags_crc_error():
    pcm = _sig(4000, 2, seed=6)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=4096)
    bad = bytearray(wvc)
    bad[len(bad) // 2] ^= 0x40     # flip a payload bit
    blks = parse_blocks(wv)
    assert pair_wvc(blks, bytes(bad)) == len(blks)
    dev = decode_states([b.state for b in blks])
    assert any(r.crc_error for r in dev)
    # oracle agrees
    blks2 = parse_blocks(wv)
    pair_wvc(blks2, bytes(bad))
    assert any(decode_block(b.state).crc_error for b in blks2)


def test_truncated_wvc_partial_pairing():
    pcm = _sig(8000, 2, seed=7)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=2000)
    blks = parse_blocks(wv)
    # keep only the first correction block
    from wvpk.container.header import scan_headers
    hdrs = [h for h in scan_headers(wvc) if h.block_samples > 0]
    cut = hdrs[1].stream_position
    paired = pair_wvc(blks, wvc[:cut])
    assert paired == 1
    dev = decode_states([b.state for b in blks])
    assert not any(r.crc_error for r in dev)
    out = np.concatenate([r.samples for r in dev])
    np.testing.assert_array_equal(out[:2000], pcm[:2000])   # exact block
    assert not np.array_equal(out[2000:], pcm[2000:])       # lossy tail


def test_api_mode_and_exactness(tmp_path):
    n = 12000
    pcm = _sig(n, 2, seed=8)
    wv, wvc = encode(pcm, hybrid=True, bitrate=450, wvc=True,
                     block_samples=3000)
    p = tmp_path / "a.wv"
    p.write_bytes(wv)
    (tmp_path / "a.wvc").write_bytes(wvc)
    wpc = api.WavpackOpenFileInput(str(p), flags=consts.OPEN_WVC)
    mode = api.WavpackGetMode(wpc)
    assert mode & consts.MODE_WVC
    assert mode & consts.MODE_LOSSLESS
    assert mode & consts.MODE_HYBRID
    assert not api.WavpackLossy(wpc)
    buf = np.zeros(n * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, n) == n
    assert api.WavpackGetNumErrors(wpc) == 0
    np.testing.assert_array_equal(buf.reshape(-1, 2), pcm)
    # without the flag: plain lossy hybrid, no MODE_WVC
    wpc2 = api.WavpackOpenFileInput(str(p))
    assert not (api.WavpackGetMode(wpc2) & consts.MODE_WVC)
    assert api.WavpackLossy(wpc2)


def test_api_chunked_decode_invariance():
    n = 9000
    pcm = _sig(n, 2, seed=9)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=2048)
    wpc = api.WavpackOpenFileInput(wv, wvc_source=wvc)
    assert wpc.wvc_all_paired
    out = np.zeros(n * 2, np.int32)
    pos = 0
    while pos < n:
        k = min(777, n - pos)
        buf = np.zeros(k * 2, np.int32)
        got = api.WavpackUnpackSamples(wpc, buf, k)
        assert got == k
        out[pos * 2:(pos + k) * 2] = buf
        pos += k
    np.testing.assert_array_equal(out.reshape(-1, 2), pcm)


def test_api_seek_with_wvc():
    n = 10000
    pcm = _sig(n, 2, seed=10)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=2500)
    wpc = api.WavpackOpenFileInput(wv, wvc_source=wvc)
    assert api.SetSample(wpc, 6100)
    k = n - 6100
    buf = np.zeros(k * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, k) == k
    np.testing.assert_array_equal(buf.reshape(-1, 2), pcm[6100:])


def test_streaming_open_pairs_wvc(tmp_path):
    n = 16000
    pcm = _sig(n, 2, seed=12)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=2000)
    p = tmp_path / "s.wv"
    p.write_bytes(wv)
    (tmp_path / "s.wvc").write_bytes(wvc)
    wpc = api.WavpackOpenFileInput(str(p), flags=consts.OPEN_WVC,
                                   streaming=True)
    assert wpc.streaming and wpc.wvc_all_paired
    assert api.WavpackGetMode(wpc) & consts.MODE_WVC
    buf = np.zeros(n * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, n) == n
    assert api.WavpackGetNumErrors(wpc) == 0
    np.testing.assert_array_equal(buf.reshape(-1, 2), pcm)


def test_multichannel_wvc():
    n = 4000
    rng = np.random.default_rng(13)
    pcm = (2500 * np.sin(np.arange(n) / 11.0)[:, None]
           + rng.normal(0, 700, (n, 5))).astype(np.int32)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=1024)
    wpc = api.WavpackOpenFileInput(wv, flags=consts.OPEN_ALL_CHANNELS,
                                   wvc_source=wvc)
    assert wpc.wvc_all_paired
    buf = np.zeros(n * 5, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, n) == n
    assert api.WavpackGetNumErrors(wpc) == 0
    np.testing.assert_array_equal(buf.reshape(-1, 5), pcm)


def test_cli_roundtrip(tmp_path):
    from wvpk.cli import main as cli_main
    from wvpk.io.pcm import format_samples
    from wvpk.io.wav import make_wav_header
    n = 14000
    pcm = _sig(n, 2, seed=14)
    src = tmp_path / "in.wav"
    src.write_bytes(make_wav_header(n, 2, 44100, 16, 2)
                    + format_samples(pcm, 2))
    wv = str(tmp_path / "out.wv")
    assert cli_main(["--encode", str(src), "-o", wv,
                     "--hybrid-bitrate", "450", "--wvc", "-q"]) == 0
    assert os.path.exists(wv + "c")
    back = str(tmp_path / "back.wav")
    assert cli_main([wv, "-o", back, "--verify-md5", "-q"]) == 0
    assert src.read_bytes() == open(back, "rb").read()
    # --no-wvc ignores the sibling: lossy output differs
    lossy = str(tmp_path / "lossy.wav")
    assert cli_main([wv, "-o", lossy, "--no-wvc", "-q"]) == 0
    assert open(lossy, "rb").read() != src.read_bytes()


def test_wvc_exact_under_lane_kernel_backend():
    """Hybrid-lossless buckets run the XLA scans on every platform: with
    the decode backend on the lane kernel, a .wvc pair still decodes to
    the exact source with both CRCs matching the oracle."""
    from wvpk.engine import decode_states
    from wvpk.ops import backend
    from wvpk.ref import decode_block
    pcm = _sig(5000, 2, seed=18)
    wv, wvc = encode(pcm, hybrid=True, bitrate=420, wvc=True,
                     block_samples=1024, md5=False)
    blks = parse_blocks(wv)
    assert pair_wvc(blks, wvc) == len(blks)
    with backend._force("kernel"):
        dev = decode_states([x.state for x in blks])
    for blk, d in zip(blks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(d.samples, want.samples)
        assert d.wvc_applied and not d.crc_error
        assert (d.crc, d.crc_wvc) == (want.crc, want.crc_wvc)
    np.testing.assert_array_equal(
        np.concatenate([d.samples for d in dev]), pcm)


def test_native_wvc_encoder_byte_identical(monkeypatch):
    """The C encoder's correction-stream emission must be byte-identical
    to the Python coder on BOTH outputs (wv and wvc)."""
    import wvpk.native as nat
    if nat.get_encode_lib() is None:
        pytest.skip("native encoder unavailable")
    pcm = _sig(7000, 2, seed=17)
    spec = EncodeSpec(hybrid=True, wvc=True, joint=True, bitrate=430,
                      hybrid_bitrate=True, block_samples=1500)
    s1: list = []
    wv1 = b"".join(encode_blocks(pcm, spec, wvc_sink=s1))
    monkeypatch.setattr(nat, "_enc_lib", None)
    monkeypatch.setattr(nat, "_enc_tried", True)
    spec2 = EncodeSpec(hybrid=True, wvc=True, joint=True, bitrate=430,
                       hybrid_bitrate=True, block_samples=1500)
    s2: list = []
    wv2 = b"".join(encode_blocks(pcm, spec2, wvc_sink=s2))
    assert wv1 == wv2
    assert b"".join(s1) == b"".join(s2)


def test_streaming_encode_wvc(tmp_path):
    """encode_wav_file(wvc=True) writes <out>c window-by-window; the
    pair decodes exactly (per-block corrections hold regardless of the
    hybrid multiwindow median differences)."""
    from wvpk.encode import encode_wav_file
    from wvpk.io.pcm import format_samples
    from wvpk.io.wav import make_wav_header
    n = 20000
    pcm = _sig(n, 2, seed=16)
    src = tmp_path / "s.wav"
    src.write_bytes(make_wav_header(n, 2, 44100, 16, 2)
                    + format_samples(pcm, 2))
    out = str(tmp_path / "s.wv")
    info = encode_wav_file(str(src), out, hybrid=True, bitrate=430,
                           wvc=True, block_samples=2048,
                           window_samples=6144)
    assert info["windows"] > 1 and info["wvc_bytes_written"] > 0
    wpc = api.WavpackOpenFileInput(out, flags=consts.OPEN_WVC)
    assert wpc.wvc_all_paired
    buf = np.zeros(n * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, n) == n
    assert api.WavpackGetNumErrors(wpc) == 0
    np.testing.assert_array_equal(buf.reshape(-1, 2), pcm)
    # device encode rejects wvc with a clear error
    from wvpk.encode import encode_device
    with pytest.raises(ValueError, match="host-encode only"):
        encode_device(pcm, hybrid=True, wvc=True)


def test_wvc_requires_hybrid_and_bans_intra_cross_terms():
    pcm = _sig(1000, 2, seed=15)
    with pytest.raises(ValueError, match="hybrid"):
        encode(pcm, wvc=True)
    spec = EncodeSpec(hybrid=True, wvc=True, joint=True,
                      terms=(18, -1, 17), deltas=(2, 2, 2))
    with pytest.raises(ValueError, match="intra-sample cross terms"):
        encode_blocks(pcm, spec)
    # the public surface maps -1/-2 -> -3 under the high preset
    wv, wvc = encode(pcm, hybrid=True, wvc=True, preset="high",
                     bitrate=420)
    blks = parse_blocks(wv)
    assert pair_wvc(blks, wvc) == len(blks)
    outs = [decode_block(b.state) for b in blks]
    assert not any(r.crc_error for r in outs)
    np.testing.assert_array_equal(
        np.concatenate([r.samples for r in outs]), pcm)
