"""Device lossless encoder: kernels + block assembly + public API.

Validation strategy: (a) decorr_invert is the exact inverse of the
device decode kernel; (b) device-encoded streams decode bit-exactly on
BOTH decoder paths (scalar oracle + device engine) and lossless
roundtrip is the identity; (c) a single-block file is byte-identical to
the host encoder (per-block seeding coincides there).
"""

import numpy as np
import pytest

from wvpk.container import parse_blocks
from wvpk.encode import encode_device
from wvpk.engine import decode_states
from wvpk.engine.device_encoder import encode_blocks_device
from wvpk.ref import decode_block
from wvpk.testgen.encoder import EncodeSpec, encode_file

TERMPOOL = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18]


def oracle_roundtrip(data, pcm, false_stereo=False, lossless=True):
    outs = []
    blocks = parse_blocks(data)
    for b in blocks:
        r = decode_block(b.state)
        assert not r.crc_error and not r.mute_error
        outs.append(r.samples)
    got = np.concatenate(outs)
    if lossless:
        src = pcm if not false_stereo else np.repeat(pcm, 2, 1)
        np.testing.assert_array_equal(got, src)
    # device decode must agree block-for-block
    dev = decode_states([b.state for b in blocks])
    for d, o in zip(dev, outs):
        np.testing.assert_array_equal(d.samples, o)
    return got


def test_invert_is_decode_inverse():
    from wvpk.ops.decorr import decorr_decode
    from wvpk.ops.encode_kernels import decorr_invert
    rng = np.random.default_rng(0)
    for mono in (False, True):
        L, T, C = 4, 150, 1 if mono else 2
        terms = np.zeros((L, 16), np.int32)
        deltas = np.zeros((L, 16), np.int32)
        nt = rng.integers(0, 17, L).astype(np.int32)
        for i in range(L):
            terms[i, :nt[i]] = rng.choice(TERMPOOL, nt[i])
            if not mono and nt[i] and rng.random() < 0.5:
                terms[i, 0] = rng.choice([-1, -2, -3])
            deltas[i, :nt[i]] = rng.integers(0, 8, nt[i])
        targ = rng.integers(-60000, 60000, (T, L, C)).astype(np.int32)
        res = np.asarray(decorr_invert(targ, terms, deltas, nt, mono=mono))
        z = np.zeros((L, 16), np.int32)
        h = np.zeros((L, 16, 8), np.int64)
        back = np.asarray(decorr_decode(res, terms, deltas, z, z, h, h,
                                        nt, mono=mono))
        np.testing.assert_array_equal(back, targ)


def sig(n, ch, scale=5000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    return np.round(scale * np.sin(2 * np.pi * t / 89.0)
                    + rng.normal(0, scale / 30, (n, ch))).astype(np.int64)


def test_multiblock_identity_and_device_decode():
    pcm = sig(3000, 2, seed=1)
    spec = EncodeSpec(block_samples=700, joint=True, terms=(18, 17, 2),
                      deltas=(2, 2, 2))
    oracle_roundtrip(b"".join(encode_blocks_device(pcm, spec)), pcm)


def test_single_block_byte_identical_to_host():
    pcm = sig(800, 2, seed=2)
    spec = EncodeSpec(block_samples=800, joint=True, terms=(18, 17, 2),
                      deltas=(2, 2, 2), md5=True)
    assert encode_blocks_device(pcm, spec)[0] == encode_file(pcm, spec)


@pytest.mark.parametrize("case", ["mono", "nojoint", "neg", "deep",
                                  "shift24", "zeros32", "silence", "spiky"])
def test_mode_matrix(case):
    kw = dict(block_samples=400, joint=True, terms=(18, 17, 2),
              deltas=(2, 2, 2))
    pcm = sig(1100, 2, seed=hash(case) % 1000)
    if case == "mono":
        kw.update(mono=True, joint=False)
        pcm = pcm[:, :1]
    elif case == "nojoint":
        kw.update(joint=False)
    elif case == "neg":
        kw.update(terms=(-2, 17, 3), deltas=(1, 2, 2))
    elif case == "deep":
        kw.update(terms=(18, 18, 17, 17, 3, 2, 5, 1, 2, 18, 17, 2),
                  deltas=(2,) * 12)
    elif case == "shift24":
        kw.update(bytes_stored=3, shift=3)
        pcm = (pcm * 40) << 3
    elif case == "zeros32":
        kw.update(bytes_stored=4, int32_mode="zeros", int32_zeros=5)
        pcm = pcm << 5
    elif case == "silence":
        pcm[100:900] = 0
    elif case == "spiky":
        pcm[:] = 0
        pcm[::61] = 9000
    spec = EncodeSpec(**kw)
    oracle_roundtrip(b"".join(encode_blocks_device(pcm, spec)), pcm)


def test_correlated_channels_mag_and_odd_payload():
    """Regressions: (a) the header MAG field must come from the
    pre-joint stored values (strongly correlated channels make the joint
    difference much smaller — a joint-domain MAG trips the decoder's
    mute limit); (b) odd-length payloads are padded by mkmeta with
    ID_ODD_SIZE, not pre-padded (double padding shifted the length)."""
    rng = np.random.default_rng(42)
    t = np.arange(4096)
    s = 8000 * np.sin(2 * np.pi * 440 * t / 44100) \
        + rng.normal(0, 300, t.size)
    pcm = np.clip(np.round(np.stack([s, s * 0.7], 1)),
                  -32768, 32767).astype(np.int64)
    data = encode_device(pcm, block_samples=512)
    oracle_roundtrip(data, pcm)
    from wvpk.encode import build_spec
    spec = build_spec(pcm[:512], block_samples=512)
    assert encode_blocks_device(pcm[:512], spec)[0] \
        == encode_file(pcm[:512], spec)


def test_warmup_seeding_roundtrip_and_smaller():
    """Warm seeding (adapt decorr state over the block's first K
    samples, store the quantized state in metadata) must roundtrip
    exactly and compress better than fresh seeds."""
    from wvpk.encode import build_spec
    rng = np.random.default_rng(21)
    t = np.arange(6000)
    s = 6000 * np.sin(2 * np.pi * t / 101.0) + rng.normal(0, 150, t.size)
    pcm = np.round(np.stack([s, s * 0.7], 1)).astype(np.int64)
    spec = build_spec(pcm, block_samples=1000, preset="high", md5=False)
    cold = b"".join(encode_blocks_device(pcm, spec, warmup=0))
    warm = b"".join(encode_blocks_device(pcm, spec, warmup=256))
    assert len(warm) < len(cold)
    oracle_roundtrip(warm, pcm)
    # mono + negative-term-free chain through the warm path too
    mono = pcm[:, :1]
    mspec = build_spec(mono, block_samples=1000, preset="high", md5=False)
    oracle_roundtrip(b"".join(encode_blocks_device(mono, mspec,
                                                   warmup=256)), mono)


def test_public_encode_device():
    pcm = sig(1500, 2, seed=5)
    data = encode_device(pcm, block_samples=512, preset="high")
    oracle_roundtrip(data, pcm)


def test_encode_device_wvx():
    # wide 32-bit content: device scans + host-packed sent-bits sidecar
    # (ID_WVX_BITSTREAM with crc_mvx, UnpackUtils.cs:1271-1314)
    base = sig(1500, 2, seed=5)
    wide = (base * (1 << 14)).astype(np.int64) | 1
    data = encode_device(wide, block_samples=512, bytes_per_sample=4)
    oracle_roundtrip(data, wide)
    # mono and false-stereo variants (false stereo exercises the
    # decoder's 2x-entry fixup with EOF-filled upper-half reads)
    mono = wide[:, :1]
    oracle_roundtrip(encode_device(mono, block_samples=512,
                                   bytes_per_sample=4), mono)
    fs = np.repeat(mono, 2, axis=1)
    oracle_roundtrip(encode_device(fs, block_samples=512,
                                   bytes_per_sample=4), fs)


def test_encode_device_multichannel():
    from collections import defaultdict
    pcm = sig(900, 5, seed=6)
    data = encode_device(pcm, block_samples=400, preset="high")
    blocks = parse_blocks(data)
    from wvpk import consts
    assert blocks[0].header.flags & consts.INITIAL_BLOCK
    assert blocks[2].header.flags & consts.FINAL_BLOCK
    seg = defaultdict(list)
    for b in blocks:
        r = decode_block(b.state)
        assert not r.crc_error and not r.mute_error
        seg[b.header.block_index].append(r.samples)
    out = np.concatenate([np.concatenate(seg[k], 1) for k in sorted(seg)])
    np.testing.assert_array_equal(out, pcm)
    # whole API surface: open + unpack all channels + md5
    import tempfile
    from wvpk import api
    with tempfile.NamedTemporaryFile(suffix=".wv") as f:
        f.write(data)
        f.flush()
        wpc = api.WavpackOpenFileInput(f.name,
                                       flags=consts.OPEN_ALL_CHANNELS)
        assert api.WavpackGetNumChannels(wpc) == 5
        n = api.WavpackGetNumSamples(wpc)
        buf = np.zeros(n * 5, np.int32)
        assert api.WavpackUnpackSamples(wpc, buf, n) == n
        np.testing.assert_array_equal(buf.reshape(n, 5), pcm)
        assert api.WavpackGetMD5Sum(wpc) is not None


# ---------------------------------------------------------------------------
# hybrid (lossy): fused reconstruction-feedback scan
# ---------------------------------------------------------------------------

def hybrid_roundtrip(data, pcm):
    """Decode on both paths, assert CRC-clean + path agreement; return
    the lossy reconstruction."""
    outs = []
    blocks = parse_blocks(data)
    for b in blocks:
        r = decode_block(b.state)
        assert not r.crc_error and not r.mute_error
        outs.append(r.samples)
    got = np.concatenate(outs)
    dev = decode_states([b.state for b in blocks])
    for d, o in zip(dev, outs):
        assert not d.crc_error
        np.testing.assert_array_equal(d.samples, o)
    return got


def noisy(n, ch, seed, scale=6000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    return np.clip(np.round(scale * np.sin(2 * np.pi * t / 89.0)
                            + rng.normal(0, scale / 8, (n, ch))),
                   -32768, 32767).astype(np.int64)


@pytest.mark.parametrize("case", ["stereo", "mono", "balance", "nobitrate"])
def test_hybrid_single_block_byte_identical_to_host(case):
    """Fresh-seeded single hybrid block == host encoder byte-for-byte
    (noisy content keeps medians off the zero-run gates, where the
    device's z=0 policy would diverge)."""
    mono = case == "mono"
    pcm = noisy(700, 1 if mono else 2, seed=hash(case) % 1000)
    spec = EncodeSpec(block_samples=1024, mono=mono, joint=not mono,
                      terms=(18, 2) if mono else (18, 17, 2),
                      deltas=(2, 2) if mono else (2, 2, 2),
                      hybrid=True,
                      hybrid_bitrate=case != "nobitrate",
                      hybrid_balance=case == "balance",
                      bitrate=420, md5=False)
    assert encode_blocks_device(pcm, spec, warmup=0)[0] \
        == encode_file(pcm, spec)


def test_hybrid_multiblock_decodes_on_both_paths():
    pcm = noisy(4200, 2, seed=77)
    spec = EncodeSpec(block_samples=1024, joint=True, terms=(18, 17, 2),
                      deltas=(2, 2, 2), hybrid=True, hybrid_bitrate=True,
                      bitrate=512, md5=False)
    got = hybrid_roundtrip(b"".join(
        encode_blocks_device(pcm, spec, warmup=0)), pcm)
    # lossy but close: the error-limit search bounds per-word error
    rms_s = np.sqrt((pcm.astype(float) ** 2).mean())
    rms_e = np.sqrt(((got - pcm).astype(float) ** 2).mean())
    assert 20 * np.log10(rms_s / max(rms_e, 1e-9)) > 25  # dB


def test_hybrid_silence_z0_policy():
    """Digital silence hits the zero-run gate at every word; the device
    emits gamma(0) + normal coding (never starts runs). Stream stays
    valid and reconstructs exact zeros."""
    pcm = np.zeros((2500, 2), np.int64)
    spec = EncodeSpec(block_samples=1024, joint=True, terms=(18, 17, 2),
                      deltas=(2, 2, 2), hybrid=True, hybrid_bitrate=True,
                      bitrate=512, md5=False)
    got = hybrid_roundtrip(b"".join(
        encode_blocks_device(pcm, spec, warmup=0)), pcm)
    np.testing.assert_array_equal(got, pcm)


def test_hybrid_warmup_and_multichannel():
    pcm = noisy(2048, 2, seed=91)
    spec = EncodeSpec(block_samples=512, joint=True, terms=(18, 17, 2),
                      deltas=(2, 2, 2), hybrid=True, hybrid_bitrate=True,
                      bitrate=512, md5=False)
    hybrid_roundtrip(b"".join(encode_blocks_device(pcm, spec, warmup=256)),
                     pcm)
    from dataclasses import replace

    from wvpk.engine.device_encoder import encode_multichannel_device
    pcm6 = noisy(1024, 6, seed=92)
    hybrid_roundtrip(encode_multichannel_device(
        pcm6, replace(spec, mono=False), warmup=0), pcm6)


def test_hybrid_public_api_and_rejections():
    from wvpk.encode import encode_device
    pcm = noisy(1500, 2, seed=93)
    blob = encode_device(pcm, hybrid=True, bitrate=512, block_samples=512)
    hybrid_roundtrip(blob, pcm)
    with pytest.raises(ValueError):
        encode_blocks_device(
            noisy(100, 2, 1),
            EncodeSpec(block_samples=100, hybrid=True, hybrid_bitrate=True,
                       float_data=True), warmup=0)
