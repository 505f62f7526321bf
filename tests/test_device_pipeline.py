"""Device pipeline vs scalar oracle: bit-exactness over the mode matrix."""

import numpy as np
import pytest

from wvpk.container import parse_blocks
from wvpk.engine import decode_bytes
from wvpk.ref import decode_block
from wvpk.testgen import EncodeSpec, encode_dsd_file, encode_file


def compare(data: bytes):
    blocks, dev = decode_bytes(data)
    assert blocks
    for blk, d in zip(blocks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(
            d.samples, want.samples,
            err_msg=f"block @{blk.header.block_index}")
        assert d.mute_error == want.mute_error
        assert d.crc_error == want.crc_error
        if not want.mute_error:
            assert d.crc == want.crc
    return dev


def noise(n, ch, scale, seed=0):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def test_dev_stereo_lossless():
    pcm = noise(1200, 2, 4000, seed=1)
    compare(encode_file(pcm, EncodeSpec(block_samples=300, joint=True)))


def test_dev_mixed_buckets_one_call():
    # different profiles decoded in one decode_bytes call
    a = encode_file(noise(500, 2, 900, 2), EncodeSpec(block_samples=250, joint=True))
    b = encode_file(noise(300, 1, 500, 3), EncodeSpec(block_samples=300, mono=True, terms=(17, 2), deltas=(2, 2)))
    compare(a + b)


def test_dev_mono():
    pcm = noise(800, 1, 1500, seed=4)
    compare(encode_file(pcm, EncodeSpec(block_samples=200, mono=True,
                                        terms=(18, 17, 2), deltas=(2, 2, 1))))


def test_dev_false_stereo():
    pcm = noise(400, 1, 800, seed=5)
    compare(encode_file(pcm, EncodeSpec(block_samples=200, false_stereo=True)))


@pytest.mark.parametrize("terms,deltas", [
    ((1,), (2,)), ((8, 5, 3, 1), (2, 2, 1, 1)),
    ((-1, 18, 2), (1, 2, 2)), ((-2, 17), (2, 2)),
    ((-3, 18, 18, 2), (2, 2, 2, 1)),
])
def test_dev_terms(terms, deltas):
    pcm = noise(500, 2, 3000, seed=sum(terms) & 0xFF)
    compare(encode_file(pcm, EncodeSpec(block_samples=250, joint=True,
                                        terms=terms, deltas=deltas)))


def test_dev_zero_runs():
    pcm = np.zeros((600, 2), np.int64)
    pcm[250:280] = noise(30, 2, 60, seed=6)
    compare(encode_file(pcm, EncodeSpec(
        block_samples=300, joint=True,
        initial_medians=((0, 0, 0), (0, 0, 0)))))


def test_dev_shift_and_depths():
    pcm = noise(400, 2, 400, seed=7) << 3
    compare(encode_file(pcm, EncodeSpec(block_samples=200, joint=True,
                                        shift=3, bytes_stored=3)))


def test_dev_hybrid():
    pcm = noise(600, 2, 7000, seed=8)
    compare(encode_file(pcm, EncodeSpec(block_samples=300, joint=True,
                                        hybrid=True, bitrate=600)))


def test_dev_hybrid_bitrate():
    pcm = noise(600, 2, 3000, seed=9)
    compare(encode_file(pcm, EncodeSpec(
        block_samples=300, joint=True, hybrid=True, hybrid_bitrate=True,
        bitrate=300, bitrate_delta=1)))


def test_dev_int32_zeros():
    pcm = noise(300, 2, 10**6, seed=10) << 5
    compare(encode_file(pcm, EncodeSpec(block_samples=150, bytes_stored=4,
                                        int32_mode="zeros", int32_zeros=5)))


def test_dev_int32_wvx_old():
    pcm = np.random.default_rng(11).integers(-2**29, 2**29, size=(300, 2))
    compare(encode_file(pcm, EncodeSpec(block_samples=150, bytes_stored=4,
                                        int32_mode="wvx", int32_sent_bits=6)))


def test_dev_int32_wvx_new():
    pcm = np.random.default_rng(12).integers(-2**26, 2**26, size=(300, 2))
    compare(encode_file(pcm, EncodeSpec(block_samples=150, bytes_stored=4,
                                        int32_mode="wvx", int32_sent_bits=4,
                                        int32_max_width=31)))


def test_dev_float():
    pcm = np.random.default_rng(13).integers(-2**22, 2**22, size=(300, 2))
    compare(encode_file(pcm, EncodeSpec(
        block_samples=150, float_data=True, bytes_stored=4,
        float_shift=0, float_max_exp=127, float_norm_exp=127)))


def test_dev_float_shifted():
    pcm = np.random.default_rng(14).integers(-2**22, 2**22, size=(300, 2))
    compare(encode_file(pcm, EncodeSpec(
        block_samples=150, float_data=True, bytes_stored=4,
        float_shift=0, float_max_exp=130, float_norm_exp=127)))


def test_dev_float_negative_shift():
    """shift = max_exp - norm_exp + float_shift < 0 takes the
    `values >>= -shift` arm of FloatUtils.cs:36-47."""
    pcm = np.random.default_rng(40).integers(-2**22, 2**22, size=(300, 2))
    compare(encode_file(pcm, EncodeSpec(
        block_samples=150, float_data=True, bytes_stored=4,
        float_shift=0, float_max_exp=120, float_norm_exp=127)))


def test_dev_float_shift_clamped():
    """|shift| > 32 clamps to +/-32 (FloatUtils.cs:36-39), and the C#
    mod-32 int shift makes the clamped shift a NO-OP (only the 24-bit
    clip applies) — both arms. float_shift itself is an unsigned byte
    (FloatUtils.cs:25), so the negative arm comes from max_exp."""
    pcm = np.random.default_rng(41).integers(-2**22, 2**22, size=(200, 2))
    for max_exp, norm_exp, fsh in ((127, 127, 40), (60, 127, 0)):
        compare(encode_file(pcm, EncodeSpec(
            block_samples=100, float_data=True, bytes_stored=4,
            float_shift=fsh, float_max_exp=max_exp, float_norm_exp=norm_exp)))


def test_dev_float_clip_saturates():
    """positive shift pushing values past 24 bits hits the 8388607 /
    -8388608 clip arms (FloatUtils.cs:49-52)."""
    pcm = np.random.default_rng(42).integers(-2**22, 2**22, size=(300, 2))
    compare(encode_file(pcm, EncodeSpec(
        block_samples=150, float_data=True, bytes_stored=4,
        float_shift=4, float_max_exp=130, float_norm_exp=127)))


def test_dev_hybrid_clip_saturates():
    """Near-full-scale hybrid content overshoots the stored-byte range so
    the lossy clip (UnpackUtils.cs:1350-1393) fires — probed at 130-156
    hits per corpus across bytes_stored 1/2/3 incl. the bs==3 logical-
    shift quirk and a shifted variant."""
    rng = np.random.default_rng(77)
    rng.normal(0, 90, (600, 2))  # keep stream position of the probe run
    for shift, bs in ((0, 1), (2, 2), (0, 3)):
        scale = (1 << (8 * bs - 1)) - 1
        p = np.clip(np.round(rng.normal(0, scale * 0.7, (600, 2))),
                    -scale - 1, scale).astype(np.int64)
        p = (p >> shift) << shift
        compare(encode_file(p, EncodeSpec(
            block_samples=300, hybrid=True, bitrate=256 * bs,
            bytes_stored=bs, shift=shift)))


def test_dev_dsd_host_fallback():
    r = np.random.default_rng(15)
    data = r.integers(0, 256, size=(400, 2)).astype(np.int64)
    compare(encode_dsd_file(data, 1, mono=False, history_bits=1))


def test_dev_corrupt_int32_counts_mod32():
    """Corrupt ID_INT32_INFO bytes push zeros/ones/dups/sent_bits past 31;
    C# shift counts are mod-32 (UnpackUtils.cs:1301-1343 run on ints), so
    fixup must NOT zero the values. The block's CRC covers pre-fixup
    samples, so concealment never catches this arm — only the
    device-vs-oracle differential does (found by the seed-100018 soak)."""
    rng = np.random.default_rng(43)
    base = rng.integers(-2**18, 2**18, size=(200, 1)).astype(np.int64)
    pcms = {"zeros": base << 5, "ones": ((base + 1) << 5) - 1,
            "dups": ((base + (base & 1)) << 5) - (base & 1)}
    for mode, off in (("zeros", 1), ("ones", 2), ("dups", 3)):
        data = bytearray(encode_file(pcms[mode], EncodeSpec(
            block_samples=200, mono=True, bytes_stored=4, int32_mode=mode,
            **{f"int32_{mode}": 5})))
        # locate the ID_INT32_INFO payload (id 0x09, word length 2) and
        # bump the mode's count byte to 37 (= 5 mod 32)
        idx = bytes(data).find(bytes([0x09, 0x02]))
        assert idx > 0 and data[idx + 2 + off] == 5
        data[idx + 2 + off] = 37
        compare(bytes(data))


def test_dev_corrupted_block_mutes():
    pcm = noise(500, 2, 2000, seed=16)
    data = bytearray(encode_file(pcm, EncodeSpec(block_samples=250, joint=True)))
    # flip bits deep inside the first block's bitstream payload
    data[200] ^= 0xFF
    data[201] ^= 0xFF
    blocks, dev = decode_bytes(bytes(data))
    want = [decode_block(b.state) for b in blocks]
    for d, w in zip(dev, want):
        np.testing.assert_array_equal(d.samples, w.samples)
        assert d.mute_error == w.mute_error
        assert d.crc_error == w.crc_error


def test_dev_chunked_delivery():
    """Chunked pipelined delivery (delivery_chunk_blocks small) matches
    the single-fetch path bit-exactly, incl. a DSD block fetched with the
    final chunk and mixed profiles split across chunk boundaries."""
    from wvpk import config
    a = encode_file(noise(64 * 20, 2, 2500, 7),
                    EncodeSpec(block_samples=64, joint=True))
    b = encode_file(noise(64 * 5, 1, 700, 8),
                    EncodeSpec(block_samples=64, mono=True,
                               terms=(17, 2), deltas=(2, 2)))
    d = np.random.default_rng(9).integers(0, 256, (300, 2)).astype(np.int64)
    data = a + b + encode_dsd_file(d, 1, mono=False, history_bits=2)
    config.set_options(delivery_chunk_blocks=8)
    try:
        compare(data)
    finally:
        config.set_options(delivery_chunk_blocks=0)


def test_chain_segment_staging_and_mapping():
    """Mixed-chain corpora: one bucket holds every chain, in the caller's
    block order (the decode paths take any chain per lane, so staging
    neither sorts nor segments lanes by chain); results map back to the
    caller's order."""
    from wvpk.engine import staging

    chains = [(18, 17, 2), (18, 18, 2, 17, 3), (17, 2)]
    datas = []
    for i, ch in enumerate(chains):
        pcm = noise(750, 2, 1500, seed=40 + i)
        datas.append(encode_file(pcm, EncodeSpec(
            block_samples=250, joint=bool(i % 2), terms=ch,
            deltas=(2,) * len(ch))))
    # interleave the three files' blocks
    data = b"".join(datas)
    states = [b.state for b in parse_blocks(data)]
    order = sorted(range(len(states)), key=lambda i: i % 3)
    states = [states[i] for i in order]
    buckets = staging.group_blocks(states)
    assert len(buckets) == 1
    b = buckets[0]
    assert [id(s) for s in b.states] == [id(s) for s in states]
    assert b.indices == list(range(len(states)))
    assert {tuple(st.terms[:st.num_terms]) for st in b.states} \
        == set(chains)
    # end-to-end: decode through the pipeline, results in caller order
    compare(data)


def test_chain_segment_uniform_bucket_has_none():
    """A uniform-chain bucket stages like any other: no chain-specific
    fields, and the decorr arrays carry the full 16-slot width."""
    data = encode_file(noise(600, 2, 1000, seed=50),
                       EncodeSpec(block_samples=300, joint=True))
    from wvpk.engine.staging import group_blocks
    b = group_blocks([blk.state for blk in parse_blocks(data)])[0]
    assert not hasattr(b, "static_terms")
    assert not hasattr(b, "chain_segments")
    assert b.terms.shape == (len(b.states), 16)
    assert b.hist_a.shape == (len(b.states), 16, 8)
    compare(data)


def test_chunked_delivery_fixed_lane_buckets(monkeypatch):
    """Per-profile chunking must produce repeated bucket lane
    counts (every full chunk identical), so one compiled fused program
    serves all full chunks — the property that makes pipelined delivery
    recompile-free."""
    from wvpk import config
    from wvpk.container import parse_blocks
    from wvpk.engine import pipeline

    a = encode_file(noise(64 * 21, 2, 2500, 17),
                    EncodeSpec(block_samples=64, joint=True))
    b = encode_file(noise(64 * 9, 1, 700, 18),
                    EncodeSpec(block_samples=64, mono=True,
                               terms=(17, 2), deltas=(2, 2)))
    states = [blk.state for blk in parse_blocks(a + b)]

    seen = []
    real = pipeline.launch_bucket

    def spy(bucket):
        seen.append((bucket.profile, len(bucket.states)))
        return real(bucket)

    monkeypatch.setattr(pipeline, "launch_bucket", spy)
    config.set_options(delivery_chunk_blocks=8)
    try:
        res = pipeline.decode_states(states)
    finally:
        config.set_options(delivery_chunk_blocks=0)
    assert len(res) == len(states)
    # stereo: 21 blocks -> chunks of 8, 8, 5; mono: 9 -> 8, 1
    stereo = sorted(n for p, n in seen if not p.mono)
    mono = sorted(n for p, n in seen if p.mono)
    assert stereo == [5, 8, 8]
    assert mono == [1, 8]
    # and the results must be bit-exact vs the oracle
    for st, r in zip(states, res):
        np.testing.assert_array_equal(r.samples,
                                      decode_block(st).samples)
