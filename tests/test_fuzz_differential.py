"""Randomized differential fuzz: random mode-matrix specs and signals,
encoder -> oracle decode vs device decode must agree exactly.

Seeds are fixed (reproducible); WVPK_FUZZ_CASES scales the sweep up for
long runs.
"""

import os
from dataclasses import asdict

import numpy as np
import pytest

from wvpk.container import parse_blocks
from wvpk.engine import decode_states
from wvpk.ref import decode_block
from wvpk.testgen import EncodeSpec, encode_file
from wvpk.testgen.fuzzspec import random_pcm, random_spec

N_CASES = int(os.environ.get("WVPK_FUZZ_CASES", "24"))


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_case(seed):
    rng = np.random.default_rng(1000 + seed)
    spec = random_spec(rng)
    n = int(rng.integers(spec.block_samples // 2,
                         spec.block_samples * 3 + 1))
    pcm = random_pcm(rng, n, spec.nch_data, spec)
    data = encode_file(pcm, spec)
    if rng.random() < 0.25:  # corrupt sometimes
        data = bytearray(data)
        data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
    blocks = parse_blocks(data)
    dev = decode_states([b.state for b in blocks])
    for blk, d in zip(blocks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(
            d.samples, want.samples,
            err_msg=f"seed {seed} spec {spec} block {blk.header.block_index}")
        assert d.mute_error == want.mute_error, (seed, spec)
        assert d.crc_error == want.crc_error, (seed, spec)
        if not spec.hybrid and not spec.float_data \
                and not want.mute_error and not want.crc_error:
            # lossless identity against the source (corrupt blocks are
            # CRC-flagged and legitimately differ; float asserts only the
            # oracle differential above)
            lo = blk.header.block_index
            hi = min(blk.header.end_index, n)
            src = pcm[lo:hi]
            if spec.false_stereo:
                src = np.repeat(src, 2, axis=1)
            np.testing.assert_array_equal(d.samples[:hi - lo], src)


@pytest.mark.parametrize("seed", range(min(N_CASES, 10)))
def test_fuzz_case_multichannel(seed):
    """Random >2ch segments (INITIAL..FINAL stream groups)."""
    from wvpk.testgen import encode_multichannel
    rng = np.random.default_rng(13000 + seed)
    nch = int(rng.integers(3, 9))
    spec = random_spec(rng, family="plain")
    spec = EncodeSpec(**{**asdict(spec), "mono": False,
                         "false_stereo": False, "hybrid": False,
                         "hybrid_bitrate": False, "bitrate_delta": 0,
                         "shift": 0,
                         "terms": tuple(t for t in spec.terms if t > 0)
                         or (18, 2)})
    n = int(rng.integers(spec.block_samples // 2,
                         spec.block_samples * 2 + 1))
    pcm = random_pcm(rng, n, nch, spec)
    data = encode_multichannel(pcm, spec)
    blocks = parse_blocks(data)
    dev = decode_states([b.state for b in blocks])
    for blk, d in zip(blocks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(
            d.samples, want.samples,
            err_msg=f"mc seed {seed} nch {nch} spec {spec}")
        assert not d.crc_error
    # whole-segment reassembly through the API must reproduce the source
    from wvpk import api, consts
    wpc = api.WavpackOpenFileInput(data, flags=consts.OPEN_ALL_CHANNELS)
    buf = np.zeros(n * nch, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, n) == n
    np.testing.assert_array_equal(buf.reshape(-1, nch), pcm)


@pytest.mark.parametrize("seed", range(min(N_CASES, 12)))
def test_fuzz_case_dsd(seed):
    from wvpk.testgen import encode_dsd_file
    rng = np.random.default_rng(9000 + seed)
    mode = int(rng.choice([0, 1, 1, 3]))
    mono = bool(rng.random() < 0.3)
    ch = 1 if mono else 2
    n = int(rng.integers(100, 1500))
    kind = rng.integers(0, 3)
    if kind == 0:
        d = rng.integers(0, 256, (n, ch))
    elif kind == 1:  # strongly patterned (silence-ish DSD)
        d = np.full((n, ch), 0x55)
        hits = rng.random((n, ch)) < 0.1
        d = np.where(hits, rng.integers(0, 256, (n, ch)), d)
    else:
        d = np.cumsum(rng.integers(-2, 3, (n, ch)), axis=0) % 256
    data = encode_dsd_file(d.astype(np.int64), mode, mono=mono,
                           history_bits=int(rng.integers(0, 4)),
                           block_samples=int(rng.choice([n, 256])))
    if rng.random() < 0.3:
        data = bytearray(data)
        data[int(rng.integers(40, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
    blocks = parse_blocks(data)
    dev = decode_states([b.state for b in blocks])
    for blk, d_res in zip(blocks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(d_res.samples, want.samples,
                                      err_msg=f"dsd seed {seed} mode {mode}")
        assert d_res.mute_error == want.mute_error


@pytest.mark.parametrize("seed", range(min(N_CASES, 8)))
def test_fuzz_case_lane_kernel(seed):
    """Same differential check with the decode path forced onto the lane
    kernel (the CUDA source compiled for the host): the engine's fused
    program as the GPU runs it, including hybrid, int32/wvx, float
    families and corrupt-stream mute/CRC arms."""
    from wvpk.ops import backend
    rng = np.random.default_rng(5000 + seed)
    spec = random_spec(rng)
    n = int(rng.integers(spec.block_samples // 2, spec.block_samples * 2 + 1))
    pcm = random_pcm(rng, n, spec.nch_data, spec)
    data = encode_file(pcm, spec)
    if rng.random() < 0.3:  # pressure the mute/CRC arms
        data = bytearray(data)
        data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
    blocks = parse_blocks(data)
    with backend._force("kernel"):
        dev = decode_states([b.state for b in blocks])
    for blk, d in zip(blocks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(d.samples, want.samples,
                                      err_msg=f"seed {seed} spec {spec}")
        assert d.mute_error == want.mute_error, (seed, spec)
        assert d.crc_error == want.crc_error, (seed, spec)


@pytest.mark.parametrize("seed", range(min(N_CASES, 2)))
def test_fuzz_case_dsd_corrupt(seed):
    """Corrupt-stream differential for DSD modes 1 and 3: the
    concealment arms (mode-1 bad-index/err latch, CRC mismatch -> 0x55
    mute fill) must match the oracle bit-for-bit."""
    from wvpk.testgen import encode_dsd_file
    rng = np.random.default_rng(128100 + seed)
    mode = int(rng.choice([1, 1, 3]))
    mono = bool(rng.random() < 0.3)
    ch = 1 if mono else 2
    n = int(rng.integers(60, 140))
    d = rng.integers(0, 256, (n, ch))
    data = bytearray(encode_dsd_file(d.astype(np.int64), mode, mono=mono,
                                     history_bits=int(rng.integers(1, 4))))
    data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
    blocks = parse_blocks(bytes(data))
    dev = decode_states([b.state for b in blocks])
    for blk, d_res in zip(blocks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(d_res.samples, want.samples,
                                      err_msg=f"seed {seed} mode {mode}")
        assert d_res.mute_error == want.mute_error, (seed, mode)
        assert d_res.crc_error == want.crc_error, (seed, mode)
