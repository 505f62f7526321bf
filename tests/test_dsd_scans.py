"""DSD modes 1 and 3 through the XLA scans (ops/dsd.py), against the
scalar oracle and the blocks' own CRCs."""

import numpy as np

from wvpk.container import parse_blocks
from wvpk.engine.dsd_pipeline import _profile, decode_dsd_states
from wvpk.ref import decode_block
from wvpk.testgen import encode_dsd_file


def check(mode, nsamp, mono, seed, lanes=3, history_bits=2, smooth=False):
    rng = np.random.default_rng(seed)
    ch = 1 if mono else 2
    states = []
    for _ in range(lanes):
        if smooth:
            # low-entropy bytes: big probability skew, exercises the
            # interval-reset (mult == 0) path more often
            d = (rng.integers(0, 4, (nsamp, ch)) * 0x55) & 0xFF
        else:
            d = rng.integers(0, 256, (nsamp, ch))
        data = encode_dsd_file(d.astype(np.int64), mode, mono=mono,
                               history_bits=history_bits)
        states += [b.state for b in parse_blocks(data)
                   if b.state.header.block_samples]
    sts = [st for st in states if _profile(st).mode == mode]
    assert len(sts) == len(states)
    for st, got in zip(sts, decode_dsd_states(sts)):
        want = decode_block(st)
        np.testing.assert_array_equal(got.samples, want.samples)
        # hard gate: CRCs must also match the headers (clean corpus)
        assert got.crc == st.header.crc
        assert not got.crc_error and not got.mute_error


def test_high_stereo():
    check(3, 700, mono=False, seed=1)


def test_high_mono():
    check(3, 500, mono=True, seed=2)


def test_high_long_block():
    check(3, 3000, mono=False, seed=3, lanes=2)


def test_fast_stereo_bins2():
    check(1, 700, mono=False, seed=4, history_bits=1)


def test_fast_mono_bins1():
    check(1, 500, mono=True, seed=5, history_bits=0)


def test_fast_bins8_smooth():
    check(1, 400, mono=False, seed=6, history_bits=3, smooth=True)


def test_fast_bins32():
    # history_bits=5 is the reference cap (DsdUtils.cs:167)
    check(1, 300, mono=False, seed=7, history_bits=5, lanes=2)
