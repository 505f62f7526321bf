"""The lane kernel (native/csrc/wvpk_lanes.cu, compiled for the host) vs
the XLA scans and the scalar oracle.

On the CPU the kernel source is built by the host C++ compiler and called
through the same FFI wrapper (ops/lanes.py) the GPU uses, so these tests
check the kernel's arithmetic and the wrapper's layouts bit-for-bit: the
XLA scans (ops/entropy.py -> ops/decorr.py -> ops/post.py) are the
int64-exact reference, themselves validated against the oracle.
"""

import numpy as np
import pytest

from wvpk.container import parse_blocks
from wvpk.engine.staging import group_blocks
from wvpk.ops import backend, lanes
from wvpk.ops.decorr import decorr_decode
from wvpk.ops.entropy import entropy_decode
from wvpk.ops.post import joint_mute_crc
from wvpk.testgen import EncodeSpec, encode_file

ALL_TERMS = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18, -1, -2, -3]
MONO_TERMS = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18]


def assert_same(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))


# --------------------------------------------------------------------------
# entropy -> decorr -> post on real streams (lanes.decode_post)
# --------------------------------------------------------------------------

def check(data: bytes, mono: bool):
    """Kernel vs the XLA chain on the file's (single) bucket."""
    b = group_blocks([bb.state for bb in parse_blocks(data)])[0]
    prof = b.profile
    assert prof.mono == mono
    kw = dict(mono=mono, hybrid=prof.hybrid,
              hybrid_bitrate=prof.hybrid_bitrate,
              hybrid_balance=prof.hybrid_balance, nsteps=prof.nsteps)
    res, broke, _ = entropy_decode(b.words, b.nwords_lane, b.med, b.slow,
                                   b.acc, b.delta, **kw)
    dec = decorr_decode(res, b.terms, b.deltas16, b.wa, b.wb, b.hist_a,
                        b.hist_b, b.num_terms, mono=mono)
    want = joint_mute_crc(dec, b.nsamples, b.joint, b.mute_limit, broke,
                          mono=mono)
    got = lanes.decode_post(
        b.words, b.nsamples, b.med, b.slow, b.acc, b.delta, b.terms,
        b.deltas16, b.wa, b.wb, b.hist_a, b.hist_b, b.num_terms, b.joint,
        b.mute_limit, **kw)
    assert_same(want, got)
    return got


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def test_kernel_stereo():
    _, crc, mute = check(encode_file(noise(700, 2, 3000, 1),
                                     EncodeSpec(block_samples=350,
                                                joint=True)), False)
    assert not np.asarray(mute).any()


def test_kernel_mono():
    check(encode_file(noise(512, 1, 900, 2),
                      EncodeSpec(block_samples=256, mono=True,
                                 terms=(18, 2), deltas=(2, 1))), True)


def test_kernel_zero_runs():
    pcm = np.zeros((512, 2), np.int64)
    pcm[100:130] = noise(30, 2, 50, 3)
    check(encode_file(pcm, EncodeSpec(block_samples=256, joint=True,
                                      initial_medians=((0, 0, 0), (0, 0, 0)))),
          False)


def test_kernel_escapes():
    check(encode_file(np.random.default_rng(4).integers(-2**22, 2**22, (256, 2)),
                      EncodeSpec(block_samples=256, bytes_stored=4)), False)


def test_kernel_corrupt_breaks():
    data = bytearray(encode_file(noise(512, 2, 2000, 5),
                                 EncodeSpec(block_samples=256, joint=True)))
    data[200] ^= 0xFF
    check(bytes(data), False)


def test_kernel_engine_integration():
    """The kernel through the whole engine (`decode_bytes`), against the
    oracle."""
    from wvpk.engine import decode_bytes
    from wvpk.ref import decode_block
    pcm = noise(600, 2, 2500, 6)
    data = encode_file(pcm, EncodeSpec(block_samples=300, joint=True))
    with backend._force("kernel"):
        blocks, dev = decode_bytes(data)
    for blk, d in zip(blocks, dev):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(d.samples, want.samples)
        assert not d.crc_error


def test_kernel_hybrid_balance():
    rng = np.random.default_rng(7)
    pcm = np.stack([np.round(rng.normal(0, 15000, 512)),
                    np.round(rng.normal(0, 60, 512))], axis=1).astype(np.int64)
    check(encode_file(pcm, EncodeSpec(
        block_samples=256, joint=False, hybrid=True, hybrid_bitrate=True,
        hybrid_balance=True, bitrate=300, bitrate_delta=1)), False)


def test_kernel_hybrid_balance_clamped():
    rng = np.random.default_rng(8)
    pcm = np.stack([np.round(rng.normal(0, 25000, 256)),
                    np.zeros(256)], axis=1).astype(np.int64)
    check(encode_file(pcm, EncodeSpec(
        block_samples=256, joint=True, hybrid=True, hybrid_bitrate=True,
        hybrid_balance=True, bitrate=70, bitrate_delta=2)), False)


# --------------------------------------------------------------------------
# decorrelation on random residuals and states (lanes.decorr_post with a
# neutral post stage: no joint stereo, no mute, every sample valid)
# --------------------------------------------------------------------------

def rand_state(rng, L, mono, max_terms=16, big=False):
    terms = np.zeros((L, 16), np.int32)
    deltas = np.zeros((L, 16), np.int32)
    num_terms = rng.integers(0, max_terms + 1, L).astype(np.int32)
    pool = MONO_TERMS if mono else ALL_TERMS
    for i in range(L):
        terms[i, :num_terms[i]] = rng.choice(pool, num_terms[i])
        deltas[i, :num_terms[i]] = rng.integers(0, 8, num_terms[i])
    scale = 2**28 if big else 2**10
    wa = rng.integers(-scale, scale, (L, 16)).astype(np.int32)
    wb = rng.integers(-scale, scale, (L, 16)).astype(np.int32)
    hscale = 2**30 if big else 2**15
    ha = rng.integers(-hscale, hscale, (L, 16, 8)).astype(np.int64)
    hb = rng.integers(-hscale, hscale, (L, 16, 8)).astype(np.int64)
    return terms, deltas, wa, wb, ha, hb, num_terms


def decorr_only(res, terms, deltas, wa, wb, ha, hb, nt, mono):
    T, L, _ = res.shape
    out, crc, mute = lanes.decorr_post(
        res, terms, deltas, wa, wb, ha, hb, nt, np.full(L, T, np.int32),
        np.zeros(L, bool), np.full(L, 1 << 40, np.int64),
        np.zeros(L, bool), mono=mono)
    assert not np.asarray(mute).any()
    return np.asarray(out)


def check_decorr(T, L, mono, seed, big=False, max_terms=16):
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    rscale = 2**29 if big else 2**14
    res = rng.integers(-rscale, rscale, (T, L, C)).astype(np.int32)
    st = rand_state(rng, L, mono, max_terms=max_terms, big=big)
    want = np.asarray(decorr_decode(res, *st, mono=mono))
    np.testing.assert_array_equal(want, decorr_only(res, *st, mono))


def test_stereo_all_terms():
    check_decorr(T=96, L=9, mono=False, seed=1)


def test_mono_all_terms():
    check_decorr(T=96, L=7, mono=True, seed=2)


def test_stereo_wraparound():
    # int32 overflow in predictor products and outputs must match C# wrap
    check_decorr(T=64, L=8, mono=False, seed=3, big=True)


def test_long_block_state_carry():
    check_decorr(T=1030, L=3, mono=False, seed=4)


def test_few_terms_bucket():
    check_decorr(T=80, L=6, mono=False, seed=5, max_terms=2)


def test_zero_terms_lane():
    rng = np.random.default_rng(6)
    res = rng.integers(-100, 100, (32, 2, 2)).astype(np.int32)
    z16 = np.zeros((2, 16), np.int32)
    z168 = np.zeros((2, 16, 8), np.int64)
    nt = np.zeros(2, np.int32)
    np.testing.assert_array_equal(
        res, decorr_only(res, z16, z16, z16, z16, z168, z168, nt, False))


@pytest.mark.parametrize("term", ALL_TERMS)
def test_single_term_stereo(term):
    rng = np.random.default_rng(100 + term)
    L, T = 4, 48
    res = rng.integers(-2**14, 2**14, (T, L, 2)).astype(np.int32)
    terms = np.full((L, 16), 0, np.int32)
    terms[:, 0] = term
    deltas = np.full((L, 16), 2, np.int32)
    wa = rng.integers(-1024, 1024, (L, 16)).astype(np.int32)
    wb = rng.integers(-1024, 1024, (L, 16)).astype(np.int32)
    ha = rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64)
    hb = rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64)
    nt = np.ones(L, np.int32)
    want = np.asarray(decorr_decode(res, terms, deltas, wa, wb, ha, hb, nt,
                                    mono=False))
    np.testing.assert_array_equal(
        want, decorr_only(res, terms, deltas, wa, wb, ha, hb, nt, False))


def check_chain(T, L, mono, seed, chain, big=False):
    """Every lane on one fixed chain (one encoder preset per corpus)."""
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    rscale = 2**29 if big else 2**14
    res = rng.integers(-rscale, rscale, (T, L, C)).astype(np.int32)
    n = len(chain)
    terms = np.zeros((L, 16), np.int32)
    terms[:, :n] = chain
    deltas = np.zeros((L, 16), np.int32)
    deltas[:, :n] = rng.integers(0, 8, (L, n))
    scale = 2**28 if big else 2**10
    wa = rng.integers(-scale, scale, (L, 16)).astype(np.int32)
    wb = rng.integers(-scale, scale, (L, 16)).astype(np.int32)
    hscale = 2**30 if big else 2**15
    ha = rng.integers(-hscale, hscale, (L, 16, 8)).astype(np.int64)
    hb = rng.integers(-hscale, hscale, (L, 16, 8)).astype(np.int64)
    nt = np.full(L, n, np.int32)
    want = np.asarray(decorr_decode(res, terms, deltas, wa, wb, ha, hb,
                                    nt, mono=mono))
    np.testing.assert_array_equal(
        want, decorr_only(res, terms, deltas, wa, wb, ha, hb, nt, mono))


@pytest.mark.parametrize("term", ALL_TERMS)
def test_chain_single_term_stereo(term):
    check_chain(T=48, L=4, mono=False, seed=200 + term, chain=[term])


def test_chain_headline():
    check_chain(T=96, L=5, mono=False, seed=300, chain=[18, 17, 2])


def test_chain_deep10():
    # the mc51 "high" preset shape: 10-term chain incl. a cross term
    check_chain(T=96, L=5, mono=False, seed=301,
                chain=[-1, 18, 18, 17, 17, 3, 2, 5, 1, 2])


def test_chain_mono():
    check_chain(T=96, L=4, mono=True, seed=302, chain=[17, 17, 2, 1])


def test_chain_wraparound():
    check_chain(T=64, L=4, mono=False, seed=303,
                chain=[18, -2, 17, 5], big=True)


def test_chain_long_block():
    check_chain(T=1030, L=3, mono=False, seed=304, chain=[18, 17, 2])


# --------------------------------------------------------------------------
# decorrelation + joint stereo / mute / CRC against joint_mute_crc
# --------------------------------------------------------------------------

def post_case(rng, T, terms, deltas, wa, wb, ha, hb, nt, mono,
              joint_frac=0.5, tight_mute=False, broke_frac=0.0,
              huge_limit=False):
    L = terms.shape[0]
    C = 1 if mono else 2
    res = rng.integers(-2**14, 2**14, (T, L, C)).astype(np.int32)
    nsamples = rng.integers(max(1, T // 2), T + 1, L).astype(np.int32)
    joint = (rng.random(L) < joint_frac) if not mono else np.zeros(L, bool)
    if huge_limit:
        ml = np.full(L, (1 << 32) + 2, np.int64)
    elif tight_mute:
        ml = rng.integers(4, 2000, L).astype(np.int64)
    else:
        ml = np.full(L, 1 << 24, np.int64)
    broke = rng.random(L) < broke_frac
    dec = decorr_decode(res, terms, deltas, wa, wb, ha, hb, nt, mono=mono)
    want = joint_mute_crc(dec, nsamples, joint, ml, broke, mono=mono)
    got = lanes.decorr_post(res, terms, deltas, wa, wb, ha, hb, nt,
                            nsamples, joint, ml, broke, mono=mono)
    assert_same(want, got)


def check_fold(T, L, mono, seed, chain=None, **kw):
    rng = np.random.default_rng(seed)
    if chain is None:
        st = rand_state(rng, L, mono)
    else:
        n = len(chain)
        terms = np.zeros((L, 16), np.int32)
        terms[:, :n] = chain
        deltas = np.zeros((L, 16), np.int32)
        deltas[:, :n] = 2
        st = (terms, deltas,
              rng.integers(-1024, 1024, (L, 16)).astype(np.int32),
              rng.integers(-1024, 1024, (L, 16)).astype(np.int32),
              rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64),
              rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64),
              np.full(L, n, np.int32))
    post_case(rng, T, *st, mono, **kw)


def test_fold_post_stereo_joint_mix():
    check_fold(T=96, L=8, mono=False, seed=400)


def test_fold_post_mute_fires():
    check_fold(T=96, L=8, mono=False, seed=401, tight_mute=True)


def test_fold_post_mono():
    check_fold(T=96, L=6, mono=True, seed=402, tight_mute=True)


def test_fold_post_broke_and_huge_limit():
    check_fold(T=64, L=6, mono=False, seed=403, broke_frac=0.5,
               huge_limit=True)


def test_fold_post_fixed_chain():
    check_fold(T=96, L=5, mono=False, seed=404, chain=[18, 17, 2],
               tight_mute=True)


def test_fold_post_long_block():
    check_fold(T=1030, L=3, mono=False, seed=405, tight_mute=True)


def mixed_chain_case(T, mono, seed, chains, counts, tail):
    """Lanes of several chains in one call, incl. ragged odd chains and a
    zero-term lane: each lane runs its own chain."""
    rng = np.random.default_rng(seed)
    rows, nts = [], []
    for chain, k in zip(chains, counts):
        row = np.zeros(16, np.int32)
        row[:len(chain)] = chain
        rows += [row] * k
        nts += [len(chain)] * k
    for chain in tail:
        row = np.zeros(16, np.int32)
        row[:len(chain)] = chain
        rows.append(row)
        nts.append(len(chain))
    terms = np.stack(rows)
    L = len(rows)
    st = (terms, np.where(terms != 0, 2, 0).astype(np.int32),
          rng.integers(-1024, 1024, (L, 16)).astype(np.int32),
          rng.integers(-1024, 1024, (L, 16)).astype(np.int32),
          rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64),
          rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64),
          np.asarray(nts, np.int32))
    post_case(rng, T, *st, mono, tight_mute=True, broke_frac=0.2)


def test_mixed_chains_match_golden():
    mixed_chain_case(96, False, 500,
                     [(18, 17, 2), (18, 18, 2, 17, 3),
                      (17, 17, 2, 18, 18, 4, 6, 2)], [7, 5, 6],
                     [(2,), (), (18, -1)])


def test_mixed_chains_mono():
    mixed_chain_case(96, True, 510, [(18, 17, 2), (17, 17, 2, 18, 18, 4)],
                     [6, 5], [(2,), ()])


def test_mixed_chains_long_block_no_tail():
    mixed_chain_case(1030, False, 511, [(18, 18, 2), (18, 17)], [4, 3], [])
