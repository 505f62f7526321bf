"""The device encode scans (ops/encode_kernels.py) against the host
encoder's bytes and the decoder.

A single-block file encoded on the device with fresh seeding
(warmup=0) must be byte-identical to the host encoder's; warm-seeded
inversions and the word coder's segments must decode back exactly.
"""

import zlib
from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp

from wvpk.encode import build_spec
from wvpk.engine.device_encoder import (_final_flush, encode_blocks_device,
                                        pack_segments)
from wvpk.ops import lanes
from wvpk.ops.decorr import decorr_decode
from wvpk.ops.encode_kernels import (decorr_invert_warm,
                                     entropy_encode_words,
                                     hybrid_encode_scan)
from wvpk.ops.entropy import entropy_decode
from wvpk.testgen.encoder import encode_blocks

CHAINS = [
    ((18, 17, 2), False),          # default preset, stereo
    ((18, 18, 2, 17, 3), False),
    ((1, 17, -2, 8), False),       # ring + cross-channel
    ((-1, 18, 2), False),
    ((-3, 5, 17), False),
    ((18, 17, 3, 2, 5, 7, 18, 1, 4, 6), False),   # 10-term deep chain
    ((18, 17, 2), True),           # mono
    ((2, 18, 1, 17, 8), True),
]


def _rand_pcm(rng, T, C, mag=1 << 14):
    s = mag * np.sin(2 * np.pi * np.arange(T) / 71.0)
    base = np.stack([s * (0.5 + 0.5 * c) for c in range(C)], 1)
    return np.round(base + rng.normal(0, mag / 30, (T, C))).astype(np.int32)


def _seed(*key):
    return zlib.crc32(repr(key).encode())


def _single_block_spec(pcm, chain, **options):
    spec = build_spec(pcm, block_samples=len(pcm), **options)
    return replace(spec, terms=tuple(chain), deltas=(2,) * len(chain))


@pytest.mark.parametrize("chain,mono", CHAINS)
@pytest.mark.parametrize("warm", [False, True])
def test_invert_differential(chain, mono, warm):
    """Fresh seeds: a one-block device encode is byte-identical to the
    host encoder's. Warm seeds: the inversion decodes back to the
    targets through both decode paths (XLA decorr and the lane kernel)."""
    rng = np.random.default_rng(_seed(chain, mono, warm))
    C = 1 if mono else 2
    if not warm:
        pcm = _rand_pcm(rng, 96, C, mag=1 << 12).astype(np.int64)
        spec = _single_block_spec(pcm, chain)
        assert b"".join(encode_blocks_device(pcm, spec, warmup=0)) \
            == b"".join(encode_blocks(pcm, spec))
        return
    T, L = 96, 5
    targ = np.stack([_rand_pcm(rng, T, C, mag=1 << (10 + i))
                     for i in range(L)], axis=1)          # (T, L, C)
    n = len(chain)
    terms = np.zeros((L, 16), np.int32)
    deltas = np.zeros((L, 16), np.int32)
    terms[:, :n] = chain
    deltas[:, :n] = 2
    nt = np.full(L, n, np.int32)
    w0a = rng.integers(-900, 900, (L, 16)).astype(np.int64)
    w0b = rng.integers(-900, 900, (L, 16)).astype(np.int64)
    h0a = rng.integers(-(1 << 14), 1 << 14, (L, 16, 8)).astype(np.int64)
    h0b = rng.integers(-(1 << 14), 1 << 14, (L, 16, 8)).astype(np.int64)
    res = np.asarray(decorr_invert_warm(targ, terms, deltas, nt, w0a, w0b,
                                        h0a, h0b, mono=mono))
    back = decorr_decode(res, terms, deltas, w0a, w0b, h0a, h0b, nt,
                         mono=mono)
    np.testing.assert_array_equal(np.asarray(back), targ)
    out, _, mute = lanes.decorr_post(
        res, terms, deltas, w0a, w0b, h0a, h0b, nt, np.full(L, T, np.int32),
        np.zeros(L, bool), np.full(L, 1 << 40, np.int64), np.zeros(L, bool),
        mono=mono)
    assert not np.asarray(mute).any()
    np.testing.assert_array_equal(np.asarray(out), targ)


def _words_case(rng, W, L, kind):
    """Residual words exercising the automaton's arms."""
    if kind == "normal":
        r = rng.normal(0, 600, (W, L))
    elif kind == "runs":
        r = rng.normal(0, 3, (W, L)).round()
        r[rng.random((W, L)) < 0.7] = 0
        r[: W // 4] = 0                       # leading run
    elif kind == "escapes":
        r = rng.normal(0, 50, (W, L))
        big = rng.random((W, L)) < 0.05
        r = np.where(big, rng.integers(1 << 20, 1 << 26, (W, L)), r)
    elif kind == "huge":
        r = rng.integers(-(1 << 26), 1 << 26, (W, L))
    return np.asarray(r, np.int64).astype(np.int32)


@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("kind", ["normal", "runs", "escapes", "huge"])
def test_entropy_words_differential(mono, kind):
    """The word coder's segments, packed into payloads the way the
    device encoder packs them, decode back to the residual words."""
    from wvpk.ops.bitio import pack_streams

    rng = np.random.default_rng(_seed(mono, kind))
    W, L = 160, 4
    C = 1 if mono else 2
    res = _words_case(rng, W, L, kind)
    med0 = np.zeros((L, 2, 3), np.int64)
    for i in range(L):
        for c in range(C):
            base = [0, 3, 9, 1 << 18][i % 4]
            med0[i, c] = sorted(rng.integers(base, base * 4 + 4, 3))
    nvals = np.asarray([W, W - 2, W // 2, 4], np.int32)[:L]

    segs = entropy_encode_words(jnp.asarray(res), jnp.asarray(med0),
                                jnp.asarray(nvals), mono=mono)
    segs = [np.asarray(s) for s in segs]
    payloads = pack_segments(*segs[:5], _final_flush(*segs[5:9]))
    words, _ = pack_streams(payloads)
    z = np.zeros((L, 2), np.int64)
    dec, broke, ndec = entropy_decode(
        words, nvals, med0, z, z, z, mono=mono, hybrid=False,
        hybrid_bitrate=False, hybrid_balance=False, nsteps=W)
    dec = np.asarray(dec).reshape(W // C, L, C).transpose(0, 2, 1) \
        .reshape(W, L)
    assert not np.asarray(broke).any(), kind
    for lane in range(L):
        n = int(nvals[lane])
        np.testing.assert_array_equal(dec[:n, lane], res[:n, lane],
                                      err_msg=f"{kind} lane {lane}")


@pytest.mark.parametrize("chain,mono", [
    ((18, 17, 2), False),
    ((18, 18, 2, 17, 3), False),
    ((1, 17, -2, 8), False),
    ((18, 17, 2), True),
])
@pytest.mark.parametrize("bitrate,balance", [(False, False),
                                             (True, False), (True, True)])
def test_hybrid_scan_differential(chain, mono, bitrate, balance):
    """A one-block hybrid device encode (the fused lossy scan) is
    byte-identical to the host encoder's, for every bitrate mode."""
    if mono and balance:
        pytest.skip("balance is stereo-only")
    rng = np.random.default_rng(_seed(chain, mono, bitrate, balance))
    C = 1 if mono else 2
    pcm = _rand_pcm(rng, 80, C, mag=1 << 13).astype(np.int64)
    pcm[:12] = 0                             # run-gate gamma(0) arm
    spec = replace(_single_block_spec(pcm, chain, hybrid=True, bitrate=384),
                   hybrid_bitrate=bitrate, hybrid_balance=balance)
    assert b"".join(encode_blocks_device(pcm, spec, warmup=0)) \
        == b"".join(encode_blocks(pcm, spec))


def test_device_encode_hybrid_bytes_identical():
    """Hybrid device encode of one 660-sample block equals the host
    encoder byte for byte."""
    rng = np.random.default_rng(31)
    t = np.arange(660)
    s = 6000 * np.sin(2 * np.pi * t / 47.0)
    pcm = np.round(np.stack([s, s * 0.7], 1)
                   + rng.normal(0, 250, (t.size, 2))).astype(np.int64)
    spec = build_spec(pcm, block_samples=660, hybrid=True, bitrate=384)
    assert b"".join(encode_blocks_device(pcm, spec, warmup=0)) \
        == b"".join(encode_blocks(pcm, spec))


def test_hybrid_scan_reconstruction_decodes():
    """The fused hybrid scan's reconstruction is what the decoder
    reproduces: a multi-block hybrid device encode decodes (oracle) to
    that lossy signal with every CRC passing."""
    from wvpk.container import parse_blocks
    from wvpk.ref import decode_block

    rng = np.random.default_rng(32)
    t = np.arange(4 * 200)
    s = 9000 * np.sin(2 * np.pi * t / 39.0)
    pcm = np.round(np.stack([s, s * 0.5], 1)
                   + rng.normal(0, 300, (t.size, 2))).astype(np.int64)
    spec = build_spec(pcm, block_samples=200, hybrid=True, bitrate=320)
    blocks = parse_blocks(b"".join(encode_blocks_device(pcm, spec)))
    outs = [decode_block(b.state) for b in blocks]
    assert not any(r.crc_error or r.mute_error for r in outs)
    lossy = np.concatenate([r.samples for r in outs])
    assert lossy.shape == pcm.shape
    assert np.abs(lossy - pcm).max() < 2000


def test_device_encode_bytes_identical():
    """Lossless device encode of one block with a zero run equals the
    host encoder byte for byte."""
    rng = np.random.default_rng(21)
    t = np.arange(720)
    s = 5000 * np.sin(2 * np.pi * t / 53.0)
    pcm = np.round(np.stack([s, s * 0.6], 1)
                   + rng.normal(0, 120, (t.size, 2))).astype(np.int64)
    pcm[300:420] = 0                         # zero-run arm
    spec = build_spec(pcm, block_samples=720)
    assert b"".join(encode_blocks_device(pcm, spec, warmup=0)) \
        == b"".join(encode_blocks(pcm, spec))


def test_sharded_encode_bytes_identical():
    """The encode scans compose with the mesh shard_map path: sharded ==
    unsharded, byte for byte."""
    from wvpk.parallel import make_mesh

    rng = np.random.default_rng(9)
    t = np.arange(5 * 128)                  # 5 % 8 != 0: padded lanes
    s = 3000 * np.sin(2 * np.pi * t / 41.0)
    pcm = np.round(np.stack([s, s * 0.8], 1)
                   + rng.normal(0, 60, (t.size, 2))).astype(np.int64)
    spec = build_spec(pcm, block_samples=128)
    assert encode_blocks_device(pcm, spec, mesh=make_mesh(8)) \
        == encode_blocks_device(pcm, spec)


def test_hybrid_scan_direct_outputs():
    """hybrid_encode_scan's reconstruction equals the decode of the
    residuals it coded: the pending state is empty for every finished
    lane and recon has the targets' shape."""
    rng = np.random.default_rng(33)
    T, L, C = 80, 3, 2
    targ = np.stack([_rand_pcm(rng, T, C, mag=1 << (9 + 2 * i))
                     for i in range(L)], axis=1)
    terms = np.zeros((L, 16), np.int32)
    terms[:, :3] = (18, 17, 2)
    deltas = np.where(terms != 0, 2, 0).astype(np.int32)
    nt = np.full(L, 3, np.int32)
    med0 = np.zeros((L, 2, 3), np.int64)
    med0[:, :, :] = (100, 50, 20)
    slow0 = np.zeros((L, 2), np.int64)
    acc0 = np.full((L, 2), 20 << 16, np.int64)
    delta0 = np.ones((L, 2), np.int64)
    nvals = np.full(L, T * C, np.int32)
    z16 = np.zeros((L, 16), np.int64)
    z168 = np.zeros((L, 16, 8), np.int64)
    out = hybrid_encode_scan(targ, terms, deltas, nt, med0, slow0, acc0,
                             delta0, nvals, z16, z16, z168, z168, mono=False,
                             hybrid_bitrate=False, hybrid_balance=False)
    assert len(out) == 10
    recon = np.asarray(out[9])
    assert recon.shape == targ.shape
    assert np.abs(recon.astype(np.int64) - targ).max() < (1 << 14)
