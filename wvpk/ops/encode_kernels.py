"""Device-side lossless ENCODE kernels (XLA scans).

The reference has no encoder at all; this goes beyond parity with a
lane-parallel encode path built on the same two hot loops as decode,
run in reverse:

- `decorr_invert`: peel the decorrelation passes off the target samples
  (the exact inverse of `ops/decorr.py::decorr_decode`; per-term
  semantics mirror UnpackUtils.cs:688-1240). For lossless streams the
  reconstructed values equal the targets, so the carried pass state
  evolves identically to decode-of-the-residuals — one forward scan
  computes residuals AND advances state.
- `entropy_encode_words`: the word state machine of the reference
  decoder's get_words (WordsUtils.cs:272-511) run in reverse — the same
  automaton as the host encoders (testgen/encoder.py::EntropyEncoder,
  native/csrc/wvpk_encode.c), producing per-word variable-length bit
  segments that a host-side scatter packs into the block payload.

Parallel structure: blocks are lanes (the device encoder seeds every
block fresh — zero weights/history, block-local medians — so blocks are
independent, mirroring how decode's blocks are self-seeded). Zero-run
lengths need no lookahead simulation: for lossless, residuals are
independent of entropy decisions, so run lengths are a vectorized
suffix run-length over the residual array.

Hybrid (lossy) feeds the reconstruction back into the decorr state,
which couples the two scans — `hybrid_encode_scan` fuses peel,
error-limit word coding, and apply into ONE scan per sample instead.
Hybrid blocks never start zero-run escapes (each run gate emits
gamma(0)); see _hyb_word.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import consts
from .bitio import mylog2_v, wrap32
from .decorr import _pred, _upd, _upd_clamp
from .entropy import _slow_decay, _update_error_limit

I64 = jnp.int64
U64 = jnp.uint64


def decorr_invert(targets, terms, deltas, num_terms, *, mono: bool):
    """Peel all passes off joint-domain targets -> entropy residuals.

    targets: (T, L, C) int32 scan-major; C = 1 (mono) or 2.
    terms/deltas: (L, 16) int32; num_terms: (L,) int32.
    State seeds fresh (zero weights, zero history, m=0) — the device
    encoder's per-block contract. Returns (T, L, C) int32 residuals.
    """
    L = targets.shape[1]
    z16 = jnp.zeros((L, 16), jnp.int64)
    z168 = jnp.zeros((L, 16, 8), jnp.int64)
    return _decorr_invert(targets, terms, deltas, num_terms,
                          z16, z16, z168, z168, mono=mono,
                          with_state=False)


def decorr_invert_warm(targets, terms, deltas, num_terms,
                       w0a, w0b, h0a, h0b, *, mono: bool,
                       with_state: bool = False):
    """decorr_invert with explicit initial weights (L, 16) and history
    rings (L, 16, 8) — the decoder-derived (quantized) warm state. With
    with_state=True also returns the final (wa, wb, sa, sb) in the same
    layouts (ring positions relative to m = T mod 8; rotate like
    _rotate_ring before storing)."""
    return _decorr_invert(targets, terms, deltas, num_terms,
                          w0a, w0b, h0a, h0b, mono=mono,
                          with_state=with_state)


def _mk_cst(terms, deltas, num_terms):
    """Per-pass constants shared by the decorr peel/apply helpers."""
    terms_t = terms.astype(I64).T                      # (16, L)
    deltas_t = deltas.astype(I64).T
    return dict(
        term=terms_t,
        delta=deltas_t,
        is17=terms_t == 17,
        is18=terms_t == 18,
        n1=terms_t == -1,
        n2=terms_t == -2,
        n3=terms_t == -3,
        pos=(terms_t >= 1) & (terms_t <= consts.MAX_TERM),
        act=(jnp.arange(16, dtype=jnp.int32)[:, None]
             < num_terms[None, :]),                    # (16, L)
        iota8=jnp.arange(8, dtype=jnp.int32),
    )


def _sam_pair(cst, ring_a, ring_b, m_slot, j):
    """Predictor inputs at pass j from history state (terms 17/18,
    ring, -3; -1/-2 handled by the caller from peel values)."""
    s17a = wrap32(2 * ring_a[:, 0] - ring_a[:, 1])
    s18a = wrap32(3 * ring_a[:, 0] - ring_a[:, 1]) >> 1
    sra = jax.lax.dynamic_index_in_dim(ring_a, m_slot, axis=1,
                                       keepdims=False)
    sa = jnp.where(cst["is17"][j], s17a,
                   jnp.where(cst["is18"][j], s18a,
                             jnp.where(cst["pos"][j], sra,
                                       ring_a[:, 0])))
    s17b = wrap32(2 * ring_b[:, 0] - ring_b[:, 1])
    s18b = wrap32(3 * ring_b[:, 0] - ring_b[:, 1]) >> 1
    srb = jax.lax.dynamic_index_in_dim(ring_b, m_slot, axis=1,
                                       keepdims=False)
    sb = jnp.where(cst["is17"][j], s17b,
                   jnp.where(cst["is18"][j], s18b,
                             jnp.where(cst["pos"][j], srb,
                                       ring_b[:, 0])))
    return sa, sb


def _peel_stereo(cst, wa, wb, sa_r, sb_r, m_slot, xa, xb):
    """Reverse peel (encoder.py::invert_stereo): pass j reads the values
    peeled of passes above it; -1 uses the CURRENT va, -2 the current vb
    (equal to that pass's reconstruct outputs)."""
    def peel(vals, j):
        va, vb = vals
        jj = 15 - j
        sa_, sb_ = _sam_pair(cst, sa_r[jj], sb_r[jj], m_slot, jj)
        sa_eff = jnp.where(cst["n2"][jj], vb, sa_)
        sb_eff = jnp.where(cst["n1"][jj], va, sb_)
        va2 = wrap32(va - _pred(wa[jj], sa_eff))
        vb2 = wrap32(vb - _pred(wb[jj], sb_eff))
        act = cst["act"][jj]
        return (jnp.where(act, va2, va), jnp.where(act, vb2, vb)), None

    (ra, rb), _ = jax.lax.scan(peel, (xa, xb),
                               jnp.arange(16, dtype=jnp.int32))
    return ra, rb


def _apply_stereo(cst, wa, wb, sa_r, sb_r, m_slot, ra, rb):
    """Forward update (decode semantics over the residual; mirrors
    decorr.py::one_pass_stereo). Returns the new per-pass state plus the
    final chained outputs (oa, ob) — the reconstruction."""
    iota8 = cst["iota8"]

    def apply(vals, xs2):
        va, vb = vals
        waj, wbj, ring_a, ring_b, j = xs2
        sa_, sb_ = _sam_pair(cst, ring_a, ring_b, m_slot, j)
        oa1 = wrap32(_pred(waj, sa_) + va)
        sb_eff = jnp.where(cst["n1"][j], oa1, sb_)
        ob1 = wrap32(_pred(wbj, sb_eff) + vb)
        ob2 = wrap32(_pred(wbj, ring_b[:, 0]) + vb)
        oa2 = wrap32(_pred(waj, ob2) + va)
        n2 = cst["n2"][j]
        oa = jnp.where(n2, oa2, oa1)
        ob = jnp.where(n2, ob2, ob1)
        sa_eff = jnp.where(n2, ob2, sa_)
        neg = cst["n1"][j] | n2 | cst["n3"][j]
        dj = cst["delta"][j]
        wa_u = jnp.where(neg, _upd_clamp(waj, dj, sa_eff, va),
                         _upd(waj, dj, sa_eff, va))
        wb_u = jnp.where(neg, _upd_clamp(wbj, dj, sb_eff, vb),
                         _upd(wbj, dj, sb_eff, vb))
        onehot = iota8[None, :] == ((m_slot + cst["term"][j]) & 7)[:, None]
        sa_pos = jnp.where(onehot, oa[:, None], ring_a)
        sb_pos = jnp.where(onehot, ob[:, None], ring_b)
        sa_1718 = jnp.concatenate(
            [oa[:, None], ring_a[:, 0:1], ring_a[:, 2:]], axis=1)
        sb_1718 = jnp.concatenate(
            [ob[:, None], ring_b[:, 0:1], ring_b[:, 2:]], axis=1)
        sa0n = jnp.where(cst["n1"][j] | cst["n3"][j], ob, ring_a[:, 0])
        sb0n = jnp.where(n2 | cst["n3"][j], oa, ring_b[:, 0])
        sa_neg = jnp.concatenate([sa0n[:, None], ring_a[:, 1:]], axis=1)
        sb_neg = jnp.concatenate([sb0n[:, None], ring_b[:, 1:]], axis=1)
        t1718 = (cst["is17"][j] | cst["is18"][j])[:, None]
        sa_new = jnp.where(cst["pos"][j][:, None], sa_pos,
                           jnp.where(t1718, sa_1718,
                                     jnp.where(neg[:, None], sa_neg,
                                               ring_a)))
        sb_new = jnp.where(cst["pos"][j][:, None], sb_pos,
                           jnp.where(t1718, sb_1718,
                                     jnp.where(neg[:, None], sb_neg,
                                               ring_b)))
        act, am = cst["act"][j], cst["act"][j][:, None]
        va = jnp.where(act, oa, va)
        vb = jnp.where(act, ob, vb)
        return ((va, vb),
                (jnp.where(act, wa_u, waj), jnp.where(act, wb_u, wbj),
                 jnp.where(am, sa_new, ring_a),
                 jnp.where(am, sb_new, ring_b)))

    (oa, ob), (wa, wb, sa_r, sb_r) = jax.lax.scan(
        apply, (ra, rb),
        (wa, wb, sa_r, sb_r, jnp.arange(16, dtype=jnp.int32)))
    return wa, wb, sa_r, sb_r, oa, ob


def _peel_mono(cst, wa, sa_r, m_slot, xa):
    def peel(va, j):
        jj = 15 - j
        sa_, _ = _sam_pair(cst, sa_r[jj], sa_r[jj], m_slot, jj)
        va2 = wrap32(va - _pred(wa[jj], sa_))
        return jnp.where(cst["act"][jj], va2, va), None

    ra, _ = jax.lax.scan(peel, xa, jnp.arange(16, dtype=jnp.int32))
    return ra


def _apply_mono(cst, wa, sa_r, m_slot, ra):
    iota8 = cst["iota8"]

    def apply(va, xs2):
        waj, ring_a, j = xs2
        sa_, _ = _sam_pair(cst, ring_a, ring_a, m_slot, j)
        oa = wrap32(_pred(waj, sa_) + va)
        wa_u = _upd(waj, cst["delta"][j], sa_, va)
        onehot = iota8[None, :] == ((m_slot + cst["term"][j]) & 7)[:, None]
        sa_pos = jnp.where(onehot, oa[:, None], ring_a)
        sa_1718 = jnp.concatenate(
            [oa[:, None], ring_a[:, 0:1], ring_a[:, 2:]], axis=1)
        t1718 = (cst["is17"][j] | cst["is18"][j])[:, None]
        sa_new = jnp.where(cst["pos"][j][:, None], sa_pos,
                           jnp.where(t1718, sa_1718, ring_a))
        act = cst["act"][j]
        va = jnp.where(act, oa, va)
        return va, (jnp.where(act, wa_u, waj),
                    jnp.where(act[:, None], sa_new, ring_a))

    oa, (wa, sa_r) = jax.lax.scan(
        apply, ra, (wa, sa_r, jnp.arange(16, dtype=jnp.int32)))
    return wa, sa_r, oa


@partial(jax.jit, static_argnames=("mono", "with_state"))
def _decorr_invert(targets, terms, deltas, num_terms, w0a, w0b, h0a, h0b,
                   *, mono: bool, with_state: bool):
    T, L, C = targets.shape
    cst = _mk_cst(terms, deltas, num_terms)

    def step_stereo(carry, xs):
        step_idx, targ = xs
        m_slot = step_idx & 7
        wa, wb, sa_r, sb_r = carry
        xa = targ[:, 0].astype(I64)
        xb = targ[:, 1].astype(I64)
        ra, rb = _peel_stereo(cst, wa, wb, sa_r, sb_r, m_slot, xa, xb)
        wa, wb, sa_r, sb_r, _, _ = _apply_stereo(
            cst, wa, wb, sa_r, sb_r, m_slot, ra, rb)
        return ((wa, wb, sa_r, sb_r),
                jnp.stack([ra, rb], axis=1).astype(jnp.int32))

    def step_mono(carry, xs):
        step_idx, targ = xs
        m_slot = step_idx & 7
        wa, sa_r = carry
        xa = targ[:, 0].astype(I64)
        ra = _peel_mono(cst, wa, sa_r, m_slot, xa)
        wa, sa_r, _ = _apply_mono(cst, wa, sa_r, m_slot, ra)
        return (wa, sa_r), ra[:, None].astype(jnp.int32)

    wa0 = w0a.astype(I64).T
    ha0 = h0a.astype(I64).transpose(1, 0, 2)
    xs = (jnp.arange(T, dtype=jnp.int32), targets)
    if mono:
        fin, res = jax.lax.scan(step_mono, (wa0, ha0), xs)
        state = (fin[0].T, fin[0].T, fin[1].transpose(1, 0, 2),
                 fin[1].transpose(1, 0, 2))
    else:
        wb0 = w0b.astype(I64).T
        hb0 = h0b.astype(I64).transpose(1, 0, 2)
        fin, res = jax.lax.scan(step_stereo, (wa0, wb0, ha0, hb0), xs)
        state = (fin[0].T, fin[1].T, fin[2].transpose(1, 0, 2),
                 fin[3].transpose(1, 0, 2))
    return (res, state) if with_state else res


# ---------------------------------------------------------------------------
# entropy encode (lossless get_words in reverse, WordsUtils.cs:272-511)
# ---------------------------------------------------------------------------

_U64_1 = np.uint64(1)


def _safe_shl(x, s):
    """x << s, yielding 0 outside 0 <= s < 64 — XLA shifts >= width are
    undefined and negative amounts must contribute nothing."""
    return jnp.where((s >= 64) | (s < 0), U64(0),
                     x << jnp.clip(s, 0, 63).astype(U64))


def _safe_shr(x, s):
    return jnp.where((s >= 64) | (s < 0), U64(0),
                     x >> jnp.clip(s, 0, 63).astype(U64))


def _seg_append(lo, hi, ln, bits, nb):
    """Append nb bits (LSB-first, in a u64) to a 128-bit (lo, hi, ln)
    segment. nb == 0 is a no-op; caller guarantees ln + nb <= 128."""
    bits = jnp.where(nb > 0, bits, U64(0))
    lo2 = lo | _safe_shl(bits, ln)
    hi2 = hi | _safe_shr(bits, 64 - ln) | _safe_shl(bits, ln - 64)
    return lo2, hi2, ln + nb


def _bitlen(v):
    """bit_length of a non-negative int64 (== count_bits)."""
    return (64 - jax.lax.clz(v.astype(jnp.int64))).astype(jnp.int32) \
        * (v > 0).astype(jnp.int32)


def _ones(n):
    """(1 << n) - 1 as u64 for n <= 63."""
    return _safe_shl(U64(1), n) - _U64_1


def _gamma_slots(v):
    """The WavPack Elias-style escape code of v (WordsUtils.cs:321-335)
    as two append slots: (bits1, len1, bits2, len2). v < 2 -> unary only;
    else unary(c) then the low c-1 bits (top bit implicit)."""
    v64 = v.astype(jnp.int64)
    c = _bitlen(v64)
    small = v64 < 2
    b1 = jnp.where(small, _ones(v.astype(jnp.int32)),
                   _ones(c))                      # ones then terminator 0
    l1 = jnp.where(small, v.astype(jnp.int32) + 1, c + 1)
    b2 = jnp.where(small, U64(0),
                   v64.astype(U64) & _ones(jnp.maximum(c - 1, 0)))
    l2 = jnp.where(small, 0, c - 1)
    return b1, l1, b2, l2


@partial(jax.jit, static_argnames=("mono",))
def entropy_encode_words(res_words, med0, nvals, *, mono: bool):
    """Encode residual words -> variable-length bit segments.

    res_words: (W, L) int32, channel-interleaved per sample (stereo) in
    word order; padded arbitrarily beyond nvals.
    med0: (L, 2, 3) int64 initial medians (ALREADY log16-quantized so
    they match what the block metadata stores; mono leaves channel 1 at
    zero like the decoder does). Non-negative (the encoder's operating
    contract; wrapped-median content must use the host encoders).
    nvals: (L,) int32 valid word count per lane.

    Returns (segA_lo, segA_hi, segA_len, segB_bits, segB_len) each
    (W, L) — per step, segment A (flushed previous word's unary+payload,
    OR a zero-run gamma) precedes segment B (h0-consumed immediate
    payload) — plus the final pending word (pend_valid, pend_oc_eff,
    pend_bits, pend_nbits), each (L,), which the caller flushes with
    b = 0 (EntropyEncoder.finish()).
    """
    W, L = res_words.shape
    med0 = jnp.transpose(med0.astype(I64), (1, 2, 0))      # (2, 3, L)

    # suffix zero-run lengths over VALID words (no lookahead simulation
    # needed: lossless residuals are entropy-independent)
    iota_w = jnp.arange(W, dtype=jnp.int32)[:, None]
    iszero = (res_words == 0) & (iota_w < nvals[None, :])

    def zrl(carry, z):
        run = jnp.where(z, carry + 1, 0)
        return run, run

    _, zlen = jax.lax.scan(zrl, jnp.zeros(L, jnp.int64), iszero,
                           reverse=True)

    def step(carry, xs):
        med, zacc, clear, pvalid, poc, pbits, pnb = carry
        w_idx, r32, z = xs
        valid = w_idx < nvals
        r = r32.astype(I64)
        ch = 0 if mono else (w_idx & 1)
        medc = med[ch]                                    # (3, L)

        tiny = ((med[0, 0] & ~I64(1)) == 0) & ((med[1, 0] & ~I64(1)) == 0)
        gate = clear & tiny & valid

        z1 = gate & (zacc > 0)
        zacc1 = jnp.where(z1, zacc - 1, zacc)
        midrun = z1 & (zacc1 > 0)
        z2 = gate & (zacc == 0)
        start = z2 & (z > 0)
        zacc2 = jnp.where(start, z, zacc1)
        normal = valid & ~midrun & ~start

        # --- ones_count from pre-update medians ---
        sign = r < 0
        av = jnp.where(sign, ~r, r)
        g0 = (medc[0] >> 4) + 1
        g1 = (medc[1] >> 4) + 1
        g2 = jnp.maximum((medc[2] >> 4) + 1, 1)
        oc = jnp.where(av < g0, I64(0),
                       jnp.where(av < g0 + g1, I64(1),
                                 2 + (av - g0 - g1) // g2))

        # --- holding resolution ---
        fromclear = normal & clear
        h0 = normal & ~clear & (oc == 0)
        h1 = normal & ~clear & (oc != 0)
        do_flush = (h0 | h1) & pvalid
        flush_raw = 2 * poc + jnp.where(h1, 1, 0).astype(I64)

        # --- segment A: flush (unary or escape+gamma, then pended
        # payload) XOR run gamma(z) — mutually exclusive by clear ---
        lo = jnp.zeros(L, U64)
        hi = jnp.zeros(L, U64)
        ln = jnp.zeros(L, jnp.int32)
        esc = flush_raw >= consts.LIMIT_ONES
        g = jnp.maximum(flush_raw - consts.LIMIT_ONES, 0)
        gb1, gl1, gb2, gl2 = _gamma_slots(g)
        zb1, zl1, zb2, zl2 = _gamma_slots(jnp.where(z2, z, 0))
        raw32 = flush_raw.astype(jnp.int32)
        # slot 1: plain unary | escape prefix | run-gamma unary part
        s1b = jnp.where(do_flush,
                        jnp.where(esc, _ones(jnp.full(L, consts.LIMIT_ONES,
                                                      jnp.int32)),
                                  _ones(raw32)),
                        zb1)
        s1l = jnp.where(do_flush,
                        jnp.where(esc, consts.LIMIT_ONES + 1, raw32 + 1),
                        jnp.where(z2, zl1, 0))
        lo, hi, ln = _seg_append(lo, hi, ln, s1b, s1l)
        # slots 2+3: escape gamma | run-gamma value part
        s2b = jnp.where(do_flush, jnp.where(esc, gb1, U64(0)), zb2)
        s2l = jnp.where(do_flush, jnp.where(esc, gl1, 0),
                        jnp.where(z2, zl2, 0))
        lo, hi, ln = _seg_append(lo, hi, ln, s2b, s2l)
        s3b = jnp.where(do_flush & esc, gb2, U64(0))
        s3l = jnp.where(do_flush & esc, gl2, 0)
        lo, hi, ln = _seg_append(lo, hi, ln, s3b, s3l)
        # slot 4: the flushed word's pended payload bits
        lo, hi, ln = _seg_append(lo, hi, ln,
                                 jnp.where(do_flush, pbits, U64(0)),
                                 jnp.where(do_flush, pnb, 0))

        # --- median interval + 5/7-2/7 adaptation (normal lanes) ---
        m0, m1, m2 = medc[0], medc[1], medc[2]
        m0n = jnp.where(oc == 0, wrap32(m0 - ((m0 + (consts.DIV0 - 2)) >> 7) * 2),
                        wrap32(m0 + ((m0 + consts.DIV0) >> 7) * 5))
        m1n = jnp.where(oc <= 0, m1,
                        jnp.where(oc == 1,
                                  wrap32(m1 - ((m1 + (consts.DIV1 - 2)) >> 6) * 2),
                                  wrap32(m1 + ((m1 + consts.DIV1) >> 6) * 5)))
        m2n = jnp.where(oc <= 1, m2,
                        jnp.where(oc == 2,
                                  wrap32(m2 - ((m2 + (consts.DIV2 - 2)) >> 5) * 2),
                                  wrap32(m2 + ((m2 + consts.DIV2) >> 5) * 5)))
        low = jnp.where(oc == 0, I64(0),
                        g0 + jnp.where(oc == 1, I64(0),
                                       g1 + (oc - 2) * g2))
        high = low + jnp.where(oc == 0, g0,
                               jnp.where(oc == 1, g1, g2)) - 1

        # --- value payload: read_code inverse + sign ---
        code = av - low
        maxcode = high - low
        bitcount = _bitlen(maxcode)
        extras = _safe_shl(U64(1), bitcount).astype(I64) - maxcode - 1
        small = code < extras
        cc = code + extras
        vb = jnp.where(small, code.astype(U64),
                       (cc >> 1).astype(U64)
                       | _safe_shl((cc & 1).astype(U64),
                                   jnp.maximum(bitcount - 1, 0)))
        vl = jnp.where(bitcount == 0, 0,
                       jnp.where(small, bitcount - 1, bitcount))
        wbits = vb | _safe_shl(sign.astype(U64), vl)
        wnb = vl + 1

        # --- segment B: h0-consumed immediate payload ---
        segB_bits = jnp.where(h0, wbits, U64(0))
        segB_len = jnp.where(h0, wnb, 0)

        # --- state updates ---
        med_norm = jnp.stack([m0n, m1n, m2n])             # (3, L)
        medc_new = jnp.where(normal, med_norm, medc)
        med = med.at[ch].set(medc_new)  # ch traced for stereo: dynamic slice
        med = jnp.where(start[None, None, :], I64(0), med)

        emit_unary = fromclear | h1
        pvalid = jnp.where(emit_unary, True,
                           jnp.where(do_flush, False, pvalid))
        poc = jnp.where(emit_unary, oc - jnp.where(h1, 1, 0), poc)
        pbits = jnp.where(emit_unary, wbits, pbits)
        pnb = jnp.where(emit_unary, wnb, pnb)
        clear = jnp.where(h0, True,
                          jnp.where(emit_unary, False, clear))
        return ((med, zacc2, clear, pvalid, poc, pbits, pnb),
                (lo, hi, ln, segB_bits, segB_len))

    carry0 = (med0, jnp.zeros(L, I64), jnp.ones(L, bool),
              jnp.zeros(L, bool), jnp.zeros(L, I64), jnp.zeros(L, U64),
              jnp.zeros(L, jnp.int32))
    xs = (jnp.arange(W, dtype=jnp.int32), res_words, zlen)
    (med, zacc, clear, pvalid, poc, pbits, pnb), segs = jax.lax.scan(
        step, carry0, xs)
    return segs + (pvalid, poc, pbits, pnb)


# ---------------------------------------------------------------------------
# hybrid (lossy) fused encode: decorr peel -> error-limit word coding ->
# reconstruction-feedback apply, one scan over samples
# ---------------------------------------------------------------------------

def _hyb_word(ent, r, valid, entidx, delta, *, mono: bool,
              hybrid_bitrate: bool, hybrid_balance: bool):
    """Encode one residual word at static channel `entidx` with the
    hybrid error-limit semantics (reference encode direction of
    WordsUtils.cs:272-511 + 195-261). Returns the updated entropy
    state, the word's (segA_lo, segA_hi, segA_len, segB_bits,
    segB_len), and the reconstructed residual (what the decoder's
    get_words returns for these bits).

    Zero-run policy: whenever the decoder would attempt a run read
    (medians tiny + clear), emit gamma(0) — one '0' bit — and code the
    word normally. Always a valid bitstream; costs ~2 bits/word vs the
    host encoder's run escapes in digital silence (documented
    device-encoder tradeoff, like fresh seeding)."""
    (med_a, med_b, slow_a, slow_b, acc, errlim,
     clear, pvalid, poc, pbits, pnb) = ent
    L = r.shape[0]
    med_c = med_a if entidx == 0 else med_b
    slow_c = slow_a if entidx == 0 else slow_b

    tiny = ((med_a[:, 0] & ~I64(1)) == 0) & ((med_b[:, 0] & ~I64(1)) == 0)
    gate = clear & tiny & valid

    # segment A opens with the 1-bit gamma(0) where the run gate fires
    # (mutually exclusive with any flush: gate requires clear, flush
    # requires ~clear)
    lo = jnp.zeros(L, U64)
    hi = jnp.zeros(L, U64)
    ln = gate.astype(jnp.int32)

    sign = r < 0
    av = jnp.where(sign, ~r, r)
    g0 = (med_c[:, 0] >> 4) + 1
    g1 = (med_c[:, 1] >> 4) + 1
    g2 = jnp.maximum((med_c[:, 2] >> 4) + 1, 1)
    oc = jnp.where(av < g0, I64(0),
                   jnp.where(av < g0 + g1, I64(1),
                             2 + (av - g0 - g1) // g2))

    # holding resolution (same machinery as the lossless kernel)
    fromclear = valid & clear
    h0 = valid & ~clear & (oc == 0)
    h1 = valid & ~clear & (oc != 0)
    do_flush = (h0 | h1) & pvalid
    flush_raw = 2 * poc + jnp.where(h1, 1, 0).astype(I64)

    esc = flush_raw >= consts.LIMIT_ONES
    g = jnp.maximum(flush_raw - consts.LIMIT_ONES, 0)
    gb1, gl1, gb2, gl2 = _gamma_slots(g)
    raw32 = flush_raw.astype(jnp.int32)
    s1b = jnp.where(do_flush,
                    jnp.where(esc, _ones(jnp.full(L, consts.LIMIT_ONES,
                                                  jnp.int32)),
                              _ones(raw32)),
                    U64(0))
    s1l = jnp.where(do_flush,
                    jnp.where(esc, consts.LIMIT_ONES + 1, raw32 + 1), 0)
    lo, hi, ln = _seg_append(lo, hi, ln, s1b, s1l)
    lo, hi, ln = _seg_append(lo, hi, ln,
                             jnp.where(do_flush & esc, gb1, U64(0)),
                             jnp.where(do_flush & esc, gl1, 0))
    lo, hi, ln = _seg_append(lo, hi, ln,
                             jnp.where(do_flush & esc, gb2, U64(0)),
                             jnp.where(do_flush & esc, gl2, 0))
    lo, hi, ln = _seg_append(lo, hi, ln,
                             jnp.where(do_flush, pbits, U64(0)),
                             jnp.where(do_flush, pnb, 0))

    # error limit: before channel-A words (every word in mono),
    # WordsUtils.cs:430-431
    if entidx == 0:
        acc_t, err_t = _update_error_limit(
            (slow_a, slow_b), (acc[:, 0], acc[:, 1]), delta,
            (errlim[:, 0], errlim[:, 1]), valid, mono,
            hybrid_bitrate, hybrid_balance)
        acc = jnp.stack(acc_t, axis=1)
        errlim = jnp.stack(err_t, axis=1)
    err_c = errlim[:, entidx]

    # median interval + 5/7-2/7 adaptation
    m0, m1, m2 = med_c[:, 0], med_c[:, 1], med_c[:, 2]
    m0n = jnp.where(oc == 0, wrap32(m0 - ((m0 + (consts.DIV0 - 2)) >> 7) * 2),
                    wrap32(m0 + ((m0 + consts.DIV0) >> 7) * 5))
    m1n = jnp.where(oc <= 0, m1,
                    jnp.where(oc == 1,
                              wrap32(m1 - ((m1 + (consts.DIV1 - 2)) >> 6) * 2),
                              wrap32(m1 + ((m1 + consts.DIV1) >> 6) * 5)))
    m2n = jnp.where(oc <= 1, m2,
                    jnp.where(oc == 2,
                              wrap32(m2 - ((m2 + (consts.DIV2 - 2)) >> 5) * 2),
                              wrap32(m2 + ((m2 + consts.DIV2) >> 5) * 5)))
    low = jnp.where(oc == 0, I64(0),
                    g0 + jnp.where(oc == 1, I64(0),
                                   g1 + (oc - 2) * g2))
    high = low + jnp.where(oc == 0, g0,
                           jnp.where(oc == 1, g1, g2)) - 1

    # value payload, lossless branch (err_c == 0): read_code inverse
    code = av - low
    maxcode = high - low
    bitcount = _bitlen(maxcode)
    extras = _safe_shl(U64(1), bitcount).astype(I64) - maxcode - 1
    small = code < extras
    cc = code + extras
    vb = jnp.where(small, code.astype(U64),
                   (cc >> 1).astype(U64)
                   | _safe_shl((cc & 1).astype(U64),
                               jnp.maximum(bitcount - 1, 0)))
    vl = jnp.where(bitcount == 0, 0,
                   jnp.where(small, bitcount - 1, bitcount))

    # value payload, lossy branch: binary search down to the error
    # limit, emitting one comparison bit per step (encode direction of
    # the decoder's search, WordsUtils.cs:482-497)
    def sbody(k, s):
        lo_, hi_, mid, used, val = s
        go = (hi_ - lo_) > err_c
        bit = av >= mid
        lo2 = jnp.where(go & bit, mid, lo_)
        hi2 = jnp.where(go & ~bit, mid - 1, hi_)
        mid2 = jnp.where(go, (hi2 + lo2 + 1) >> 1, mid)
        val2 = val | jnp.where(go & bit, _safe_shl(U64(1), used), U64(0))
        return lo2, hi2, mid2, used + go.astype(jnp.int32), val2

    mid0 = (high + low + 1) >> 1
    _, _, mid_hy, used_hy, val_hy = jax.lax.fori_loop(
        0, 32, sbody,
        (low, high, mid0, jnp.zeros(L, jnp.int32), jnp.zeros(L, U64)))

    ll = err_c == 0
    base_bits = jnp.where(ll, vb, val_hy)
    base_len = jnp.where(ll, vl, used_hy)
    wbits = base_bits | _safe_shl(sign.astype(U64), base_len)
    wnb = base_len + 1
    mid_fin = jnp.where(ll, av, mid_hy)
    rhat = wrap32(jnp.where(sign, ~mid_fin, mid_fin))
    rhat = jnp.where(valid, rhat, 0)

    # state updates (masked by valid)
    med_new = jnp.stack([m0n, m1n, m2n], axis=1)
    med_c2 = jnp.where(valid[:, None], med_new, med_c)
    if entidx == 0:
        med_a = med_c2
    else:
        med_b = med_c2
    if hybrid_bitrate:
        slow_c2 = jnp.where(valid,
                            _slow_decay(slow_c) + mylog2_v(mid_fin), slow_c)
        if entidx == 0:
            slow_a = slow_c2
        else:
            slow_b = slow_c2

    segB_bits = jnp.where(h0, wbits, U64(0))
    segB_len = jnp.where(h0, wnb, 0)
    emit_unary = fromclear | h1
    pvalid = jnp.where(emit_unary, True,
                       jnp.where(do_flush, False, pvalid))
    poc = jnp.where(emit_unary, oc - jnp.where(h1, 1, 0), poc)
    pbits = jnp.where(emit_unary, wbits, pbits)
    pnb = jnp.where(emit_unary, wnb, pnb)
    clear = jnp.where(h0, True, jnp.where(emit_unary, False, clear))

    ent = (med_a, med_b, slow_a, slow_b, acc, errlim,
           clear, pvalid, poc, pbits, pnb)
    return ent, (lo, hi, ln, segB_bits, segB_len), rhat


@partial(jax.jit, static_argnames=("mono", "hybrid_bitrate",
                                   "hybrid_balance"))
def hybrid_encode_scan(targets, terms, deltas, num_terms, med0,
                       slow0, acc0, delta0, nvals, w0a, w0b, h0a, h0b,
                       *, mono: bool, hybrid_bitrate: bool,
                       hybrid_balance: bool):
    """Fused hybrid (lossy) encode: one scan over samples doing decorr
    peel -> error-limit entropy coding -> decorr apply over the
    RECONSTRUCTED residuals, so the carried decorr state evolves exactly
    as the decoder's will (the coupling that keeps lossless encode as
    two separate scans, encoder.py:683-702).

    targets: (T, L, C) int32 joint-domain, scan-major.
    med0 (L, 2, 3) / slow0 (L, 2) / acc0 (L, 2) / delta0 (L, 2): int64
    quantized entropy + hybrid profile state (what the block metadata
    stores). nvals: (L,) int32 valid WORD count. w0a/w0b (L, 16),
    h0a/h0b (L, 16, 8): initial decorr weights/history.

    Returns the same (segA_lo, segA_hi, segA_len, segB_bits, segB_len)
    (W, L) + pending-word tuple as entropy_encode_words, plus
    recon (T, L, C) int32 — the decoder's stored-domain reconstruction
    (joint domain), for the CRC stamp and wvx-free delivery checks."""
    T, L, C = targets.shape
    cst = _mk_cst(terms, deltas, num_terms)
    delta = delta0.astype(I64)
    med0 = med0.astype(I64)

    ent0 = (med0[:, 0, :], med0[:, 1, :],
            slow0[:, 0].astype(I64), slow0[:, 1].astype(I64),
            acc0.astype(I64), jnp.zeros((L, 2), I64),
            jnp.ones(L, bool), jnp.zeros(L, bool), jnp.zeros(L, I64),
            jnp.zeros(L, U64), jnp.zeros(L, jnp.int32))

    def step_stereo(carry, xs):
        step_idx, targ = xs
        m_slot = step_idx & 7
        (wa, wb, sa_r, sb_r), ent = carry
        xa = targ[:, 0].astype(I64)
        xb = targ[:, 1].astype(I64)
        ra, rb = _peel_stereo(cst, wa, wb, sa_r, sb_r, m_slot, xa, xb)
        ent, segs_a, ra_hat = _hyb_word(
            ent, ra, step_idx * 2 < nvals, 0, delta, mono=False,
            hybrid_bitrate=hybrid_bitrate, hybrid_balance=hybrid_balance)
        ent, segs_b, rb_hat = _hyb_word(
            ent, rb, step_idx * 2 + 1 < nvals, 1, delta, mono=False,
            hybrid_bitrate=hybrid_bitrate, hybrid_balance=hybrid_balance)
        wa, wb, sa_r, sb_r, oa, ob = _apply_stereo(
            cst, wa, wb, sa_r, sb_r, m_slot, ra_hat, rb_hat)
        return (((wa, wb, sa_r, sb_r), ent),
                (segs_a, segs_b,
                 jnp.stack([oa, ob], axis=1).astype(jnp.int32)))

    def step_mono(carry, xs):
        step_idx, targ = xs
        m_slot = step_idx & 7
        (wa, sa_r), ent = carry
        xa = targ[:, 0].astype(I64)
        ra = _peel_mono(cst, wa, sa_r, m_slot, xa)
        ent, segs_a, ra_hat = _hyb_word(
            ent, ra, step_idx < nvals, 0, delta, mono=True,
            hybrid_bitrate=hybrid_bitrate, hybrid_balance=hybrid_balance)
        wa, sa_r, oa = _apply_mono(cst, wa, sa_r, m_slot, ra_hat)
        return (((wa, sa_r), ent),
                (segs_a, oa[:, None].astype(jnp.int32)))

    xs = (jnp.arange(T, dtype=jnp.int32), targets)
    if mono:
        dec0 = (w0a.astype(I64).T, h0a.astype(I64).transpose(1, 0, 2))
        (dec, ent), (segs_a, recon) = jax.lax.scan(
            step_mono, (dec0, ent0), xs)
        segs = segs_a                               # (T, L) per slot
    else:
        dec0 = (w0a.astype(I64).T, w0b.astype(I64).T,
                h0a.astype(I64).transpose(1, 0, 2),
                h0b.astype(I64).transpose(1, 0, 2))
        (dec, ent), (segs_a, segs_b, recon) = jax.lax.scan(
            step_stereo, (dec0, ent0), xs)
        # interleave channel A/B words: (T, L) x2 -> (2T, L)
        segs = tuple(
            jnp.stack([a, b], axis=1).reshape(2 * T, L)
            for a, b in zip(segs_a, segs_b))
    pvalid, poc, pbits, pnb = ent[7], ent[8], ent[9], ent[10]
    return segs + (pvalid, poc, pbits, pnb, recon)
