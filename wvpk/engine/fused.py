"""Single-jit fused decode: entropy -> decorr -> joint/CRC/mute -> fixup.

One compiled XLA program per bucket profile; this is the function the
multi-chip path shards over the lane (block) axis and what bench/entry
compile-check. Entropy -> decorr -> joint/CRC/mute is `backend.decode_post`:
the CUDA lane kernel on the GPU, the XLA scans elsewhere.

The `_blob` variants take ALL per-lane arrays as ONE packed int32 vector
(built host-side by `build_blob`) and unpack on device with static
offsets: a decode_states call then moves exactly one host->device buffer
per bucket instead of ~20, since every PCIe transfer pays a fixed
latency. The byte pack (ops/pack.py) and crc/mute stacking are fused into
the same dispatch.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import backend
from ..ops.decorr import decorr_decode
from ..ops.entropy import entropy_decode, wvc_corrections
from ..ops.post import fixup, joint_mute_crc, wvx_inject


@partial(jax.jit, static_argnames=(
    "mono", "hybrid", "hybrid_bitrate", "hybrid_balance",
    "is_float", "int32_expand", "nsteps"))
def fused_decode(words, nwords_lane, nsamples, med, slow, acc, delta,
                 terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
                 joint, mute_limit, shift, bytes_stored, float_shift_eff,
                 int32_zod, *,
                 mono: bool, hybrid: bool, hybrid_bitrate: bool,
                 hybrid_balance: bool, is_float: bool, int32_expand: bool,
                 nsteps: int):
    out, crc, mute = backend.decode_post(
        words, nwords_lane, nsamples, med, slow, acc, delta, terms,
        deltas16, wa, wb, hist_a, hist_b, num_terms, joint, mute_limit,
        mono=mono, hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance, nsteps=nsteps)
    out = fixup(out, shift, bytes_stored, float_shift_eff, int32_zod,
                is_float=is_float, int32_expand=int32_expand, hybrid=hybrid)
    return out, crc, mute


@partial(jax.jit, static_argnames=(
    "mono", "hybrid", "hybrid_bitrate", "hybrid_balance",
    "has_false_stereo", "nsteps"))
def fused_decode_wvx(words, nwords_lane, nsamples, med, slow, acc, delta,
                     terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
                     joint, mute_limit, shift, bytes_stored,
                     float_shift_eff, int32_zod, wvx_words, wvx_start_bit,
                     wvx_start_bc, sent_bits, max_width, false_stereo, *,
                     mono: bool, hybrid: bool, hybrid_bitrate: bool,
                     hybrid_balance: bool, has_false_stereo: bool,
                     nsteps: int):
    """Single-dispatch decode for INT32+wvx buckets: the wvx low-bit
    injection (with its own expansion + crc_x, UnpackUtils.cs:1271-1314)
    runs BETWEEN joint/CRC and the final fixup shift — the same ordering
    the stage-wise path honors."""
    out, crc, mute = backend.decode_post(
        words, nwords_lane, nsamples, med, slow, acc, delta, terms,
        deltas16, wa, wb, hist_a, hist_b, num_terms, joint, mute_limit,
        mono=mono, hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance, nsteps=nsteps)
    out, crc_x = wvx_inject(
        out, nsamples, wvx_words, wvx_start_bit, wvx_start_bc, sent_bits,
        max_width, int32_zod,
        false_stereo=false_stereo if has_false_stereo else None)
    out = fixup(out, shift, bytes_stored, float_shift_eff, int32_zod,
                is_float=False, int32_expand=False, hybrid=hybrid)
    return out, crc, mute, crc_x


@partial(jax.jit, static_argnames=(
    "mono", "hybrid_bitrate", "hybrid_balance", "int32_expand", "nsteps"))
def fused_decode_wvc(words, nwords_lane, nsamples, med, slow, acc, delta,
                     terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
                     joint, mute_limit, shift, bytes_stored,
                     float_shift_eff, int32_zod, wvc_words, *,
                     mono: bool, hybrid_bitrate: bool,
                     hybrid_balance: bool, int32_expand: bool,
                     nsteps: int):
    """Single-dispatch hybrid-lossless decode (beyond reference parity;
    the reference never reads the correction stream, WavPackUtils.cs:31).

    The exact-semantics XLA entropy scan emits each word's narrowed
    interval, the cursor-only correction scan reads the wvc stream, and
    corrections add AFTER the decorr chain (linear in the residual for
    its lossy-driven prediction sequence) and before the joint undo.
    Both CRCs come back: the wv header's (lossy reconstruction) and the
    wvc header's (exact samples). Runs the XLA scans on every platform.
    Returns (out, crc_lossy, mute, crc_wvc)."""
    residuals, mc, base, broke, _ndec = entropy_decode(
        words, nwords_lane, med, slow, acc, delta,
        mono=mono, hybrid=True, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance, nsteps=nsteps, wvc=True)
    corr = wvc_corrections(wvc_words, mc, base, residuals)
    decorr_out = decorr_decode(
        residuals, terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
        mono=mono)
    exact = decorr_out + corr                   # int32 add wraps like C#
    out, crc_wvc, mute = joint_mute_crc(
        exact, nsamples, joint, mute_limit, broke, mono=mono)
    _, crc, _ = joint_mute_crc(
        decorr_out, nsamples, joint, mute_limit, broke, mono=mono)
    out = fixup(out, shift, bytes_stored, float_shift_eff, int32_zod,
                is_float=False, int32_expand=int32_expand, hybrid=True)
    return out, crc, mute, crc_wvc


# ---------------------------------------------------------------------------
# blob staging
# ---------------------------------------------------------------------------

def build_blob(arrays, narrow: frozenset | set = frozenset()
               ) -> tuple[np.ndarray, tuple]:
    """Concatenate host arrays into one flat int32 vector + static metas
    (offset, size, shape, dtype) for the device-side unpack. int64 splits
    into little-endian (lo, hi) int32 pairs; bool widens to int32.
    Indices in `narrow` are int64 arrays whose values fit int32 (medians,
    decorr history... — everything except bitrate_acc, which is a genuine
    64-bit accumulator): they ship as int32 and widen back on device,
    halving their transfer bytes."""
    parts, metas, off = [], [], 0
    for i, arr in enumerate(arrays):
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.int64 and i in narrow:
            flat = arr.astype(np.int32).reshape(-1)
            assert (flat.astype(np.int64) == arr.reshape(-1)).all(), \
                f"narrow blob array {i} does not fit int32"
            dt = "int64_narrow"
        elif arr.dtype == np.int64:
            flat = arr.view(np.int32).reshape(-1)
            dt = "int64"
        elif arr.dtype == np.bool_:
            flat = arr.astype(np.int32).reshape(-1)
            dt = "bool"
        elif arr.dtype == np.uint32:
            flat = arr.view(np.int32).reshape(-1)
            dt = "uint32"
        else:
            assert arr.dtype == np.int32, arr.dtype
            flat = arr.reshape(-1)
            dt = "int32"
        parts.append(flat)
        metas.append((off, flat.size,
                      tuple(int(s) for s in arr.shape), dt))
        off += flat.size
    return np.concatenate(parts), tuple(metas)


def _unpack_blob(blob, metas):
    out = []
    for off, size, shape, dt in metas:
        flat = blob[off:off + size]
        if dt == "int64":
            a = jax.lax.bitcast_convert_type(
                flat.reshape(shape + (2,)), jnp.int64)
        elif dt == "int64_narrow":
            a = flat.reshape(shape).astype(jnp.int64)
        elif dt == "bool":
            a = (flat != 0).reshape(shape)
        elif dt == "uint32":
            a = jax.lax.bitcast_convert_type(flat, jnp.uint32).reshape(shape)
        else:
            a = flat.reshape(shape)
        out.append(a)
    return out


# positions in the launch_bucket blob-arg order of the decorr term arrays
# (terms, deltas16, wa, wb: (L, nterms); hist_a, hist_b: (L, nterms, 8)).
# They ship trimmed to the bucket's deepest chain and are padded back to
# MAX_NTERMS here, the width both decode paths take.
_TERM2D = (7, 8, 9, 10)
_TERM3D = (11, 12)


def _restore_terms(args):
    from .. import consts
    full = consts.MAX_NTERMS
    for i in _TERM2D:
        a = args[i]
        if a.shape[1] < full:
            args[i] = jnp.pad(a, ((0, 0), (0, full - a.shape[1])))
    for i in _TERM3D:
        a = args[i]
        if a.shape[1] < full:
            args[i] = jnp.pad(a, ((0, 0), (0, full - a.shape[1]), (0, 0)))
    return args


def _deliver(out, crc, mute, crc_x, pack_bps):
    if pack_bps is not None:
        from ..ops.pack import pack_samples
        payload = pack_samples(out, bps=pack_bps)
    else:
        payload = out
    crcmute = jnp.stack([crc.astype(jnp.int32),
                         jnp.asarray(mute).astype(jnp.int32),
                         crc_x.astype(jnp.int32)])
    return payload, crcmute


@partial(jax.jit, static_argnames=(
    "metas", "mono", "hybrid", "hybrid_bitrate", "hybrid_balance",
    "is_float", "int32_expand", "nsteps", "pack_bps"))
def fused_decode_blob(blob, *, metas, mono, hybrid, hybrid_bitrate,
                      hybrid_balance, is_float, int32_expand, nsteps,
                      pack_bps):
    args = _restore_terms(_unpack_blob(blob, metas))
    out, crc, mute = fused_decode(
        *args, mono=mono, hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance, is_float=is_float,
        int32_expand=int32_expand, nsteps=nsteps)
    crc_x = jnp.full(crc.shape, -1, jnp.int32)
    return _deliver(out, crc, mute, crc_x, pack_bps)


@partial(jax.jit, static_argnames=(
    "metas", "mono", "hybrid_bitrate", "hybrid_balance", "int32_expand",
    "nsteps", "pack_bps"))
def fused_decode_wvc_blob(blob, *, metas, mono, hybrid_bitrate,
                          hybrid_balance, int32_expand, nsteps, pack_bps):
    """Blob-staged hybrid-lossless decode: one H2D buffer per bucket,
    one dispatch; crcmute gains a 4th row (crc_wvc)."""
    args = _restore_terms(_unpack_blob(blob, metas))
    out, crc, mute, crc_wvc = fused_decode_wvc(
        *args, mono=mono, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance, int32_expand=int32_expand,
        nsteps=nsteps)
    if pack_bps is not None:
        from ..ops.pack import pack_samples
        payload = pack_samples(out, bps=pack_bps)
    else:
        payload = out
    crcmute = jnp.stack([crc.astype(jnp.int32),
                         jnp.asarray(mute).astype(jnp.int32),
                         jnp.full(crc.shape, -1, jnp.int32),
                         crc_wvc.astype(jnp.int32)])
    return payload, crcmute


@partial(jax.jit, static_argnames=(
    "metas", "mono", "hybrid", "hybrid_bitrate", "hybrid_balance",
    "has_false_stereo", "nsteps", "pack_bps"))
def fused_decode_wvx_blob(blob, *, metas, mono, hybrid, hybrid_bitrate,
                          hybrid_balance, has_false_stereo, nsteps,
                          pack_bps):
    args = _restore_terms(_unpack_blob(blob, metas))
    out, crc, mute, crc_x = fused_decode_wvx(
        *args, mono=mono, hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance, has_false_stereo=has_false_stereo,
        nsteps=nsteps)
    return _deliver(out, crc, mute, crc_x, pack_bps)
