"""Device mesh + lane sharding for batch decode.

Blocks are self-seeded (every block's metadata carries its decorr/entropy
state, SURVEY.md section 2.3), so the multi-device story is pure data
parallelism over the lane (block) axis with ZERO collectives on the hot
path: shard_map runs each device's program on its lane shard (the lane
kernel is an FFI call, opaque to the SPMD partitioner, so shard_map is
the correct structure, not sharding propagation). The mesh is flat:
every card reaches every other at the same rate. Covers every codec
path: plain/hybrid/float PCM via fused_decode, int32+wvx via
fused_decode_wvx, and DSD modes 1/3 via the packed DSD group kernels.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.fused import fused_decode, fused_decode_wvc, fused_decode_wvx
from ..engine.staging import Bucket

LANE_AXIS = "blocks"

_BASE_NAMES = ["words", "nwords_lane", "nsamples", "med", "slow", "acc",
               "delta", "terms", "deltas16", "wa", "wb", "hist_a", "hist_b",
               "num_terms", "joint", "mute_limit", "shift", "bytes_stored",
               "float_shift_eff", "int32_zod"]
_WVX_NAMES = ["wvx_words", "wvx_start_bit", "wvx_start_bc", "sent_bits",
              "max_width"]
_WVC_NAMES = ["wvc_words"]


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (LANE_AXIS,))


def _pad_lanes(arr: np.ndarray, L_pad: int) -> np.ndarray:
    """Pad the lane axis to a mesh multiple by replicating lane 0 (a real
    block's data, so padded lanes run the kernels on valid inputs; their
    outputs are sliced away)."""
    if arr.shape[0] == L_pad:
        return arr
    rep = np.repeat(arr[:1], L_pad - arr.shape[0], axis=0)
    return np.concatenate([arr, rep], axis=0)


def shard_bucket_arrays(b: Bucket, mesh: Mesh,
                        names: list[str]) -> tuple[dict, int]:
    """Pad the lane axis to a mesh multiple and device_put every array with
    a lane-sharded NamedSharding."""
    n = mesh.devices.size
    L = b.words.shape[0]
    L_pad = ((L + n - 1) // n) * n
    sh = NamedSharding(mesh, P(LANE_AXIS))
    out = {}
    for name in names:
        arr = _pad_lanes(np.asarray(getattr(b, name)), L_pad)
        out[name] = jax.device_put(arr, sh)
    return out, L


def sharded_decode_bucket(b: Bucket, mesh: Mesh):
    """Decode one bucket with the lane axis sharded across the mesh.

    Returns (out (T, L, C) int32, crc (L,), mute (L,), crc_x (L,))
    unpadded; crc_x is -1 for non-wvx buckets (reference semantics:
    crc_mvx only exists with a wvx stream, UnpackUtils.cs:124-128).
    """
    from functools import partial

    from jax.experimental.shard_map import shard_map

    prof = b.profile
    names = _BASE_NAMES + (_WVX_NAMES if prof.has_wvx else []) \
        + (_WVC_NAMES if prof.has_wvc else [])
    arrs, L = shard_bucket_arrays(b, mesh, names)
    args = [arrs[n] for n in names]
    if prof.has_wvc:
        fn = partial(fused_decode_wvc,
                     mono=prof.mono,
                     hybrid_bitrate=prof.hybrid_bitrate,
                     hybrid_balance=prof.hybrid_balance,
                     int32_expand=prof.is_int32,
                     nsteps=prof.nsteps)
        out_specs = (P(None, LANE_AXIS, None), P(LANE_AXIS), P(LANE_AXIS),
                     P(LANE_AXIS))
    elif prof.has_wvx:
        from .. import consts
        fs = np.asarray([bool(st.flags & consts.FALSE_STEREO)
                         for st in b.states])
        fs_pad = _pad_lanes(fs, args[0].shape[0])
        args.append(jax.device_put(fs_pad, NamedSharding(mesh, P(LANE_AXIS))))
        fn = partial(fused_decode_wvx,
                     mono=prof.mono, hybrid=prof.hybrid,
                     hybrid_bitrate=prof.hybrid_bitrate,
                     hybrid_balance=prof.hybrid_balance,
                     has_false_stereo=bool(fs.any()),
                     nsteps=prof.nsteps)
        out_specs = (P(None, LANE_AXIS, None), P(LANE_AXIS), P(LANE_AXIS),
                     P(LANE_AXIS))
    else:
        fn = partial(fused_decode,
                     mono=prof.mono, hybrid=prof.hybrid,
                     hybrid_bitrate=prof.hybrid_bitrate,
                     hybrid_balance=prof.hybrid_balance,
                     is_float=prof.is_float,
                     int32_expand=prof.is_int32,
                     nsteps=prof.nsteps)
        out_specs = (P(None, LANE_AXIS, None), P(LANE_AXIS), P(LANE_AXIS))
    in_specs = tuple(P(LANE_AXIS, *([None] * (a.ndim - 1))) for a in args)
    sharded = shard_map(fn, mesh=mesh, in_specs=in_specs,
                        out_specs=out_specs, check_rep=False)
    res = jax.jit(sharded)(*args)
    crc_wvc = None
    if prof.has_wvc:
        out, crc, mute, crc_wvc = res
        crc_wvc = np.asarray(crc_wvc)[:L]
        crc_x = np.full(L, -1, np.int32)
    elif prof.has_wvx:
        out, crc, mute, crc_x = res
        crc_x = np.asarray(crc_x)[:L]
    else:
        out, crc, mute = res
        crc_x = np.full(L, -1, np.int32)
    return (np.asarray(out)[:, :L, :], np.asarray(crc)[:L],
            np.asarray(mute)[:L], crc_x, crc_wvc)


def sharded_decode_states(states, mesh: Mesh):
    """Multi-chip batch decode: the mesh-parallel counterpart of
    `engine.decode_states`. Buckets PCM blocks by profile and runs each
    bucket's fused decode lane-sharded over the mesh; DSD groups route
    through the sharded group kernels. Returns the same `DecodedBlock`
    list (order preserved), so swapping a single-chip batch decode for an
    N-chip one is a one-line change."""
    from .. import consts
    from ..engine.dsd_pipeline import finalize_dsd_group, launch_dsd_states
    from ..engine.pipeline import DecodedBlock
    from ..engine.staging import group_blocks

    results = [None] * len(states)
    pcm, pcm_idx, dsd, dsd_idx = [], [], [], []
    for i, st in enumerate(states):
        if st.flags & consts.DSD_FLAG:
            dsd.append(st)
            dsd_idx.append(i)
        elif st.header.block_samples == 0:
            results[i] = DecodedBlock(
                samples=np.zeros((0, 1), np.int32), crc=-1, crc_x=-1,
                mute_error=False, crc_error=False)
        else:
            pcm.append(st)
            pcm_idx.append(i)
    remap = {id(st): i for st, i in zip(pcm, pcm_idx)}
    for b in group_blocks(pcm):
        out, crc, mute, crc_x, crc_wvc = sharded_decode_bucket(b, mesh)
        for i, st in enumerate(b.states):
            n = st.header.block_samples
            vals = out[:n, i, :]
            if st.flags & consts.FALSE_STEREO:
                vals = np.repeat(vals, 2, axis=1)
            crc_err = (int(crc[i]) != st.header.crc
                       or (b.profile.has_wvx
                           and int(crc_x[i]) != st.crc_mvx))
            cw = -1
            if b.profile.has_wvc:
                cw = int(crc_wvc[i])
                if st.wvc_crc is not None and cw != int(b.wvc_crc[i]):
                    crc_err = True
            results[remap[id(st)]] = DecodedBlock(
                samples=np.ascontiguousarray(vals), crc=int(crc[i]),
                crc_x=int(crc_x[i]), mute_error=bool(mute[i]),
                crc_error=bool(crc_err),
                crc_wvc=cw, wvc_applied=b.profile.has_wvc)
    if dsd:
        for ld in launch_dsd_states(dsd, mesh=mesh):
            for i, res in zip(ld.idxs, finalize_dsd_group(ld)):
                results[dsd_idx[i]] = res
    return results


def shard_lanes_call(fn, args, mesh: Mesh, out_lane_axes: tuple[int, ...]):
    """shard_map an arbitrary lane-leading kernel call over the mesh:
    every arg is padded on its leading (lane) axis to a mesh multiple by
    replicating lane 0, the call runs per-device on its shard, and each
    output is unpadded along `out_lane_axes[i]`. Used for the DSD group
    kernels (dsd_pipeline launches route through here when a mesh is
    given)."""
    from jax.experimental.shard_map import shard_map

    n = mesh.devices.size
    L = int(np.asarray(args[0]).shape[0])
    L_pad = ((L + n - 1) // n) * n
    sh = NamedSharding(mesh, P(LANE_AXIS))
    padded = [jax.device_put(_pad_lanes(np.asarray(a), L_pad), sh)
              for a in args]
    in_specs = tuple(P(LANE_AXIS, *([None] * (a.ndim - 1))) for a in padded)
    out_specs = tuple(
        P(*(LANE_AXIS if d == ax else None
            for d in range(2)))            # DSD outputs are rank 2
        for ax in out_lane_axes)
    sharded = shard_map(fn, mesh=mesh, in_specs=in_specs,
                        out_specs=out_specs, check_rep=False)
    res = jax.jit(sharded)(*padded)
    out = []
    for r, ax in zip(res, out_lane_axes):
        idx = tuple(slice(0, L) if d == ax else slice(None)
                    for d in range(r.ndim))
        out.append(r[idx])
    return tuple(out)


def sharded_encode_scans(targ, terms, deltas, num_terms, med0, nvals,
                         mesh: Mesh, *, mono: bool,
                         seeds: tuple | None = None):
    """Run the device ENCODE scans lane-sharded over the mesh: pure
    data parallelism like decode — blocks are independent lanes, zero
    hot-path collectives. Lanes padded to a mesh multiple by
    replicating lane 0; outputs unpadded. `seeds` is an optional (w0a, w0b, h0a, h0b)
    warm decorr state per lane (fresh zero seeds otherwise). Returns
    the same 9-tuple as entropy_encode_words (segments + final pending
    state)."""
    from functools import partial

    from jax.experimental.shard_map import shard_map

    from ..ops.encode_kernels import decorr_invert_warm, \
        entropy_encode_words

    n = mesh.devices.size
    T, L, C = targ.shape
    L_pad = ((L + n - 1) // n) * n

    def padl(a, axis):
        a = np.asarray(a)
        if L_pad == L:
            return a
        reps = np.repeat(np.take(a, [0], axis=axis), L_pad - L, axis=axis)
        return np.concatenate([a, reps], axis=axis)

    if seeds is None:
        seeds = (np.zeros((L, 16), np.int64), np.zeros((L, 16), np.int64),
                 np.zeros((L, 16, 8), np.int64),
                 np.zeros((L, 16, 8), np.int64))
    w0a, w0b, h0a, h0b = seeds
    args = (padl(targ, 1), padl(terms, 0), padl(deltas, 0),
            padl(num_terms, 0), padl(med0, 0), padl(nvals, 0),
            padl(w0a, 0), padl(w0b, 0), padl(h0a, 0), padl(h0b, 0))
    specs = (P(None, LANE_AXIS, None), P(LANE_AXIS, None),
             P(LANE_AXIS, None), P(LANE_AXIS),
             P(LANE_AXIS, None, None), P(LANE_AXIS),
             P(LANE_AXIS, None), P(LANE_AXIS, None),
             P(LANE_AXIS, None, None), P(LANE_AXIS, None, None))
    args = [jax.device_put(a, NamedSharding(mesh, s))
            for a, s in zip(args, specs)]

    def fn(tg, tm, dl, nt, md, nv, wa, wb, ha, hb):
        Ls = tg.shape[1]
        res = decorr_invert_warm(tg, tm, dl, nt, wa, wb, ha, hb, mono=mono)
        words = res.transpose(0, 2, 1).reshape(T * C, Ls)
        return entropy_encode_words(words, md, nv, mono=mono)

    out_specs = tuple([P(None, LANE_AXIS)] * 5 + [P(LANE_AXIS)] * 4)
    sharded = shard_map(partial(fn), mesh=mesh, in_specs=specs,
                        out_specs=out_specs, check_rep=False)
    res = jax.jit(sharded)(*args)
    return tuple(r[:, :L] if r.ndim == 2 else r[:L] for r in res)


def sharded_invert_warm_state(targ, terms, deltas, num_terms, mesh: Mesh,
                              *, mono: bool):
    """Lane-shard the warm-seeding lookahead scan: run the decorr
    inversion over each block's first K samples from fresh seeds and
    return ONLY the final per-lane decorr state (wa, wb, ha, hb) —
    the state `encode_blocks_device` quantizes into the block's
    metadata before the main sharded scan. Pure data parallelism, same
    lane padding contract as the other sharded encode entry points."""
    from jax.experimental.shard_map import shard_map

    from ..ops.encode_kernels import decorr_invert_warm

    n = mesh.devices.size
    K, L, C = targ.shape
    L_pad = ((L + n - 1) // n) * n

    def padl(a, axis):
        a = np.asarray(a)
        if L_pad == L:
            return a
        reps = np.repeat(np.take(a, [0], axis=axis), L_pad - L, axis=axis)
        return np.concatenate([a, reps], axis=axis)

    raw = (padl(targ, 1), padl(terms, 0), padl(deltas, 0),
           padl(num_terms, 0))
    specs = (P(None, LANE_AXIS, None), P(LANE_AXIS, None),
             P(LANE_AXIS, None), P(LANE_AXIS))
    args = [jax.device_put(a, NamedSharding(mesh, s))
            for a, s in zip(raw, specs)]

    def fn(tg, tm, dl, nt):
        Ls = tg.shape[1]
        z16 = jnp.zeros((Ls, 16), jnp.int64)
        z168 = jnp.zeros((Ls, 16, 8), jnp.int64)
        _, state = decorr_invert_warm(tg, tm, dl, nt, z16, z16, z168, z168,
                                      mono=mono, with_state=True)
        return state

    out_specs = (P(LANE_AXIS, None), P(LANE_AXIS, None),
                 P(LANE_AXIS, None, None), P(LANE_AXIS, None, None))
    sharded = shard_map(fn, mesh=mesh, in_specs=specs,
                        out_specs=out_specs, check_rep=False)
    res = jax.jit(sharded)(*args)
    return tuple(r[:L] for r in res)


def sharded_hybrid_encode_scan(targ, terms, deltas, num_terms, med0,
                               slow0, acc0, delta0, nvals, w0a, w0b,
                               h0a, h0b, mesh: Mesh, *, mono: bool,
                               hybrid_bitrate: bool, hybrid_balance: bool):
    """Lane-shard the fused HYBRID encode scan (ops/encode_kernels.py::
    hybrid_encode_scan) over the mesh. Same data-parallel structure as
    the lossless path: each block is an independent lane (the lossy
    reconstruction feedback is block-local), zero hot-path collectives.
    Returns the scan's 10-tuple (9 segment/pending arrays + recon
    (T, L, C)) unpadded."""
    from functools import partial

    from jax.experimental.shard_map import shard_map

    from ..ops.encode_kernels import hybrid_encode_scan

    n = mesh.devices.size
    L = targ.shape[1]
    L_pad = ((L + n - 1) // n) * n

    def padl(a, axis):
        a = np.asarray(a)
        if L_pad == L:
            return a
        reps = np.repeat(np.take(a, [0], axis=axis), L_pad - L, axis=axis)
        return np.concatenate([a, reps], axis=axis)

    raw = (padl(targ, 1), padl(terms, 0), padl(deltas, 0),
           padl(num_terms, 0), padl(med0, 0), padl(slow0, 0),
           padl(acc0, 0), padl(delta0, 0), padl(nvals, 0),
           padl(w0a, 0), padl(w0b, 0), padl(h0a, 0), padl(h0b, 0))
    specs = tuple(P(None, LANE_AXIS, None) if a.ndim == 3 and i == 0
                  else P(LANE_AXIS, *([None] * (a.ndim - 1)))
                  for i, a in enumerate(raw))
    args = [jax.device_put(a, NamedSharding(mesh, s))
            for a, s in zip(raw, specs)]

    fn = partial(hybrid_encode_scan, mono=mono,
                 hybrid_bitrate=hybrid_bitrate,
                 hybrid_balance=hybrid_balance)
    out_specs = tuple([P(None, LANE_AXIS)] * 5 + [P(LANE_AXIS)] * 4
                      + [P(None, LANE_AXIS, None)])
    sharded = shard_map(fn, mesh=mesh, in_specs=specs,
                        out_specs=out_specs, check_rep=False)
    res = jax.jit(sharded)(*args)
    out = []
    for r in res:
        if r.ndim == 1:
            out.append(r[:L])
        elif r.ndim == 2:
            out.append(r[:, :L])
        else:
            out.append(r[:, :L, :])
    return tuple(out)
