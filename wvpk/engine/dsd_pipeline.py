"""DSD block staging and device decode (modes 0/1/3).

Mirrors the PCM pipeline: group blocks by a static profile, stage per-lane
tables/state arrays, run the lane-parallel kernels, reassemble. The
block-end CRC check (DsdUtils.cs:99-101) and FALSE_STEREO duplication
(:119-131) happen at reassembly.

Delivery is unified with the PCM engine: `launch_dsd_states` returns
device handles (byte-values packed to 1 byte/value on device — DSD output
IS bytes, so shipping int32 would inflate D2H 4x) and `decode_states`
folds them into its single cross-bucket batched fetch; each mode-1/3
group is ONE fused dispatch (kernel + pack + crc stack under one jit).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .. import consts
from ..container.blockstate import BlockState
from ..ops.dsd import dsd_fast_decode, dsd_high_decode, dsd_raw_crc
from ..ops.pack import pack_samples

MAX_DSD_BITS_VALUE = 256


def _pow2_at_least(n: int, lo: int = 64) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


@dataclass(frozen=True)
class DsdProfile:
    mode: int
    mono: bool
    nsteps: int
    nbytes_cap: int
    bins: int = 0
    lookup_cap: int = 0


def _profile(st: BlockState) -> DsdProfile:
    d = st.dsd
    mono = bool(st.flags & consts.MONO_DATA)
    chans = 1 if mono else 2
    n = st.header.block_samples
    if d.mode == 0:
        return DsdProfile(0, mono, 0, 0)
    if d.mode == 1:
        return DsdProfile(
            1, mono, _pow2_at_least(n * chans),
            _pow2_at_least(len(d.data), 16), bins=d.history_bins,
            lookup_cap=_pow2_at_least(max(d.lookup_buffer.size, 1), 256))
    return DsdProfile(3, mono, _pow2_at_least(n),
                      _pow2_at_least(len(d.data), 16))


def _pad_bytes(payloads: list[bytes], cap: int) -> np.ndarray:
    out = np.zeros((len(payloads), cap), np.int32)
    for i, p in enumerate(payloads):
        out[i, :len(p)] = np.frombuffer(p, np.uint8)
    return out


# ---------------------------------------------------------------------------
# fused single-dispatch wrappers: kernel + byte pack + crc/err stack
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mono", "nsteps"))
def _fast_packed_xla(data, nbytes, summed, probs, vlook, lookup, value0,
                     bins_arr, nvals, *, mono, nsteps):
    outs, err, crc = dsd_fast_decode(
        data, nbytes, summed, probs, vlook, lookup, value0, bins_arr,
        nvals, mono=mono, nsteps=nsteps)
    payload = pack_samples(outs[:, :, None].astype(jnp.int32), bps=1,
                           dsd=True)
    crcerr = jnp.stack([jnp.asarray(crc, jnp.int32),
                        jnp.asarray(err).astype(jnp.int32)])
    return payload, crcerr


@partial(jax.jit, static_argnames=("mono", "nsteps"))
def _high_packed(data, nbytes, ptable, filters, value0, nsamples, *,
                 mono, nsteps):
    outs, crc = dsd_high_decode(
        data, nbytes, ptable, filters, value0, nsamples, mono=mono,
        nsteps=nsteps)
    payload = pack_samples(jnp.asarray(outs, jnp.int32), bps=1, dsd=True)
    crcerr = jnp.stack([jnp.asarray(crc, jnp.int32),
                        jnp.zeros(crc.shape, jnp.int32)])
    return payload, crcerr


@dataclass
class LaunchedDsd:
    """One DSD profile group's in-flight decode. `payload` is the packed
    (L, W) uint32 device array of byte-values in per-lane memory order
    (mode 1: interleaved values; mode 3: (sample, ch)); None for mode 0,
    whose bytes never left the host. `crcerr` is a (2, L) int32 device
    array [crc, coder_error]."""
    prof: DsdProfile
    idxs: list[int]
    sts: list[BlockState]
    payload: object | None
    crcerr: object
    host_vals: list[np.ndarray] | None   # mode 0 raw values per state
    nvals: np.ndarray                    # (L,) delivered value counts


def launch_dsd_states(states: list[BlockState],
                      mesh=None) -> list[LaunchedDsd]:
    """Enqueue every DSD profile group's decode on device; nothing is
    fetched here (decode_states batches all fetches into one transfer).
    With `mesh` the mode-1/3 group kernels run lane-sharded across the
    device mesh via shard_map (mode 0 is a host byte copy + device CRC
    and stays unsharded)."""
    from functools import partial

    def _call(fn, statics, args):
        if mesh is None:
            return fn(*args, **statics)
        from ..parallel.mesh import shard_lanes_call
        return shard_lanes_call(partial(fn, **statics), args, mesh,
                                out_lane_axes=(0, 1))

    from . import xferstats

    def _count_h2d(*arrs):
        for a in arrs:
            xferstats.add("h2d", np.asarray(a).nbytes)

    groups: dict[DsdProfile, list[int]] = {}
    for i, st in enumerate(states):
        groups.setdefault(_profile(st), []).append(i)

    launched = []
    for prof, idxs in groups.items():
        sts = [states[i] for i in idxs]
        chans = 1 if prof.mono else 2
        nsamples = np.asarray([st.header.block_samples for st in sts],
                              np.int32)
        nvals = nsamples * chans
        if prof.mode == 0:
            cap = max(int(nvals.max()), 1)
            data = _pad_bytes([st.dsd.data for st in sts], cap)
            neff = np.minimum(nvals, [len(st.dsd.data) for st in sts])
            _count_h2d(data)
            crc = dsd_raw_crc(data, neff.astype(np.int32))
            crcerr = jnp.stack([jnp.asarray(crc, jnp.int32),
                                jnp.zeros(len(sts), jnp.int32)])
            host_vals = [data[k, :nvals[k]].astype(np.int32)
                         for k in range(len(sts))]
            launched.append(LaunchedDsd(prof, idxs, sts, None, crcerr,
                                        host_vals, nvals))
            continue
        data = _pad_bytes([st.dsd.data for st in sts], prof.nbytes_cap)
        nbytes = np.asarray([len(st.dsd.data) for st in sts], np.int64)
        _count_h2d(data)
        if prof.mode == 1:
            B = prof.bins
            summed = np.zeros((len(sts), B * 256), np.int32)
            value0 = np.zeros(len(sts), np.int64)
            for k, st in enumerate(sts):
                d = st.dsd
                summed[k] = d.summed_probabilities.astype(np.int32).reshape(-1)
                value0[k] = d.value
            _count_h2d(summed)
            probs = np.zeros((len(sts), B * 256), np.int32)
            vlook = np.zeros((len(sts), B), np.int32)
            lookup = np.zeros((len(sts), prof.lookup_cap), np.int32)
            for k, st in enumerate(sts):
                d = st.dsd
                probs[k] = d.probabilities.astype(np.int32).reshape(-1)
                vlook[k] = d.value_lookup
                lookup[k, :d.lookup_buffer.size] = d.lookup_buffer
            payload, crcerr = _call(
                _fast_packed_xla,
                dict(mono=prof.mono, nsteps=prof.nsteps),
                (data, nbytes, summed, probs, vlook, lookup, value0,
                 np.full(len(sts), B, np.int64),
                 nvals.astype(np.int32)))
        else:
            ptable = np.stack([st.dsd.ptable for st in sts]).astype(np.int32)
            filters = np.stack([st.dsd.filters for st in sts]).astype(np.int32)
            value0 = np.asarray([st.dsd.value for st in sts], np.int64)
            _count_h2d(ptable, filters)
            payload, crcerr = _call(
                _high_packed, dict(mono=prof.mono, nsteps=prof.nsteps),
                (data, nbytes, ptable, filters, value0,
                 nsamples.astype(np.int32)))
        launched.append(LaunchedDsd(prof, idxs, sts, payload, crcerr,
                                    None, nvals))
    return launched


def finalize_dsd_group(ld: LaunchedDsd,
                       fetched: tuple[np.ndarray, np.ndarray | None]
                       | None = None):
    """Assemble one group's DecodedBlocks from (crcerr, payload) numpy
    arrays (fetched by the engine's batched transfer, or here if None)."""
    if fetched is None:
        payload_np = (None if ld.payload is None else np.asarray(ld.payload))
        crcerr = np.asarray(ld.crcerr)
    else:
        crcerr, payload_np = fetched
    crc, err = crcerr[0], crcerr[1]
    out = []
    for k, st in enumerate(ld.sts):
        if ld.host_vals is not None:
            vals = ld.host_vals[k]
        else:
            vals = (payload_np[k].view(np.uint8)[:ld.nvals[k]]
                    .astype(np.int32))
        out.append(_assemble(st, vals, int(crc[k]), bool(err[k])))
    return out


def decode_dsd_states(states: list[BlockState]):
    """Device-decode a list of DSD block states (standalone path; the
    engine's decode_states uses launch/finalize with a batched fetch)."""
    results = [None] * len(states)
    for ld in launch_dsd_states(states):
        for i, res in zip(ld.idxs, finalize_dsd_group(ld)):
            results[i] = res
    return results


def _assemble(st: BlockState, interleaved: np.ndarray, crc: int, err: bool):
    from .pipeline import DecodedBlock

    hdr = st.header
    n = hdr.block_samples
    mute = err or crc != hdr.crc
    flags = st.flags
    if mute:
        interleaved = np.full_like(interleaved, 0x55)
        # the reference zero-fills only what it decoded; with CRC mismatch
        # the whole block muted (0x55 fill, DsdUtils.cs:104-117)
    if flags & consts.FALSE_STEREO:
        out = np.repeat(interleaved[:n, None], 2, axis=1)
    elif flags & consts.MONO_FLAG:
        out = interleaved[:n, None]
    else:
        out = interleaved.reshape(-1, 2)[:n]
    return DecodedBlock(samples=np.ascontiguousarray(out.astype(np.int32)),
                        crc=crc, crc_x=-1, mute_error=mute, crc_error=mute)
