"""The fused device decode pipeline.

Per bucket: staged bitstreams -> entropy scan -> decorr scan -> joint-stereo
/ mute / CRC -> wvx injection -> fixup, all on device; the host only parses
containers and reassembles outputs. This is the accelerator restructuring
of unpack_samples (reference UnpackUtils.cs:510-686): the reference's
host/device boundary does not exist — here it sits exactly between
unpack_init (host) and the sample-domain math (device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import consts, trace
from ..config import get_options
from ..container.blockstate import BlockState
from ..ops import backend
from ..ops.decorr import decorr_decode
from ..ops.entropy import entropy_decode
from ..ops.post import fixup, joint_mute_crc, wvx_inject
from .staging import Bucket, group_blocks


@dataclass
class DecodedBlock:
    samples: np.ndarray    # (n, ch_out) int32 (FALSE_STEREO already dup'd)
    crc: int
    crc_x: int
    mute_error: bool
    crc_error: bool
    # hybrid-lossless (wvc) extras, mirroring ref.oracle.BlockResult
    crc_wvc: int = -1
    wvc_applied: bool = False


def _sync(x):
    if get_options().sync_stages:
        import jax
        jax.block_until_ready(x)
    return x


@dataclass
class LaunchedBucket:
    """Device handles for one bucket's in-flight decode: everything stays
    on device until `finalize_bucket`, so multiple buckets can be enqueued
    back-to-back (the device serializes the compute while the host keeps
    parsing/staging) and each bucket pays exactly two host fetches —
    the PCM payload and one stacked (crc, mute, crc_x) vector."""
    bucket: Bucket
    payload: object            # (L, W) uint32 packed PCM or (T, L, C) int32
    crcmute: object            # (3, L) int32 device array
    bps: int | None            # packed bytes/sample, None = raw int32


def _bucket_bps(b: Bucket) -> int | None:
    """Packed delivery width: set when every lane agrees on bytes_stored
    and packing actually shrinks the device->host transfer (reference
    analog is the demo's format loop WvDemo.cs:117-141 packing to
    bytes_per_sample)."""
    if b.profile.is_float:
        return None            # float restore delivers 24-bit ints in 4B
    bs = b.bytes_stored
    if len(bs) == 0 or (bs != bs[0]).any():
        return None
    bps = int(bs[0]) + 1
    return bps if bps in (1, 2, 3) else None


def fused_call(b: Bucket):
    """The fused single-dispatch decode of one bucket, unlaunched:
    returns (jitted fn, blob, static kwargs, packed bytes/sample) with
    `fn(blob, **kwargs)` -> (payload, crcmute). wvx buckets take
    fused_decode_wvx, which runs the injection between joint/CRC and the
    final fixup shift (the ordering the reference requires,
    UnpackUtils.cs:1271-1314)."""
    from .fused import build_blob, fused_decode_blob, \
        fused_decode_wvc_blob, fused_decode_wvx_blob

    prof = b.profile
    bps = _bucket_bps(b) if get_options().packed_delivery else None
    names = ["words", "nwords_lane", "nsamples", "med", "slow", "acc",
             "delta", "terms", "deltas16", "wa", "wb", "hist_a",
             "hist_b", "num_terms", "joint", "mute_limit", "shift",
             "bytes_stored", "float_shift_eff", "int32_zod"]
    arrays = [getattr(b, n) for n in names]
    # ship the decorr term arrays trimmed to the bucket's term count
    # (restored to MAX_NTERMS on device) and the int32-range int64
    # arrays narrowed: the history matrices alone are 2 KiB/lane at
    # full width, pure H2D waste on shallow-chain content
    tier = max(int(b.num_terms.max()) if len(b.states) else 1, 1)
    for i in (7, 8, 9, 10):            # (L, 16) -> (L, tier)
        arrays[i] = arrays[i][:, :tier]
    for i in (11, 12):                 # (L, 16, 8) -> (L, tier, 8)
        arrays[i] = arrays[i][:, :tier, :]
    narrow = {3, 4, 6, 11, 12, 15}     # med slow delta hists mute_limit
    kw = dict(mono=prof.mono, hybrid_bitrate=prof.hybrid_bitrate,
              hybrid_balance=prof.hybrid_balance, nsteps=prof.nsteps,
              pack_bps=bps)
    if prof.has_wvc:
        arrays += [b.wvc_words]
        fn = fused_decode_wvc_blob
        kw.update(int32_expand=prof.is_int32)
    elif prof.has_wvx:
        fs = np.asarray([bool(st.flags & consts.FALSE_STEREO)
                         for st in b.states])
        arrays += [b.wvx_words, b.wvx_start_bit, b.wvx_start_bc,
                   b.sent_bits, b.max_width, fs]
        fn = fused_decode_wvx_blob
        kw.update(hybrid=prof.hybrid, has_false_stereo=bool(fs.any()))
    else:
        fn = fused_decode_blob
        kw.update(hybrid=prof.hybrid, is_float=prof.is_float,
                  int32_expand=prof.is_int32)
    blob, metas = build_blob(arrays, narrow)
    kw.update(metas=metas)
    return fn, blob, kw, bps


def _scan_stages(b: Bucket):
    """The XLA scans stage by stage (entropy, decorr, [wvc], post), each
    timed and synced: -> (out, crc, mute, crc_wvc or None)."""
    prof = b.profile
    wvc_mc = wvc_base = None
    with trace.stage("entropy"):
        if prof.has_wvc:
            # hybrid-lossless: the main scan also emits the per-word
            # narrowed intervals the correction scan needs
            residuals, wvc_mc, wvc_base, broke, ndec = entropy_decode(
                b.words, b.nwords_lane, b.med, b.slow, b.acc, b.delta,
                mono=prof.mono, hybrid=True,
                hybrid_bitrate=prof.hybrid_bitrate,
                hybrid_balance=prof.hybrid_balance, nsteps=prof.nsteps,
                wvc=True)
        else:
            residuals, broke, ndec = entropy_decode(
                b.words, b.nwords_lane, b.med, b.slow, b.acc, b.delta,
                mono=prof.mono, hybrid=prof.hybrid,
                hybrid_bitrate=prof.hybrid_bitrate,
                hybrid_balance=prof.hybrid_balance, nsteps=prof.nsteps)
        _sync(residuals)

    with trace.stage("decorr"):
        decorr_out = _sync(decorr_decode(
            residuals, b.terms, b.deltas16, b.wa, b.wb, b.hist_a, b.hist_b,
            b.num_terms, mono=prof.mono))

    if not prof.has_wvc:
        with trace.stage("post"):
            out, crc, mute = joint_mute_crc(
                decorr_out, b.nsamples, b.joint, b.mute_limit, broke,
                mono=prof.mono)
            return _sync(out), crc, mute, None
    with trace.stage("wvc"):
        # corrections add AFTER the decorr chain (linear in the residual
        # for the lossy-driven prediction sequence) and BEFORE the joint
        # undo; int32 add wraps like C#
        from ..ops.entropy import wvc_corrections
        corr = wvc_corrections(b.wvc_words, wvc_mc, wvc_base, residuals)
        exact = decorr_out + corr
    with trace.stage("post"):
        out, crc_wvc, mute = joint_mute_crc(
            exact, b.nsamples, b.joint, b.mute_limit, broke, mono=prof.mono)
        # the wv header crc covers the LOSSY reconstruction
        _, crc, _ = joint_mute_crc(
            decorr_out, b.nsamples, b.joint, b.mute_limit, broke,
            mono=prof.mono)
        return _sync(out), crc, mute, crc_wvc


def launch_bucket(b: Bucket) -> LaunchedBucket:
    """Enqueue one bucket's decode: one fused jit dispatch, or, with
    `sync_stages` (per-stage honest trace timings), each stage on its own
    and synced. Both reach entropy -> decorr -> post through
    ops/backend.py, so both run the lane kernel on the GPU."""
    import jax.numpy as jnp

    prof = b.profile
    if not get_options().sync_stages:
        from . import xferstats
        fn, blob, kw, bps = fused_call(b)
        xferstats.add("h2d", blob.nbytes)
        payload, crcmute = fn(blob, **kw)
        return LaunchedBucket(bucket=b, payload=payload, crcmute=crcmute,
                              bps=bps)

    L = b.words.shape[0]
    crc_wvc_dev = None
    if prof.has_wvc or not backend.use_lane_kernel():
        out, crc, mute, crc_wvc_dev = _scan_stages(b)
    else:
        with trace.stage("decode"):
            out, crc, mute = _sync(backend.decode_post(
                b.words, b.nwords_lane, b.nsamples, b.med, b.slow, b.acc,
                b.delta, b.terms, b.deltas16, b.wa, b.wb, b.hist_a,
                b.hist_b, b.num_terms, b.joint, b.mute_limit,
                mono=prof.mono, hybrid=prof.hybrid,
                hybrid_bitrate=prof.hybrid_bitrate,
                hybrid_balance=prof.hybrid_balance, nsteps=prof.nsteps))

    if prof.has_wvx:
        with trace.stage("wvx"):
            fs = np.asarray([bool(st.flags & consts.FALSE_STEREO)
                             for st in b.states])
            out, crc_x_dev = wvx_inject(
                out, b.nsamples, b.wvx_words, b.wvx_start_bit,
                b.wvx_start_bc, b.sent_bits, b.max_width,
                np.stack([np.asarray([st.int32_zeros for st in b.states]),
                          np.asarray([st.int32_ones for st in b.states]),
                          np.asarray([st.int32_dups for st in b.states])],
                         axis=1).astype(np.int32),
                false_stereo=fs if fs.any() else None)
    else:
        crc_x_dev = jnp.full((L,), -1, jnp.int32)

    with trace.stage("fixup"):
        out = _sync(fixup(out, b.shift, b.bytes_stored, b.float_shift_eff,
                          b.int32_zod,
                          is_float=prof.is_float,
                          int32_expand=prof.is_int32 and not prof.has_wvx,
                          hybrid=prof.hybrid))

    bps = _bucket_bps(b) if get_options().packed_delivery else None
    if bps is not None:
        from ..ops.pack import pack_samples
        payload = pack_samples(out, bps=bps)
    else:
        payload = out
    rows = [jnp.asarray(crc, jnp.int32).astype(jnp.int32),
            jnp.asarray(mute).astype(jnp.int32),
            crc_x_dev.astype(jnp.int32)]
    if crc_wvc_dev is not None:
        rows.append(jnp.asarray(crc_wvc_dev, jnp.int32).astype(jnp.int32))
    crcmute = jnp.stack(rows)
    return LaunchedBucket(bucket=b, payload=payload, crcmute=crcmute,
                          bps=bps)


def _unpack_lane(raw_words: np.ndarray, n_vals: int, bps: int,
                 C: int) -> np.ndarray:
    """Host-side inverse of ops.pack.pack_samples for one lane."""
    by = raw_words.view(np.uint8)[:n_vals * bps]
    if bps == 1:
        v = by.astype(np.int32) - 128
    elif bps == 2:
        v = by.view("<i2").astype(np.int32)
    else:
        b3 = by.reshape(-1, 3).astype(np.int32)
        v = b3[:, 0] | (b3[:, 1] << 8) | (b3[:, 2] << 16)
        v = (v ^ 0x800000) - 0x800000
    return v.reshape(-1, C)


def finalize_bucket(lb: LaunchedBucket,
                    fetched: tuple[np.ndarray, np.ndarray] | None = None
                    ) -> list[DecodedBlock]:
    b = lb.bucket
    prof = b.profile
    if fetched is not None:
        cm, payload_np = fetched
    else:
        with trace.stage("transfer"):
            cm = np.asarray(lb.crcmute)
            payload_np = np.asarray(lb.payload)
    crc_np, mute_np, crc_x = cm[0], cm[1], cm[2]

    C = 1 if prof.mono else 2
    results = []
    for i, st in enumerate(b.states):
        n = int(b.nsamples[i])
        if lb.bps is not None:
            vals = _unpack_lane(payload_np[i], n * C, lb.bps, C)
        else:
            vals = payload_np[:n, i, :]
        if st.flags & consts.FALSE_STEREO:
            vals = np.repeat(vals, 2, axis=1)
        crc_err = (int(crc_np[i]) != st.header.crc
                   or (prof.has_wvx and int(crc_x[i]) != st.crc_mvx))
        crc_wvc = -1
        if prof.has_wvc:
            crc_wvc = int(cm[3][i])
            if st.wvc_crc is not None and crc_wvc != int(b.wvc_crc[i]):
                crc_err = True
        results.append(DecodedBlock(
            samples=np.ascontiguousarray(vals),
            crc=int(crc_np[i]), crc_x=int(crc_x[i]),
            mute_error=bool(mute_np[i]), crc_error=bool(crc_err),
            crc_wvc=crc_wvc, wvc_applied=prof.has_wvc))
    return results


def _start_fetch(arrs: list):
    """Begin ONE device->host transfer for a list of device arrays:
    bitcast each to a flat int32 vector, concatenate on device, and
    start the D2H copy asynchronously (copy_to_host_async) — the
    transfer runs as soon as the producing compute finishes, overlapping
    any later host staging / H2D / compute the caller queues before
    `_finish_fetch` blocks. Returns an opaque (device_blob, metas)
    handle."""
    import jax
    import jax.numpy as jnp

    if not arrs:
        return None, []
    parts, metas = [], []
    for arr in arrs:
        flat = jax.lax.bitcast_convert_type(arr, jnp.int32).reshape(-1)
        parts.append(flat)
        metas.append((flat.size, arr.shape, np.dtype(str(arr.dtype))))
    blob = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    try:
        blob.copy_to_host_async()
    except (AttributeError, NotImplementedError):
        pass                     # backend without async copy: asarray pays it
    return blob, metas


def _finish_fetch(handle) -> list[np.ndarray]:
    blob_dev, metas = handle
    if blob_dev is None:
        return []
    with trace.stage("transfer"):
        blob = np.asarray(blob_dev)
    from . import xferstats
    xferstats.add("d2h", blob.nbytes)
    out, pos = [], 0
    for size, shape, dt in metas:
        out.append(blob[pos:pos + size].view(dt).reshape(shape))
        pos += size
    return out


def _fetch_arrays(arrs: list) -> list[np.ndarray]:
    """ONE device->host transfer for an arbitrary list of device arrays
    (see _start_fetch). Every transfer pays a fixed latency, so
    batching makes delivery cost scale with bytes, not with array
    count."""
    return _finish_fetch(_start_fetch(arrs))


def _fetch_launched(lbs: list[LaunchedBucket]
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
    fetched = _fetch_arrays([a for lb in lbs
                             for a in (lb.crcmute, lb.payload)])
    return [(fetched[2 * i], fetched[2 * i + 1]) for i in range(len(lbs))]


def decode_bucket(b: Bucket) -> list[DecodedBlock]:
    return finalize_bucket(launch_bucket(b))


def decode_states(states: list[BlockState]) -> list[DecodedBlock]:
    """Decode a list of blocks (any mix of profiles) on device: PCM
    buckets and DSD groups are all launched first (device work queues
    asynchronously) and everything — PCM payloads, packed DSD bytes,
    crc/mute vectors — comes back in ONE batched transfer, so a mixed
    corpus pays the fetch latency exactly once."""
    from .dsd_pipeline import finalize_dsd_group, launch_dsd_states

    results: list[DecodedBlock | None] = [None] * len(states)
    pcm_states, pcm_indices = [], []
    dsd_states, dsd_indices = [], []
    for i, st in enumerate(states):
        if st.flags & consts.DSD_FLAG:
            dsd_states.append(st)
            dsd_indices.append(i)
        elif st.header.block_samples == 0:
            results[i] = DecodedBlock(
                samples=np.zeros((0, 1), np.int32), crc=-1, crc_x=-1,
                mute_error=False, crc_error=False)
        else:
            pcm_states.append(st)
            pcm_indices.append(i)
    remap = {id(st): i for st, i in zip(pcm_states, pcm_indices)}
    # chunked pipelining: chunk k's payload fetch starts ASYNC the
    # moment its compute finishes (copy_to_host_async, _start_fetch)
    # and drains while chunk k+1's staging + H2D + compute proceed —
    # D2H overlaps host CPU work always, and H2D too when the link is
    # duplex. Chunks are cut per profile run at a fixed lane count, so
    # each chunk stages to ONE bucket whose compiled fused program is
    # shared by every same-shape chunk (no per-chunk recompiles — the
    # cost that sank the naive order-split chunking). Small corpora stay
    # single-chunk single-fetch.
    CH = get_options().delivery_chunk_blocks
    if CH and len(pcm_states) > CH * 3 // 2:
        from .staging import profile_of
        order = sorted(range(len(pcm_states)),
                       key=lambda i: repr(profile_of(pcm_states[i])))
        chunks, run, run_prof = [], [], None
        for i in order:
            st = pcm_states[i]
            p = profile_of(st)
            if run and (p != run_prof or len(run) >= CH):
                chunks.append(run)
                run = []
            run.append(st)
            run_prof = p
        if run:
            chunks.append(run)
    else:
        chunks = [pcm_states] if pcm_states else []

    def _launch_chunk(chunk_states):
        with trace.stage("staging"):
            buckets = group_blocks(chunk_states)
        return [launch_bucket(bucket) for bucket in buckets]

    dsd_launched = launch_dsd_states(dsd_states) if dsd_states else []

    def _chunk_arrs(lbs, with_dsd):
        arrs = [a for lb in lbs for a in (lb.crcmute, lb.payload)]
        dsd_slots = []
        if with_dsd:
            for ld in dsd_launched:
                dsd_slots.append((len(arrs), ld.payload is not None))
                arrs.append(ld.crcerr)
                if ld.payload is not None:
                    arrs.append(ld.payload)
        return arrs, dsd_slots

    def _launch_and_start(chunk_states, with_dsd):
        lbs = _launch_chunk(chunk_states)
        arrs, dsd_slots = _chunk_arrs(lbs, with_dsd)
        return lbs, _start_fetch(arrs), dsd_slots

    def _consume(lbs, fetched, dsd_slots):
        for k, lb in enumerate(lbs):
            pair = (fetched[2 * k], fetched[2 * k + 1])
            for st, res in zip(lb.bucket.states,
                               finalize_bucket(lb, pair)):
                results[remap[id(st)]] = res
        for ld, (pos, has_payload) in zip(dsd_launched, dsd_slots):
            pair = (fetched[pos],
                    fetched[pos + 1] if has_payload else None)
            for i, res in zip(ld.idxs, finalize_dsd_group(ld, pair)):
                results[dsd_indices[i]] = res

    if not chunks and dsd_launched:
        arrs, dsd_slots = _chunk_arrs([], with_dsd=True)
        _consume([], _finish_fetch(_start_fetch(arrs)), dsd_slots)
    inflight = []
    if chunks:
        inflight.append(_launch_and_start(chunks[0],
                                          with_dsd=len(chunks) == 1))
    for ci in range(len(chunks)):
        if ci + 1 < len(chunks):
            inflight.append(_launch_and_start(
                chunks[ci + 1], with_dsd=(ci + 1 == len(chunks) - 1)))
        lbs, handle, dsd_slots = inflight[ci]
        _consume(lbs, _finish_fetch(handle), dsd_slots)
    if get_options().oracle_check:
        from ..ref import decode_block as oracle_decode
        for st, res in zip(states, results):
            want = oracle_decode(st)
            if not np.array_equal(want.samples, res.samples):
                raise AssertionError(
                    f"oracle mismatch at block {st.header.block_index}")
    return results


def decode_bytes(data: bytes) -> tuple[list, list[DecodedBlock]]:
    """Parse a .wv byte string and decode every block on device."""
    from ..container import parse_blocks
    blocks = parse_blocks(data)
    return blocks, decode_states([b.state for b in blocks])
