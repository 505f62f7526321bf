"""Device encode: block assembly around the encode kernels.

`encode_blocks_device(pcm, spec)` produces standard WavPack block byte
strings like `testgen.encoder.encode_blocks`, but runs the hot loops
lane-parallel on device (ops/encode_kernels.py) with blocks as lanes —
two scans for lossless (decorrelation inversion + entropy word coding),
one fused reconstruction-feedback scan for hybrid. Each block is seeded fresh
(zero decorr weights/history, block-local quantized medians), so blocks
are independent — the same self-seeding property decode exploits
(SURVEY §2.3). Output streams decode bit-exactly on every decoder path
(oracle + device), and lossless roundtrip is the identity; the byte
stream differs from the host encoders only through the per-block
seeding choice (both are conforming WavPack).

Container assembly (header, metadata quantization, CRC stamp) reuses
the host encoder's helpers so the two encoders cannot drift.
"""

from __future__ import annotations

import numpy as np

from .. import consts, trace
from ..ops.encode_pack import finish_crc
from ..testgen.encoder import (EncodeSpec, EncPass, WordsState, _auto_medians,
                               _crc_fast, _make_words_state, _quantize_decorr,
                               _quantize_entropy, _quantize_hybrid,
                               _stored_domain, mkmeta)

SEG_SLOTS = 2   # segment A (flush/run gamma) + segment B (immediate)


def pack_segments(seg_lo, seg_hi, seg_len, segb_bits, segb_len,
                  tail_bits_list):
    """Scatter per-step variable-length segments into per-lane payloads.

    seg_lo/seg_hi (W, L) uint64 + seg_len (W, L) int32: 128-bit segment A
    per step; segb_bits/segb_len: <=64-bit segment B (emitted after A
    within the step). tail_bits_list: per-lane (bits_bytes, nbits) final
    flush appended at the end. Returns list of payload bytes per lane.
    """
    from .. import native as _native
    res = _native.pack_lanes_native(seg_lo, seg_hi, seg_len, segb_bits,
                                    segb_len, tail_bits_list)
    if res is not None:
        return res

    W, L = seg_len.shape
    lens = np.stack([seg_len, segb_len], axis=1).astype(np.int64)  # (W,2,L)
    flat = lens.transpose(2, 0, 1).reshape(L, W * 2)               # (L, 2W)
    offs = np.zeros_like(flat)
    np.cumsum(flat[:, :-1], axis=1, out=offs[:, 1:])
    total = flat.sum(axis=1)                                       # (L,)

    # tails as one more (lo, hi, len) segment per lane at offset total
    tail_lo = np.zeros(L, np.uint64)
    tail_hi = np.zeros(L, np.uint64)
    tail_len = np.zeros(L, np.int32)
    for lane, (tb, tn) in enumerate(tail_bits_list):
        if tn:
            v = int.from_bytes(tb, "little") & ((1 << tn) - 1)
            tail_lo[lane] = v & 0xFFFFFFFFFFFFFFFF
            tail_hi[lane] = v >> 64
            tail_len[lane] = tn

    nbits = total + tail_len
    nwords = int(nbits.max() + 63) // 64 + 2 if L else 0
    size = L * nwords
    acc = np.zeros(size, np.uint64)

    # one global scatter over all (lane, segment) pairs. Every payload
    # bit is written exactly once, so OR == ADD, and each uint64 word
    # splits into two 32-bit halves whose sums stay < 2^32 — exact in
    # float64 — letting np.bincount (fast C path) do the accumulation
    # instead of the unbuffered np.bitwise_or.at.
    def scatter(idx, vals):
        lo32 = np.bincount(idx, weights=(vals & np.uint64(0xFFFFFFFF))
                           .astype(np.float64), minlength=size)
        hi32 = np.bincount(idx, weights=(vals >> np.uint64(32))
                           .astype(np.float64), minlength=size)
        np.add(acc, lo32.astype(np.uint64)
               + (hi32.astype(np.uint64) << np.uint64(32)), out=acc)

    for offs_x, lo_x, hi_x, len_x in (
            (offs[:, 0::2], seg_lo.T.astype(np.uint64),
             seg_hi.T.astype(np.uint64), seg_len.T),
            (offs[:, 1::2], segb_bits.T.astype(np.uint64),
             np.zeros((L, W), np.uint64), segb_len.T),
            (total[:, None], tail_lo[:, None], tail_hi[:, None],
             tail_len[:, None])):
        m = len_x > 0
        if not m.any():
            continue
        lane_idx = np.nonzero(m)[0]
        pos = np.asarray(offs_x)[m]
        lo = lo_x[m]
        hi = hi_x[m]
        wi = lane_idx * nwords + (pos >> 6)
        sh = (pos & 63).astype(np.uint64)
        inv = np.where(sh > 0, np.uint64(64) - sh, np.uint64(0))
        scatter(wi, lo << sh)
        scatter(wi + 1, np.where(sh > 0, lo >> inv, np.uint64(0))
                | (hi << sh))
        scatter(wi + 2, np.where(sh > 0, hi >> inv, np.uint64(0)))

    buf = acc.reshape(L, nwords)
    return [buf[lane].tobytes()[:(int(nbits[lane]) + 7) // 8]
            for lane in range(L)]


def _final_flush(pvalid, poc, pbits, pnb):
    """EntropyEncoder.finish(): flush the pending word with b = 0, per
    lane, via the host BitWriter (exact same emission code)."""
    from ..testgen.bits import BitWriter
    tails = []
    for v, oc, bits, nb in zip(np.asarray(pvalid), np.asarray(poc),
                               np.asarray(pbits), np.asarray(pnb)):
        bw = BitWriter()
        if v:
            raw = 2 * int(oc)
            if raw < consts.LIMIT_ONES:
                bw.put_unary_ones(raw)
            else:
                bw.put_unary_ones(consts.LIMIT_ONES)
                bw.put_gamma(raw - consts.LIMIT_ONES)
            bw.putbits(int(bits), int(nb))
        tails.append((bw.getvalue(), bw.bit_length()))
    return tails


def _crc_x_fast(vals: np.ndarray, crc0: int = 0xFFFFFFFF) -> int:
    """Closed-form extended CRC: the affine recurrence
    crc_x = crc_x*9 + lo16*3 + hi16 (UnpackUtils.cs:1308) over the
    decoder's post-injection values, evaluated as
    9^M*crc0 + sum 9^(M-1-j)*g_j mod 2^32 (numpy uint32 wraps like C#)."""
    x = vals.astype(np.int64).astype(np.uint32)
    m = x.size
    if m == 0:
        return crc0
    g = ((x & 0xFFFF) * np.uint32(3) + (x >> np.uint32(16)))
    p = np.full(m, 9, np.uint32)
    p[0] = 1
    p = np.multiply.accumulate(p)            # 9^j mod 2^32
    acc = int(np.add.reduce(p[::-1] * g, dtype=np.uint32))
    return (acc + pow(9, m, 1 << 32) * crc0) & 0xFFFFFFFF


def _wvx_meta_fast(spec: EncodeSpec, full_pcm: np.ndarray) -> bytes:
    """Vectorized old-style wvx sidecar for one block: sent_bits low
    bits per value, LSB-first in (time, channel) order, plus the
    closed-form crc_mvx stamp (reference read side
    UnpackUtils.cs:1271-1314; the host encoder's scalar analog is
    testgen/encoder.py::_build_wvx).

    FALSE_STEREO blocks need care: the decoder runs fixup over
    2*block_samples entries with the upper half zeros
    (UnpackUtils.cs:1265), so entries past the written payload read the
    BitWriter zero padding and then the 0xff EOF fill — deterministic
    junk whose crc_x contribution must be reproduced exactly for the
    crc_mvx stamp to verify."""
    assert spec.int32_max_width == 0, "device encoder emits old-style wvx"
    sent = spec.int32_sent_bits
    mask = (1 << sent) - 1
    vals = full_pcm.reshape(-1).astype(np.int64)   # (time, ch) interleave
    lows = (vals & mask).astype(np.uint16)
    bits = ((lows[:, None] >> np.arange(sent, dtype=np.uint16)) & 1)
    payload = np.packbits(bits.reshape(-1).astype(np.uint8),
                          bitorder="little").tobytes()
    if len(payload) & 1:
        payload += b"\x00"
    if spec.false_stereo:
        n = full_pcm.shape[0]
        stream = np.concatenate([
            np.unpackbits(np.frombuffer(payload, np.uint8),
                          bitorder="little"),
            np.ones(2 * n * sent, np.uint8)])[:2 * n * sent]
        data = (stream.reshape(2 * n, sent).astype(np.int64)
                << np.arange(sent, dtype=np.int64)).sum(axis=1)
        # upper-half entries are zeros; injected value == junk data
        dec_vals = np.concatenate([vals, data[n:]])
    else:
        dec_vals = vals
    crc_x = _crc_x_fast(dec_vals)
    return mkmeta(consts.ID_WVX_BITSTREAM,
                  crc_x.to_bytes(4, "little") + payload)


def _zero_underived_slots(p) -> None:
    """Zero the ring slots the decoder does NOT derive from metadata.
    They are write-before-read in the scan (ring terms read slot k at
    sample k, which is written at sample k-term for k >= term), so this
    only normalizes state — outputs are unchanged."""
    t = p.term
    keep = 2 if t > consts.MAX_TERM else (1 if t < 0 else t)
    for k in range(keep, consts.MAX_TERM):
        p.sa[k] = 0
        p.sb[k] = 0


def _prep_targets(pcm, spec: EncodeSpec, stored, starts, L, T, C, mono):
    """Joint transform + lane staging arrays (vectorized; encoder.py
    semantics). Returns (targ, nsamp, targ_d, terms16, deltas16, nt)."""
    bs = spec.block_samples
    targ = np.zeros((L, T, C), np.int64)
    nsamp = np.zeros(L, np.int32)
    for i, s0 in enumerate(starts):
        blk = stored[s0:s0 + bs].astype(np.int64)
        nsamp[i] = blk.shape[0]
        if not mono and (spec.flags() & consts.JOINT_STEREO):
            sd = (blk[:, 0] - blk[:, 1]).astype(np.int32).astype(np.int64)
            blk = np.stack([sd, (blk[:, 1] + (sd >> 1)).astype(np.int32)], 1)
        targ[i, :blk.shape[0]] = blk

    terms16 = np.zeros((L, 16), np.int32)
    deltas16 = np.zeros((L, 16), np.int32)
    nt = np.full(L, len(spec.terms), np.int32)
    terms16[:, :len(spec.terms)] = spec.terms
    deltas16[:, :len(spec.terms)] = spec.deltas
    targ_d = np.ascontiguousarray(targ.transpose(1, 0, 2).astype(np.int32))
    return targ, nsamp, targ_d, terms16, deltas16, nt


def encode_blocks_device(pcm: np.ndarray, spec: EncodeSpec,
                         mesh=None, warmup: int = 0, *,
                         start_sample: int = 0, first: bool = True,
                         last: bool = True,
                         md5_digest: bytes | None = None,
                         pad_to: int | None = None) -> list[bytes]:
    """Encode PCM into WavPack blocks with the device kernels.

    Lossless: two scans (decorr inversion, entropy word coding).
    Hybrid (lossy): one fused scan (`ops/encode_kernels.py::
    hybrid_encode_scan`) — the lossy reconstruction feeds back into the
    decorr state, so the stages cannot split. Hybrid blocks never start
    zero-run escapes (each run gate emits gamma(0) and codes the word;
    always a valid stream, ~2 bits/word above the host encoder in
    digital silence — a documented tradeoff like fresh seeding).

    Wide-32-bit content (int32_mode == "wvx") emits the sent-bits
    low-bit sidecar per block (ID_WVX_BITSTREAM + crc_mvx,
    UnpackUtils.cs:1271-1314): the device scans code the stored high
    bits while the sidecar is packed vectorized on host (pure
    elementwise bit packing — no serial state, so it costs no device
    round trip and shards trivially).

    Restrictions (fall back to the host encoders otherwise): hybrid
    excludes float/int32 content; stored magnitudes < 2^27 (keeps
    medians in the non-wrapping regime the kernels contract on). Both lossless and hybrid shard over a
    `jax.sharding.Mesh` (pure lane data-parallelism), with or without
    warmup — the warm lookahead scan shards the same way
    (`sharded_invert_warm_state`), so sharded output is block-identical
    to unsharded at any warmup.

    Batch positioning (the streaming encoder's hooks; blocks are
    independent lanes, so a file can be emitted in any lane batching):
    `start_sample` offsets the headers' block_index; `first`/`last`
    gate the file-level metadata (RIFF header / MD5 + trailer);
    `md5_digest` supplies a precomputed whole-file digest when `pcm` is
    only this batch's window (spec.total_samples_override must then
    carry the file total). `pad_to` (the file total) pins the lane
    padding T to what a whole-file batch would use: the warm seeding
    scan adapts over min(warmup, T) steps INCLUDING a short last
    block's zero padding, so a window must pad like the batch for its
    bytes to stay split-invariant.
    """
    from ..ops.encode_kernels import decorr_invert_warm, \
        entropy_encode_words, hybrid_encode_scan

    hybrid = bool(spec.hybrid)
    if hybrid and (spec.float_data or spec.int32_mode is not None):
        raise ValueError("device encoder: hybrid is plain-PCM only")
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    assert pcm.shape[1] == spec.nch_data
    mono = spec.nch_data == 1
    stored = _stored_domain(pcm, spec)
    if stored.size and int(np.abs(stored).max()) >= (1 << 27):
        raise ValueError("device encoder: stored magnitude >= 2^27")
    n = pcm.shape[0]
    bs = spec.block_samples
    starts = list(range(0, n, bs))
    L = len(starts)
    C = 1 if mono else 2
    T = min(bs, max(n, pad_to or 0))

    # joint transform per block (vectorized; encoder.py semantics)
    with trace.stage("enc_prep"):
        targ, nsamp, targ_d, terms16, deltas16, nt = _prep_targets(
            pcm, spec, stored, starts, L, T, C, mono)
    import time as _time
    _t = _time.perf_counter()
    # per-block seeds: fresh (zeros) or WARM — adapt the decorr state
    # over the block's own first `warmup` samples on device, quantize it
    # exactly like the metadata stores it, and seed the main scan with
    # the decoder-derived values (a lookahead-adaptation strategy that
    # recovers most of the fresh-seed compression cost while keeping
    # blocks independent lanes)
    np_ = len(spec.terms)
    wfa = wfb = np.zeros((L, 16), np.int64)
    hfa = hfb = np.zeros((L, 16, 8), np.int64)
    if warmup > 0 and np_ > 0:
        K = min(warmup, T)
        if mesh is not None:
            from ..parallel.mesh import sharded_invert_warm_state
            wa_f, wb_f, ha_f, hb_f = sharded_invert_warm_state(
                targ_d[:K], terms16, deltas16, nt, mesh, mono=mono)
        else:
            _, (wa_f, wb_f, ha_f, hb_f) = decorr_invert_warm(
                targ_d[:K], terms16, deltas16, nt,
                wfa, wfb, hfa, hfb, mono=mono, with_state=True)
        m_fin = K & 7
        rot = (np.arange(8) + m_fin) & 7          # _rotate_ring order
        wfa, wfb = np.asarray(wa_f), np.asarray(wb_f)
        hfa = np.asarray(ha_f)[:, :, rot]
        hfb = np.asarray(hb_f)[:, :, rot]
        warm = True
    else:
        warm = False
    _t = trace.mark("enc_warm", _t)

    med0 = np.zeros((L, 2, 3), np.int64)
    slow0 = np.zeros((L, 2), np.int64)
    acc0 = np.zeros((L, 2), np.int64)
    delta0 = np.zeros((L, 2), np.int64)
    w0a = np.zeros((L, 16), np.int64)
    w0b = np.zeros((L, 16), np.int64)
    h0a = np.zeros((L, 16, 8), np.int64)
    h0b = np.zeros((L, 16, 8), np.int64)
    metas = []
    for i, s0 in enumerate(starts):
        passes = [EncPass(t, d) for t, d in zip(spec.terms, spec.deltas)]
        if warm:
            for j, p in enumerate(passes):
                p.wa, p.wb = int(wfa[i, j]), int(wfb[i, j])
                p.sa = [int(x) for x in hfa[i, j]]
                p.sb = [int(x) for x in hfb[i, j]]
        w = _make_words_state(spec, _auto_medians(
            _stored_domain(pcm[s0:s0 + bs], spec)))
        tmd, wmd, smd = _quantize_decorr(passes, mono)
        emd = _quantize_entropy(w, mono)      # quantizes w's medians too
        hmd = None
        if hybrid:
            # quantizes w's slow_level/bitrate state too (encoder.py:504)
            hmd = mkmeta(consts.ID_HYBRID_PROFILE,
                         _quantize_hybrid(spec, w, mono))
            if spec.version == 0x402:
                # v4.02 hybrid prepends 2 bytes/channel that readers
                # skip (UnpackUtils.cs:277-283)
                smd = b"\x00\x00" * (1 if mono else 2) + smd
            slow0[i] = (w.c[0].slow_level, w.c[1].slow_level)
            acc0[i] = w.bitrate_acc
            delta0[i] = w.bitrate_delta
        if warm:
            for j, p in enumerate(passes):
                _zero_underived_slots(p)
                w0a[i, j], w0b[i, j] = p.wa, p.wb
                h0a[i, j] = p.sa
                h0b[i, j] = p.sb
        med0[i, 0] = w.c[0].median
        med0[i, 1] = w.c[1].median
        metas.append((tmd, wmd, smd, emd, hmd))

    _t = trace.mark("enc_meta", _t)
    # device: residuals, then the entropy word automaton (optionally
    # lane-sharded over a jax.sharding.Mesh — pure data parallelism)
    nvals = nsamp * C
    recon = None
    if hybrid:
        if mesh is not None:
            from ..parallel.mesh import sharded_hybrid_encode_scan
            out = sharded_hybrid_encode_scan(
                targ_d, terms16, deltas16, nt, med0, slow0, acc0, delta0,
                nvals, w0a, w0b, h0a, h0b, mesh, mono=mono,
                hybrid_bitrate=bool(spec.hybrid_bitrate),
                hybrid_balance=bool(spec.hybrid_balance))
        else:
            out = hybrid_encode_scan(
                targ_d, terms16, deltas16, nt, med0, slow0, acc0, delta0,
                nvals, w0a, w0b, h0a, h0b, mono=mono,
                hybrid_bitrate=bool(spec.hybrid_bitrate),
                hybrid_balance=bool(spec.hybrid_balance))
        segs, recon_dev = out[:9], out[9]
    elif mesh is not None:
        from ..parallel.mesh import sharded_encode_scans
        segs = sharded_encode_scans(targ_d, terms16, deltas16, nt, med0,
                                    nvals, mesh, mono=mono,
                                    seeds=(w0a, w0b, h0a, h0b))
    else:
        res = decorr_invert_warm(targ_d, terms16, deltas16, nt,
                                 w0a, w0b, h0a, h0b, mono=mono)
        words = res.transpose(0, 2, 1).reshape(T * C, L)
        segs = entropy_encode_words(words, med0, nvals, mono=mono)
    _t = trace.mark("enc_scan", _t)
    from ..config import get_options
    recon = crc_acc = None
    if get_options().encode_device_pack and mesh is None:
        # device-side packing: ONE small batched fetch (per-lane bit
        # totals + pending-flush state + the hybrid CRC accumulator) +
        # the dense payload fetch, instead of ~16 B of sparse segment
        # descriptors per value (and, for hybrid, the whole (T, L, C)
        # reconstruction fetched only to stamp CRCs)
        import jax.numpy as jnp

        from ..ops.encode_pack import hybrid_crc_acc, \
            pack_segments_device, segment_total_bits
        rows = [segment_total_bits(segs[2], segs[4]).astype(jnp.uint64),
                segs[5].astype(jnp.uint64), segs[6].astype(jnp.uint64),
                segs[7].astype(jnp.uint64), segs[8].astype(jnp.uint64)]
        if hybrid:
            rows.append(hybrid_crc_acc(
                recon_dev, jnp.asarray(nvals),
                joint=bool(spec.flags() & consts.JOINT_STEREO),
                mono=mono).astype(jnp.uint64))
        small = np.asarray(jnp.stack(rows))
        total, pvalid, poc, pbits, pnb = small[:5]
        if hybrid:
            crc_acc = small[5].astype(np.uint32)
        _t = trace.mark("enc_fetch", _t)
        payloads = pack_segments_device(
            segs[:5], _final_flush(pvalid.astype(bool), poc,
                                   pbits, pnb),
            total=total.astype(np.int64))
    else:
        if hybrid:
            recon = np.asarray(recon_dev).astype(np.int64)
        (sa_lo, sa_hi, sa_len, sb_bits, sb_len, pvalid, poc, pbits,
         pnb) = [np.asarray(x) for x in segs]
        _t = trace.mark("enc_fetch", _t)

        payloads = pack_segments(sa_lo, sa_hi, sa_len, sb_bits, sb_len,
                                 _final_flush(pvalid, poc, pbits, pnb))

    _t = trace.mark("enc_pack", _t)
    # container assembly (mirrors encoder.py::encode_block)
    total = spec.total_samples_override
    if total is None:
        total = n
    out = []
    for i, s0 in enumerate(starts):
        tmd, wmd, smd, emd, hmd = metas[i]
        nb = int(nsamp[i])
        blk_targ = targ[i, :nb]
        # MAG from the PRE-joint stored values: the decoder's mute limit
        # (2^mag + 2, UnpackUtils.cs:517; hybrid doubles it) checks the
        # joint-UNDONE values
        blk_stored = stored[s0:s0 + nb]
        maxabs = int(np.max(np.abs(blk_stored))) if nb else 0
        flags = (spec.flags() | consts.INITIAL_BLOCK | consts.FINAL_BLOCK
                 | (min(maxabs.bit_length(), 30) << consts.MAG_LSB))
        mdl = [mkmeta(consts.ID_DECORR_TERMS, tmd),
               mkmeta(consts.ID_DECORR_WEIGHTS, wmd),
               mkmeta(consts.ID_DECORR_SAMPLES, smd),
               mkmeta(consts.ID_ENTROPY_VARS, emd)]
        if hmd is not None:
            mdl.append(hmd)
        if spec.float_data:
            mdl.append(mkmeta(consts.ID_FLOAT_INFO,
                              bytes([spec.float_flags, spec.float_shift,
                                     spec.float_max_exp,
                                     spec.float_norm_exp])))
        if spec.int32_mode is not None:
            mdl.append(mkmeta(consts.ID_INT32_INFO,
                              bytes([spec.int32_sent_bits, spec.int32_zeros,
                                     spec.int32_ones, spec.int32_dups])))
        if spec.sample_rate not in consts.SAMPLE_RATES:
            mdl.append(mkmeta(consts.ID_SAMPLE_RATE,
                              (spec.sample_rate & 0xFFFFFF)
                              .to_bytes(3, "little")))
        if i == 0 and first and spec.config_flags:
            cf = spec.config_flags
            mdl.append(mkmeta(consts.ID_CONFIG_BLOCK,
                              bytes([(cf >> 8) & 0xFF, (cf >> 16) & 0xFF,
                                     (cf >> 24) & 0xFF])))
        if i == 0 and first and spec.riff_header is not None:
            mdl.append(mkmeta(consts.ID_RIFF_HEADER, spec.riff_header))
        mdl.append(mkmeta(consts.ID_WV_BITSTREAM, payloads[i]))
        if spec.int32_mode == "wvx" and spec.int32_sent_bits:
            # sent-bits low-bit sidecar, built vectorized on host (pure
            # elementwise packing; the device scans code the stored
            # high bits above)
            mdl.append(_wvx_meta_fast(spec, pcm[s0:s0 + nb]))
        if i == L - 1 and last and spec.md5:
            digest = md5_digest
            if digest is None:
                import hashlib

                from ..io.pcm import format_samples
                outp = (pcm if not spec.false_stereo
                        else np.repeat(pcm, 2, 1))
                digest = hashlib.md5(
                    format_samples(outp, spec.bytes_stored)).digest()
            mdl.append(mkmeta(consts.ID_MD5_CHECKSUM, digest))
        if i == L - 1 and last and spec.riff_trailer is not None:
            mdl.append(mkmeta(consts.ID_RIFF_TRAILER, spec.riff_trailer))
        body = b"".join(mdl)
        from ..container.header import HEADER_SIZE
        header = bytearray(HEADER_SIZE)
        header[0:4] = b"wvpk"
        header[4:8] = (HEADER_SIZE + len(body) - 8).to_bytes(4, "little")
        header[8:10] = spec.version.to_bytes(2, "little")
        bidx = s0 + start_sample
        header[10] = (bidx >> 32) & 0xFF
        header[11] = (total >> 32) & 0xFF
        header[12:16] = (total & 0xFFFFFFFF).to_bytes(4, "little")
        header[16:20] = (bidx & 0xFFFFFFFF).to_bytes(4, "little")
        header[20:24] = nb.to_bytes(4, "little")
        header[24:28] = flags.to_bytes(4, "little")
        # lossless: decoded == targets, so the CRC is closed-form over
        # the joint-undone targets (same as encoder.py's fast stamp);
        # hybrid: over the scan's lossy reconstruction (what the
        # decoder's crc*3 accumulation sees, UnpackUtils.cs:577,626)
        if crc_acc is not None and hybrid:
            crc_val = finish_crc(int(crc_acc[i]), nb * C)
        else:
            final = recon[:nb, i, :] if hybrid else blk_targ
            if not mono and (flags & consts.JOINT_STEREO):
                r = (final[:, 1] - (final[:, 0] >> 1)).astype(np.int32)
                left = (final[:, 0] + r).astype(np.int32)
                final = np.stack([left, r], 1)
            crc_val = _crc_fast(final)
        header[28:32] = crc_val.to_bytes(4, "little")
        block = bytes(header) + body
        if spec.block_checksum:
            from ..container.checksum import add_block_checksum
            block = add_block_checksum(block, spec.block_checksum)
        out.append(block)
    trace.mark("enc_assemble", _t)
    return out


def encode_multichannel_device(pcm: np.ndarray, spec: EncodeSpec,
                               channel_mask: int | None = None,
                               warmup: int = 0, mesh=None, *,
                               start_sample: int = 0, first: bool = True,
                               last: bool = True,
                               md5_digest: bytes | None = None,
                               pad_to: int | None = None) -> bytes:
    """Device encode of a >2ch segment (INITIAL..FINAL stream runs with
    ID_CHANNEL_INFO, like testgen.multichannel.encode_multichannel).
    Each stream's blocks are one device lane batch; streams are encoded
    independently (self-seeded) and their blocks interleaved per time
    window. The keyword hooks position `pcm` as one window of a larger
    stream (see encode_blocks_device); device blocks are independent
    lanes, so any window split is byte-identical to the batch."""
    from ..testgen.multichannel import (_inject_metadata,
                                        _set_segment_flags, split_streams,
                                        stream_specs)

    n, nch = pcm.shape
    assert nch > 2
    widths = split_streams(nch)
    if channel_mask is None:
        channel_mask = (1 << nch) - 1

    from dataclasses import replace
    stream_blocks = []
    off = 0
    for si, (w, sspec) in enumerate(zip(widths, stream_specs(spec, nch))):
        # file-level metadata rides specific segment slots: the RIFF
        # header on the first stream's first block, the trailer on the
        # last stream's last block, the MD5 injected below
        sspec = replace(
            sspec, md5=False,
            riff_header=spec.riff_header if si == 0 else None,
            riff_trailer=spec.riff_trailer if si == len(widths) - 1
            else None)
        stream_blocks.append(encode_blocks_device(
            pcm[:, off:off + w], sspec, mesh=mesh, warmup=warmup,
            start_sample=start_sample, first=first, last=last,
            pad_to=pad_to))
        off += w

    chan_info = bytes([nch]) + channel_mask.to_bytes(
        max(1, (channel_mask.bit_length() + 7) // 8), "little")
    digest = md5_digest
    if spec.md5 and last and digest is None:
        import hashlib

        from ..io.pcm import format_samples
        digest = hashlib.md5(format_samples(
            pcm, spec.bytes_stored)).digest()

    out = bytearray()
    nwin = len(stream_blocks[0])
    for win in range(nwin):
        for si in range(len(widths)):
            blk = stream_blocks[si][win]
            blk = _set_segment_flags(blk, initial=(si == 0),
                                     final=(si == len(widths) - 1))
            if first and win == 0 and si == 0:
                blk = _inject_metadata(
                    blk, mkmeta(consts.ID_CHANNEL_INFO, chan_info))
            if spec.md5 and digest is not None and last \
                    and win == nwin - 1 and si == len(widths) - 1:
                blk = _inject_metadata(
                    blk, mkmeta(consts.ID_MD5_CHECKSUM, digest))
            if spec.block_checksum:
                from ..container.checksum import add_block_checksum
                blk = add_block_checksum(blk, spec.block_checksum)
            out += blk
    return bytes(out)
