"""Benchmark: batch .wv decode throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Primary metric: decoded Msamples/sec/card on BASELINE config 2 (batch of
stereo lossless 16-bit/44.1kHz files), with the FULL fused pipeline on
device (entropy -> decorr -> joint/CRC -> fixup -> PCM byte pack) and every
block's CRC checked against its header — the decoder's built-in
bit-exactness oracle covers the whole corpus each run. Inputs are staged
in device memory before the timed region and only the (L,) CRC vector
leaves the device inside it; the `h2d_seconds` and
`host_delivery_msamples` fields report the transfer-inclusive rates.
vs_baseline is throughput over the derived 100x-realtime floor
4.41 Msamples/s (BASELINE.md; the reference publishes no numbers).
Corpora are cached under the checkout's build/bench directory.
"""

import json
import os
import sys
import time

import numpy as np


def _cache_dir() -> str:
    from wvpk.native import BUILD_DIR
    return os.path.join(BUILD_DIR, "bench")


def make_corpus(n_files: int, seconds: float, block_samples: int,
                seed: int = 0):
    """Synthesize the bench corpus (disk-cached: generation uses the pure-
    Python encoder and costs minutes; the cache key pins all parameters)."""
    import hashlib
    import pickle

    cache_dir = _cache_dir()
    key = hashlib.sha256(
        f"v1:{n_files}:{seconds}:{block_samples}:{seed}".encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"corpus_{key}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    files, n = _generate_corpus(n_files, seconds, block_samples, seed)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump((files, n), f)
    os.replace(tmp, path)
    return files, n


def _generate_corpus(n_files: int, seconds: float, block_samples: int,
                     seed: int):
    from wvpk.testgen import EncodeSpec, encode_file

    rng = np.random.default_rng(seed)
    n = int(44100 * seconds)
    t = np.arange(n)
    files = []
    for i in range(n_files):
        f0 = 220 * (1 + (i % 7))
        sig = (6000 * np.sin(2 * np.pi * f0 * t / 44100)
               + 2500 * np.sin(2 * np.pi * 2.01 * f0 * t / 44100)
               + rng.normal(0, 400, n))
        pcm = np.stack([np.round(sig),
                        np.round(sig * 0.8 + rng.normal(0, 200, n))],
                       axis=1).astype(np.int64)
        np.clip(pcm, -32768, 32767, out=pcm)
        spec = EncodeSpec(block_samples=block_samples, joint=True,
                          terms=(18, 17, 2), deltas=(2, 2, 2))
        files.append(encode_file(pcm, spec))
    return files, n


def main():
    # corpus size: 192 files x 4 s ~= 33.9 M frames
    n_files = int(os.environ.get("WVPK_BENCH_FILES", "192"))
    seconds = float(os.environ.get("WVPK_BENCH_SECONDS", "4.0"))
    block_samples = int(os.environ.get("WVPK_BENCH_BLOCK", "4096"))
    repeats = int(os.environ.get("WVPK_BENCH_REPEATS", "3"))

    import jax

    from wvpk.container import parse_blocks
    from wvpk.engine import decode_states
    from wvpk.engine.fused import fused_decode
    from wvpk.engine.staging import group_blocks
    from wvpk.ops.pack import pack_samples

    t_gen = time.perf_counter()
    files, n = make_corpus(n_files, seconds, block_samples)
    states = []
    for data in files:
        states += [b.state for b in parse_blocks(data)]
    total_samples = sum(st.header.block_samples for st in states)
    buckets = group_blocks(states)
    gen_s = time.perf_counter() - t_gen

    # host delivery: decode_states on a 96-file subset PLUS a DSD slice
    # (modes 1+3), so what's timed is the mixed-codec delivery path:
    # compressed words up (one packed blob per bucket), packed PCM +
    # packed DSD bytes down. Plain best-of-repeats; payload bytes are
    # counted by engine/xferstats.
    from wvpk.engine import xferstats
    host_states = states[:len(states) * 96 // max(n_files, 96)] \
        if n_files > 96 else states
    dsd_files = _cache_blob("dsd_delivery_v1", _make_dsd_delivery)
    dsd_states = []
    for data in dsd_files:
        dsd_states += [b.state for b in parse_blocks(data)]
    host_states = host_states + dsd_states
    host_samples = sum(st.header.block_samples for st in host_states)
    decode_states(host_states)   # warm/compile
    # two delivery modes are measured with the same repeats: the
    # single-batched-fetch path
    # (CH=0) and the pipelined path (fixed-lane chunks + async D2H,
    # engine/pipeline.py), whose fetches overlap later chunks'
    # staging/H2D/compute; the headline is the better of the two and
    # both are reported. Every per-repeat timing lands in the JSON so
    # the best-of-N claim is verifiable from the artifact alone.
    from wvpk import config as _config
    d_repeats = int(os.environ.get("WVPK_BENCH_DELIVERY_REPEATS", "5"))
    d_chunk = int(os.environ.get("WVPK_BENCH_DELIVERY_CHUNK", "768"))
    d_times: dict[int, list] = {0: [], d_chunk: []}
    _config.set_options(delivery_chunk_blocks=d_chunk)
    decode_states(host_states)   # warm/compile the chunked programs
    _config.set_options(delivery_chunk_blocks=0)
    xfer = None
    for _ in range(d_repeats):
        for ch in (0, d_chunk):
            _config.set_options(delivery_chunk_blocks=ch)
            xferstats.reset()
            t0 = time.perf_counter()
            host_results = decode_states(host_states)
            d_times[ch].append(round(time.perf_counter() - t0, 3))
            if xfer is None:
                xfer = dict(xferstats.counters)
            assert not any(r.crc_error for r in host_results)
    _config.set_options(delivery_chunk_blocks=0)
    single_rate = host_samples / min(d_times[0]) / 1e6
    chunked_rate = host_samples / min(d_times[d_chunk]) / 1e6
    host_rate = max(single_rate, chunked_rate)
    delivery = {
        "host_delivery_msamples": round(host_rate, 3),
        "delivery_single_msamples": round(single_rate, 3),
        "delivery_chunked_msamples": round(chunked_rate, 3),
        "delivery_chunk_blocks": d_chunk,
        "d_repeats": d_repeats,
        "delivery_single_s": d_times[0],
        "delivery_chunked_s": d_times[d_chunk],
        "delivery_h2d_mb": round(xfer["h2d"] / 1e6, 1),
        "delivery_d2h_mb": round(xfer["d2h"] / 1e6, 1),
    }

    # stage every bucket's arrays into HBM once, outside the timed region
    names = ("words", "nwords_lane", "nsamples", "med", "slow", "acc",
             "delta", "terms", "deltas16", "wa", "wb", "hist_a", "hist_b",
             "num_terms", "joint", "mute_limit", "shift", "bytes_stored",
             "float_shift_eff", "int32_zod")
    t_h2d = time.perf_counter()
    staged = []
    for b in buckets:
        dev = {k: jax.device_put(getattr(b, k)) for k in names}
        jax.block_until_ready(dev)
        staged.append(dev)
    h2d_s = time.perf_counter() - t_h2d

    import jax.numpy as jnp

    def run_device(rounds=1):
        # enqueue every bucket asynchronously (rounds x over the corpus);
        # the device serializes the compute, and ONE blocking fetch of the
        # cross-bucket concatenated crc/mute array ends the window
        handles = []
        packs = []
        for _ in range(rounds):
            for b, dev in zip(buckets, staged):
                prof = b.profile
                out, crc, mute = fused_decode(
                    *(dev[k] for k in names),
                    mono=prof.mono, hybrid=prof.hybrid,
                    hybrid_bitrate=prof.hybrid_bitrate,
                    hybrid_balance=prof.hybrid_balance,
                    is_float=prof.is_float,
                    int32_expand=prof.is_int32 and not prof.has_wvx,
                    nsteps=prof.nsteps)
                packed = pack_samples(out, bps=2)
                # keep `packed` resident on device; fetch only CRC + mute
                handles.append(jnp.stack([crc.astype(jnp.int32),
                                          mute.astype(jnp.int32)]))
                packs.append(packed)
        cm = np.asarray(jnp.concatenate(handles, axis=1))
        out = []
        pos = 0
        for b, packed in zip(buckets, packs[:len(buckets)]):
            L = len(b.states)
            out.append((cm[0, pos:pos + L], cm[1, pos:pos + L].astype(bool),
                        packed))
            pos += L
        return out

    # warmup / compile
    res = run_device()
    # bit-exactness gate: every block CRC must match its header
    ok = True
    for b, (crc, mute, _p) in zip(buckets, res):
        ok &= not mute.any()
        ok &= (crc == b.hdr_crc).all()
    assert ok, "bench corpus failed the CRC bit-exactness gate"

    # K launch rounds per blocking fetch, same amortization the serving
    # path gets from decode_states' single batched fetch
    launch_rounds = int(os.environ.get("WVPK_BENCH_ROUNDS", "3"))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_device(launch_rounds)
        t1 = time.perf_counter()
        best = min(best, t1 - t0)
    best /= launch_rounds

    # secondary configs: 24-bit 5.1 multichannel (BASELINE config 3),
    # float (config 4) and hybrid lossy (config 5 PCM half), decoded
    # through the same engine
    mc51 = _bench_secondary(_make_mc51, "mc51_v6")
    hyb = _bench_secondary(_make_hybrid, "hybrid_v6")
    flt = _bench_secondary(_make_float, "float_v4")

    # sparse / silence-heavy corpus (the zero-run escape path,
    # WordsUtils.cs:304-352): alternating silence and tone blocks plus
    # an all-silence file, so the entropy kernel's speculative repair
    # body is a measured number instead of an untimed hope
    sparse = _bench_secondary(_make_sparse, "sparse_v1")

    # hybrid-lossless (wvc correction pairs, round-5 surface): the fused
    # entropy + correction-scan + decorr + dual-CRC program, gated on
    # BOTH crcs (wv header = lossy reconstruction, wvc header = exact)
    wvc_ms = _bench_wvc()

    # DSD configs (BASELINE config 5): batch decode of DSD64-stereo
    # blocks, modes 1 (fast) and 3 (high), CRC-gated; realtime factor is
    # vs the DSD64 stereo byte rate (2ch x 2.8224 MHz / 8 = 705600
    # byte-values/s). Mode 1 is measured at BOTH history_bits=2 (the
    # easy table) and history_bits=5 / bins=32, the reference's hardest
    # fast-mode table (DsdUtils.cs:170)
    dsd_fast = _bench_dsd(1)
    dsd_fast_b32 = _bench_dsd(1, history_bits=5)
    dsd_high = _bench_dsd(3)

    # gated hardware differential coverage: a compact randomized
    # mode-matrix sweep (PCM incl. wvx/float + DSD modes) runs against the
    # device kernels every bench run and must be mismatch-free
    if os.environ.get("WVPK_BENCH_SWEEP", "1") != "0":
        from wvpk.testgen.fuzzspec import run_hw_sweep
        sweep_fails, sweep_blocks = run_hw_sweep(
            n_cases=int(os.environ.get("WVPK_BENCH_SWEEP_CASES", "40")),
            n_dsd=8, n_mc=4, verbose=True)
        hw_sweep_ok = sweep_fails == 0
        assert hw_sweep_ok, f"hardware sweep: {sweep_fails} mismatches"
    else:
        hw_sweep_ok, sweep_blocks = None, 0

    # host-side encode rate (native C path; no device involvement).
    # Warm-up + best-of-3 with every repeat recorded: the first call
    # after a multi-GB working-set shift pays page-fault recovery.
    from wvpk.encode import encode as _encode
    rng = np.random.default_rng(7)
    tgrid = np.arange(44100 * 4)
    esig = 8000 * np.sin(2 * np.pi * 440 * tgrid / 44100) \
        + rng.normal(0, 300, tgrid.size)
    epcm = np.clip(np.round(np.stack([esig, esig * 0.7], 1)),
                   -32768, 32767).astype(np.int64)
    _encode(epcm, md5=False)               # warm (page the working set in)
    enc_all = []
    for _ in range(3):
        t_enc = time.perf_counter()
        _encode(epcm, md5=False)
        enc_all.append(round(4.0 / (time.perf_counter() - t_enc), 1))
    enc_rt = max(enc_all)

    # host-side DSD encode rate (native C range/arithmetic coders),
    # DSD64 stereo realtime factor, warm best-of-3
    dsd_enc_rt = _bench_dsd_encode()

    # device-side encode, END TO END: PCM in host memory to finished .wv
    # bytes on host through encode_blocks_device with device-side segment
    # packing (the encode analog of the demo's timed whole-file loop,
    # WvDemo.cs:107-137)
    enc_e2e = _bench_device_encode_e2e()

    msamples = total_samples / best / 1e6
    realtime = (total_samples / 44100) / best
    print(json.dumps({
        "metric": "decode_throughput",
        "value": round(msamples, 3),
        "unit": "Msamples/s/card",
        "vs_baseline": round(msamples / 4.41, 3),
        "realtime_factor": round(realtime, 1),
        "h2d_seconds": round(h2d_s, 2),
        **delivery,
        "mc51_24bit_msamples": mc51,
        "hybrid_msamples": hyb,
        "float_msamples": flt,
        "sparse_msamples": sparse,
        "wvc_msamples": wvc_ms,
        "dsd_fast_realtime_x": dsd_fast,
        "dsd_fast_b32_realtime_x": dsd_fast_b32,
        "dsd_high_realtime_x": dsd_high,
        "encode_realtime_x": enc_rt,
        "encode_realtime_all": enc_all,
        "dsd_encode_realtime_x": dsd_enc_rt,
        "encode_e2e_device_msamples": enc_e2e,
        "hw_sweep_ok": hw_sweep_ok,
        "hw_sweep_blocks": sweep_blocks,
        "corpus_samples": total_samples,
        "blocks": len(states),
        "gen_seconds": round(gen_s, 1),
    }))
    return 0


def _cache_blob(tag: str, builder):
    import pickle
    cache_dir = _cache_dir()
    path = os.path.join(cache_dir, f"{tag}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    data = builder()
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(data, f)
    os.replace(tmp, path)
    return data


def _fill_copies(files, lane_tile: int = 512, min_lanes: int = 1536,
                 max_lanes: int = 2600):
    """Per-class copy counts: group the distinct files by bucket profile
    (the granularity the engine buckets at) and repeat each class so its
    lane count lands within ~2% of a lane_tile multiple. Content stays
    diverse (every distinct signal decodes each round); the copy count
    only sets scale, like the headline's 192-file corpus."""
    from wvpk.container import parse_blocks
    from wvpk.engine.staging import profile_of

    classes: dict[tuple, tuple[list[bytes], int]] = {}
    for f in files:
        sts = [b.state for b in parse_blocks(f)]
        key = profile_of(sts[0])
        fs, n = classes.get(key, ([], 0))
        classes[key] = (fs + [f], n + len(sts))
    out = []
    for fs, per_copy in classes.values():
        k_lo = max(1, -(-min_lanes // per_copy))
        k_hi = max(k_lo, max_lanes // per_copy)

        def pad_frac(k):
            n = k * per_copy
            cap = -(-n // lane_tile) * lane_tile
            return (cap - n) / cap
        k = min(range(k_lo, k_hi + 1), key=pad_frac)
        out += fs * k
    return out


def _make_mc51():
    """8 distinct 5.1 signals (seeds, frequencies, term chains, noise
    floors), replicated per profile class (_fill_copies); distinct
    content keeps the perf claim honest."""
    from wvpk.testgen import EncodeSpec, encode_multichannel
    n = 44100 * 2
    t = np.arange(n)[:, None]
    chains = [(18, 18, 18, 18, 18, 2, 2, 17, 17, 3),
              (18, 17, 18, 17, 2, 3, 5, 18, 2, 17),
              (18, 18, 2, 17, 3), (17, 17, 2, 18, 18, 4, 6, 2, 18, 17)]
    files = []
    for i in range(8):
        rng = np.random.default_rng(700 + i)
        f0 = 180 + 60 * i
        base = 150000 * np.sin(2 * np.pi * f0 * t / 44100) \
            + 40000 * np.sin(2 * np.pi * 2.7 * f0 * t / 44100)
        pcm = np.round(base * rng.uniform(0.3, 1.0, (1, 6))
                       + rng.normal(0, 2000 * (1 + i), (n, 6))) \
            .astype(np.int64)
        np.clip(pcm, -(1 << 23) + 1, (1 << 23) - 1, out=pcm)
        spec = EncodeSpec(block_samples=4096, joint=True, bytes_stored=3,
                          terms=chains[i % 4],
                          deltas=(2,) * len(chains[i % 4]))
        files.append(encode_multichannel(pcm, spec))
    return _fill_copies(files), n


def _make_hybrid():
    """10 distinct hybrid signals (bitrates 256..976, balance on/off,
    varied tones/noise), tile-filled per class (_fill_copies)."""
    from wvpk.testgen import EncodeSpec, encode_file
    n = 44100 * 2
    t = np.arange(n)
    files = []
    for i in range(10):
        rng = np.random.default_rng(800 + i)
        f0 = 200 + 90 * i
        sig = (4000 + 900 * i) * np.sin(2 * np.pi * f0 * t / 44100) \
            + rng.normal(0, 300 + 120 * i, n)
        pcm = np.stack([np.round(sig), np.round(sig * (0.5 + 0.05 * i))],
                       1).astype(np.int64)
        np.clip(pcm, -32768, 32767, out=pcm)
        spec = EncodeSpec(block_samples=4096, joint=True, hybrid=True,
                          hybrid_bitrate=True, bitrate=256 + 80 * i,
                          bitrate_delta=i % 3,
                          hybrid_balance=(i % 3 == 2),
                          terms=(18, 17, 2) if i % 2 else (18, 18, 2, 17, 3),
                          deltas=(2, 2, 2) if i % 2 else (2,) * 5)
        files.append(encode_file(pcm, spec))
    return _fill_copies(files), n


def _make_float():
    """8 distinct float signals (grids norm_exp 127/130, freqs, noise
    scales), tile-filled per class (_fill_copies); decoded-int domain for the float restore path
    (24-bit mantissa scale; FloatUtils.cs:32-56)."""
    from wvpk.testgen import EncodeSpec, encode_file
    n = 44100 * 2
    t = np.arange(n)
    files = []
    for i in range(8):
        rng = np.random.default_rng(900 + i)
        f0 = 260 + 110 * i
        sig = (2 << 20) * (1 + i % 3) * np.sin(2 * np.pi * f0 * t / 44100) \
            + rng.normal(0, 20000 * (1 + i), n)
        pcm = np.stack([np.round(sig), np.round(sig * (0.4 + 0.06 * i))],
                       1).astype(np.int64)
        np.clip(pcm, -(1 << 23) + 1, (1 << 23) - 1, out=pcm)
        spec = EncodeSpec(block_samples=4096, joint=True, float_data=True,
                          bytes_stored=4, float_shift=0,
                          float_max_exp=127 + 3 * (i % 2),
                          float_norm_exp=127 + 3 * (i % 2),
                          terms=(18, 17, 2) if i % 2 else (18, 18, 2, 17, 3),
                          deltas=(2, 2, 2) if i % 2 else (2,) * 5)
        files.append(encode_file(pcm, spec))
    return _fill_copies(files), n


def _make_sparse():
    """Silence-heavy corpus for the zero-run escape path: 8 distinct
    signals whose every other 4096-sample block is digital silence
    (plus scattered intra-block zero gaps) and one all-silence file,
    tile-filled per class (_fill_copies). Silence drives all medians
    below 2, so the entropy kernel's speculative common path mispredicts
    into its whole-iteration repair body (zero-run gammas,
    WordsUtils.cs:304-352) at the highest rate any real content
    produces."""
    from wvpk.testgen import EncodeSpec, encode_file
    n = 44100 * 2
    t = np.arange(n)
    files = []
    for i in range(8):
        rng = np.random.default_rng(1000 + i)
        f0 = 210 + 85 * i
        sig = (5000 + 500 * i) * np.sin(2 * np.pi * f0 * t / 44100) \
            + rng.normal(0, 180 + 40 * i, n)
        pcm = np.stack([np.round(sig), np.round(sig * 0.6)],
                       1).astype(np.int64)
        np.clip(pcm, -32768, 32767, out=pcm)
        for b0 in range(0 if i % 2 else 4096, n, 8192):
            pcm[b0:b0 + 4096] = 0           # every other block silent
        for g0 in range(2048, n, 4096 * 3):
            pcm[g0:g0 + 192 + 32 * i] = 0   # short zero runs inside tone
        spec = EncodeSpec(block_samples=4096, joint=True,
                          terms=(18, 17, 2) if i % 2 else (18, 18, 2, 17, 3),
                          deltas=(2, 2, 2) if i % 2 else (2,) * 5)
        files.append(encode_file(pcm, spec))
    files.append(encode_file(np.zeros((n, 2), np.int64),
                             EncodeSpec(block_samples=4096, joint=True)))
    return _fill_copies(files), n


def _bench_dsd_encode() -> float:
    """Host DSD encode (native C coders, modes 1+3 averaged-worst):
    DSD64 stereo realtime factor, warm best-of-3 on 1 s of content.
    Returns the SLOWER of the two coded modes (the honest promise)."""
    from wvpk.encode import encode_dsd
    rng = np.random.default_rng(31)
    nvals = 705600                       # 1 s of DSD64 stereo byte-values
    d = rng.integers(0, 256, (nvals // 2, 2)).astype(np.uint8)
    worst = float("inf")
    for mode in (1, 3):
        encode_dsd(d, mode, history_bits=2 if mode == 1 else 1)  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            encode_dsd(d, mode, history_bits=2 if mode == 1 else 1)
            best = min(best, time.perf_counter() - t0)
        worst = min(worst, 1.0 / best)
    return round(worst, 1)


def _bench_device_encode_e2e() -> float:
    """END-TO-END device encode in Msamples(frames)/s: PCM in host
    memory -> finished .wv block bytes on host, through the public
    encode_device path (warmup seeding, device scans, device-side
    segment packing, container assembly). Warm best-of-3; the output of
    the warm-up run is decode-gated (CRC-clean + sample-exact)."""
    from wvpk.container import parse_blocks
    from wvpk.encode import encode_device
    from wvpk.engine import decode_states

    rng = np.random.default_rng(21)
    T, nblk = 4096, 64
    tg = np.arange(nblk * T)
    sig = 7000 * np.sin(2 * np.pi * 330 * tg / 44100) \
        + rng.normal(0, 260, tg.size)
    pcm = np.clip(np.round(np.stack([sig, sig * 0.7], 1)),
                  -32768, 32767).astype(np.int64)
    wv = encode_device(pcm, md5=False, block_samples=T)   # warm/compile
    outs = decode_states([b.state for b in parse_blocks(wv)])
    assert not any(r.crc_error or r.mute_error for r in outs), \
        "device e2e encode failed the CRC gate"
    assert np.array_equal(np.concatenate([r.samples for r in outs]), pcm), \
        "device e2e encode roundtrip not sample-exact"
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        encode_device(pcm, md5=False, block_samples=T)
        best = min(best, time.perf_counter() - t0)
    return round(pcm.shape[0] / best / 1e6, 3)


def _make_dsd_delivery():
    """Small DSD slice (modes 1 + 3) folded into the host-delivery corpus
    so the mixed PCM+DSD single-fetch path is what the bench times."""
    from wvpk.testgen import encode_dsd_file
    rng = np.random.default_rng(11)
    files = []
    for mode in (1, 3):
        for _ in range(12):
            d = rng.integers(0, 256, (4096, 2)).astype(np.int64)
            files.append(encode_dsd_file(d, mode, mono=False,
                                         history_bits=2))
    return files


def _bench_dsd(mode: int, history_bits: int = 2) -> float:
    """DSD batch decode realtime factor for one mode (1=fast, 3=high):
    512 stereo 4096-sample blocks through the XLA scans
    (engine/dsd_pipeline.py), CRC-gated, one fetch per round batch.
    history_bits sizes mode 1's per-bin tables (5 -> bins=32, the
    reference's widest fast-mode table, DsdUtils.cs:170)."""
    import jax

    from wvpk.container import parse_blocks
    from wvpk.engine.dsd_pipeline import finalize_dsd_group, \
        launch_dsd_states
    from wvpk.testgen import encode_dsd_file

    L, n = 512, 4096
    rng = np.random.default_rng(40 + mode + history_bits)
    states = []
    for _ in range(L):
        d = rng.integers(0, 256, (n, 2)).astype(np.int64)
        states += [b.state for b in parse_blocks(encode_dsd_file(
            d, mode, mono=False, history_bits=history_bits))]
    total = sum(st.header.block_samples for st in states) * 2
    for ld in launch_dsd_states(states):   # warm/compile + gate
        assert not any(r.crc_error for r in finalize_dsd_group(ld)), \
            f"DSD mode {mode} corpus failed CRC gate"

    def run_rounds(k):
        outs = [ld.crcerr for _ in range(k)
                for ld in launch_dsd_states(states)]
        jax.block_until_ready(outs)

    rounds = 4
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_rounds(rounds)
        best = min(best, time.perf_counter() - t0)
    return round(rounds * total / best / 705600, 1)


def _make_wvc():
    """8 distinct hybrid-lossless (wv, wvc) pairs — bitrates 256..970,
    balance on/off, fast/default presets — replicated to fill lane
    tiles. Returns (pairs, copies)."""
    from wvpk.encode import encode
    n = 44100 * 2
    t = np.arange(n)
    pairs = []
    blocks_per = 0
    for i in range(8):
        rng = np.random.default_rng(1100 + i)
        f0 = 220 + 100 * i
        sig = (4500 + 700 * i) * np.sin(2 * np.pi * f0 * t / 44100) \
            + rng.normal(0, 250 + 140 * i, n)
        pcm = np.stack([np.round(sig), np.round(sig * (0.5 + 0.05 * i))],
                       1).astype(np.int64)
        np.clip(pcm, -32768, 32767, out=pcm)
        wv, wvc = encode(pcm.astype(np.int32), hybrid=True, wvc=True,
                         bitrate=256 + 102 * i,
                         preset="fast" if i % 2 else "default",
                         block_samples=4096, md5=False)
        pairs.append((wv, wvc))
        blocks_per += -(-n // 4096)
    copies = max(1, -(-1536 // blocks_per))
    return pairs, copies


def _bench_wvc(rounds_lo: int = 2, rounds_hi: int = 6) -> float:
    """Hybrid-lossless decode rate: the fused wvc program
    (entropy scan emitting narrowed intervals + cursor-only correction
    scan + decorr + dual-CRC post), rounds-slope methodology as the
    other secondaries, gated on BOTH crcs and mute-free."""
    import jax
    import jax.numpy as jnp

    from wvpk.container import parse_blocks
    from wvpk.container.blocks import pair_wvc
    from wvpk.engine.fused import fused_decode_wvc
    from wvpk.engine.staging import group_blocks

    pairs, copies = _cache_blob("wvc_v1", _make_wvc)
    base_states = []
    for wv, wvc in pairs:
        blks = parse_blocks(wv)
        paired = pair_wvc(blks, wvc)
        assert paired == len(blks)
        base_states += [b.state for b in blks]
    states = base_states * copies
    total = sum(st.header.block_samples for st in states)
    buckets = group_blocks(states)
    names = ("words", "nwords_lane", "nsamples", "med", "slow", "acc",
             "delta", "terms", "deltas16", "wa", "wb", "hist_a", "hist_b",
             "num_terms", "joint", "mute_limit", "shift", "bytes_stored",
             "float_shift_eff", "int32_zod", "wvc_words")
    staged = []
    for b in buckets:
        assert b.profile.has_wvc
        dev = {k: jax.device_put(getattr(b, k)) for k in names}
        jax.block_until_ready(dev)
        staged.append(dev)

    def run(rounds=1):
        handles = []
        for _ in range(rounds):
            for b, dev in zip(buckets, staged):
                prof = b.profile
                _out, crc, mute, crc_wvc = fused_decode_wvc(
                    *(dev[k] for k in names),
                    mono=prof.mono,
                    hybrid_bitrate=prof.hybrid_bitrate,
                    hybrid_balance=prof.hybrid_balance,
                    int32_expand=prof.is_int32,
                    nsteps=prof.nsteps)
                handles.append(jnp.stack([crc.astype(jnp.int32),
                                          mute.astype(jnp.int32),
                                          crc_wvc.astype(jnp.int32)]))
        cm = np.asarray(jnp.concatenate(handles, axis=1))
        out = []
        pos = 0
        for b in buckets:
            out.append(cm[:, pos:pos + len(b.states)])
            pos += len(b.states)
        return out

    res = run()
    for b, cm in zip(buckets, res):
        assert not cm[1].any(), "wvc corpus must decode mute-free"
        assert (cm[0] == b.hdr_crc).all(), "wvc corpus failed lossy CRC"
        assert (cm[2] == b.wvc_crc).all(), "wvc corpus failed exact CRC"
    t = {}
    for k in (rounds_lo, rounds_hi):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(k)
            best = min(best, time.perf_counter() - t0)
        t[k] = best
    per_round = (t[rounds_hi] - t[rounds_lo]) / (rounds_hi - rounds_lo)
    return round(total / per_round / 1e6, 3)


def _bench_secondary(builder, tag: str, rounds_lo: int = 2,
                     rounds_hi: int = 6) -> float:
    """Device decode throughput for a secondary corpus: inputs staged in
    HBM, CRC-gated, measured by the rounds-slope methodology the repo's
    profilers use — time `rounds_lo` and `rounds_hi` back-to-back decode
    launches per blocking fetch and take the slope, which isolates the
    steady-state per-round cost (per-bucket dispatch + compute) from the
    single fixed fetch round trip (which decode_states amortizes across
    arbitrarily large batches with its one batched fetch)."""
    import jax
    import jax.numpy as jnp

    from wvpk.container import parse_blocks
    from wvpk.engine.fused import fused_decode
    from wvpk.engine.staging import group_blocks

    files, _n = _cache_blob(tag, builder)
    parsed: dict[bytes, list] = {}
    states = []
    for data in files:
        if data not in parsed:
            parsed[data] = [b.state for b in parse_blocks(data)]
        states += parsed[data]
    total = sum(st.header.block_samples for st in states)
    buckets = group_blocks(states)
    names = ("words", "nwords_lane", "nsamples", "med", "slow", "acc",
             "delta", "terms", "deltas16", "wa", "wb", "hist_a", "hist_b",
             "num_terms", "joint", "mute_limit", "shift", "bytes_stored",
             "float_shift_eff", "int32_zod")
    staged = []
    for b in buckets:
        dev = {k: jax.device_put(getattr(b, k)) for k in names}
        jax.block_until_ready(dev)
        staged.append(dev)

    def run(rounds=1):
        handles = []
        for _ in range(rounds):
            for b, dev in zip(buckets, staged):
                prof = b.profile
                _out, crc, mute = fused_decode(
                    *(dev[k] for k in names),
                    mono=prof.mono, hybrid=prof.hybrid,
                    hybrid_bitrate=prof.hybrid_bitrate,
                    hybrid_balance=prof.hybrid_balance,
                    is_float=prof.is_float,
                    int32_expand=prof.is_int32 and not prof.has_wvx,
                    nsteps=prof.nsteps)
                handles.append(jnp.stack([crc.astype(jnp.int32),
                                          mute.astype(jnp.int32)]))
        # one cross-bucket fetch
        cm = np.asarray(jnp.concatenate(handles, axis=1))
        out = []
        pos = 0
        for b in buckets:
            out.append(cm[:, pos:pos + len(b.states)])
            pos += len(b.states)
        return out

    res = run()  # warm/compile + gate
    for b, cm in zip(buckets, res):
        assert not cm[1].any(), f"{tag} corpus must decode mute-free"
        assert (cm[0] == b.hdr_crc).all(), f"{tag} corpus failed CRC gate"
    t = {}
    for k in (rounds_lo, rounds_hi):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(k)
            best = min(best, time.perf_counter() - t0)
        t[k] = best
    per_round = (t[rounds_hi] - t[rounds_lo]) / (rounds_hi - rounds_lo)
    return round(total / per_round / 1e6, 3)


if __name__ == "__main__":
    sys.exit(main())
