"""Where `decode_states` spends its time on the headline batch, per step.

    python tools/decode_breakdown.py [--seed N] [--repeats N] [--out DIR]

Runs on a GPU only. For the lane kernel and for the XLA scans (through
`backend._force`, in one process on one card) it times each step of
`decode_states` alone, median of --repeats after one warm-up: parse,
staging, blob build, H2D, device decode (to `block_until_ready`), D2H and
reassembly, beside `decode_states` end to end. Then, with the backend the
platform picks, it decodes one 3-minute track through the CLI (cold and
warm, and once with --trace for the CLI's own stage timings), and takes a
`jax.profiler` trace of one steady `decode_states` call: device busy time
(the union of the GPU planes' events), the lane kernel's own time, and the
busy share of that call's wall time.

Prints the card's name and power limit, then one JSON object per
section. The trace is written to a temporary directory, or to --out.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_time(fn, repeats: int) -> float:
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def step_times(files, repeats: int) -> dict:
    """Median seconds of each step of `decode_states`, each run alone."""
    import jax

    from chip_smoke import file_states
    from wvpk.engine import decode_states
    from wvpk.engine.pipeline import (LaunchedBucket, _fetch_launched,
                                      finalize_bucket, fused_call)
    from wvpk.engine.staging import group_blocks

    _, states = file_states(files)
    buckets = group_blocks(states)
    calls = [fused_call(b) for b in buckets]
    blobs = [jax.block_until_ready(jax.device_put(c[1])) for c in calls]

    def device():
        return jax.block_until_ready(
            [fn(blob, **kw) for (fn, _, kw, _), blob in zip(calls, blobs)])

    outs = device()
    lbs = [LaunchedBucket(bucket=b, payload=p, crcmute=cm, bps=c[3])
           for b, (p, cm), c in zip(buckets, outs, calls)]
    fetched = _fetch_launched(lbs)

    return dict(
        parse=median_time(lambda: file_states(files), repeats),
        staging=median_time(lambda: group_blocks(states), repeats),
        blob_build=median_time(lambda: [fused_call(b) for b in buckets],
                               repeats),
        h2d=median_time(lambda: jax.block_until_ready(
            [jax.device_put(c[1]) for c in calls]), repeats),
        device_decode=median_time(device, repeats),
        d2h=median_time(lambda: _fetch_launched(lbs), repeats),
        reassembly=median_time(lambda: [finalize_bucket(lb, f)
                                        for lb, f in zip(lbs, fetched)],
                               repeats),
        decode_states=median_time(lambda: decode_states(states), repeats),
        buckets=[len(b.states) for b in buckets])


def cli_times(seed: int, seconds: float, workdir: str) -> dict:
    """One track through `wvpk.cli.main`: cold, warm, and the --trace
    stage timings (which sync each stage)."""
    import contextlib
    import io

    from chip_smoke import stereo_pcm
    from wvpk import cli
    from wvpk.encode import encode

    import numpy as np

    pcm = stereo_pcm(np.random.default_rng(seed + 1), int(44100 * seconds),
                     330.0)
    wv = os.path.join(workdir, "x.wv")
    wav = os.path.join(workdir, "x.wav")
    with open(wv, "wb") as f:
        f.write(encode(pcm, block_samples=4096))
    out = {}
    for name, extra in (("cold_s", []), ("warm_s", []),
                        ("trace_s", ["--trace"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            assert cli.main([wv, "-o", wav, *extra]) == 0
        out[name] = time.perf_counter() - t0
        if extra:
            out["trace_report"] = buf.getvalue().splitlines()[-12:]
    out["samples"] = len(pcm)
    return out


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_device(states, out_dir: str) -> dict:
    """Profile one steady `decode_states` call and reduce the trace: the
    GPU planes' busy time, the lane kernel's time, and busy / wall."""
    import jax

    from wvpk.engine import decode_states

    decode_states(states)
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0         # device events and host spans only
    with jax.profiler.trace(out_dir, profiler_options=opts):
        t0 = time.perf_counter()
        decode_states(states)
        wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    spans, kernel_ns, names = [], 0, {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                s = int(ev.start_ns)
                spans.append((s, s + int(ev.duration_ns)))
                names[ev.name] = names.get(ev.name, 0) + int(ev.duration_ns)
                if "lanes_kernel" in ev.name:
                    kernel_ns += int(ev.duration_ns)
    busy = busy_ns(spans)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_s=wall, device_busy_s=busy / 1e9,
                busy_share=busy / 1e9 / wall, lane_kernel_s=kernel_ns / 1e9,
                top_events_s={k[:60]: v / 1e9 for k, v in top}, trace=path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", help="keep the profiler trace here")
    args = ap.parse_args(argv)

    import jax

    import chip_smoke as cs
    from wvpk.ops import backend

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"decode_breakdown: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    print(f"card: {cs.card_info()}", flush=True)
    files, _ = cs.make_headline(args.seed, **cs.HEADLINE)
    for impl in ("kernel", "xla"):
        with backend._force(impl):
            r = step_times(files, args.repeats)
        print(f"steps {impl}: {json.dumps(r)}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        print(f"cli: {json.dumps(cli_times(args.seed, 180.0, d))}",
              flush=True)
    _, states = cs.file_states(files)
    with tempfile.TemporaryDirectory() as d:
        r = trace_device(states, args.out or d)
    print(f"trace: {json.dumps(r)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
