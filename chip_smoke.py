"""Smoke test of wvpk's decode path on one NVIDIA GPU.

    python chip_smoke.py [--seed N]      # one card: every phase below
    python chip_smoke.py --cards 4       # four cards: the sharded path only

One card, in one process, every result checked bit-exactly:

1. headline batch: 192 files x 4 s of 16-bit/44.1 kHz stereo in
   4096-sample blocks (encoded by the host C encoder from --seed) through
   `decode_states`; every sample equals the source and every block CRC
   passes;
2. CLI and API: a 3-minute stereo track through `wvpk.cli.main` (the
   `python -m wvpk.cli x.wv -o x.wav` entry point) checked byte-exactly,
   and `WavpackOpenFileInput` / `WavpackUnpackSamples` with one seek;
3. mode matrix: a few blocks of every codec family through
   `decode_states`, checked against the scalar oracle `wvpk.ref`;
4. device encode: one `encode_device` roundtrip;
5. kernel comparison: the headline batch through `decode_states` with
   the CUDA lane kernel and with the XLA scans; outputs bit-equal,
   medians printed.

With --cards 4 it runs only the sharded path: the headline batch and the
mixed corpus through `sharded_decode_states` on a 4-device mesh, compared
with single-card `decode_states` and the source, plus sharded
`encode_device` block-identical to unsharded.

Earlier lines print the card's name and power limit, the compile and run
seconds of each phase and the headline bucket's memory analysis. The last
line is one JSON object with the device as JAX reports it. The script
exits non-zero, printing no result, where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HEADLINE = dict(n_files=192, seconds=4.0, block_samples=4096)


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def log(msg: str) -> None:
    print(msg, flush=True)


def stereo_pcm(rng, n: int, f0: float) -> np.ndarray:
    """Two correlated tones plus noise, 16-bit stereo (n, 2) int64."""
    t = np.arange(n)
    sig = (6000 * np.sin(2 * np.pi * f0 * t / 44100)
           + 2500 * np.sin(2 * np.pi * 2.01 * f0 * t / 44100)
           + rng.normal(0, 400, n))
    pcm = np.stack([np.round(sig),
                    np.round(sig * 0.8 + rng.normal(0, 200, n))], axis=1)
    return np.clip(pcm, -32768, 32767).astype(np.int64)


def make_headline(seed: int, n_files: int, seconds: float,
                  block_samples: int):
    """Encode the headline batch with the host C encoder: returns
    (list of .wv bytes, list of source PCM)."""
    from wvpk.encode import encode

    rng = np.random.default_rng(seed)
    n = int(44100 * seconds)
    files, pcms = [], []
    for i in range(n_files):
        pcm = stereo_pcm(rng, n, 220 * (1 + i % 7))
        files.append(encode(pcm, block_samples=block_samples, md5=False))
        pcms.append(pcm)
    return files, pcms


def file_states(files):
    from wvpk.container import parse_blocks

    per_file = [[b.state for b in parse_blocks(d)] for d in files]
    return per_file, [st for sts in per_file for st in sts]


def check_against_source(per_file, results, pcms, what: str) -> None:
    pos = 0
    for k, (sts, pcm) in enumerate(zip(per_file, pcms)):
        res = results[pos:pos + len(sts)]
        pos += len(sts)
        bad = [i for i, r in enumerate(res) if r.crc_error or r.mute_error]
        assert not bad, f"{what}: file {k} blocks {bad} fail their CRC"
        got = np.concatenate([r.samples for r in res])
        assert np.array_equal(got, pcm), f"{what}: file {k} != source"


def same_results(a, b, what: str) -> None:
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x.samples, y.samples), f"{what}: block {i}"
        assert (x.crc, x.crc_x, x.mute_error, x.crc_error, x.crc_wvc) == \
            (y.crc, y.crc_x, y.mute_error, y.crc_error, y.crc_wvc), \
            f"{what}: block {i} CRC/mute"


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


# --------------------------------------------------------------------------
# phases (each takes its sizes, so the tests can run them small on a CPU)
# --------------------------------------------------------------------------

def phase_headline(files, pcms) -> dict:
    """Decode the batch through `decode_states`, check it against the
    source, and report the fused program's memory analysis."""
    from wvpk.engine import decode_states
    from wvpk.engine.pipeline import fused_call
    from wvpk.engine.staging import group_blocks

    per_file, states = file_states(files)
    buckets = group_blocks(states)
    fn, blob, kw, _ = fused_call(max(buckets, key=lambda b: len(b.states)))
    t0 = time.perf_counter()
    compiled = fn.lower(blob, **kw).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    results, first_s = timed(decode_states, states)
    check_against_source(per_file, results, pcms, "headline")
    results, steady_s = timed(decode_states, states)
    check_against_source(per_file, results, pcms, "headline (repeat)")
    samples = sum(len(p) for p in pcms)
    return dict(blocks=len(states), buckets=len(buckets),
                lanes=max(len(b.states) for b in buckets), samples=samples,
                compile_s=compile_s, first_s=first_s, steady_s=steady_s,
                memory_analysis=str(mem))


def phase_cli_api(seed: int, seconds: float, workdir: str) -> dict:
    """Encode one track, decode it through the CLI entry point and check
    the WAV byte-exactly; read it through the API with one seek."""
    from wvpk import api, cli
    from wvpk.encode import encode
    from wvpk.io.wav import make_wav_header

    rng = np.random.default_rng(seed + 1)
    n = int(44100 * seconds)
    pcm = stereo_pcm(rng, n, 330.0)
    wv = os.path.join(workdir, "x.wv")
    wav = os.path.join(workdir, "x.wav")
    with open(wv, "wb") as f:
        f.write(encode(pcm, block_samples=HEADLINE["block_samples"]))
    rc, cli_s = timed(cli.main, [wv, "-o", wav])
    assert rc == 0, f"CLI exit code {rc}"
    blob = open(wav, "rb").read()
    hdr = make_wav_header(n, 2, 44100, 16, 2)
    assert blob[:len(hdr)] == hdr, "WAV header"
    got = np.frombuffer(blob[len(hdr):], "<i2").reshape(-1, 2)
    assert np.array_equal(got, pcm), "CLI WAV samples != source"

    wpc = api.WavpackOpenFileInput(wv)
    assert api.WavpackGetNumSamples(wpc) == n
    k = min(4096 * 3, n)
    buf = np.zeros(k * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, k) == k
    assert np.array_equal(buf.reshape(-1, 2), pcm[:k]), "API head"
    seek = n // 2 + 1234
    assert api.SetSample(wpc, seek)
    k2 = min(5000, n - seek)
    buf = np.zeros(k2 * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, k2) == k2
    assert np.array_equal(buf.reshape(-1, 2), pcm[seek:seek + k2]), \
        "API after seek"
    return dict(samples=n, cli_s=cli_s)


def mode_matrix(seed: int, n_devices: int = 1) -> dict:
    """.wv byte strings of every codec family, a few blocks each."""
    from __graft_entry__ import _mixed_corpus
    from wvpk.encode import encode
    from wvpk.testgen import encode_dsd_file

    fams, dsd = _mixed_corpus(n_devices)
    rng = np.random.default_rng(seed + 2)
    fams.update(dsd)
    pcm51 = np.round(rng.normal(0, 1 << 18, (64 * 5, 6))).astype(np.int64)
    fams["mc51_24bit"] = encode(pcm51, bytes_per_sample=3, block_samples=64)
    wv, wvc = encode(stereo_pcm(rng, 64 * 5, 500.0), hybrid=True,
                     bitrate=400, wvc=True, block_samples=64)
    fams["wvc"] = (wv, wvc)
    fams["dsd_mode0"] = encode_dsd_file(
        rng.integers(0, 256, (64 * 4, 2)).astype(np.int64), 0, mono=False)
    return fams


def family_states(data):
    from wvpk.container import parse_blocks
    from wvpk.container.blocks import pair_wvc

    if isinstance(data, tuple):
        wv, wvc = data
        blocks = parse_blocks(wv)
        assert pair_wvc(blocks, wvc) == len(blocks)
    else:
        blocks = parse_blocks(data)
    return [b.state for b in blocks]


def check_oracle(states, results, fam: str) -> None:
    from wvpk.ref import decode_block

    for i, (st, r) in enumerate(zip(states, results)):
        want = decode_block(st)
        assert np.array_equal(r.samples, want.samples), f"{fam} block {i}"
        assert r.mute_error == want.mute_error, f"{fam} block {i} mute"
        assert r.crc_error == want.crc_error, f"{fam} block {i} crc"
        assert not r.crc_error, f"{fam} block {i} fails its CRC"


def phase_modes(seed: int) -> dict:
    from wvpk.engine import decode_states

    out = {}
    for fam, data in mode_matrix(seed).items():
        states = family_states(data)
        results, s = timed(decode_states, states)
        check_oracle(states, results, fam)
        out[fam] = dict(blocks=len(states), first_s=round(s, 3))
    return out


def phase_device_encode(seed: int, seconds: float) -> dict:
    from wvpk.encode import encode_device
    from wvpk.engine import decode_states

    rng = np.random.default_rng(seed + 3)
    pcm = stereo_pcm(rng, int(44100 * seconds), 440.0)
    data, enc_s = timed(encode_device, pcm)
    _, states = file_states([data])
    results = decode_states(states)
    check_against_source([states], results, [pcm], "device encode")
    return dict(samples=len(pcm), blocks=len(states), encode_s=enc_s)


def phase_kernel_vs_xla(files, pcms, repeats_kernel: int,
                        repeats_xla: int) -> dict:
    """`decode_states` on the same batch with the CUDA lane kernel and
    with the XLA scans: bit-equal outputs, and the median wall time of
    each (host bytes in, checked PCM out; compilation excluded). Beside
    it the device layer alone: the largest bucket's fused program on a
    blob already in device memory, timed to `block_until_ready`."""
    import jax

    from wvpk.engine import decode_states
    from wvpk.engine.pipeline import fused_call
    from wvpk.engine.staging import group_blocks
    from wvpk.ops import backend

    per_file, states = file_states(files)
    big = max(group_blocks(states), key=lambda b: len(b.states))
    fn, blob, kw, _ = fused_call(big)
    blob = jax.device_put(blob)

    def device_run():
        return jax.block_until_ready(fn(blob, **kw))

    runs, outs = {}, {}
    for impl, reps in (("kernel", repeats_kernel), ("xla", repeats_xla)):
        with backend._force(impl):
            outs[impl], first = timed(decode_states, states)
            times = [timed(decode_states, states)[1] for _ in range(reps)]
            device_run()
            device = [timed(device_run)[1] for _ in range(reps)]
        check_against_source(per_file, outs[impl], pcms, impl)
        runs[impl] = dict(first_s=first, times_s=times,
                          median_s=statistics.median(times),
                          device_times_s=device,
                          device_median_s=statistics.median(device))
    same_results(outs["kernel"], outs["xla"], "kernel vs xla")
    samples = sum(len(p) for p in pcms)
    for r in runs.values():
        r["msamples_per_s"] = samples / r["median_s"] / 1e6
    runs["device_lanes"] = len(big.states)
    runs["speedup"] = runs["xla"]["median_s"] / runs["kernel"]["median_s"]
    runs["device_speedup"] = (runs["xla"]["device_median_s"]
                              / runs["kernel"]["device_median_s"])
    return runs


def phase_sharded(seed: int, n_cards: int, files, pcms) -> dict:
    """The headline batch and the mixed corpus through
    `sharded_decode_states`, against single-card `decode_states` and the
    source; sharded `encode_device` block-identical to unsharded."""
    from wvpk.encode import encode_device
    from wvpk.engine import decode_states
    from wvpk.parallel import make_mesh, sharded_decode_states

    mesh = make_mesh(n_cards)
    per_file, states = file_states(files)
    sharded, first_s = timed(sharded_decode_states, states, mesh)
    check_against_source(per_file, sharded, pcms, "sharded headline")
    same_results(sharded, decode_states(states), "sharded vs one card")
    _, steady_s = timed(sharded_decode_states, states, mesh)
    fams = {}
    for fam, data in mode_matrix(seed, n_cards).items():
        sts = family_states(data)
        res = sharded_decode_states(sts, mesh)
        check_oracle(sts, res, f"sharded {fam}")
        same_results(res, decode_states(sts), f"sharded {fam} vs one card")
        fams[fam] = len(sts)
    rng = np.random.default_rng(seed + 4)
    pcm = stereo_pcm(rng, 4096 * (n_cards * 2 + 3), 440.0)
    enc = encode_device(pcm, mesh=mesh)
    assert enc == encode_device(pcm), "sharded encode != unsharded"
    _, est = file_states([enc])
    check_against_source([est], decode_states(est), [pcm], "sharded encode")
    return dict(blocks=len(states), first_s=first_s, steady_s=steady_s,
                families=fams, encode_blocks=len(est))


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded four-card path")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2
    log(f"card: {card_info()}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    t_all = time.perf_counter()

    (files, pcms), gen_s = timed(make_headline, args.seed, *HEADLINE.values())
    log(f"corpus: {len(files)} files x {HEADLINE['seconds']} s encoded on "
        f"the host in {gen_s:.3f} s")

    if args.cards > 1:
        r = phase_sharded(args.seed, args.cards, files, pcms)
        log(f"sharded x{args.cards}: {json.dumps(r)}")
    else:
        r = phase_headline(files, pcms)
        log(f"phase 1 headline: {r.pop('memory_analysis')}")
        log(f"phase 1 headline: {json.dumps(r)}")
        with tempfile.TemporaryDirectory() as d:
            log(f"phase 2 cli/api: {json.dumps(phase_cli_api(args.seed, 180.0, d))}")
        log(f"phase 3 modes: {json.dumps(phase_modes(args.seed))}")
        log(f"phase 4 device encode: "
            f"{json.dumps(phase_device_encode(args.seed, 8.0))}")
        r = phase_kernel_vs_xla(files, pcms, repeats_kernel=5, repeats_xla=3)
        log(f"phase 5 kernel vs xla: {json.dumps(r)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
