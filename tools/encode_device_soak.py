"""Randomized device-encode soak for the card (the XLA encode scans).

Each case: random PCM + spec -> `encode_device` (the device encode
scans) -> scalar-oracle decode. Gates:
  - lossless: bit-exact PCM roundtrip identity (the independent oracle,
    SURVEY.md section 4) + 0 crc/mute errors;
  - hybrid: 0 crc/mute errors and RMS error <= 1.5x the HOST encoder's
    RMS on the same input (device blocks are fresh/warm-seeded, so small
    adaptation differences are expected; gross divergence is not).

Usage: python tools/encode_device_soak.py [seed_base] [n_cases]
Seeds are disjoint from the CI device-encoder tests and the CPU pools
(710000/730000); hardware pools start at 720000.
"""

import sys

import numpy as np

sys.path.insert(0, "/root/repo")

from wvpk.container import parse_blocks          # noqa: E402
from wvpk.encode import encode, encode_device    # noqa: E402
from wvpk.ref import decode_block                # noqa: E402

SEED_BASE = int(sys.argv[1]) if len(sys.argv) > 1 else 720000
N_CASES = int(sys.argv[2]) if len(sys.argv) > 2 else 40


def oracle_decode(data):
    outs, bad = [], 0
    segments = {}
    for b in parse_blocks(data):
        r = decode_block(b.state)
        bad += int(r.crc_error) + int(r.mute_error)
        segments.setdefault(b.header.block_index, []).append(r.samples)
    for idx in sorted(segments):
        outs.append(np.concatenate(segments[idx], axis=1))
    return np.concatenate(outs), bad


def run_case(seed: int) -> str:
    rng = np.random.default_rng(seed)
    ch = int(rng.choice([1, 1, 2, 2, 2, 2, 3, 4, 6, 8]))
    bps = int(rng.choice([1, 2, 2, 2, 3]))
    lim = 1 << (bps * 8 - 1)
    n = int(rng.integers(300, 4000))
    t = np.arange(n)
    base = np.sin(2 * np.pi * rng.uniform(80, 2000) * t / 44100)
    pcm = np.stack(
        [np.round(base * rng.uniform(0.1, 0.8) * (lim - 1)
                  + rng.normal(0, lim * rng.uniform(0.001, 0.05), n))
         for _ in range(ch)], axis=1)
    pcm = np.clip(pcm, -lim, lim - 1).astype(np.int64)
    if rng.random() < 0.1:           # trailing-zero shift arm
        pcm = (pcm >> 2) << 2
    hybrid = bool(rng.random() < 0.4)
    opts = dict(
        bytes_per_sample=bps,
        block_samples=int(rng.choice([256, 512, 1000])),
        preset=str(rng.choice(["fast", "default", "high"])),
        joint=bool(rng.random() < 0.6),
        hybrid=hybrid,
        bitrate=int(rng.choice([384, 512, 768])),
    )
    warmup = int(rng.choice([0, 512]))
    data = encode_device(pcm, warmup=warmup, **opts)
    got, bad = oracle_decode(data)
    if bad:
        return f"FAIL seed {seed}: {bad} crc/mute errors ({opts})"
    if not hybrid:
        if not np.array_equal(got, pcm.astype(np.int32)):
            return f"FAIL seed {seed}: lossless roundtrip mismatch ({opts})"
        return "ok"
    host_got, hbad = oracle_decode(encode(pcm, **opts))
    if hbad:
        return f"FAIL seed {seed}: host reference decode errors ({opts})"
    dev_rms = float(np.sqrt(np.mean((got - pcm) ** 2)))
    host_rms = float(np.sqrt(np.mean((host_got - pcm) ** 2)))
    if dev_rms > max(host_rms, 1.0) * 1.5:
        return (f"FAIL seed {seed}: hybrid rms {dev_rms:.2f} vs host "
                f"{host_rms:.2f} ({opts})")
    return "ok"


def main() -> int:
    fails = 0
    for i in range(N_CASES):
        res = run_case(SEED_BASE + i)
        if res != "ok":
            fails += 1
            print(res, flush=True)
        if (i + 1) % 10 == 0:
            print(f"... {i + 1}/{N_CASES} cases, {fails} fails", flush=True)
    print(f"device-encode soak pool {SEED_BASE}: {N_CASES} cases, "
          f"{fails} fails")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
