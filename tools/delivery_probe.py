"""Probe host-delivery (decode_states round trip) on the real chip:
times the blob-staged single-fetch path per subset size, PCM-only and
mixed PCM+DSD. Usage: python tools/delivery_probe.py [n_files ...]"""
import os, sys, time
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import make_corpus, _cache_blob, _make_dsd_delivery
from wvpk.container import parse_blocks
from wvpk.engine import decode_states

def probe(states, tag, reps=3):
    samples = sum(st.header.block_samples for st in states)
    res = decode_states(states)  # warm/compile
    assert not any(r.crc_error for r in res), tag
    best = float("inf"); ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_states(states)
        dt = time.perf_counter() - t0
        ts.append(round(dt, 3)); best = min(best, dt)
    print(f"{tag}: {samples/1e6:.2f} Msamples, times {ts}, "
          f"best rate {samples/best/1e6:.3f} Msamples/s", flush=True)

def main():
    sizes = [int(a) for a in sys.argv[1:]] or [48]
    files, n = make_corpus(192, 4.0, 4096)
    all_states = []
    for data in files:
        all_states += [b.state for b in parse_blocks(data)]
    per_file = len(all_states) // 192
    dsd_files = _cache_blob("dsd_delivery_v1", _make_dsd_delivery)
    dsd_states = []
    for data in dsd_files:
        dsd_states += [b.state for b in parse_blocks(data)]
    for nf in sizes:
        sub = all_states[:per_file * nf]
        probe(sub, f"pcm_{nf}f")
        probe(sub + dsd_states, f"mixed_{nf}f")

if __name__ == "__main__":
    main()
