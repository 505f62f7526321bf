"""Large-file streaming demo: synthesize a ~1 GB .wv by tiling encoded
blocks (block_index patched per copy — CRC covers samples, not headers),
then decode it end-to-end through the streaming API under bounded memory,
reporting throughput and peak RSS.

Usage: python tools/stream_bigfile.py [target_gb] [path]
"""
import os, resource, sys, time
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def block_table(data: bytes):
    """(offset, size, block_samples) per block (our encoder writes blocks
    back-to-back; ckSize at +4, block_samples at +20)."""
    out, pos = [], 0
    while pos < len(data):
        assert data[pos:pos + 4] == b"wvpk"
        ck = int.from_bytes(data[pos + 4:pos + 8], "little") + 8
        ns = int.from_bytes(data[pos + 20:pos + 24], "little")
        out.append((pos, ck, ns))
        pos += ck
    return out


def synthesize(path: str, target_bytes: int):
    from bench import make_corpus
    files, _n = make_corpus(192, 4.0, 4096)
    units = files[:8]
    tables = [block_table(u) for u in units]
    unit_bytes = sum(len(u) for u in units)
    reps = max(1, target_bytes // unit_bytes)
    total_samples = reps * sum(ns for t in tables for (_o, _s, ns) in t)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        index = 0
        for r in range(reps):
            for u, table in zip(units, tables):
                buf = bytearray(u)
                for off, _size, ns in table:
                    buf[off + 16:off + 20] = (index & 0xFFFFFFFF).to_bytes(4, "little")
                    buf[off + 10] = (index >> 32) & 0xFF
                    # total_samples: known in every header (encoder parity)
                    buf[off + 12:off + 16] = (total_samples & 0xFFFFFFFF).to_bytes(4, "little")
                    buf[off + 11] = (total_samples >> 32) & 0xFF
                    index += ns
                f.write(buf)
    sz = os.path.getsize(path)
    print(f"synthesized {sz/1e9:.2f} GB, {total_samples/1e6:.1f} Msamples, "
          f"{index} samples indexed, {time.perf_counter()-t0:.1f}s", flush=True)
    return total_samples


def main():
    target = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    path = sys.argv[2] if len(sys.argv) > 2 else "/tmp/wvpk_big.wv"
    total = synthesize(path, int(target * 1e9))

    from wvpk import api
    t0 = time.perf_counter()
    wpc = api.WavpackOpenFileInput(path)
    assert wpc.error_message == "", wpc.error_message
    assert wpc.streaming, "expected streaming mode for a GB-scale file"
    t_open = time.perf_counter() - t0
    n = api.WavpackGetNumSamples(wpc)
    assert n == total, (n, total)
    buf = np.zeros(65536 * 2, np.int32)
    got = 0
    nreq = 0
    t0 = time.perf_counter()
    while True:
        k = api.WavpackUnpackSamples(wpc, buf, 65536)
        if k == 0:
            break
        got += k
        nreq += 1
        if os.environ.get("WVPK_STREAM_PROGRESS") and nreq % 16 == 0:
            r = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
            print(f"  {got/1e6:.0f} Msamples, {got/(time.perf_counter()-t0)/1e6:.2f} Ms/s, RSS {r:.0f} MB", flush=True)
    dt = time.perf_counter() - t0
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    assert got == total, (got, total)
    assert api.WavpackGetNumErrors(wpc) == 0
    wpc.close()
    print(f"streamed {got/1e6:.1f} Msamples in {dt:.1f}s = "
          f"{got/dt/1e6:.2f} Msamples/s ({got/44100/dt:.0f}x realtime), "
          f"open+index {t_open:.2f}s, peak RSS {rss_mb:.0f} MB", flush=True)


if __name__ == "__main__":
    main()
