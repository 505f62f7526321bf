"""Hardware differential sweep: decode_states on the GPU vs the
scalar oracle, over randomized mode-matrix specs (PCM + DSD).

Run on the card: `python tools/hw_sweep.py [n]`.
The CI suite runs the same generators CPU-side (tests/test_fuzz_differential)
and bench.py gates a compact sweep per run (`hw_sweep_ok`); this script is
the full-size manual version. Logic lives in wvpk.testgen.fuzzspec.
"""

import sys

sys.path.insert(0, ".")


def main(n_cases: int = 30, n_dsd: int = 8) -> int:
    from wvpk.testgen.fuzzspec import run_hw_sweep

    fails, blocks_checked = run_hw_sweep(n_cases, n_dsd)
    print(f"hardware differential sweep: {blocks_checked} blocks, "
          f"{fails} mismatches")
    return 1 if fails else 0


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    sys.exit(main(n))
