"""Tests that need the card (marked `gpu`; they skip elsewhere).

Run them on the GPU with:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

from wvpk.container import parse_blocks
from wvpk.engine import decode_states
from wvpk.ops import backend
from wvpk.ref import decode_block
from wvpk.testgen import encode_file
from wvpk.testgen.fuzzspec import random_pcm, random_spec

pytestmark = pytest.mark.gpu


def test_gpu_selects_lane_kernel(gpu):
    assert backend.use_lane_kernel()


@pytest.mark.parametrize("seed", range(16))
def test_gpu_kernel_matches_xla_and_oracle(gpu, seed):
    """The CUDA kernel against the XLA scans on the same card and the
    scalar oracle, on random mode-matrix streams (a quarter corrupted)."""
    rng = np.random.default_rng(7000 + seed)
    spec = random_spec(rng)
    n = int(rng.integers(spec.block_samples // 2, spec.block_samples * 3))
    data = encode_file(random_pcm(rng, n, spec.nch_data, spec), spec)
    if rng.random() < 0.25:
        data = bytearray(data)
        data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
    states = [b.state for b in parse_blocks(data)]
    kernel = decode_states(states)
    with backend._force("xla"):
        xla = decode_states(states)
    for st, k, x in zip(states, kernel, xla):
        want = decode_block(st)
        for got in (k, x):
            np.testing.assert_array_equal(got.samples, want.samples)
            assert got.mute_error == want.mute_error
            assert got.crc_error == want.crc_error
        assert k.crc == x.crc


def test_gpu_chip_smoke_small(gpu, tmp_path):
    import chip_smoke as cs
    files, pcms = cs.make_headline(1, n_files=8, seconds=1.0,
                                   block_samples=4096)
    cs.phase_headline(files, pcms)
    cs.phase_cli_api(1, 2.0, str(tmp_path))
    cs.phase_modes(1)
    r = cs.phase_kernel_vs_xla(files, pcms, 2, 1)
    assert r["speedup"] > 1.0
