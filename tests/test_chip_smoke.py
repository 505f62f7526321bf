"""chip_smoke.py's phases at tiny sizes on the CPU (only `main` insists
on a GPU), and its refusal to run without one."""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    return cs.make_headline(0, n_files=3, seconds=0.2, block_samples=1024)


def test_headline_phase(tiny):
    files, pcms = tiny
    r = cs.phase_headline(files, pcms)
    assert r["blocks"] == 3 * 9 and r["samples"] == 3 * 8820
    assert "CompiledMemoryStats" in r["memory_analysis"]


def test_cli_api_phase(tmp_path):
    r = cs.phase_cli_api(0, 0.5, str(tmp_path))
    assert r["samples"] == 22050


def test_modes_phase():
    r = cs.phase_modes(0)
    assert {"lossless", "mono", "hybrid_balance", "float", "int32_wvx",
            "deep12", "dsd_mode1", "dsd_mode3", "mc51_24bit", "wvc",
            "dsd_mode0"} <= set(r)


def test_device_encode_phase():
    assert cs.phase_device_encode(0, 0.2)["blocks"] == 3


def test_kernel_vs_xla_phase(tiny):
    files, pcms = tiny
    r = cs.phase_kernel_vs_xla(files, pcms, repeats_kernel=1, repeats_xla=1)
    assert len(r["kernel"]["times_s"]) == 1 and r["speedup"] > 0


def test_sharded_phase(tiny):
    files, pcms = tiny
    r = cs.phase_sharded(0, 4, files, pcms)
    assert r["blocks"] == 27 and r["encode_blocks"] == 11


def test_main_refuses_without_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True,
                         env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_breakdown_steps_small(tiny):
    """tools/decode_breakdown.py's step timing runs each step of
    `decode_states` alone (here at a tiny size, for its control flow)."""
    sys.path.insert(0, str(REPO / "tools"))
    import decode_breakdown as db
    files, _ = tiny
    r = db.step_times(files, 1)
    assert set(r) == {"parse", "staging", "blob_build", "h2d",
                      "device_decode", "d2h", "reassembly", "decode_states",
                      "buckets"}
    assert sum(r["buckets"]) == 3 * 9
    assert db.busy_ns([(0, 10), (5, 20), (30, 40), (32, 35)]) == 30
