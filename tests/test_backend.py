"""The one backend decision (ops/backend.py), the kernel library build,
and the compile-cache rule."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax

from wvpk.config import DecodeOptions
from wvpk.container import parse_blocks
from wvpk.engine.staging import group_blocks
from wvpk.ops import backend, lanes
from wvpk.testgen import EncodeSpec, encode_file

REPO = pathlib.Path(__file__).resolve().parent.parent


def _bucket():
    pcm = np.round(np.random.default_rng(0).normal(0, 900, (300, 2))
                   ).astype(np.int64)
    data = encode_file(pcm, EncodeSpec(block_samples=150, joint=True))
    return group_blocks([b.state for b in parse_blocks(data)])[0]


def _fused_jaxpr(b) -> str:
    from wvpk.engine.fused import fused_decode
    prof = b.profile
    args = (b.words, b.nwords_lane, b.nsamples, b.med, b.slow, b.acc,
            b.delta, b.terms, b.deltas16, b.wa, b.wb, b.hist_a, b.hist_b,
            b.num_terms, b.joint, b.mute_limit, b.shift, b.bytes_stored,
            b.float_shift_eff, b.int32_zod)
    return str(jax.make_jaxpr(lambda *a: fused_decode(
        *a, mono=prof.mono, hybrid=prof.hybrid,
        hybrid_bitrate=prof.hybrid_bitrate,
        hybrid_balance=prof.hybrid_balance, is_float=prof.is_float,
        int32_expand=False, nsteps=prof.nsteps))(*args))


def test_cpu_platform_runs_xla_scans():
    assert backend.platform() == "cpu"
    assert not backend.use_lane_kernel()
    text = _fused_jaxpr(_bucket())
    assert "wvpk_lanes" not in text
    assert "scan" in text


def test_gpu_platform_selects_lane_kernel(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert backend.use_lane_kernel()
    jax.clear_caches()
    try:
        text = _fused_jaxpr(_bucket())
    finally:
        jax.clear_caches()
    assert "wvpk_lanes_decode" in text


@pytest.mark.parametrize("platform", ["cpu", "rocm", "metal"])
def test_other_platforms_select_xla(monkeypatch, platform):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert not backend.use_lane_kernel()


def test_force_overrides_and_restores():
    with backend._force("kernel"):
        assert backend.use_lane_kernel()
        with backend._force("xla"):
            assert not backend.use_lane_kernel()
        assert backend.use_lane_kernel()
    assert not backend.use_lane_kernel()
    with pytest.raises(AssertionError):
        with backend._force("pallas"):
            pass


def test_decode_options_choose_no_kernel():
    names = {f.name for f in dataclasses.fields(DecodeOptions)}
    assert not {n for n in names if "kernel" in n or "decorr" in n}
    for gone in ("entropy_kernel", "decorr_kernel", "dsd_kernel",
                 "encode_kernel", "decorr_specialize"):
        with pytest.raises(TypeError):
            DecodeOptions(**{gone: "xla"})


def test_no_interpret_mode_anywhere():
    """Nothing in the package runs a kernel in interpret mode, and no
    Pallas code is left."""
    pkg = REPO / "wvpk"
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        for needle in ("interpret=", "pallas", "Pallas"):
            assert needle not in text, f"{path}: {needle}"


def test_build_commands():
    gpu = lanes.build_command("gpu", "/x/out.so")
    assert os.path.basename(gpu[0]) == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in gpu
    assert "-shared" in gpu and gpu[-1] == lanes.SRC
    cpu = lanes.build_command("cpu", "/x/out.so")
    assert cpu[1:3] == ["-x", "c++"] and cpu[-1] == lanes.SRC
    assert jax.ffi.include_dir() in cpu


def test_host_library_built_once_in_checkout():
    from wvpk.native import BUILD_DIR
    path = lanes.library_path("cpu")
    assert path == lanes.library_path("cpu")
    assert os.path.exists(path)
    assert pathlib.Path(path).parent == pathlib.Path(BUILD_DIR)
    assert pathlib.Path(BUILD_DIR) == REPO / "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def _cache_dir_in_fresh_process(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, wvpk.ops; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_from_environment(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(want) == want


def test_cache_dir_default_inside_checkout():
    got = _cache_dir_in_fresh_process(None)
    assert got == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


# --------------------------------------------------------------------------
# every entry point reaches the same implementation
# --------------------------------------------------------------------------

@pytest.fixture
def kernel_calls(monkeypatch):
    """Count calls of the lane kernel's wrapper (traced or eager)."""
    calls = []
    real = lanes.decode_post

    def counted(*a, **kw):
        calls.append(kw["nsteps"])
        return real(*a, **kw)

    monkeypatch.setattr(lanes, "decode_post", counted)
    return calls


@pytest.mark.parametrize("extra", [[], ["--trace"], ["--report"]])
def test_cli_decode_reaches_lane_kernel(tmp_path, kernel_calls, extra):
    """`python -m wvpk.cli x.wv -o x.wav` decodes through the lane kernel
    where the backend picks it, with or without stage timings, and the
    WAV is byte-exact."""
    from wvpk import cli
    from wvpk.io.wav import make_wav_header
    pcm = np.round(np.random.default_rng(11).normal(0, 1500, (900, 2))
                   ).astype(np.int64)
    wv, wav = tmp_path / "x.wv", tmp_path / "x.wav"
    wv.write_bytes(encode_file(pcm, EncodeSpec(block_samples=300,
                                               joint=True)))
    with backend._force("kernel"):
        assert cli.main([str(wv), "-o", str(wav), "-q", *extra]) == 0
    assert kernel_calls
    blob = wav.read_bytes()
    hdr = make_wav_header(900, 2, 44100, 16, 2)
    assert blob[:len(hdr)] == hdr
    np.testing.assert_array_equal(
        np.frombuffer(blob[len(hdr):], "<i2").reshape(-1, 2), pcm)


@pytest.mark.parametrize("impl,stage", [("kernel", "decode"),
                                        ("xla", "entropy")])
def test_sync_stages_path_matches_fused(impl, stage):
    """The synced stage-wise path (`sync_stages`, used by --trace) runs the
    backend's implementation: one "decode" stage for the lane kernel,
    entropy/decorr/post for the scans, and the same blocks as the fused
    dispatch."""
    from wvpk import config, trace
    from wvpk.engine import decode_states
    pcm = np.round(np.random.default_rng(12).normal(0, 2000, (700, 2))
                   ).astype(np.int64)
    states = [b.state for b in parse_blocks(
        encode_file(pcm, EncodeSpec(block_samples=350, joint=True)))]
    with backend._force(impl):
        fused = decode_states(states)
        config.set_options(sync_stages=True)
        try:
            with trace.collect() as stages:
                staged = decode_states(states)
        finally:
            config.set_options(sync_stages=False)
    assert stage in stages
    for f, s in zip(fused, staged):
        np.testing.assert_array_equal(f.samples, s.samples)
        assert (f.crc, f.mute_error, f.crc_error) == \
            (s.crc, s.mute_error, s.crc_error)


@pytest.mark.parametrize("setup", ["trace", "oracle_check"])
def test_observers_keep_fused_path(monkeypatch, setup):
    """A trace collector or the oracle cross-check observes the decode;
    neither switches it to the stage-wise path."""
    from wvpk import config, trace
    from wvpk.engine import decode_states, pipeline

    def no_stages(b):
        raise AssertionError("stage-wise path taken")

    monkeypatch.setattr(pipeline, "_scan_stages", no_stages)
    pcm = np.round(np.random.default_rng(13).normal(0, 800, (600, 2))
                   ).astype(np.int64)
    states = [b.state for b in parse_blocks(
        encode_file(pcm, EncodeSpec(block_samples=300, joint=True)))]
    if setup == "trace":
        with trace.collect() as stages:
            res = decode_states(states)
        assert "staging" in stages
    else:
        config.set_options(oracle_check=True)
        try:
            res = decode_states(states)
        finally:
            config.set_options(oracle_check=False)
    np.testing.assert_array_equal(
        np.concatenate([r.samples for r in res]), pcm)
