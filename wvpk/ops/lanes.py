"""The lane-serial decode kernel (native/csrc/wvpk_lanes.cu), as XLA FFI calls.

One thread per block walks the whole block: entropy words -> decorrelation
-> joint stereo, mute check and CRC, with the same contract as the XLA
scans it replaces on the GPU (`entropy_decode` -> `decorr_decode` ->
`joint_mute_crc`). There is no interpret mode: on the GPU the source is
compiled by nvcc, on the CPU by the host C++ compiler (a loop over lanes),
which is how the CPU tests check the kernel's arithmetic. Each library is
built once per source version into the checkout's `build/` directory.

`ops/backend.py` decides where the kernel runs; callers go through it.
`decorr_post` (the library's second FFI target) exists for the tests only.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from ..native import BUILD_DIR
from ..tables import EXP2_NP, LOG2_NP

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native",
                   "csrc", "wvpk_lanes.cu")
_TARGETS = {"decode": "WvpkLanesDecode", "decorr": "WvpkLanesDecorr"}
_registered: set[str] = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda, "bin", "nvcc")


def build_command(platform: str, out: str) -> list[str]:
    """The compiler command that builds the kernel library for `platform`
    ("gpu": nvcc for Hopper, sm_90a; "cpu": the host C++ compiler)."""
    inc = jax.ffi.include_dir()
    if platform == "gpu":
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", inc, "-o", out, SRC]
    cxx = os.environ.get("CXX", "c++")
    return [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
            "-w", "-I", inc, "-o", out, SRC]


def library_path(platform: str) -> str:
    """Build (once per source version, under a file lock shared by
    concurrent processes) and return the kernel library for `platform`."""
    tag = hashlib.sha256(open(SRC, "rb").read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"wvpk_lanes_{platform}_{tag}.so")
    if os.path.exists(path):
        return path
    with open(os.path.join(BUILD_DIR, "wvpk_lanes.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = path + ".partial"
            proc = subprocess.run(build_command(platform, tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {os.path.basename(SRC)} for {platform} "
                    f"failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, path)
    return path


def _register(platform: str) -> None:
    if platform in _registered:
        return
    lib = ctypes.cdll.LoadLibrary(library_path(platform))
    ffi_platform = "CUDA" if platform == "gpu" else platform
    for kind, symbol in _TARGETS.items():
        jax.ffi.register_ffi_target(
            f"wvpk_lanes_{kind}_{platform}",
            jax.ffi.pycapsule(getattr(lib, symbol)), platform=ffi_platform)
    _registered.add(platform)


def _call(kind: str, arrays, out_shape, **attrs):
    platform = jax.devices()[0].platform
    _register(platform)
    T, L, C = out_shape
    result = (jax.ShapeDtypeStruct((T, L, C), jnp.int32),
              jax.ShapeDtypeStruct((L,), jnp.int32),
              jax.ShapeDtypeStruct((L,), jnp.int32))
    out, crc, mute = jax.ffi.ffi_call(
        f"wvpk_lanes_{kind}_{platform}", result)(*arrays, **attrs)
    return out, crc, mute != 0


def _params(nsamples, med, slow, acc, delta, terms, deltas, wa, wb,
            num_terms, joint, mute_limit, broke):
    """(L, NPARAM) int64 per-lane parameters, in the kernel's P_* order."""
    L = terms.shape[0]

    def col(x):
        return jnp.asarray(x).astype(jnp.int64).reshape(L, -1)

    return jnp.concatenate(
        [col(nsamples), col(med), col(slow), col(acc), col(delta),
         col(num_terms), col(joint), col(mute_limit), col(broke),
         col(terms), col(deltas), col(wa), col(wb)], axis=1)


def _hist(hist_a, hist_b):
    return jnp.stack([jnp.asarray(hist_a), jnp.asarray(hist_b)],
                     axis=1).astype(jnp.int32)


def _tables():
    return jnp.asarray(np.concatenate([LOG2_NP, EXP2_NP]), jnp.int32)


def decode_post(words, nsamples, med, slow, acc, delta, terms, deltas16,
                wa, wb, hist_a, hist_b, num_terms, joint, mute_limit, *,
                mono: bool, hybrid: bool, hybrid_bitrate: bool,
                hybrid_balance: bool, nsteps: int):
    """Bitstreams to post-processed samples for every lane.

    Contract of `entropy_decode` -> `decorr_decode` -> `joint_mute_crc`
    (the XLA path in ops/backend.py), same argument shapes: words (L, W)
    uint32, med (L, 2, 3), slow/acc/delta (L, 2), decorr terms (L, 16),
    hist (L, 16, 8), mute_limit (L,). Returns (out (T, L, C) int32,
    crc (L,) int32, mute (L,) bool) with T = nsteps / C."""
    L = words.shape[0]
    C = 1 if mono else 2
    params = _params(nsamples, med, slow, acc, delta, terms, deltas16, wa,
                     wb, num_terms, joint, mute_limit,
                     jnp.zeros((L,), jnp.int64))
    words = jnp.asarray(words).astype(jnp.uint32)
    return _call("decode", (words, params, _hist(hist_a, hist_b), _tables()),
                 (nsteps // C, L, C), mono=mono, hybrid=hybrid,
                 hybrid_bitrate=hybrid_bitrate,
                 hybrid_balance=hybrid_balance)


def decorr_post(residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
                num_terms, nsamples, joint, mute_limit, broke, *,
                mono: bool):
    """Test-only hook, called by no decode path: the kernel's
    decorrelation and joint/mute/CRC stages on given residuals (T, L, C)
    int32, so tests can drive them with arbitrary state. Contract of
    `decorr_decode` -> `joint_mute_crc`."""
    residuals = jnp.asarray(residuals).astype(jnp.int32)
    L = residuals.shape[1]
    z2 = jnp.zeros((L, 2), jnp.int64)
    params = _params(nsamples, jnp.zeros((L, 2, 3), jnp.int64), z2, z2, z2,
                     terms, deltas, w0_a, w0_b, num_terms, joint, mute_limit,
                     broke)
    return _call("decorr",
                 (residuals, params, _hist(hist0_a, hist0_b), _tables()),
                 residuals.shape, mono=mono)
