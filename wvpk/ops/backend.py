"""Where the per-block decode loop runs: one decision, from the platform.

On the GPU the lane kernel (ops/lanes.py: one CUDA thread walks one whole
block) takes entropy decode, decorrelation and joint/mute/CRC. On any other
platform (the CPU is the test platform) the XLA scans do:
ops/entropy.py -> ops/decorr.py -> ops/post.py. Both give bit-identical
results. Everything else (hybrid-lossless corrections, wvx, DSD, device
encode) runs the XLA scans everywhere.

`_force` exists to time the two against each other on one card; it is not
an option a user sets.
"""

from __future__ import annotations

import contextlib

import jax

from . import lanes
from .decorr import decorr_decode
from .entropy import entropy_decode
from .post import joint_mute_crc

_forced: str | None = None


def platform() -> str:
    return jax.devices()[0].platform


def use_lane_kernel() -> bool:
    """True where the fused decode runs the lane kernel (the GPU)."""
    if _forced is not None:
        return _forced == "kernel"
    return platform() == "gpu"


@contextlib.contextmanager
def _force(impl: str):
    """Run the decode path with `impl` ("kernel" or "xla") whatever the
    platform. Compiled programs bake the choice in at trace time, so the
    caches are cleared on the way in and out."""
    global _forced
    assert impl in ("kernel", "xla"), impl
    prev, _forced = _forced, impl
    jax.clear_caches()
    try:
        yield
    finally:
        _forced = prev
        jax.clear_caches()


def decode_post(words, nwords_lane, nsamples, med, slow, acc, delta, terms,
                deltas16, wa, wb, hist_a, hist_b, num_terms, joint,
                mute_limit, *, mono: bool, hybrid: bool,
                hybrid_bitrate: bool, hybrid_balance: bool, nsteps: int):
    """Bitstreams -> (out (T, L, C) int32, crc (L,) int32, mute (L,) bool):
    entropy decode, decorrelation, joint-stereo undo, mute check and CRC
    (the `joint_mute_crc` contract)."""
    if use_lane_kernel():
        return lanes.decode_post(
            words, nsamples, med, slow, acc, delta, terms, deltas16, wa, wb,
            hist_a, hist_b, num_terms, joint, mute_limit, mono=mono,
            hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
            hybrid_balance=hybrid_balance, nsteps=nsteps)
    residuals, broke, _ndec = entropy_decode(
        words, nwords_lane, med, slow, acc, delta, mono=mono, hybrid=hybrid,
        hybrid_bitrate=hybrid_bitrate, hybrid_balance=hybrid_balance,
        nsteps=nsteps)
    dec = decorr_decode(residuals, terms, deltas16, wa, wb, hist_a, hist_b,
                        num_terms, mono=mono)
    return joint_mute_crc(dec, nsamples, joint, mute_limit, broke, mono=mono)
