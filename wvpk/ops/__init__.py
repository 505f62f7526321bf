"""Device-side decode kernels (JAX/XLA, and the CUDA lane kernel).

Layout convention: lanes = blocks (the embarrassingly-parallel axis, see
SURVEY.md section 2.3); every kernel is vectorized over a (L,) lane axis and
scans over samples. int64 is used where the reference uses C# long.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: bucket profiles compile once per checkout,
# not once per process. JAX reads JAX_COMPILATION_CACHE_DIR itself; without
# it the cache is the checkout's `.jax_cache` directory (git-ignored).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
