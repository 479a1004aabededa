"""seal_embedded_jax: a batched CKKS encode/encrypt framework in JAX.

Re-implements the full capability surface of microsoft/SEAL-Embedded
(IoT-side CKKS encoder/encryptor) as a JAX/XLA framework: batched,
sharded, with a Pallas SHAKE-256 kernel on the GPU.
"""

import os as _os

import jax as _jax

# The framework requires x64: plaintexts are int64 (ckks_common.c:187-209)
# and encode runs in f64.
_jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str | None:
    """The persistent compile cache this package sets: None where
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself), otherwise the
    fixed directory .jax_cache at the root of the checkout."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


_cache = compile_cache_dir()
if _cache is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

__version__ = "0.1.0"
