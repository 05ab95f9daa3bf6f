"""cuda_pathtracer_tpu — a wavefront path-tracing framework in JAX with the
capabilities of HugoPeters1024/cuda_pathtracer. See README.md and PARITY.md.
"""
import os


def _default_compilation_cache():
    """Persist compiled programs across processes. JAX reads
    JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the cache is
    one fixed directory in the checkout (git ignores it)."""
    if os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        return
    import jax
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update('jax_compilation_cache_dir', os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            '.jax_cache'))


_default_compilation_cache()
