"""Traversal dispatch: the CUDA per-ray kernel on the GPU, XLA on the CPU.

`trace` lowers to ops/traverse_cuda.py on a CUDA device and to the threaded
walk (ops/traverse.py, the semantics reference) on the CPU. The choice is
made per lowering (`lax.platform_dependent`), so one process can render on
both. Any other platform is an error.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import intersect as isect
from . import traverse_cuda
from .traverse import traverse, Hit
from ..constants import T_MAX


def gpu_present() -> bool:
    """Whether this process has a CUDA backend (the kernel library is then
    built and registered before the first lowering)."""
    try:
        return any(d.platform == 'gpu' for d in jax.devices('gpu'))
    except RuntimeError:
        return False


def _with_barycentrics(hit: Hit, world, ro, rd) -> Hit:
    """The XLA path's (u, v): the winning triangle re-intersected with the
    same Möller arithmetic the kernel runs (src/kernels.h:585-619)."""
    tri = world.tris[jnp.clip(hit.prim_id, 0, world.tris.shape[0] - 1)]
    _, _, u, v = isect.ray_triangle(ro, rd, tri[..., 0:3], tri[..., 3:6],
                                    tri[..., 6:9])
    return hit._replace(u=u, v=v)


def trace(scene, dyn, ro, rd, *, t_max=None, active=None,
          any_hit: bool = False, stop_on_hit=None) -> Hit:
    """Closest-hit (or any-hit / per-lane stop-on-hit) trace of f32[B, 3]
    rays. Returns Hit with the winning triangle's barycentrics in u/v."""
    if gpu_present():
        traverse_cuda.load_library()
    B = ro.shape[:-1]
    if t_max is None:
        t_max = jnp.full(B, T_MAX, jnp.float32)
    if active is None:
        active = jnp.ones(B, bool)
    if stop_on_hit is None:
        stop_on_hit = jnp.full(B, bool(any_hit))

    def on_gpu(ro, rd, t_max, active, stop_on_hit):
        return traverse_cuda.traverse_cuda(
            scene, dyn.kernel, ro, rd, t_max=t_max, active=active,
            any_hit=any_hit, stop_on_hit=stop_on_hit)

    def on_cpu(ro, rd, t_max, active, stop_on_hit):
        hit = traverse(scene, dyn.world, ro, rd, t_max=t_max, active=active,
                       any_hit=any_hit, stop_on_hit=stop_on_hit)
        return _with_barycentrics(hit, dyn.world, ro, rd)

    return jax.lax.platform_dependent(ro, rd, t_max, active, stop_on_hit,
                                      cpu=on_cpu, cuda=on_gpu)

