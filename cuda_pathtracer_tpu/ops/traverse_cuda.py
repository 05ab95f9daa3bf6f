"""Per-ray BVH traversal on the GPU: the CUDA kernel in ops/cuda/traverse.cu,
called through jax.ffi.

One thread walks one ray over the binary world BVH (`dyn.world`) with a
short stack, nearer child first, as the reference does (traverseBVHStack,
src/kernels.h:202-275). The contract is ops/traverse.py:traverse's, plus the
winning triangle's barycentrics in Hit.u/Hit.v. Spheres and planes stay in
the XLA prepass, whose t seeds the kernel. The kernel reads `dyn.kernel`,
tables derived from `dyn.world` once per scene build and once per device
refit (scene/scene.py), not on every trace.

The library is built from the committed source by `make` at first use (or
ahead of time: `make -C cuda_pathtracer_tpu/ops/cuda`) into a directory git
ignores. A failed build or load raises: there is no silent fallback.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .traverse import Hit, PRIM_TRIANGLE, WorldArrays, _primitives_prepass
from ..constants import T_MAX

# kept equal to kBlock and kStack in ops/cuda/traverse.cu
BLOCK = 128   # rays per CUDA block: the wrapper pads the ray count to it
STACK = 64    # per-ray stack entries: bounds a leaf's inner ancestors

TARGET = 'cpt_traverse'
CUDA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'cuda')
LIB_PATH = os.path.join(CUDA_DIR, 'build', 'libcpt_traverse.so')

_registered = False


def load_library() -> None:
    """Build the kernel library (make skips an up-to-date build) and
    register it with XLA for the CUDA platform. Raises RuntimeError when the
    build or the load fails."""
    global _registered
    if _registered:
        return
    register(TARGET, LIB_PATH)
    _registered = True


def register(target: str, lib_path: str, *make_vars: str) -> None:
    """`make` the library at lib_path (with make_vars such as FMAD=true
    BUILD=build/fmad) and register its handler as the FFI target `target`."""
    proc = subprocess.run(
        ['make', '-C', CUDA_DIR,
         f'JAX_FFI_INCLUDE={jax.ffi.include_dir()}', *make_vars],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'building the GPU traversal kernel failed:\n'
                           f'{proc.stdout}{proc.stderr}')
    try:
        lib = ctypes.CDLL(lib_path)
        capsule = jax.ffi.pycapsule(lib.CptTraverse)
    except (OSError, AttributeError) as e:
        raise RuntimeError(f'cannot load {lib_path}: {e}') from e
    jax.ffi.register_ffi_target(target, capsule, platform='CUDA')


def _bits(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32)


class KernelTables(NamedTuple):
    """The kernel's view of the world BVH (layouts in ops/cuda/traverse.cu)."""
    nodes: jnp.ndarray   # f32[N, 16] left box | right box | refs | pad
    tris: jnp.ndarray    # f32[WT, 12] v0 | e1 | e2, each padded to 4
    root: jnp.ndarray    # f32[8] root box | root ref | pad


@jax.jit
def kernel_tables(world: WorldArrays) -> KernelTables:
    """The kernel's tables from the threaded world BVH. In the DFS layout an
    inner node's left child is n + 1 and its right child miss[n + 1]
    (accel/flatten.py)."""
    n = world.node_box.shape[0]
    if n == 0:
        return KernelTables(jnp.zeros((0, 16), jnp.float32),
                            jnp.zeros((0, 12), jnp.float32),
                            jnp.zeros((8,), jnp.float32))
    miss, lstart, lcount = (world.node_meta[:, 0], world.node_meta[:, 1],
                            world.node_meta[:, 2])
    ref = jnp.where(lcount > 0, ~((lstart << 3) | lcount),
                    jnp.arange(n, dtype=jnp.int32))
    left = jnp.minimum(jnp.arange(n, dtype=jnp.int32) + 1, n - 1)
    right = jnp.clip(miss[left], 0, n - 1)
    box = world.node_box
    nodes = jnp.concatenate(
        [box[left], box[right], _bits(ref[left])[:, None],
         _bits(ref[right])[:, None], jnp.zeros((n, 2), jnp.float32)], axis=1)
    v0 = world.tris[:, 0:3]
    pad = jnp.zeros((world.tris.shape[0], 1), jnp.float32)
    tris = jnp.concatenate([v0, pad, world.tris[:, 3:6] - v0, pad,
                            world.tris[:, 6:9] - v0, pad], axis=1)
    root = jnp.concatenate([box[0], _bits(ref[0:1]),
                            jnp.zeros((1,), jnp.float32)])
    return KernelTables(nodes, tris, root)


def call_kernel(nodes, tris, root, ro, rd, t_init, flags, target=TARGET):
    """The FFI call on a ray count that is a multiple of BLOCK. Returns
    (t, world-triangle index or -1, u, v)."""
    n = t_init.shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    return jax.ffi.ffi_call(target, (f32, i32, f32, f32))(
        nodes, tris, root, ro, rd, t_init, flags)


def traverse_cuda(scene, tables: KernelTables, ro, rd, t_max=None,
                  active=None, any_hit: bool = False,
                  stop_on_hit=None, target: str = TARGET) -> Hit:
    """Closest-hit (or any-hit) trace of f32[B, 3] rays; see traverse().
    `target` names another registered build of the kernel (register())."""
    B = ro.shape[0]
    if t_max is None:
        t_max = jnp.full((B,), T_MAX, jnp.float32)
    if active is None:
        active = jnp.ones((B,), bool)
    if stop_on_hit is None:
        stop_on_hit = jnp.full((B,), bool(any_hit))

    t0, ptype0, pid0, found0 = _primitives_prepass(scene, ro, rd, t_max,
                                                   any_hit)
    walk = active & ~(stop_on_hit & found0)
    flags = walk.astype(jnp.int32) | (stop_on_hit.astype(jnp.int32) << 1)

    if tables.nodes.shape[0] == 0:
        t, tri = t0, jnp.full((B,), -1, jnp.int32)
        u = v = jnp.zeros((B,), jnp.float32)
    else:
        pad = (-B) % BLOCK

        def padded(x):
            return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

        t, tri, u, v = call_kernel(*tables, padded(ro), padded(rd),
                                   padded(t0), padded(flags), target=target)
        t, tri, u, v = t[:B], tri[:B], u[:B], v[:B]

    found = tri >= 0
    return Hit(t=t, prim_type=jnp.where(found, PRIM_TRIANGLE, ptype0),
               prim_id=jnp.where(found, tri, pid0),
               intersected=active & (found | found0), u=u, v=v)
