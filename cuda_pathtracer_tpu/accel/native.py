"""Bridge to the native C++ BVH builder (accel/native/bvh_builder.cpp).

The reference's hot init path is a single-core SSE binned-SAH build that does
2M triangles in <700ms (README.md:199-211, src/bvhBuilder.h:35-274). This
module loads a C++ implementation of that algorithm via ctypes; it builds
every BVH of the program (bvh.py's numpy builder is the reference it is
tested against). Built with ``make -C cuda_pathtracer_tpu/accel/native``,
done automatically on first use; a failed build raises with make's output.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_DIR = os.path.join(_HERE, 'native')
_SO_PATH = os.path.join(_DIR, 'libbvh.so')
_LIB = None


def _build() -> None:
    """`make` the library (a no-op when it is up to date), under a lock on
    the Makefile so concurrent processes do not write the .so at once. The
    environment's CXX first; where it cannot link OpenMP (a toolchain
    without libgomp), the system g++. Raises with make's output when both
    fail."""
    errors = []
    with open(os.path.join(_DIR, 'Makefile')) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for extra in ([], ['CXX=g++']):
            proc = subprocess.run(['make', '-C', _DIR, *extra],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode == 0:
                return
            errors.append(f'make {" ".join(extra)}:\n{proc.stdout}'
                          f'{proc.stderr}')
    raise RuntimeError('building the native BVH builder failed:\n'
                       + '\n'.join(errors))


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    _build()
    lib = ctypes.CDLL(_SO_PATH)
    lib.build_bvh_binned.restype = ctypes.c_int64
    lib.build_bvh_binned.argtypes = [
        ctypes.c_int64,                   # n triangles
        ctypes.POINTER(ctypes.c_float),   # v0 [n,3]
        ctypes.POINTER(ctypes.c_float),   # v1
        ctypes.POINTER(ctypes.c_float),   # v2
        ctypes.POINTER(ctypes.c_float),   # out vmin [2n-1,3]
        ctypes.POINTER(ctypes.c_float),   # out vmax
        ctypes.POINTER(ctypes.c_int32),   # out left
        ctypes.POINTER(ctypes.c_int32),   # out leaf_start
        ctypes.POINTER(ctypes.c_int32),   # out leaf_count
        ctypes.POINTER(ctypes.c_int32),   # out perm [n]
    ]
    lib.build_bvh_sbvh.restype = ctypes.c_int64
    lib.build_bvh_sbvh.argtypes = [
        ctypes.c_int64,                   # n triangles
        ctypes.POINTER(ctypes.c_float),   # v0 [n,3]
        ctypes.POINTER(ctypes.c_float),   # v1
        ctypes.POINTER(ctypes.c_float),   # v2
        ctypes.c_float,                   # alpha (overlap gate)
        ctypes.c_int64,                   # max_refs
        ctypes.POINTER(ctypes.c_float),   # out vmin [2*max_refs-1,3]
        ctypes.POINTER(ctypes.c_float),   # out vmax
        ctypes.POINTER(ctypes.c_int32),   # out left
        ctypes.POINTER(ctypes.c_int32),   # out leaf_start
        ctypes.POINTER(ctypes.c_int32),   # out leaf_count
        ctypes.POINTER(ctypes.c_int32),   # out perm [max_refs]
        ctypes.POINTER(ctypes.c_int64),   # out n_refs
    ]
    _LIB = lib
    return lib


def load() -> str:
    """Build and load the library; returns its path. Raises when the build
    or the load fails: every BVH of the program comes from this builder."""
    _load()
    return _SO_PATH


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    from .bvh import BVHNodes
    lib = _load()
    n = len(v0)
    max_nodes = max(2 * n - 1, 1)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    vmin = np.empty((max_nodes, 3), np.float32)
    vmax = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    leaf_start = np.empty(max_nodes, np.int32)
    leaf_count = np.empty(max_nodes, np.int32)
    perm = np.empty(n, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    count = lib.build_bvh_binned(
        n,
        v0.ctypes.data_as(fp), v1.ctypes.data_as(fp), v2.ctypes.data_as(fp),
        vmin.ctypes.data_as(fp), vmax.ctypes.data_as(fp),
        left.ctypes.data_as(ip),
        leaf_start.ctypes.data_as(ip), leaf_count.ctypes.data_as(ip),
        perm.ctypes.data_as(ip))
    c = int(count)
    return BVHNodes(vmin[:c], vmax[:c], left[:c],
                    leaf_start[:c], leaf_count[:c], perm)


def build_bvh_sbvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                          alpha: float = 1e-5,
                          dup_factor: float = 1.4):
    """Spatial-split BVH (SBVH, Stich 2009) via the native builder. The
    returned `perm` has n_refs >= n entries — a straddling triangle may be
    referenced from several leaves with clipped bounds. Quality mode:
    ~15-30% fewer traversal visits on architectural scenes at the cost of a
    slower, single-threaded build. Returns None when the build gives up
    (more references than max_refs)."""
    from .bvh import BVHNodes
    lib = _load()
    n = len(v0)
    max_refs = max(int(n * dup_factor) + 16, n)
    max_nodes = 2 * max_refs - 1
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    vmin = np.empty((max_nodes, 3), np.float32)
    vmax = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    leaf_start = np.empty(max_nodes, np.int32)
    leaf_count = np.empty(max_nodes, np.int32)
    perm = np.empty(max_refs, np.int32)
    nrefs = ctypes.c_int64(0)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    count = lib.build_bvh_sbvh(
        n,
        v0.ctypes.data_as(fp), v1.ctypes.data_as(fp), v2.ctypes.data_as(fp),
        ctypes.c_float(alpha), max_refs,
        vmin.ctypes.data_as(fp), vmax.ctypes.data_as(fp),
        left.ctypes.data_as(ip),
        leaf_start.ctypes.data_as(ip), leaf_count.ctypes.data_as(ip),
        perm.ctypes.data_as(ip), ctypes.byref(nrefs))
    c = int(count)
    if c <= 0:
        return None
    return BVHNodes(vmin[:c].copy(), vmax[:c].copy(), left[:c].copy(),
                    leaf_start[:c].copy(), leaf_count[:c].copy(),
                    perm[:int(nrefs.value)].copy())
