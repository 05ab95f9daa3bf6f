"""Native C++ BVH builder vs the numpy reference implementation."""
import numpy as np
import pytest

from cuda_pathtracer_tpu.accel import native
from cuda_pathtracer_tpu.accel.bvh import build_bvh_numpy


@pytest.fixture(scope='module')
def tris():
    r = np.random.RandomState(7)
    n = 5000
    base = (r.rand(n, 3).astype(np.float32) - 0.5) * 50
    return (base,
            base + (r.rand(n, 3).astype(np.float32) - 0.5),
            base + (r.rand(n, 3).astype(np.float32) - 0.5))


def test_native_matches_numpy_topology(tris):
    v0, v1, v2 = tris
    a = native.build_bvh_native(v0, v1, v2)
    b = build_bvh_numpy(v0, v1, v2)
    assert len(a.vmin) == len(b.vmin)
    np.testing.assert_array_equal(a.leaf_count, b.leaf_count)
    np.testing.assert_array_equal(a.leaf_start, b.leaf_start)
    np.testing.assert_allclose(a.vmin, b.vmin, rtol=1e-6)
    np.testing.assert_allclose(a.vmax, b.vmax, rtol=1e-6)


def test_native_coverage(tris):
    v0, v1, v2 = tris
    nodes = native.build_bvh_native(v0, v1, v2)
    n = len(v0)
    counts = np.zeros(n, np.int64)
    for i in range(len(nodes.vmin)):
        if nodes.leaf_count[i] > 0:
            s, c = nodes.leaf_start[i], nodes.leaf_count[i]
            counts[s:s + c] += 1
    np.testing.assert_array_equal(counts, 1)
    assert len(np.unique(nodes.perm)) == n


def test_native_single_triangle():
    v0 = np.array([[0, 0, 0]], np.float32)
    v1 = np.array([[1, 0, 0]], np.float32)
    v2 = np.array([[0, 1, 0]], np.float32)
    nodes = native.build_bvh_native(v0, v1, v2)
    assert len(nodes.vmin) == 1
    assert nodes.leaf_count[0] == 1


def _canonical(nodes):
    """Renumber a BVH into preorder-DFS canonical form so builds that differ
    only in node numbering (the parallel builder's atomic id counter) compare
    equal. Children are (left, left+1) by construction."""
    n = len(nodes.vmin)
    order = np.empty(n, np.int64)
    stack = [0]
    k = 0
    while stack:
        i = stack.pop()
        order[k] = i
        k += 1
        if nodes.leaf_count[i] == 0:
            left = nodes.left[i]
            stack.append(left + 1)
            stack.append(left)
    assert k == n
    return (nodes.vmin[order], nodes.vmax[order],
            nodes.leaf_start[order], nodes.leaf_count[order], nodes.perm)


def test_parallel_build_matches_single_thread(tmp_path):
    """The OpenMP subtree-parallel build must produce the same TREE as the
    sequential build (only node numbering may differ). Forcing
    OMP_NUM_THREADS=2 exercises the parallel path even on a 1-core VM."""
    import subprocess
    import sys
    import os
    script = tmp_path / 'build_one.py'
    script.write_text('''
import sys
import numpy as np
from cuda_pathtracer_tpu.accel import native
r = np.random.RandomState(11)
n = 80_000   # above the 1<<16 parallel-path threshold
base = (r.rand(n, 3).astype(np.float32) - 0.5) * 100
v0 = base
v1 = base + (r.rand(n, 3).astype(np.float32) - 0.5)
v2 = base + (r.rand(n, 3).astype(np.float32) - 0.5)
nodes = native.build_bvh_native(v0, v1, v2)
np.savez(sys.argv[1], vmin=nodes.vmin, vmax=nodes.vmax, left=nodes.left,
         leaf_start=nodes.leaf_start, leaf_count=nodes.leaf_count,
         perm=nodes.perm)
''')
    outs = {}
    for nt in ('1', '2'):
        out = tmp_path / f'bvh_{nt}.npz'
        env = dict(os.environ, OMP_NUM_THREADS=nt, JAX_PLATFORMS='cpu',
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))) + ':'
                   + os.environ.get('PYTHONPATH', ''))
        subprocess.run([sys.executable, str(script), str(out)], check=True,
                       env=env, timeout=300)
        outs[nt] = np.load(out)

    class N:
        def __init__(self, z):
            self.vmin, self.vmax = z['vmin'], z['vmax']
            self.left = z['left']
            self.leaf_start, self.leaf_count = z['leaf_start'], z['leaf_count']
            self.perm = z['perm']

    a = _canonical(N(outs['1']))
    b = _canonical(N(outs['2']))
    for x, y, name in zip(a, b, ('vmin', 'vmax', 'leaf_start', 'leaf_count',
                                 'perm')):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_failed_build_raises_with_make_output(tmp_path, monkeypatch):
    """A build that fails raises with make's output: no silent fallback to
    the numpy builder."""
    (tmp_path / 'Makefile').write_text(
        'all:\n\t@echo no compiler here >&2; false\n')
    monkeypatch.setattr(native, '_DIR', str(tmp_path))
    monkeypatch.setattr(native, '_LIB', None)
    with pytest.raises(RuntimeError, match='no compiler here'):
        native.load()
