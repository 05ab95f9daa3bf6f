"""Profiling and observability.

The reference's observability is printf: an FPS EMA every 60 ticks
(src/main.cpp:416-418) and BVH-build wall times (src/bvhBuilder.h:37,264).
This module provides the equivalents here: a stage timer with
block_until_ready fencing, the FPS EMA, and a reduction of jax.profiler
traces to per-kernel device time (SURVEY §5's replacement for nvprof).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall time per named stage; device work is fenced so the
    numbers mean what they say."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.perf_counter()
        yield
        if fence is not None:
            jax.block_until_ready(fence)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f'{name:30s} {tot * 1e3:9.1f} ms total '
                         f'({tot / n * 1e3:8.2f} ms x {n})')
        return '\n'.join(lines)


class FpsMeter:
    """The running-average FPS of main.cpp:416-418 (EMA 0.95/0.05)."""

    def __init__(self, report_every: int = 60):
        self.ema = 0.0
        self.tick = 0
        self.report_every = report_every
        self._last = None

    def frame(self) -> float | None:
        """Call once per frame; returns the EMA when it's time to report."""
        now = time.perf_counter()
        if self._last is not None:
            fps = 1.0 / max(now - self._last, 1e-9)
            self.ema = self.ema * 0.95 + 0.05 * fps
        self._last = now
        self.tick += 1
        if self.tick % self.report_every == 0:
            return self.ema
        return None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace for per-kernel timing (view with TensorBoard or
    xprof) — the nvprof/Nsight replacement."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def _categorize_op(name: str) -> str:
    n = name.lower()
    if 'traverse_kernel' in n or 'cpt_traverse' in n:
        return 'traversal-kernel'
    if 'sort' in n:
        return 'sort'
    if 'scatter' in n or 'dynamic-update' in n or 'dynamic_update' in n:
        return 'scatter'
    if 'gather' in n:
        return 'gather'
    if 'fusion' in n:
        return 'fusion'
    if 'copy' in n or 'memcpy' in n or 'memset' in n or 'transpose' in n:
        return 'copy/layout'
    if 'reduce' in n:
        return 'reduce'
    return 'other'


def gpu_kernel_ms(xplane_path: str) -> dict:
    """{kernel name: device ms} summed over the GPU device planes of a
    jax.profiler trace (their lines are CUDA streams, their events kernels
    and copies). Raises when the trace holds no GPU device plane."""
    data = jax.profiler.ProfileData.from_file(xplane_path)
    planes = [p for p in data.planes if p.name.startswith('/device:GPU')]
    if not planes:
        raise RuntimeError('no GPU device plane in the trace: '
                           + ', '.join(p.name for p in data.planes))
    op_ms = defaultdict(float)
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                op_ms[ev.name] += ev.duration_ns / 1e6
    return dict(op_ms)


def device_op_shares(run, log_dir: str):
    """Run `run()` under a profiler trace and return {category: device ms}
    summed over the kernels on the GPU device planes — the per-stage cost
    breakdown the reference reads off nvprof (its guiding share: 2.3% of
    frame, README.md:119-124). `run` must end in block_until_ready.
    Raises when the trace holds no GPU device plane."""
    import glob
    import shutil
    shutil.rmtree(log_dir, ignore_errors=True)
    jax.profiler.start_trace(log_dir)
    run()
    jax.profiler.stop_trace()

    paths = sorted(glob.glob(f'{log_dir}/**/*.xplane.pb', recursive=True))
    if not paths:
        raise RuntimeError(f'no profile written under {log_dir}')
    op_ms = gpu_kernel_ms(paths[-1])
    cat_ms = defaultdict(float)
    for name, ms in op_ms.items():
        cat_ms[_categorize_op(name)] += ms
    top = sorted(op_ms.items(), key=lambda kv: -kv[1])[:12]
    cat_ms['_top_ops'] = top
    return dict(cat_ms)
