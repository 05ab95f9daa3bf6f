"""Multi-chip rendering: band sharding over a jax.sharding.Mesh.

The reference is single-GPU (SURVEY.md §2: no NCCL/MPI anywhere); frames are
embarrassingly parallel over pixels, so the multi-card scaling axis is pure
data parallelism over a 1-D mesh (cards joined all to all, as NVLink joins
the cards of one host). `ShardedPathtracer` is a THIN subclass of the tuned single-chip
engine: it overrides only `_sample_dispatch`, replacing the sequential
host-side band loop with a `shard_map` that places whole bands on mesh
devices. Every band runs the SAME `render_sample` configuration as the
single-chip engine — tile-ordered lanes, spp batching, multi-level tail
narrowing, deferred guiding — so a sharded render is BIT-identical per band
(the per-band luminance is the same array either way; only the order of the
floating-point guiding partial-sum reduction differs, by design the same
lullaby as the single-chip band loop's left-to-right sum).

Collectives: one `psum` for the guiding bucket sums (applied before the
nonlinear EMA so every card holds the same cache), a `pmax` for the rand
counter and a `psum` for the ray statistic; XLA hands them to NCCL on GPUs.
Framebuffer shards cross the interconnect only at display time (jax
assembles the sharded array on fetch). Each band's traversal kernel call
runs inside the `shard_map`, on its own device's stream.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.pathtracer import Pathtracer, render_sample
from ..models import film
from ..models.guiding import propagate as guide_propagate


def make_mesh(devices=None, axis_name: str = 'b') -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


class ShardedPathtracer(Pathtracer):
    """Multi-chip progressive renderer: same host API and same engine
    configuration as models.Pathtracer, with the frame's bands sharded over
    every device in the mesh.

    Any resolution a single chip accepts works here too: when no band count
    that is a multiple of the mesh size divides the height, the internal
    frame is PADDED to the next height that shards evenly. The pad rows
    render off-frustum rays (camera framing stays keyed to the requested
    height via `full_height`) and are cropped from `image()`/`energy()`, so
    the visible output is identical to an unpadded render."""

    def __init__(self, scene, width: int = 640, height: int = 480,
                 mesh: Mesh | None = None, skydome: str | None = None,
                 spp: int | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.out_height = height
        super().__init__(scene, width, height, skydome=skydome, spp=spp)
        n = int(self.mesh.devices.size)
        best = self._mesh_band_count(height, n)
        if best is None:
            # pad: smallest height >= requested that the minimum mesh-aligned
            # band count divides evenly (e.g. H=100 on 8 devices -> 104).
            # When the width allows the tile lane order, prefer a padded
            # height whose band_h is a multiple of 8 so tile_order stays on.
            b0 = -(-self.bands // n) * n
            padded = -(-height // b0) * b0
            if width % 16 == 0 and (padded // b0) % 8:
                aligned = -(-height // (b0 * 8)) * (b0 * 8)
                # accept up to ~25% extra rows for the aligned layout
                if aligned - height <= max(8 * b0, height // 4):
                    padded = aligned
            self.height = padded
            self.lum, self.alb = film.clear_accumulators(width * padded)
            best = self._mesh_band_count(padded, n)
            assert best is not None, (height, padded, n)
        self._set_bands(best)
        if width % 16 == 0 and not self.tile_order:
            print(f'mesh: band_h={self.band_h} not tile-aligned; '
                  f'tile lane order disabled for this geometry')
        self._sharded_fns = {}

    def _mesh_band_count(self, height: int, n: int):
        """Smallest band count that is a multiple of the mesh size and
        divides `height`; prefers tile-aligned bands (band_h % 8 == 0)."""
        best = None
        b = -(-self.bands // n) * n
        while b <= height:
            if height % b == 0:
                if (height // b) % 8 == 0 or self.width % 16:
                    return b
                if best is None:
                    best = b
            b += n
        return best

    def _sharded(self, key):
        if key in self._sharded_fns:
            return self._sharded_fns[key]
        g_on, max_bounces, use_spp, nee, cache_on = key
        axis = self.mesh.axis_names[0]
        n_dev = int(self.mesh.devices.size)
        per_dev = self.bands // n_dev
        # camera framing keys to the REQUESTED height: pad rows (if any)
        # trace off-frustum rays and are cropped at display time
        W, H, band_h = self.width, self.out_height, self.band_h
        tile_order = self.tile_order

        def per_shard(scene, dyn, camera, radiance, lum_b, alb_b,
                      sample_idx, rand_idx, guide, row0_b, bn_b):
            # lum_b: [per_dev, band_len, 4] — this device's bands, identical
            # math to the single-chip band loop body
            lums, albs = [], []
            gsum = gcnt = None
            ridx = rand_idx
            rays = jnp.zeros((), jnp.float32)
            for j in range(per_dev):
                lum_j, alb_j, (s_b, c_b), ridx_j, rays_j = render_sample(
                    scene, dyn, camera, radiance, lum_b[j], alb_b[j],
                    sample_idx, rand_idx, guide, bn_b[j],
                    nee=nee, cache_on=cache_on, max_bounces=max_bounces,
                    width=W, height=band_h, full_height=H,
                    row_offset=row0_b[j], defer_guide=True,
                    tile_order=tile_order, spp=use_spp, guide_off=not g_on)
                lums.append(lum_j)
                albs.append(alb_j)
                gsum = s_b if gsum is None else gsum + s_b
                gcnt = c_b if gcnt is None else gcnt + c_b
                ridx = jnp.maximum(ridx, ridx_j)
                rays = rays + rays_j
            # the only collectives in a frame: guiding sums (before the
            # nonlinear EMA), the rand counter max, the ray statistic
            gsum = jax.lax.psum(gsum, axis)
            gcnt = jax.lax.psum(gcnt, axis)
            ridx = jax.lax.pmax(ridx, axis)
            rays = jax.lax.psum(rays, axis)
            radiance2 = radiance
            if use_spp > 1:
                # per-sample sums: the nonlinear EMA runs once per sample,
                # matching the single-chip engine and the reference
                for s in range(use_spp):
                    radiance2 = guide_propagate(radiance2, gsum[s],
                                                gcnt[s], guide)
            else:
                radiance2 = guide_propagate(radiance, gsum, gcnt, guide)
            return (jnp.stack(lums), jnp.stack(albs), radiance2, ridx, rays)

        sharded = jax.shard_map(
            per_shard, mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(), P(), P(),
                      P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(), P(), P()),
            check_vma=False)

        row0 = jnp.arange(self.bands, dtype=jnp.int32) * band_h
        bn_stack = jnp.stack(self._bn_bands())

        @jax.jit
        def run(scene, dyn, camera, radiance, lum, alb,
                sample_idx, rand_idx, guide):
            bl = band_h * W
            lum_s = lum.reshape(self.bands, bl, 4)
            alb_s = alb.reshape(self.bands, bl, 4)
            out = sharded(scene, dyn, camera, radiance, lum_s, alb_s,
                          sample_idx, rand_idx, guide, row0, bn_stack)
            lum2, alb2, radiance2, ridx, rays = out
            return (lum2.reshape(-1, 4), alb2.reshape(-1, 4), radiance2,
                    ridx, rays)

        self._sharded_fns[key] = run
        return run

    def _sample_dispatch(self, camera, guide, g_on: bool, max_bounces: int,
                         use_spp: int):
        run = self._sharded((g_on, max_bounces, use_spp,
                             self.nee, self.cache))
        # give the carried state (accumulators, radiance cache, rand
        # counter) the shardings the program returns it with, so the first
        # call after a clear and the ones after it share one compiled
        # program (a fresh single-device input would compile another)
        axis = self.mesh.axis_names[0]
        self.lum, self.alb = jax.device_put(
            (self.lum, self.alb), NamedSharding(self.mesh, P(axis)))
        self.radiance, rand_idx = jax.device_put(
            (self.radiance, jnp.asarray(self.rand_idx, jnp.uint32)),
            NamedSharding(self.mesh, P()))
        self.lum, self.alb, self.radiance, ridx, rays = run(
            self.arrays, self.dyn, camera, self.radiance,
            self.lum, self.alb,
            jnp.asarray(self.sample_idx, jnp.uint32), rand_idx, guide)
        return ridx, rays

    # ---- pad-aware output (no-ops when height needed no padding) ----

    def image(self, blur: bool = False):
        if self.height == self.out_height:
            return super().image(blur=blur)
        lum, alb = self.accumulators_pixel_order()
        k = self.out_height * self.width
        return film.display(lum[:k], alb[:k], float(self.sample_idx),
                            self.width, self.out_height, blur=blur)

    def energy(self):
        if self.height == self.out_height:
            return super().energy()
        lum, _ = self.accumulators_pixel_order()
        total, has_nan, has_neg = film.energy_audit(
            lum[:self.out_height * self.width])
        return float(total), bool(has_nan), bool(has_neg)
