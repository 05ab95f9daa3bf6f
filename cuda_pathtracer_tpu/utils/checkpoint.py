"""Render-state checkpoint/resume.

The reference persists only the camera (save.txt, src/stateLoader.h:30-75) —
that format is kept bit-compatible in scene/state.py. This module adds the
SURVEY §5 "improvement" checkpoints: the full progressive render state
(luminance/albedo accumulators, the path-guiding radiance cache, sample and
RNG counters) snapshots to one .npz so a long converge can resume across
process restarts.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.camera import Camera
from ..models.guiding import RadianceState

FORMAT_VERSION = 1


def save_checkpoint(path: str, engine, camera: Camera) -> None:
    """Snapshot a Pathtracer/ShardedPathtracer's progressive state."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        width=engine.width,
        height=engine.height,
        lum=np.asarray(engine.lum),
        alb=np.asarray(engine.alb),
        radiance_cache=np.asarray(engine.radiance.cache),
        radiance_total=np.asarray(engine.radiance.total),
        sample_idx=engine.sample_idx,
        rand_idx=int(np.asarray(engine.rand_idx)),
        rays_traced=float(np.asarray(engine.rays_traced)),
        nee=engine.nee,
        cache=engine.cache,
        cam_eye=np.asarray(camera.eye),
        cam_view=np.asarray(camera.view_dir),
        cam_d=float(camera.d),
        cam_focal=float(camera.focal_length),
        cam_aperture=float(camera.aperture),
    )


def load_checkpoint(path: str, engine) -> Camera:
    """Restore a snapshot into an engine built for the same scene/resolution.
    Returns the camera the snapshot was rendered with."""
    z = np.load(path)
    assert int(z['version']) == FORMAT_VERSION, 'unknown checkpoint version'
    assert int(z['width']) == engine.width and int(z['height']) == engine.height, \
        'checkpoint resolution does not match the engine'
    assert z['radiance_cache'].shape == tuple(engine.radiance.cache.shape), \
        'checkpoint scene (triangle count) does not match'
    engine.lum = jnp.asarray(z['lum'])
    engine.alb = jnp.asarray(z['alb'])
    engine.radiance = RadianceState(jnp.asarray(z['radiance_cache']),
                                    jnp.asarray(z['radiance_total']))
    engine.sample_idx = int(z['sample_idx'])
    engine.rand_idx = int(z['rand_idx'])
    engine.rays_traced = float(z['rays_traced'])
    engine.nee = bool(z['nee'])
    engine.cache = bool(z['cache'])
    return Camera.create(z['cam_eye'], z['cam_view'], float(z['cam_d']),
                         float(z['cam_focal']), float(z['cam_aperture']))
