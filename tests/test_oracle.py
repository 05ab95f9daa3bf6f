"""Independent brute-force oracle renderer (VERDICT round-3 item 5).

Every other render test compares the engine against itself (goldens, tier
diff-tests, NEE-on/off A/Bs). This one compares it against an INDEPENDENT
implementation: a float64 numpy path tracer with

  * brute-force closest-hit over ALL triangles + planes (no BVH),
  * brute-force any-hit NEE visibility,
  * its own RNG (numpy PCG64, nothing shared with core/rng.py),
  * its own cosine-hemisphere sampling and NEE estimator.

Both are unbiased estimators of the same depth-truncated transport integral,
so their MEANS must agree — any traversal bug (missed/false hit), shading
factor error, pdf/weight bias or NEE double-count shows up as a mean shift.
This is the quantitative version of the reference's DEBUG_ENERGY audit
(src/main.cpp:342-366), anchored outside the engine.

Scene conventions mirrored from models/shading.py (and src/kernels.h):
  * diffuse BRDF = albedo/pi, cosine sampling, throughput *= albedo
  * emissive hits add mask*emission and TERMINATE the path; under NEE they
    only count when from_specular (kernels.h:563-576)
  * plane checkerboard: 4-unit cells, (1,1,1) vs 0.2 (kernels.h:578-582)
  * sky on miss adds mask*sky (uniform sky here)
  * camera: uniform pixel jitter + barrel distortion r+0.2r^3, aperture 0
    (src/types.h:641-676)
"""
import numpy as np
import pytest
import jax.numpy as jnp

from cuda_pathtracer_tpu.scene.scene import (Scene, Material, GameObject,
                                             Plane)
from cuda_pathtracer_tpu.models.pathtracer import render_sample
from cuda_pathtracer_tpu.models import film
from cuda_pathtracer_tpu.models.guiding import init_radiance_state
from cuda_pathtracer_tpu.models.sky import build_sky_pairs
from cuda_pathtracer_tpu.ops.dispatch import trace
from cuda_pathtracer_tpu.core.camera import Camera

W, H = 32, 24
SKY_L = 0.25   # uniform sky radiance


# ---------------------------------------------------------------------------
# scene: diffuse cube + emissive cube light + checkerboard plane
# ---------------------------------------------------------------------------

def build_scene(reference_assets):
    scene = Scene(asset_dirs=[reference_assets])
    grey = scene.add_material(Material.DIFFUSE((0.5, 0.4, 0.3)))
    glow = Material.DIFFUSE((1.0, 1.0, 1.0))
    glow.emission = (6.0, 6.0, 6.0)
    glow_id = scene.add_material(glow)
    cube = scene.add_model('cube.obj', 1.0, (0, 0, 0), (0, 0, 0), grey)
    scene.add_object(GameObject(cube))
    light = GameObject(cube, material_id=glow_id)
    light.position[:] = [1.5, 4.0, 1.0]
    scene.add_object(light)
    scene.add_plane(Plane((0.0, 1.0, 0.0), 1.5, grey))
    scene.finalize()
    return scene


def cam():
    return Camera.create([0.0, 1.2, -5.0], [0.0, -0.05, 1.0], 1.5, 6.0, 0.0)


# ---------------------------------------------------------------------------
# oracle geometry/material extraction (host-side, float64)
# ---------------------------------------------------------------------------

def oracle_scene(scene):
    """World triangles (from tri_meta cols 2:11 — the baked world verts),
    per-tri albedo/emission resolved through the HOST material list, and the
    host plane list."""
    arrays, dyn = scene.to_device(), scene.dynamic_arrays()
    tm = np.asarray(dyn.tri_meta, np.float64)
    gid = tm[:, 0].astype(np.int64)
    inst = tm[:, 1].astype(np.int64)
    v0, v1, v2 = tm[:, 2:5], tm[:, 5:8], tm[:, 8:11]
    tri_mat = np.asarray(arrays.tri_mat, np.int64)[gid]
    over = np.asarray(dyn.inst_mat, np.int64)[inst]
    mid = np.where(over >= 0, over, tri_mat)
    alb = np.array([m.diffuse_color for m in scene.materials], np.float64)[mid]
    emis = np.array([m.emission for m in scene.materials], np.float64)[mid]
    planes = [(np.asarray(p.normal, np.float64), float(p.d),
               scene.materials[p.material]) for p in scene.planes]
    return dict(v0=v0, v1=v1, v2=v2, alb=alb, emis=emis, planes=planes,
                arrays=arrays, dyn=dyn)


def oracle_camera_rays(camera, rng, n):
    """f64 mirror of camera.generate_rays with aperture=0
    (src/types.h:641-676): pinhole from eye through the barrel-distorted,
    uniformly jittered screen point."""
    eye = np.asarray(camera.eye, np.float64)
    view = np.asarray(camera.view_dir, np.float64)
    d = float(camera.d)
    center = eye + d * view
    up = np.array([0.0, 1.0, 0.0])
    u = np.cross(up, view)
    u /= np.linalg.norm(u)
    v = np.cross(view, u)
    v /= np.linalg.norm(v)
    ar = W / H
    lt = center - u * ar - v
    uu, vv = 2.0 * ar * u, 2.0 * v

    pix = np.arange(W * H)
    xs = np.tile(pix % W, n)
    ys = np.tile(pix // W, n)
    xf = (xs + rng.random(xs.shape)) / W
    yf = (ys + rng.random(ys.shape)) / H
    p = lt + xf[:, None] * uu + yf[:, None] * vv
    fc = p - center
    r = np.linalg.norm(fc, axis=1)
    rd_ = r + 0.2 * r ** 3
    p = center + fc * (rd_ / np.maximum(1e-12, r))[:, None]
    direction = p - eye
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    origin = np.broadcast_to(eye, direction.shape).copy()
    return origin, direction


def oracle_closest(o, dvec, osc, t_cap=np.inf):
    """Brute-force closest hit over ALL triangles + planes. Returns
    (t, kind, idx): kind -1 miss, 0 triangle, 1 plane."""
    n = o.shape[0]
    best_t = np.full(n, t_cap)
    kind = np.full(n, -1, np.int64)
    idx = np.zeros(n, np.int64)
    v0, v1, v2 = osc['v0'], osc['v1'], osc['v2']
    # chunk triangles to bound memory at big batch sizes
    for s in range(0, v0.shape[0], 512):
        a, b, c = (v0[s:s + 512][None], v1[s:s + 512][None],
                   v2[s:s + 512][None])
        e1, e2 = b - a, c - a
        pv = np.cross(dvec[:, None, :], e2)
        det = np.sum(e1 * pv, axis=-1)
        inv = np.where(np.abs(det) < 1e-300, np.inf, 1.0 / det)
        tv = o[:, None, :] - a
        uu = np.sum(tv * pv, axis=-1) * inv
        qv = np.cross(tv, e1)
        vv = np.sum(dvec[:, None, :] * qv, axis=-1) * inv
        tt = np.sum(e2 * qv, axis=-1) * inv
        ok = ((uu >= 0) & (uu <= 1) & (vv >= 0) & (uu + vv <= 1)
              & (tt > 1e-9) & (tt < best_t[:, None]))
        tt = np.where(ok, tt, np.inf)
        j = np.argmin(tt, axis=1)
        tj = tt[np.arange(n), j]
        upd = tj < best_t
        best_t = np.where(upd, tj, best_t)
        kind = np.where(upd, 0, kind)
        idx = np.where(upd, s + j, idx)
    for pi, (nrm, pd, _m) in enumerate(osc['planes']):
        q = dvec @ nrm
        t = -(o @ nrm + pd) / np.where(np.abs(q) < 1e-300, np.inf, q)
        upd = (np.abs(q) > 0) & (t > 1e-9) & (t < best_t)
        best_t = np.where(upd, t, best_t)
        kind = np.where(upd, 1, kind)
        idx = np.where(upd, pi, idx)
    return best_t, kind, idx


def oracle_render(osc, camera, rng, spp, max_depth):
    """BSDF-only (no NEE, no RR) f64 path tracer to `max_depth` — the same
    depth-truncated integral the engine estimates."""
    total = np.zeros((W * H, 3))
    CH = 64   # spp per chunk
    done = 0
    while done < spp:
        n = min(CH, spp - done)
        o, d = oracle_camera_rays(camera, rng, n)
        L = o.shape[0]
        mask = np.ones((L, 3))
        acc = np.zeros((L, 3))
        alive = np.ones(L, bool)
        for _b in range(max_depth):
            if not alive.any():
                break
            t, kind, idx = oracle_closest(o[alive], d[alive], osc)
            gl = np.where(alive)[0]
            miss = kind < 0
            acc[gl[miss]] += mask[gl[miss]] * SKY_L
            hit_tri = kind == 0
            hit_pla = kind == 1
            pos = o[alive] + t[:, None] * d[alive]
            # triangle shading
            em = np.zeros((t.shape[0], 3))
            albedo = np.zeros((t.shape[0], 3))
            nrm = np.zeros((t.shape[0], 3))
            if hit_tri.any():
                ti = idx[hit_tri]
                em[hit_tri] = osc['emis'][ti]
                albedo[hit_tri] = osc['alb'][ti]
                e1 = osc['v1'][ti] - osc['v0'][ti]
                e2 = osc['v2'][ti] - osc['v0'][ti]
                nn = np.cross(e1, e2)
                nrm[hit_tri] = nn / np.linalg.norm(nn, axis=1, keepdims=True)
            if hit_pla.any():
                for pi, (pn, _pd, pm) in enumerate(osc['planes']):
                    sel = hit_pla & (idx == pi)
                    if not sel.any():
                        continue
                    px = np.abs(pos[sel, 0] / 4.0 + 1000.0).astype(np.int64)
                    py = np.abs(pos[sel, 2] / 4.0 + 1000.0).astype(np.int64)
                    # the checker REPLACES the material diffuse
                    # (kernels.h:578-582, models/shading.py plane branch)
                    chk = np.where(((px + py) % 2 == 0)[:, None],
                                   np.ones(3), np.full(3, 0.2))
                    albedo[sel] = chk
                    em[sel] = pm.emission
                    nrm[sel] = pn
            # emissive hits terminate (kernels.h:563-576, NEE off: always add)
            emissive = (~miss) & (em.max(axis=1) > 1e-4)
            acc[gl[emissive]] += mask[gl[emissive]] * em[emissive]
            scat = (~miss) & ~emissive
            # flip normal toward the incoming ray
            face_n = np.where((np.sum(d[alive] * nrm, axis=1) > 0)[:, None],
                              -nrm, nrm)
            # cosine-hemisphere sample about face_n (own basis + RNG)
            r1 = rng.random(t.shape[0])
            r2 = rng.random(t.shape[0])
            st = np.sqrt(r1)
            phi = 2 * np.pi * r2
            a_ = np.where(np.abs(face_n[:, 0])[:, None] > 0.9,
                          np.array([0.0, 1.0, 0.0]),
                          np.array([1.0, 0.0, 0.0]))
            tx = np.cross(a_, face_n)
            tx /= np.maximum(np.linalg.norm(tx, axis=1, keepdims=True), 1e-300)
            ty = np.cross(face_n, tx)
            nd = (tx * (st * np.cos(phi))[:, None]
                  + ty * (st * np.sin(phi))[:, None]
                  + face_n * np.sqrt(1 - r1)[:, None])
            # throughput *= albedo (pi * brdf, kernels.h:772-781)
            mask[gl] = np.where(scat[:, None], mask[gl] * albedo, mask[gl])
            o2 = pos + 1e-7 * face_n
            new_alive = np.zeros(L, bool)
            new_alive[gl[scat]] = True
            o[gl], d[gl] = o2, nd
            alive = new_alive
        total += acc.reshape(n, W * H, 3).sum(axis=0)
        done += n
    return total / spp


# ---------------------------------------------------------------------------
# engine render at the same config
# ---------------------------------------------------------------------------

def engine_render(scene, camera, samples, max_bounces, nee, seed0=0):
    arrays, dyn = scene.to_device(), scene.dynamic_arrays()
    # uniform sky (replace both the raw image and the pair table the shader
    # samples — the furnace-test trick)
    uni = np.full((8, 16, 3), SKY_L, np.float32)
    arrays = arrays._replace(sky_img=jnp.asarray(uni),
                             sky_pairs=jnp.asarray(build_sky_pairs(uni)))
    radiance = init_radiance_state(int(arrays.tri_mat.shape[0]))
    lum, alb = film.clear_accumulators(W * H)
    rand_idx = jnp.uint32(seed0)
    for s in range(samples):
        lum, alb, _, rand_idx, _ = render_sample(
            arrays, dyn, camera, radiance, lum, alb,
            jnp.uint32(seed0 + s), rand_idx, jnp.asarray(False),
            nee=nee, cache_on=False, max_bounces=max_bounces,
            width=W, height=H, guide_off=True)
    lum = np.asarray(lum, np.float64)
    return lum[:, :3] / lum[:, 3:4]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def osc(reference_assets):
    return oracle_scene(build_scene(reference_assets))


def test_oracle_closest_hit(reference_assets, osc):
    """Engine trace() (the dispatch path) vs f64 brute force
    over all triangles+planes: same hit set, same t, same prim kind."""
    rng = np.random.default_rng(7)
    camera = cam()
    o, d = oracle_camera_rays(camera, rng, 4)   # 4 jittered rays/pixel
    bt, bk, _bi = oracle_closest(o, d, osc)

    hit = trace(osc['arrays'], osc['dyn'], jnp.asarray(o, jnp.float32),
                jnp.asarray(d, jnp.float32))
    et = np.asarray(hit.t, np.float64)
    ei = np.asarray(hit.intersected)

    assert 0.0 < ei.mean() < 1.0
    # same hit classification everywhere (f32 vs f64 can only disagree on
    # measure-zero grazing rays; none at this resolution/seed)
    agree = ei == (bk >= 0)
    assert agree.mean() > 0.999, f'{(~agree).sum()} classification diffs'
    both = ei & (bk >= 0)
    rel = np.abs(et[both] - bt[both]) / np.maximum(bt[both], 1e-9)
    assert np.percentile(rel, 99) < 1e-4, f'p99 rel t err {np.percentile(rel, 99)}'
    assert rel.max() < 1e-2


def test_oracle_nee_visibility(reference_assets, osc):
    """Engine any-hit occlusion vs brute force: shadow feelers from surface
    points toward the light, engine trace(any_hit=True) must agree with the
    f64 oracle's occlusion bit."""
    rng = np.random.default_rng(11)
    camera = cam()
    o, d = oracle_camera_rays(camera, rng, 2)
    t, kind, _ = oracle_closest(o, d, osc)
    sel = kind >= 0
    pos = (o + t[:, None] * d)[sel]
    # aim at jittered points on the emissive cube's top face (y≈4.5)
    lp = np.stack([1.0 + rng.random(pos.shape[0]),
                   np.full(pos.shape[0], 4.499),
                   0.5 + rng.random(pos.shape[0])], axis=1)
    sd = lp - pos
    dist = np.linalg.norm(sd, axis=1)
    sd /= dist[:, None]
    so = pos + 1e-4 * sd
    tmax = dist - 2e-4
    bt, bk, _ = oracle_closest(so, sd, osc, t_cap=np.inf)
    occluded_oracle = (bk >= 0) & (bt < tmax)

    hit = trace(osc['arrays'], osc['dyn'], jnp.asarray(so, jnp.float32),
                jnp.asarray(sd, jnp.float32),
                t_max=jnp.asarray(tmax, jnp.float32), any_hit=True)
    occluded_engine = np.asarray(hit.intersected)
    assert 0.0 < occluded_oracle.mean() < 1.0   # both classes present
    agree = occluded_engine == occluded_oracle
    assert agree.mean() > 0.995, f'{(~agree).sum()} occlusion diffs'


@pytest.mark.slow
def test_oracle_energy(reference_assets):
    """Engine (NEE on AND off) vs the independent f64 oracle: per-pixel
    relMSE and global energy of two unbiased estimators of the same
    integral must converge. Catches any systematic transport bias."""
    scene = build_scene(reference_assets)
    osc_ = oracle_scene(scene)
    camera = cam()
    M = 4
    rng = np.random.default_rng(3)
    ref = oracle_render(osc_, camera, rng, spp=768, max_depth=M)

    for nee in (False, True):
        img = engine_render(scene, camera, samples=256, max_bounces=M,
                            nee=nee)
        # global energy: MC noise on the mean at these sample counts is
        # ~0.2%; 1.5% catches any real factor error
        ge = img.mean() / ref.mean()
        assert abs(ge - 1.0) < 0.015, f'nee={nee}: energy ratio {ge:.4f}'
        # per-pixel relMSE, gauged against the pure-noise floor: a second
        # engine render with disjoint RNG streams prices what two unbiased
        # 256-spp estimates differ by; the oracle comparison must sit at
        # that scale (oracle noise is smaller: 768 spp). A localized bias
        # (wrong shadow, misplaced hit) blows relmse past the gauge.
        img_b = engine_render(scene, camera, samples=256, max_bounces=M,
                              nee=nee, seed0=1 << 16)
        denom = np.maximum(ref.mean(axis=1), 1e-3)

        def relmse(a, b):
            return np.mean(((a - b).mean(axis=1) / denom) ** 2)

        noise = relmse(img, img_b)
        vs_oracle = relmse(img, ref)
        assert vs_oracle < max(1.5 * noise, 5e-4), \
            f'nee={nee}: relMSE {vs_oracle:.5f} vs noise gauge {noise:.5f}'
