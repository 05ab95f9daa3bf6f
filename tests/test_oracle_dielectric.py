"""f64 oracle for the SPECULAR transport paths (VERDICT round-4 item 5).

tests/test_oracle.py anchors closest-hit, NEE visibility and the diffuse
transport factors against an independent float64 brute-force renderer — but
it is BSDF-diffuse-only. This module teaches the oracle the full material
branch of the reference (stochastic transmit/reflect/diffuse select,
refraction with Fresnel reweighting — including the verbatim
`sinti = sqrt(max(0, 1 - costi - costi))` of src/kernels.h:464 — Beer
absorption, and the glossy lerp WITHOUT renormalization of
src/kernels.h:651-660) and renders a scene with a glass cube and a glossy
mirror cube. A factor error anywhere in the engine's
refract/Fresnel/Beer/glossy branch (models/shading.py:321-352,
src/kernels.h:624-661 + 458-483) now fails CI instead of just shifting a
self-golden.

Estimator notes (both sides estimate the SAME depth-truncated integral):
  * branch select: draw r; transmit if r < t, reflect if r - t < refl,
    else diffuse — a probability-proportional pick of the BSDF mixture, so
    branch weights stay 1 (kernels.h:624-631).
  * transmit: mask *= beer first (both sub-branches), then Fresnel pick:
    reflect with prob `reflected` (mask *= diffuse), else refract
    (kernels.h:633-653).
  * reflect: mask *= diffuse (kernels.h:655-658).
  * glossy: d' = (1-g)*d + g*cosine_sample(d), NOT normalized — subsequent
    bounces propagate the non-unit direction through the same formulas on
    both sides (kernels.h:651-660 parity).
  * the oracle runs no NEE and no Russian roulette; the engine runs RR and
    (in one variant) NEE — all are unbiased, so the MEANS must agree.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from cuda_pathtracer_tpu.scene.scene import (Scene, Material, GameObject,
                                             Plane)

from test_oracle import (W, H, SKY_L, cam, engine_render, oracle_camera_rays,
                         oracle_closest)

pytestmark = pytest.mark.slow


def build_dielectric_scene(reference_assets):
    """Grey cube + emissive cube + checker plane (the test_oracle fixture
    set) PLUS a glass cube and a glossy mirror cube."""
    scene = Scene(asset_dirs=[reference_assets])
    grey = scene.add_material(Material.DIFFUSE((0.5, 0.4, 0.3)))
    glow = Material.DIFFUSE((1.0, 1.0, 1.0))
    glow.emission = (6.0, 6.0, 6.0)
    glow_id = scene.add_material(glow)
    # glass: forced-white diffuse like the MTL pipeline does
    # (src/scene.h:214-217), transmit-dominant, real absorption
    glass = Material(diffuse_color=(1.0, 1.0, 1.0), transmit=0.95,
                     refractive_index=1.5, absorption=(0.12, 0.04, 0.02))
    glass_id = scene.add_material(glass)
    mirror = Material(diffuse_color=(0.9, 0.75, 0.6), reflect=0.85,
                      glossy=0.25)
    mirror_id = scene.add_material(mirror)

    cube = scene.add_model('cube.obj', 1.0, (0, 0, 0), (0, 0, 0), grey)
    scene.add_object(GameObject(cube))
    light = GameObject(cube, material_id=glow_id)
    light.position[:] = [1.5, 4.0, 1.0]
    scene.add_object(light)
    g = GameObject(cube, material_id=glass_id)
    g.position[:] = [-2.2, 0.2, -0.8]
    scene.add_object(g)
    m = GameObject(cube, material_id=mirror_id)
    m.position[:] = [2.4, 0.0, 0.6]
    scene.add_object(m)
    scene.add_plane(Plane((0.0, 1.0, 0.0), 1.5, grey))
    scene.finalize()
    return scene


def oracle_scene_full(scene):
    """tri tables + FULL per-tri material rows resolved through the host
    material list (diffuse, emission, reflect, glossy, transmit, ior,
    absorption) + plane list."""
    arrays, dyn = scene.to_device(), scene.dynamic_arrays()
    tm = np.asarray(dyn.tri_meta, np.float64)
    gid = tm[:, 0].astype(np.int64)
    inst = tm[:, 1].astype(np.int64)
    tri_mat = np.asarray(arrays.tri_mat, np.int64)[gid]
    over = np.asarray(dyn.inst_mat, np.int64)[inst]
    mid = np.where(over >= 0, over, tri_mat)
    mats = scene.materials

    def col(get):
        return np.array([get(m) for m in mats], np.float64)[mid]

    planes = [(np.asarray(p.normal, np.float64), float(p.d),
               scene.materials[p.material]) for p in scene.planes]
    return dict(
        v0=tm[:, 2:5], v1=tm[:, 5:8], v2=tm[:, 8:11],
        alb=col(lambda m: m.diffuse_color),
        emis=col(lambda m: m.emission),
        refl=col(lambda m: (m.reflect,))[:, 0],
        gloss=col(lambda m: (m.glossy,))[:, 0],
        transm=col(lambda m: (m.transmit,))[:, 0],
        ior=col(lambda m: (m.refractive_index,))[:, 0],
        absorb=col(lambda m: m.absorption),
        planes=planes, arrays=arrays, dyn=dyn)


def _own_basis(n):
    """Oracle's own orthonormal basis about n (independent of the engine's
    construction; the cosine-hemisphere integral is basis-invariant)."""
    a = np.where(np.abs(n[:, 0])[:, None] > 0.9,
                 np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    tx = np.cross(a, n)
    tx /= np.maximum(np.linalg.norm(tx, axis=1, keepdims=True), 1e-300)
    ty = np.cross(n, tx)
    return tx, ty


def _cosine_about(n, r1, r2):
    st = np.sqrt(r1)
    phi = 2 * np.pi * r2
    tx, ty = _own_basis(n)
    return (tx * (st * np.cos(phi))[:, None]
            + ty * (st * np.sin(phi))[:, None]
            + n * np.sqrt(np.maximum(1 - r1, 0.0))[:, None])


def oracle_render_full(osc, camera, rng, spp, max_depth):
    """f64 path tracer with the FULL material branch (no NEE, no RR)."""
    total = np.zeros((W * H, 3))
    CH = 64
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
            gl = np.where(alive)[0]
            oo, dd = o[alive], d[alive]
            t, kind, idx = oracle_closest(oo, dd, osc)
            k = t.shape[0]
            miss = kind < 0
            acc[gl[miss]] += mask[gl[miss]] * SKY_L
            hit_tri = kind == 0
            hit_pla = kind == 1
            pos = oo + t[:, None] * dd

            em = np.zeros((k, 3))
            albedo = np.zeros((k, 3))
            nrm = np.zeros((k, 3))
            refl_p = np.zeros(k)
            gloss = np.zeros(k)
            transm = np.zeros(k)
            ior = np.zeros(k)
            absorb = np.zeros((k, 3))
            if hit_tri.any():
                ti = idx[hit_tri]
                em[hit_tri] = osc['emis'][ti]
                albedo[hit_tri] = osc['alb'][ti]
                refl_p[hit_tri] = osc['refl'][ti]
                gloss[hit_tri] = osc['gloss'][ti]
                transm[hit_tri] = osc['transm'][ti]
                ior[hit_tri] = osc['ior'][ti]
                absorb[hit_tri] = osc['absorb'][ti]
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
                    chk = np.where(((px + py) % 2 == 0)[:, None],
                                   np.ones(3), np.full(3, 0.2))
                    albedo[sel] = chk
                    em[sel] = pm.emission
                    nrm[sel] = pn

            emissive = (~miss) & (em.max(axis=1) > 1e-4)
            acc[gl[emissive]] += mask[gl[emissive]] * em[emissive]
            scat = (~miss) & ~emissive

            inside = np.sum(dd * nrm, axis=1) > 0.0
            face_n = np.where(inside[:, None], -nrm, nrm)

            # ---- stochastic branch select (kernels.h:624-631) ----
            rb = rng.random(k)
            take_t = scat & (rb < transm)
            take_r = scat & ~take_t & (rb - transm < refl_p)
            take_d = scat & ~take_t & ~take_r

            new_d = np.zeros((k, 3))
            new_o = np.zeros((k, 3))
            m2 = mask[gl].copy()

            # transmit branch: Beer, then Fresnel pick (kernels.h:633-653,
            # getRefractRay 458-483 with the verbatim sinti typo)
            if take_t.any():
                n1 = np.where(inside, ior, 1.0)
                n2 = np.where(inside, 1.0, ior)
                eta = n1 / np.maximum(n2, 1e-12)
                costi = np.sum(face_n * -dd, axis=1)
                kk = 1.0 - eta * eta * (1.0 - costi * costi)
                tir = kk < 0.0
                refr_d = (eta[:, None] * dd + face_n
                          * (eta * costi - np.sqrt(np.maximum(kk, 0)))[:, None])
                refr_d /= np.maximum(
                    np.linalg.norm(refr_d, axis=1, keepdims=True), 1e-300)
                sinti = np.sqrt(np.maximum(0.0, 1.0 - costi - costi))
                costt = np.sqrt(np.maximum(1.0 - eta * eta * sinti * sinti, 0))
                spol = (n1 * costi - n2 * costt) / np.maximum(
                    n1 * costi + n2 * costt, 1e-12)
                ppol = (n1 * costt - n2 * costi) / np.maximum(
                    n1 * costt + n2 * costi, 1e-12)
                reflected = np.where(tir, 1.0, 0.5 * (spol ** 2 + ppol ** 2))
                beer = np.where(inside[:, None],
                                np.exp(-absorb * t[:, None]), 1.0)
                m2 = np.where(take_t[:, None], m2 * beer, m2)
                rf = rng.random(k)
                fres = take_t & (rf < reflected)
                refl_d = dd - 2.0 * np.sum(dd * face_n, axis=1)[:, None] * face_n
                m2 = np.where(fres[:, None], m2 * albedo, m2)
                sd = np.where(fres[:, None], refl_d, refr_d)
                so = pos + 1e-7 * sd
                new_d = np.where(take_t[:, None], sd, new_d)
                new_o = np.where(take_t[:, None], so, new_o)

            # reflect branch (kernels.h:655-658)
            if take_r.any():
                refl_d = dd - 2.0 * np.sum(dd * face_n, axis=1)[:, None] * face_n
                m2 = np.where(take_r[:, None], m2 * albedo, m2)
                new_d = np.where(take_r[:, None], refl_d, new_d)
                new_o = np.where(take_r[:, None], pos + 1e-7 * refl_d, new_o)

            # glossy lerp on BOTH specular branches, NOT renormalized
            take_s = take_t | take_r
            if take_s.any():
                g0 = np.where(take_s, rng.random(k), 0.0)
                g1 = np.where(take_s, rng.random(k), 0.0)
                sdn = new_d / np.maximum(
                    np.linalg.norm(new_d, axis=1, keepdims=True), 1e-300)
                noise = _cosine_about(sdn, g0, g1)
                gd = new_d * (1.0 - gloss)[:, None] + gloss[:, None] * noise
                new_d = np.where(take_s[:, None], gd, new_d)

            # diffuse branch (cosine sample, throughput *= albedo)
            if take_d.any():
                r1 = np.where(take_d, rng.random(k), 0.0)
                r2 = np.where(take_d, rng.random(k), 0.0)
                nd = _cosine_about(face_n, r1, r2)
                m2 = np.where(take_d[:, None], m2 * albedo, m2)
                new_d = np.where(take_d[:, None], nd, new_d)
                new_o = np.where(take_d[:, None], pos + 1e-7 * face_n, new_o)

            mask[gl] = m2
            new_alive = np.zeros(L, bool)
            new_alive[gl[take_t | take_r | take_d]] = True
            o[gl], d[gl] = new_o, new_d
            alive = new_alive
        total += acc.reshape(n, W * H, 3).sum(axis=0)
        done += n
    return total / spp


@pytest.fixture(scope='module')
def dielectric(reference_assets):
    scene = build_dielectric_scene(reference_assets)
    return scene, oracle_scene_full(scene)


def test_oracle_dielectric_energy(reference_assets, dielectric):
    """Engine (NEE on AND off) vs the independent f64 oracle on a scene with
    a glass cube and a glossy mirror: global energy within MC error and
    per-pixel relMSE at the pure-noise floor. A factor error in
    refract/Fresnel/Beer/glossy (src/kernels.h:624-661, 458-483) fails this
    gate."""
    scene, osc_ = dielectric
    camera = cam()
    M = 6
    rng = np.random.default_rng(5)
    ref = oracle_render_full(osc_, camera, rng, spp=1024, max_depth=M)

    for nee in (False, True):
        img = engine_render(scene, camera, samples=256, max_bounces=M,
                            nee=nee)
        ge = img.mean() / ref.mean()
        assert abs(ge - 1.0) < 0.02, f'nee={nee}: energy ratio {ge:.4f}'

        img_b = engine_render(scene, camera, samples=256, max_bounces=M,
                              nee=nee, seed0=1 << 16)
        denom = np.maximum(ref.mean(axis=1), 1e-3)

        def relmse(a, b):
            return np.mean(((a - b).mean(axis=1) / denom) ** 2)

        noise = relmse(img, img_b)
        vs_oracle = relmse(img, ref)
        assert vs_oracle < max(1.5 * noise, 1e-3), \
            f'nee={nee}: relMSE {vs_oracle:.5f} vs noise gauge {noise:.5f}'


def test_oracle_dielectric_sanity(reference_assets, dielectric):
    """Cheap structural checks: the glass cube transmits (rays reach the
    floor behind it), Beer tints transmitted paths, and the oracle scene
    actually contains all four cubes."""
    scene, osc_ = dielectric
    assert osc_['v0'].shape[0] == 4 * 12 + 0  # four cubes, 12 tris each
    assert (osc_['transm'] > 0.9).sum() == 12
    assert (osc_['refl'] > 0.8).sum() == 12
    camera = cam()
    rng = np.random.default_rng(9)
    img = oracle_render_full(osc_, camera, rng, spp=32, max_depth=6)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01
