"""Wavefront shading: the vectorized material/NEE/bounce stage.

Behavioral mirror of kernel_shade + kernel_connect (src/kernels.h:513-810),
restructured for SIMT-by-select execution: every lane computes every
branch and the results are merged with masks, while the per-lane RNG stream is
advanced only at the draw sites the reference would actually execute on that
lane (sampling.masked_rand) — so draw sequences match the CUDA threads
one-to-one.

Ray lanes are pixel-indexed (no compaction): the reference's AtomicQueue push
of survivors (src/types.h:534-537) becomes an `alive` mask; shadow rays live
in their own masked lane set, one per pixel, exactly mirroring the
DShadowRayQueue capacity of NR_PIXELS.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import sampling
from . import sky as sky_mod
from .guiding import SAMPLE_IGNORE, SAMPLE_TERMINATE, SAMPLE_BUCKET, RadianceState
from ..core import rng as _rng
from ..core import vecmath as vm
from ..ops.lookup import table_lookup
from ..ops.traverse import Hit, PRIM_TRIANGLE, PRIM_SPHERE, PRIM_PLANE
from ..constants import EPS, PI


class TraceState(NamedTuple):
    """Per-pixel path state (TraceState, src/types.h:461-468)."""
    mask: jnp.ndarray           # f32[B, 3] throughput
    accucolor: jnp.ndarray      # f32[B, 3]
    light: jnp.ndarray          # f32[B, 3] pending NEE contribution
    from_specular: jnp.ndarray  # bool[B]
    albedo_set: jnp.ndarray     # bool[B]

    @staticmethod
    def clear(n: int) -> 'TraceState':
        """kernel_clear_state (src/kernels.h:485-491): mask=1,
        fromSpecular=true, accucolor=0, albedoSet=false."""
        return TraceState(
            mask=jnp.ones((n, 3), jnp.float32),
            accucolor=jnp.zeros((n, 3), jnp.float32),
            light=jnp.zeros((n, 3), jnp.float32),
            from_specular=jnp.ones(n, bool),
            albedo_set=jnp.zeros(n, bool))


class ShadeOutput(NamedTuple):
    state: TraceState
    ray_o: jnp.ndarray          # f32[B, 3] secondary ray
    ray_d: jnp.ndarray
    alive: jnp.ndarray          # bool[B]
    shadow_o: jnp.ndarray       # f32[B, 3]
    shadow_d: jnp.ndarray
    shadow_tmax: jnp.ndarray    # f32[B]
    shadow_active: jnp.ndarray  # bool[B]
    cache_stype: jnp.ndarray    # i32[B]
    cache_tri: jnp.ndarray      # i32[B]
    cache_bucket: jnp.ndarray   # i32[B]
    cache_cum_mask: jnp.ndarray  # f32[B, 3]
    albedo_add: jnp.ndarray     # f32[B, 3]
    albedo_inc: jnp.ndarray     # f32[B] 1.0 where albedo written this bounce


def _reflect_ray(rd, normal, pos):
    """getReflectRay (src/kernels.h:452-456)."""
    nd = vm.reflect(rd, normal)
    return pos + EPS * nd, nd


def _refract(rd, normal, pos, ior, absorption, inside, t):
    """getRefractRay (src/kernels.h:458-483). Returns
    (refract_o, refract_d, reflected_prob, beer). The reference's
    sinti = sqrt(max(0, 1 - costi - costi)) is reproduced verbatim for parity
    (it reads like a typo for 1 - costi*costi but is the shipped behavior)."""
    n1 = jnp.where(inside, ior, 1.0)
    n2 = jnp.where(inside, 1.0, ior)
    eta = n1 / jnp.maximum(n2, 1e-9)
    costi = vm.dot(normal, -rd)
    k = 1.0 - (eta * eta) * (1.0 - costi * costi)
    tir = k < 0.0
    refract_d = eta[..., None] * rd + normal * (
        eta * costi - jnp.sqrt(jnp.maximum(k, 0.0)))[..., None]
    refract_d = vm.normalize(refract_d, eps=1e-12)

    sinti = jnp.sqrt(jnp.maximum(0.0, 1.0 - costi - costi))
    costt = jnp.sqrt(jnp.maximum(1.0 - eta * eta * sinti * sinti, 0.0))
    spol = (n1 * costi - n2 * costt) / jnp.maximum(n1 * costi + n2 * costt, 1e-9)
    ppol = (n1 * costt - n2 * costi) / jnp.maximum(n1 * costt + n2 * costi, 1e-9)
    reflected = jnp.where(tir, 1.0, 0.5 * (spol * spol + ppol * ppol))

    beer = jnp.where(inside[..., None],
                     jnp.exp(-absorption * t[..., None]), 1.0)
    return pos + EPS * refract_d, refract_d, reflected, beer


def shade(scene, dyn, ro, rd, hit: Hit, state: TraceState, ray_active,
          xs, ys, rand_idx, sample_idx, bounce,
          nee: bool, cache_on: bool, radiance: RadianceState,
          width: int, bn_sample=None) -> ShadeOutput:
    """One wavefront shade pass. `nee`/`cache_on` are static toggles (the
    reference's __constant__ DNEE/DCACHE synced per clear, src/globals.h:8-28).
    `ray_active` marks lanes that had a ray this bounce (the wavefront queue
    membership); lanes outside it keep their state untouched.
    """
    B = ro.shape[0]
    f3 = lambda m: m[..., None]  # noqa: E731 broadcast helper

    # ---- sky escape (kernels.h:526-537) ----
    missed = ray_active & ~hit.intersected
    sk = sky_mod.sample_sky_pairs(scene.sky_pairs, scene.sky_img.shape[:2],
                                  rd, live=missed)
    sky_add = state.mask * sk
    albedo_add = jnp.where(f3(missed & ~state.albedo_set), sky_add, 0.0)
    albedo_inc = (missed & ~state.albedo_set).astype(jnp.float32)
    accucolor = state.accucolor + jnp.where(f3(missed), sky_add, 0.0)
    albedo_set = state.albedo_set | missed

    live = hit.intersected  # lanes still shading

    # ---- per-bounce RNG (kernels.h:540-542). The blue-noise texture read is
    # constant per pixel, so callers running a bounce loop hoist it out and
    # pass bn_sample (saves one gather dispatch per bounce) ----
    if bn_sample is None:
        bw = scene.blue_noise.shape[1]
        bh = scene.blue_noise.shape[0]
        bn_sample = scene.blue_noise[ys % bh, xs % bw]
    # rand_idx / sample_idx may be per-lane vectors (spp-batched wavefronts
    # give each sample's lanes a disjoint rand_idx window)
    rand_state = _rng.RandState(
        seed=_rng.get_seed(xs, ys, rand_idx, width),
        bn_sample=bn_sample,
        bn_idx=jnp.broadcast_to(jnp.asarray(rand_idx, jnp.uint32), (B,)),
        sample_idx=jnp.asarray(sample_idx, jnp.uint32))

    # ---- hit decode: every per-hit lookup is ONE fat-row gather ----
    pid = jnp.maximum(hit.prim_id, 0)
    # ONE pid-keyed gather serves gid|inst AND the baked shade attrs (cols
    # 11:27: model-space normal/tangent/bitangent, uvs, mid — scene.py bakes
    # tri_packed[gid] per world tri), from a table of ONLY the columns this
    # program reads: cache_on reads just gid|inst (attrs ride tri_guide
    # below); cache_off needs the baked attrs too, minus tangent/bitangent
    # when the scene has no normal maps. The traversal returns the
    # barycentrics (hit.u/hit.v), so the world-vert columns are never read.
    # The table is a swapped concat of column pieces (a single slice from
    # col 0 would be folded back into the loop parameter by the algebraic
    # simplifier). That shape, the >=8-column pad and the scalar column
    # picks below are gather-layout choices whose cost on the GPU is not
    # measured yet.
    tm = dyn.tri_meta
    has_nmap = int(scene.nmap_marker.shape[0]) > 0
    # pid -> (gid, inst) by ARITHMETIC when the scene's world tris are few
    # contiguous per-instance blocks (always true by construction,
    # accel/toplevel.py emit; gate on block count so the unrolled chain
    # stays tiny): gid = pid + delta(block), inst = inst(block). This
    # removes cols 0|1 from the gather below entirely.
    blocks = getattr(dyn, 'tri_blocks', None)
    n_blocks = int(blocks.shape[0]) if blocks is not None else 0
    use_decode = 1 <= n_blocks <= 64
    gi_cols = [] if use_decode else [0, 1]
    if cache_on:
        want = gi_cols
    elif has_nmap:
        want = gi_cols + list(range(11, 27))
    else:
        # drop tangent/bitangent (old 14:20) and the pad
        want = gi_cols + list(range(11, 14)) + list(range(20, 27))
    # Pad narrow programs to >=8 gathered columns with real neighbor cols.
    # The extra columns are unused (and unread: scalar col picks below).
    if want:
        pad_col = 11
        while len(want) < 8 and pad_col < 27:
            if pad_col not in want:
                want.append(pad_col)
            pad_col += 1
        # contiguous pieces of `want`, rotated so the first piece doesn't
        # start at column 0 (the swap requirement above)
        want = sorted(want)
        pieces, start = [], want[0]
        for a, b in zip(want, want[1:] + [None]):
            if b != a + 1:
                pieces.append((start, a + 1))
                start = b
        if len(pieces) > 1:
            pieces = pieces[1:] + pieces[:1]
        else:
            # single contiguous run: split and swap the halves so the
            # simplifier can't fold the concat back into the raw parameter
            a, b = pieces[0]
            mid = a + (b - a + 1) // 2
            pieces = [(mid, b), (a, mid)]
        cols = [c for (a, b) in pieces for c in range(a, b)]
        _pos = {c: i for i, c in enumerate(cols)}
        tm_tab = jnp.concatenate([tm[:, a:b] for a, b in pieces], axis=1)
        tri_meta = tm_tab[pid]             # f32[B, len(cols)]
        # SCALAR column picks only (block slices can push XLA to a
        # row-major gather layout)
        mcol = lambda j: tri_meta[..., _pos[j]]  # noqa: E731
    else:
        mcol = None                        # decode covers every wanted col
    if use_decode:
        # unrolled compare/select over the sorted block bases; pid < 2^24 so
        # the f32 compares and the pid+delta sum are exact
        bi, ii, dd = blocks[:, 0], blocks[:, 1], blocks[:, 2]
        pidf = pid.astype(jnp.float32)
        instf = jnp.broadcast_to(ii[0], pid.shape)
        deltaf = jnp.broadcast_to(dd[0], pid.shape)
        for k in range(1, n_blocks):
            ge = pidf >= bi[k]
            instf = jnp.where(ge, ii[k], instf)
            deltaf = jnp.where(ge, dd[k], deltaf)
        gid = (pidf + deltaf).astype(jnp.int32)
        inst = instf.astype(jnp.int32)
    else:
        gid = jnp.maximum(mcol(0).astype(jnp.int32), 0)
        inst = jnp.maximum(mcol(1).astype(jnp.int32), 0)
    is_tri = live & (hit.prim_type == PRIM_TRIANGLE)
    is_sphere = live & (hit.prim_type == PRIM_SPHERE)
    is_plane = live & (hit.prim_type == PRIM_PLANE)

    pos = ro + f3(hit.t) * rd

    # one fused gather serves triangle attributes AND the guiding cache row
    # (both keyed by gid): a second big-table gather costs a full dispatch
    if cache_on:
        tri_guide = jnp.concatenate([scene.tri_packed, radiance.cache],
                                    axis=1)               # [T, 24]
        row = tri_guide[gid]
        trip, rc_row = row[..., :16], row[..., 16:24]
        nrm_model = trip[..., 0:3]
        tang = trip[..., 3:6]
        bitang = trip[..., 6:9]
        uvs = trip[..., 9:15]                             # [B, 6]
        mid_f = trip[..., 15]
    else:
        # no second gather: the per-tri shade attrs are BAKED into
        # tri_meta cols 11:27 per world triangle (scene.py), so the one
        # tm_tab gather above already fetched them. tangent/bitangent are
        # consumed only by the normal-map branch (statically absent here
        # when the scene carries no normal maps — and then also absent
        # from the staged concat above).
        nrm_model = jnp.stack([mcol(11), mcol(12), mcol(13)], axis=-1)
        if has_nmap:
            tang = jnp.stack([mcol(14), mcol(15), mcol(16)], axis=-1)
            bitang = jnp.stack([mcol(17), mcol(18), mcol(19)], axis=-1)
        else:
            tang = bitang = None
        uvs = jnp.stack([mcol(20), mcol(21), mcol(22), mcol(23), mcol(24),
                         mcol(25)], axis=-1)
        mid_f = mcol(26)
        rc_row = None
    instp = table_lookup(dyn.inst_packed, inst)           # [B, 16]
    inst_tf = instp[..., 0:12].reshape(*instp.shape[:-1], 3, 4)
    override = jax.lax.bitcast_convert_type(instp[..., 12], jnp.int32)

    # material id with instance override (getColliderMaterialID, kernels.h:88-99)
    n_sph = scene.sphere_packed.shape[0]
    n_pla = scene.plane_packed.shape[0]
    tri_mid = jax.lax.bitcast_convert_type(mid_f, jnp.int32)
    mid = jnp.where(override >= 0, override, tri_mid)
    sphp = plap = None
    if n_sph:
        sphp = table_lookup(scene.sphere_packed, jnp.clip(pid, 0, n_sph - 1))
        mid = jnp.where(is_sphere,
                        jax.lax.bitcast_convert_type(sphp[..., 4], jnp.int32),
                        mid)
    if n_pla:
        plap = table_lookup(scene.plane_packed, jnp.clip(pid, 0, n_pla - 1))
        mid = jnp.where(is_plane,
                        jax.lax.bitcast_convert_type(plap[..., 4], jnp.int32),
                        mid)
    mid = jnp.clip(mid, 0, scene.mat_packed.shape[0] - 1)

    matp = table_lookup(scene.mat_packed, mid)            # [B, 24]
    diffuse = matp[..., 0:3]
    emission = matp[..., 6:9]
    reflect_p = matp[..., 9]
    glossy = matp[..., 10]
    transmit_p = matp[..., 11]
    ior = matp[..., 12]
    absorption = matp[..., 13:16]
    tex_id = jax.lax.bitcast_convert_type(matp[..., 16], jnp.int32)
    ntex_id = jax.lax.bitcast_convert_type(matp[..., 17], jnp.int32)

    # normal (getColliderNormal, kernels.h:101-118 + world transform :553-556)
    normal = vm.normalize(vm.transform_dir(inst_tf, nrm_model), eps=1e-12)
    if n_sph:
        normal = jnp.where(f3(is_sphere),
                           vm.normalize(pos - sphp[..., 0:3], eps=1e-12), normal)
    if n_pla:
        normal = jnp.where(f3(is_plane), plap[..., 0:3], normal)
    original_normal = normal

    inside = vm.dot(rd, original_normal) > 0.0
    surface_normal = jnp.where(f3(inside), -original_normal, original_normal)
    collider_normal = surface_normal

    # ---- emissive hit (kernels.h:563-576) ----
    is_emissive = live & (vm.max_comp(emission) > EPS)
    emis_visible = is_emissive & ((not nee) | state.from_specular)
    emis_add = state.mask * emission
    accucolor = accucolor + jnp.where(f3(emis_visible), emis_add, 0.0)
    albedo_add = albedo_add + jnp.where(f3(emis_visible & ~albedo_set), emis_add, 0.0)
    albedo_inc = albedo_inc + (emis_visible & ~albedo_set).astype(jnp.float32)
    albedo_set = albedo_set | emis_visible
    live = live & ~is_emissive  # emissive hits terminate the path

    # ---- plane checkerboard (kernels.h:578-582) ----
    if n_pla:
        px = jnp.abs(pos[..., 0] / 4.0 + 1000.0).astype(jnp.uint32)
        py = jnp.abs(pos[..., 2] / 4.0 + 1000.0).astype(jnp.uint32)
        checker = jnp.where(((px + py) % 2 == 0)[..., None],
                            jnp.ones(3, jnp.float32),
                            jnp.full(3, 0.2, jnp.float32))
        diffuse = jnp.where(f3(is_plane), checker, diffuse)

    # ---- texturing barycentrics (kernels.h:585-619) ----
    has_tex = is_tri & (tex_id >= 0)
    has_nmap = is_tri & (ntex_id >= 0)
    needs_uv = has_tex | has_nmap
    # the traversal returns the winning triangle's Möller (u, v)
    tu, tv = hit.u, hit.v
    w0 = 1.0 - tu - tv
    uv_u = uvs[..., 0] * w0 + uvs[..., 2] * tu + uvs[..., 4] * tv
    uv_v = uvs[..., 1] * w0 + uvs[..., 3] * tu + uvs[..., 5] * tv

    if int(scene.textures.texels.shape[0]) > 1:
        from ..scene.textures import sample_bilinear
        texel = sample_bilinear(scene.textures, jnp.maximum(tex_id, 0), uv_u,
                                uv_v, live=has_tex)
        diffuse = jnp.where(f3(has_tex), diffuse * texel, diffuse)

        # normal-map fetch + TBN transform, statically skipped when no
        # material carries a normal map (nmap_marker shape flag)
        if int(scene.nmap_marker.shape[0]) > 0:
            ntexel = sample_bilinear(scene.textures, jnp.maximum(ntex_id, 0),
                                     uv_u, uv_v, live=has_nmap)
            tn = ntexel * 2.0 - 1.0
            tex_normal = (tn[..., 0:1] * tang + tn[..., 1:2] * bitang
                          + tn[..., 2:3] * nrm_model)
            tex_normal = vm.normalize(
                vm.transform_dir(inst_tf, tex_normal), eps=1e-12)
            flip = vm.dot(tex_normal, collider_normal) < 0.0
            tex_normal = jnp.where(f3(flip), -tex_normal, tex_normal)
            collider_normal = jnp.where(f3(has_nmap), tex_normal,
                                        collider_normal)

    # ---- branch select (kernels.h:624-661) ----
    brdf = diffuse / PI
    r_branch, rand_state = sampling.masked_rand(rand_state, live)
    take_transmit = live & (r_branch < transmit_p)
    take_reflect = live & ~take_transmit & (r_branch - transmit_p < reflect_p)
    take_diffuse = live & ~take_transmit & ~take_reflect

    mask = state.mask

    # transmit branch
    refr_o, refr_d, refl_prob, beer = _refract(rd, collider_normal, pos, ior,
                                               absorption, inside, hit.t)
    mask = jnp.where(f3(take_transmit), mask * beer, mask)
    r_fres, rand_state = sampling.masked_rand(rand_state, take_transmit)
    fres_reflect = take_transmit & (r_fres < refl_prob)
    refl_o, refl_d = _reflect_ray(rd, collider_normal, pos)
    mask = jnp.where(f3(fres_reflect), mask * diffuse, mask)
    spec_o = jnp.where(f3(fres_reflect), refl_o, refr_o)
    spec_d = jnp.where(f3(fres_reflect), refl_d, refr_d)

    # reflect branch
    mask = jnp.where(f3(take_reflect), mask * diffuse, mask)
    spec_o = jnp.where(f3(take_reflect), refl_o, spec_o)
    spec_d = jnp.where(f3(take_reflect), refl_d, spec_d)

    # glossy perturbation (both specular branches, kernels.h:651-660; the
    # reference does NOT renormalize the lerped direction)
    take_spec = take_transmit | take_reflect
    g0, rand_state = sampling.masked_rand(rand_state, take_spec)
    g1, rand_state = sampling.masked_rand(rand_state, take_spec)
    noise_d = sampling.hemisphere_cosine(spec_d, g0, g1)
    spec_d = spec_d * f3(1.0 - glossy) + f3(glossy) * noise_d

    from_specular = jnp.where(live, take_spec, state.from_specular)

    # ---- diffuse branch ----
    albedo_add = albedo_add + jnp.where(f3(take_diffuse & ~albedo_set),
                                        mask * diffuse, 0.0)
    albedo_inc = albedo_inc + (take_diffuse & ~albedo_set).astype(jnp.float32)
    albedo_set = albedo_set | take_diffuse

    # NEE: 4-candidate area-light sampling (kernels.h:672-752)
    shadow_o = jnp.zeros_like(ro)
    shadow_d = jnp.zeros_like(rd)
    shadow_tmax = jnp.zeros(B, jnp.float32)
    shadow_active = jnp.zeros(B, bool)
    light_out = state.light
    n_lights = int(dyn.light_packed.shape[0])
    if nee and n_lights > 0:
        valid = jnp.zeros(B, jnp.float32)
        success = jnp.zeros(B, jnp.int32)
        for _ in range(4):
            rl, rand_state = sampling.masked_rand(rand_state, take_diffuse)
            pick = jnp.mod((rl * n_lights).astype(jnp.uint32),
                           jnp.uint32(n_lights)).astype(jnp.int32)
            lp = table_lookup(dyn.light_packed, pick)
            centroid = (lp[..., 0:3] + lp[..., 3:6] + lp[..., 6:9]) / 3.0
            lnorm = lp[..., 9:12]
            from_light = vm.normalize(pos - centroid, eps=1e-12)
            ok = take_diffuse & (vm.dot(lnorm, from_light) > 0.0)
            valid = valid + ok.astype(jnp.float32)
            success = jnp.where(ok, pick, success)

        has_light = take_diffuse & (valid > 0.0)
        lu, rand_state = sampling.masked_rand(rand_state, has_light)
        lv, rand_state = sampling.masked_rand(rand_state, has_light)
        fold = lu + lv > 1.0
        lu = jnp.where(fold, 1.0 - lu, lu)
        lv = jnp.where(fold, 1.0 - lv, lv)

        lps = table_lookup(dyn.light_packed, success)
        lv0 = lps[..., 0:3]
        v0v1 = lps[..., 3:6] - lv0
        v0v2 = lps[..., 6:9] - lv0
        cr = vm.cross(v0v1, v0v2)
        cr_len = jnp.maximum(vm.length(cr), 1e-20)
        sample_point = lv0 + f3(lu) * v0v1 + f3(lv) * v0v2

        sdir = pos - sample_point
        slen = jnp.maximum(vm.length(sdir), 1e-20)
        inv_slen = 1.0 / slen
        sdir = sdir * f3(inv_slen)
        lnormal = cr * f3(1.0 / cr_len)
        nl = vm.dot(collider_normal, -sdir)
        lnl = vm.dot(lnormal, sdir)
        unoccludable = has_light & (nl > 0.0) \
            & (vm.dot(-sdir, surface_normal) > 0.0) & (lnl > 0.0)

        l_emis = lps[..., 12:15]
        area = 0.5 * cr_len
        sa = lnl * area * inv_slen * inv_slen
        contrib = mask * f3(nl * sa * n_lights * (valid / 4.0)) * brdf * l_emis
        light_out = jnp.where(f3(unoccludable), contrib, light_out)

        # inverted shadow ray for coherent origins (kernels.h:746-750)
        fw = lnl * lnl * lnl
        shadow_o = sample_point + f3(fw * EPS) * sdir + f3((1.0 - fw) * EPS) * lnormal
        shadow_d = sdir
        shadow_tmax = slen - 2.0 * EPS
        shadow_active = unoccludable

    # hemisphere sample: guided or cosine (kernels.h:755-770)
    guided = take_diffuse & jnp.asarray(cache_on) & is_tri \
        & (vm.dot(collider_normal, original_normal) > 0.0)
    # column form: [L]-shaped slices of the merged 24-col row gather keep
    # the CDF walk lane-major (the [L,8] array form made XLA rematerialize
    # the cache gather from the raw [T,8] table in a column-major layout)
    rc = rc_row if rc_row is not None else radiance.cache[gid]
    rc_cols = [rc[..., j] for j in range(rc.shape[-1])]
    # radianceTotal is identically sum(cache) under our update rule — derive
    # it instead of a second gather (kernels.h:899 maintains it incrementally)
    rt = rc_cols[0]
    for _c in rc_cols[1:]:
        rt = rt + _c
    gs, rand_state = sampling.masked_rand(rand_state, guided)
    gr0, rand_state = sampling.masked_rand(rand_state, guided)
    gr1, rand_state = sampling.masked_rand(rand_state, guided)
    gdir, gbucket, ginvprob = sampling.hemisphere_cached_cols(
        collider_normal, rc_cols, rt, gs, gr0, gr1)

    plain = take_diffuse & ~guided
    c0, rand_state = sampling.masked_rand(rand_state, plain)
    c1, rand_state = sampling.masked_rand(rand_state, plain)
    cdir = sampling.hemisphere_cosine(collider_normal, c0, c1)

    r_dir = jnp.where(f3(guided), gdir, cdir)
    mask = jnp.where(f3(guided), mask * f3(ginvprob), mask)

    cache_stype = jnp.where(guided, SAMPLE_BUCKET,
                            jnp.where(live, SAMPLE_IGNORE, SAMPLE_TERMINATE))
    cache_tri = jnp.where(guided, gid, 0)
    cache_bucket = jnp.where(guided, gbucket, 0)
    cache_cum_mask = jnp.where(f3(guided), mask, 1.0)

    # kill reversed samples, offset trick, BRDF (kernels.h:772-781)
    reversed_ = take_diffuse & (vm.dot(r_dir, surface_normal) < 0.0)
    mask = jnp.where(f3(reversed_), 0.0, mask)
    fdot = jnp.maximum(vm.dot(collider_normal, r_dir), 0.0)
    fcube = fdot * fdot * fdot
    diff_o = pos + f3(EPS * fcube) * r_dir + f3(EPS * (1.0 - fcube)) * collider_normal
    mask = jnp.where(f3(take_diffuse), mask * PI * brdf, mask)

    russian_p = jnp.where(take_diffuse,
                          jnp.clip(vm.max_comp(diffuse), 0.1, 0.9), 1.0)

    new_o = jnp.where(f3(take_diffuse), diff_o, spec_o)
    new_d = jnp.where(f3(take_diffuse), r_dir, spec_d)

    # ---- Russian roulette (kernels.h:784-793) ----
    rr, rand_state = sampling.masked_rand(rand_state, live)
    survive = live & (vm.max_comp(mask) > 0.0001) & (rr < russian_p)
    mask = jnp.where(f3(survive), mask / f3(russian_p), mask)
    cache_stype = jnp.where(live & ~survive, SAMPLE_TERMINATE, cache_stype)

    # merge state: lanes not shading this bounce keep previous values
    out_state = TraceState(
        mask=jnp.where(f3(live), mask, state.mask),
        accucolor=accucolor,
        light=light_out,
        from_specular=from_specular,
        albedo_set=albedo_set)

    return ShadeOutput(
        state=out_state,
        ray_o=new_o, ray_d=new_d, alive=survive,
        shadow_o=shadow_o, shadow_d=shadow_d,
        shadow_tmax=shadow_tmax, shadow_active=shadow_active,
        cache_stype=cache_stype.astype(jnp.int32),
        cache_tri=cache_tri.astype(jnp.int32),
        cache_bucket=cache_bucket.astype(jnp.int32),
        cache_cum_mask=cache_cum_mask,
        albedo_add=albedo_add, albedo_inc=albedo_inc)


# NOTE: there is deliberately no standalone connect() here — the engine
# traces the NEE shadow rays as a separate dest-sorted any-hit wavefront
# right after shade (kernel_connect, src/kernels.h:799-810; see
# models/pathtracer.py::_bounce_body). Round 1's extend+connect traversal
# fusion is obsolete on the packet path: packets pay no per-dispatch gather
# overhead, and separate calls let each wavefront sort by its own key.
