"""The wavefront path-tracing engine.

Counterpart of the reference Pathtracer (src/pathtracer.h:46-311):
one jitted `render_sample` runs the whole generate → extend → shade → connect
wavefront for a sample, with the bounce loop as a `lax.while_loop` carrying
fixed-shape SoA state (alive masks instead of AtomicQueues), followed by the
fused guiding update and framebuffer accumulation. The host loop only decides
sample counts and toggles, mirroring Pathtracer::Render's orchestration
(src/pathtracer.h:224-302).

Design notes:
  * everything is pixel-indexed and statically shaped — XLA compiles exactly
    one program per (resolution, toggle set); camera motion, sample index and
    rand counters are traced scalars, so interaction never recompiles;
  * the per-bounce early exit is the while_loop predicate any(alive), the
    moral equivalent of the wavefront queues shrinking to empty;
  * the RNG is derived from pixel coordinates (core/rng.py), which makes
    multi-chip pixel sharding bit-identical to single-chip rendering.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import film
from .guiding import (RadianceState, SampleCache, init_radiance_state,
                      update_radiance_state)
from .shading import TraceState, shade
from ..core import camera as cam_mod
from ..core import rng as _rng
from ..ops.dispatch import trace
from ..constants import MAX_RAY_DEPTH, MAX_CACHE_DEPTH, T_MAX


# tail-narrowing configuration (see render_sample): after TAIL_START bounces
# survivors are compacted into a B/TAIL_DIV buffer; disabled under
# TAIL_MIN_LANES where the narrow width can't amortize the fixed step cost
import os as _os
TAIL_START = int(_os.environ.get('CPT_TAIL_START', '3'))
TAIL_DIV = int(_os.environ.get('CPT_TAIL_DIV', '8'))
TAIL2_START = int(_os.environ.get('CPT_TAIL2_START', '8'))
TAIL2_DIV = int(_os.environ.get('CPT_TAIL2_DIV', '32'))
TAIL_MIN_LANES = 131072

# the reference trains the radiance cache for the first 100 converge samples
# (HCACHE && converge && sampleIndex < 100, src/pathtracer.h:292); module
# constant so unbiasedness tests can shrink the window
GUIDE_TRAIN_SAMPLES = 100


class _BounceCarry(NamedTuple):
    bounce: jnp.ndarray
    ro: jnp.ndarray
    rd: jnp.ndarray
    alive: jnp.ndarray
    state: TraceState
    cache: SampleCache
    rand_idx: jnp.ndarray
    albedo_add: jnp.ndarray
    albedo_inc: jnp.ndarray
    rays_traced: jnp.ndarray  # i64-ish f32 counter: extend + connect rays


def _tile_coords(lanes, width: int):
    """Lane -> pixel mapping in 8x16-tile order: each 128 consecutive lanes
    are one compact 8-row x 16-column pixel tile instead of a thin scanline
    strip, so a CUDA block of the traversal kernel walks a tight ray cone."""
    tpr = width // 16
    g = lanes // 128
    w = lanes % 128
    xs = (g % tpr) * 16 + w % 16
    ys = (g // tpr) * 8 + w // 16
    return xs, ys


def tile_permutation(width: int, height: int):
    """numpy lane->pixel permutation for the tile order (for display
    unpermute); None when the resolution doesn't tile."""
    import numpy as np
    if width % 16 or height % 8:
        return None
    lanes = np.arange(width * height)
    tpr = width // 16
    g, w = lanes // 128, lanes % 128
    xs = (g % tpr) * 16 + w % 16
    ys = (g // tpr) * 8 + w // 16
    return ys * width + xs


def tile_unpermute(arr, width: int, band_h: int, bands: int = 1):
    """Tile-order lanes -> pixel (row-major) order as a pure
    reshape/transpose: the tile layout is structured (lane = tile-major,
    8x16 tiles), so its inverse is a layout transform instead of a
    gather.
    `arr` is [bands*band_h*width, C...]; bands are already pixel-major."""
    th = band_h // 8
    tpr = width // 16
    tail = arr.shape[1:]
    a = arr.reshape(bands, th, tpr, 8, 16, *tail)
    a = jnp.swapaxes(a, 2, 3)              # [bands, th, 8, tpr, 16, ...]
    return a.reshape(bands * band_h * width, *tail)


@partial(jax.jit, static_argnames=('nee', 'cache_on', 'max_bounces',
                                   'width', 'height', 'full_height',
                                   'guide_axis', 'defer_guide',
                                   'tile_order', 'spp', 'guide_off'))
def render_sample(scene, dyn, camera, radiance: RadianceState,
                  lum, alb, sample_idx, rand_idx, guide_enabled,
                  bn_lanes=None,
                  *, nee: bool, cache_on: bool, max_bounces: int,
                  width: int, height: int, full_height: int = 0,
                  row_offset=0, guide_axis: str | None = None,
                  defer_guide: bool = False,
                  tile_order: bool = False, spp: int = 1,
                  guide_off: bool = False):
    """Trace `spp` samples per pixel; returns (lum', alb', radiance',
    rand_idx').

    Mirrors the sample loop in Pathtracer::Render (src/pathtracer.h:255-301);
    with spp > 1 several iterations are BATCHED into one wavefront of
    spp*width*height lanes (sample-major blocks). This amortizes the
    per-bounce fixed costs (shade dispatches, kernel launches) over spp x
    the rays. Each sample's lanes draw from a
    disjoint rand_idx window (stride sized for the worst-case advancement,
    including multi-round tail narrowing) so streams stay decorrelated;
    spp=1 is bit-identical to the unbatched engine.

    For multi-chip sharding (parallel/mesh.py) the function renders a
    horizontal band: `height` is the band height, `row_offset` (traced) the
    band's first global row and `full_height` the full image height — pixel
    coordinates, and therefore RNG streams, stay globally consistent, so a
    sharded render is bit-identical to single-chip.

    With tile_order=True lanes map to pixels in 8x16-tile order so each
    block of 128 lanes is a compact pixel tile; accumulators come back in LANE
    order (unpermute with tile_permutation for display). RNG streams are
    keyed on pixel coordinates, so the rendered image is identical either
    way."""
    full_height = full_height or height
    B = width * height
    L = B * spp
    lanes = jnp.arange(L, dtype=jnp.int32)
    pix = lanes % B
    if tile_order:
        xs, tys = _tile_coords(pix, width)
        ys = tys + jnp.asarray(row_offset, jnp.int32)
    else:
        xs = pix % width
        ys = pix // width + jnp.asarray(row_offset, jnp.int32)
    # per-lane rand_idx offset and sample index for batched spp. The shared
    # rand_idx advances once for generate and once per bounce — but the tail
    # levels below replay their bounce span once per compaction ROUND, so the
    # worst-case advancement is 1 + max_bounces + (rounds-1) * span per level
    # (rounds <= ceil(L / level_width)). The window stride must cover that
    # worst case or sample s's seeds overlap sample s+1's (advisor finding,
    # round 2).
    RSTRIDE = max_bounces + 2
    if max_bounces > TAIL_START and L >= TAIL_MIN_LANES:
        span1 = min(TAIL2_START, max_bounces) - TAIL_START
        RSTRIDE += (TAIL_DIV - 1) * span1
        if max_bounces > TAIL2_START:
            c2 = max(L // TAIL2_DIV, 2048)
            rounds2 = -(-L // c2)
            RSTRIDE += (rounds2 - 1) * (max_bounces - TAIL2_START)
    if spp > 1:
        s_vec = lanes // B
        soff = (s_vec * RSTRIDE).astype(jnp.uint32)
        samp = jnp.asarray(sample_idx, jnp.uint32) + s_vec.astype(jnp.uint32)
    else:
        soff = jnp.uint32(0)
        samp = sample_idx

    # generate primary rays (kernel_generate_primary_rays, kernels.h:493-501;
    # camera jitter uses the raw xorshift stream, types.h:641-658)
    seeds = _rng.get_seed(xs, ys, rand_idx + soff, width)
    ro, rd, _ = cam_mod.generate_rays(camera, xs, ys, seeds, width, full_height)
    rand_idx = rand_idx + jnp.uint32(1)

    state0 = TraceState.clear(L)
    carry = _BounceCarry(
        bounce=jnp.asarray(0, jnp.int32),
        ro=ro, rd=rd,
        alive=jnp.ones(L, bool),
        state=state0,
        cache=SampleCache.empty(L),
        rand_idx=rand_idx,
        albedo_add=jnp.zeros((L, 3), jnp.float32),
        albedo_inc=jnp.zeros(L, jnp.float32),
        rays_traced=jnp.zeros((), jnp.float32))

    def cond(c: _BounceCarry):
        return (c.bounce < max_bounces) & jnp.any(c.alive)

    # blue-noise texture read is constant per pixel: the caller can pass the
    # per-lane values (hoisted to engine init); fall back to gathering here
    # for direct callers
    if bn_lanes is not None:
        bn_all = (jnp.tile(bn_lanes, spp) if spp > 1 else bn_lanes)
    else:
        bnw = scene.blue_noise.shape[1]
        bnh = scene.blue_noise.shape[0]
        bn_all = scene.blue_noise[ys % bnh, xs % bnw]

    def _bounce_body(c: _BounceCarry, xs_l, ys_l, soff_l, samp_l, bn_l):
        # extend: closest hit
        hit = trace(scene, dyn, c.ro, c.rd, active=c.alive)

        out = shade(scene, dyn, c.ro, c.rd, hit, c.state, c.alive,
                    xs_l, ys_l, c.rand_idx + soff_l, samp_l, c.bounce,
                    nee, cache_on, radiance, width, bn_sample=bn_l)
        rand_idx2 = c.rand_idx + jnp.uint32(1)

        # connect: NEE shadow rays traced immediately (kernel_connect,
        # src/kernels.h:799-810), from the light to this bounce's hit points
        if nee:
            sh = trace(scene, dyn, out.shadow_o, out.shadow_d,
                       t_max=out.shadow_tmax, active=out.shadow_active,
                       any_hit=True)
            add = out.shadow_active & ~sh.intersected
            st2 = out.state._replace(
                accucolor=out.state.accucolor
                + jnp.where(add[..., None], out.state.light, 0.0))
            out = out._replace(state=st2)

        # sample-cache write for bounce < MAX_CACHE_DEPTH (kernels.h:536,795)
        w = jnp.minimum(c.bounce, MAX_CACHE_DEPTH - 1)
        in_depth = c.bounce < MAX_CACHE_DEPTH

        def upd(buf, val):
            new = jax.lax.dynamic_update_index_in_dim(buf, val, w, 0)
            return jnp.where(in_depth, new, buf)

        cache = SampleCache(
            stype=upd(c.cache.stype, out.cache_stype),
            tri=upd(c.cache.tri, out.cache_tri),
            bucket=upd(c.cache.bucket, out.cache_bucket),
            cum_mask=upd(c.cache.cum_mask, out.cache_cum_mask))

        n_rays = jnp.sum(c.alive.astype(jnp.float32))
        if nee:
            n_rays = n_rays + jnp.sum(out.shadow_active.astype(jnp.float32))
        return _BounceCarry(
            bounce=c.bounce + 1,
            ro=out.ray_o, rd=out.ray_d, alive=out.alive,
            state=out.state, cache=cache, rand_idx=rand_idx2,
            albedo_add=c.albedo_add + out.albedo_add,
            albedo_inc=c.albedo_inc + out.albedo_inc,
            rays_traced=c.rays_traced + n_rays)

    def body(c: _BounceCarry):
        return _bounce_body(c, xs, ys, soff, samp, bn_all)

    # ---- tail narrowing ----
    # After TAIL_START bounces, branch termination + Russian roulette leave
    # only a fraction of lanes alive, but a lockstep bounce still costs the
    # full wavefront width in shade math and traversal launches. So survivors
    # are compacted into a B/TAIL_DIV-wide buffer and run to completion
    # there, in as many rounds as needed (unbiased — no ray is dropped).
    # SampleCache rows ride through the compaction and scatter back, so
    # guiding updates for bounces < MAX_CACHE_DEPTH stay identical to the
    # full-width loop even when TAIL_START < MAX_CACHE_DEPTH. Disabled for
    # small frames where it can't pay off.
    use_tail = max_bounces > TAIL_START and L >= TAIL_MIN_LANES

    if use_tail:
        main_cond = lambda c: (c.bounce < TAIL_START) & jnp.any(c.alive)  # noqa: E731
    else:
        main_cond = cond
    final = jax.lax.while_loop(main_cond, body, carry)

    if use_tail:
        # narrowing LEVELS: (start_bounce, end_bounce, buffer_width). Each
        # level compacts the still-pending lanes into an ever-narrower buffer
        # — RR halves the live set every bounce, so the per-bounce fixed
        # costs (shade, gathers) must shrink with it, not stay at B.
        levels = [(TAIL_START, min(TAIL2_START, max_bounces),
                   L // TAIL_DIV)]
        if max_bounces > TAIL2_START:
            levels.append((TAIL2_START, max_bounces,
                           max(L // TAIL2_DIV, 2048)))

        tf = dict(alive=final.alive, ro=final.ro, rd=final.rd,
                  mask=final.state.mask,
                  from_specular=final.state.from_specular,
                  albedo_set=final.state.albedo_set,
                  accucolor=final.state.accucolor,
                  albedo_add=final.albedo_add,
                  albedo_inc=final.albedo_inc,
                  rand_idx=final.rand_idx,
                  rays=final.rays_traced,
                  # SampleCache rides through compaction (axis 0 is the
                  # cache depth, axis 1 the lane) so bounces entering the
                  # tail below MAX_CACHE_DEPTH still record guiding samples
                  c_stype=final.cache.stype, c_tri=final.cache.tri,
                  c_bucket=final.cache.bucket, c_cum=final.cache.cum_mask)

        # Packed tail carry: each round's compaction reads, and its scatter-
        # back writes, ONE wide [L, W] f32 buffer instead of ~9 per-field
        # arrays — one gather and one scatter per round instead of one per
        # field. Every packed field is
        # f32-exact (colors/dirs are f32, flags are 0/1, pixel coords and
        # rand offsets < 2^24), so this is bit-identical to per-field carry.
        # Ray state is read-only within a level (a lane runs at most one
        # round per level); on the LAST level nothing downstream reads it
        # either, so there it rides the gather-only static pack and its
        # scatter-back disappears entirely.
        RAY_FIELDS = [('ro', 3), ('rd', 3), ('mask', 3),
                      ('from_specular', 1), ('albedo_set', 1)]

        def f1(x):
            return x.astype(jnp.float32).reshape(-1, 1)

        def _pack(fields, src):
            return jnp.concatenate(
                [src[n] if w == 3 else f1(src[n]) for n, w in fields],
                axis=1)

        def _cols(fields):
            cols, off = {}, 0
            for name, w in fields:
                cols[name] = (off, off + w)
                off += w
            return cols

        for li, (start_b, end_b, C) in enumerate(levels):
            last_level = li == len(levels) - 1
            # the SampleCache carry is only live when this level starts
            # below MAX_CACHE_DEPTH (static) — the default TAIL_START=3
            # config skips all of its gathers/scatters
            carry_cache = start_b < MAX_CACHE_DEPTH

            dyn_fields = [('accucolor', 3), ('albedo_add', 3),
                          ('albedo_inc', 1), ('alive', 1), ('pending', 1)]
            if not last_level:
                dyn_fields += RAY_FIELDS
            sta_fields = [('xs', 1), ('ys', 1), ('bn', 1)]
            if spp > 1:
                sta_fields += [('soff', 1), ('samp', 1)]
            if last_level:
                sta_fields += RAY_FIELDS
            dcols, scols = _cols(dyn_fields), _cols(sta_fields)
            ip = dcols['pending'][0]

            src = dict(tf, pending=tf['alive'], xs=xs, ys=ys, bn=bn_all)
            if spp > 1:
                src.update(soff=soff, samp=samp)
            P0 = _pack(dyn_fields, src)
            S = _pack(sta_fields, src)

            def tail_round(tc, start_b=start_b, end_b=end_b, C=C,
                           dyn_fields=tuple(dyn_fields), dcols=dcols,
                           scols=scols, S=S, ip=ip,
                           last_level=last_level, carry_cache=carry_cache):
                P = tc['P']
                pending = P[:, ip] != 0.0
                # compact: pending lanes first (stable -> lane order)
                order = jnp.argsort(~pending, stable=True)
                sel = order[:C]
                sub_p = P[sel]          # one gather for every carried field
                sub_s = S[sel]          # one gather for every static field

                def dget(name):
                    a, b = dcols[name]
                    return sub_p[:, a] if b - a == 1 else sub_p[:, a:b]

                def sget(name):
                    a, b = scols[name]
                    return sub_s[:, a] if b - a == 1 else sub_s[:, a:b]

                rget = sget if last_level else dget
                st0 = TraceState(mask=rget('mask'),
                                 accucolor=dget('accucolor'),
                                 light=jnp.zeros((C, 3), jnp.float32),
                                 from_specular=rget('from_specular') != 0.0,
                                 albedo_set=rget('albedo_set') != 0.0)
                if carry_cache:
                    sub_cache = SampleCache(
                        stype=tc['c_stype'][:, sel], tri=tc['c_tri'][:, sel],
                        bucket=tc['c_bucket'][:, sel],
                        cum_mask=tc['c_cum'][:, sel])
                else:
                    sub_cache = SampleCache.empty(C)
                sub_alive = dget('pending') != 0.0
                sc = _BounceCarry(
                    bounce=jnp.asarray(start_b, jnp.int32),
                    ro=rget('ro'), rd=rget('rd'), alive=sub_alive,
                    state=st0, cache=sub_cache,
                    rand_idx=tc['rand_idx'],
                    albedo_add=jnp.zeros((C, 3), jnp.float32),
                    albedo_inc=jnp.zeros(C, jnp.float32),
                    rays_traced=jnp.zeros((), jnp.float32))

                def sub_body(c):
                    return _bounce_body(
                        c, sget('xs').astype(jnp.int32),
                        sget('ys').astype(jnp.int32),
                        sget('soff').astype(jnp.uint32) if spp > 1 else soff,
                        sget('samp').astype(jnp.uint32) if spp > 1 else samp,
                        sget('bn'))

                sf = jax.lax.while_loop(
                    lambda c: (c.bounce < end_b) & jnp.any(c.alive),
                    sub_body, sc)

                # scatter back by lane id — ONE row-packed scatter;
                # survivors stay alive for the next level (their ray/state
                # advanced to end_b), pending cleared
                upd = dict(
                    accucolor=sf.state.accucolor,
                    albedo_add=dget('albedo_add') + sf.albedo_add,
                    albedo_inc=dget('albedo_inc') + sf.albedo_inc,
                    alive=sf.alive,
                    pending=jnp.zeros((C,), jnp.bool_))
                if not last_level:
                    upd.update(ro=sf.ro, rd=sf.rd, mask=sf.state.mask,
                               from_specular=sf.state.from_specular,
                               albedo_set=sf.state.albedo_set)
                out = dict(
                    P=P.at[sel].set(_pack(dyn_fields, upd)),
                    rand_idx=sf.rand_idx,
                    rays=tc['rays'] + sf.rays_traced,
                    c_stype=tc['c_stype'], c_tri=tc['c_tri'],
                    c_bucket=tc['c_bucket'], c_cum=tc['c_cum'])
                if carry_cache:
                    # rounds after the first pad `sel` with already-completed
                    # lanes (pending=False); their replayed bounces would
                    # overwrite the guiding records they wrote in an earlier
                    # round with TERMINATE, so only pending lanes scatter
                    pend = sub_alive
                    out.update(
                        c_stype=tc['c_stype'].at[:, sel].set(
                            jnp.where(pend[None, :], sf.cache.stype,
                                      sub_cache.stype)),
                        c_tri=tc['c_tri'].at[:, sel].set(
                            jnp.where(pend[None, :], sf.cache.tri,
                                      sub_cache.tri)),
                        c_bucket=tc['c_bucket'].at[:, sel].set(
                            jnp.where(pend[None, :], sf.cache.bucket,
                                      sub_cache.bucket)),
                        c_cum=tc['c_cum'].at[:, sel].set(
                            jnp.where(pend[None, :, None], sf.cache.cum_mask,
                                      sub_cache.cum_mask)))
                return out

            init = dict(P=P0, rand_idx=tf['rand_idx'], rays=tf['rays'],
                        c_stype=tf['c_stype'], c_tri=tf['c_tri'],
                        c_bucket=tf['c_bucket'], c_cum=tf['c_cum'])
            fin = jax.lax.while_loop(
                lambda tc, ip=ip: jnp.any(tc['P'][:, ip] != 0.0),
                tail_round, init)
            Pf = fin['P']
            for name, w in dyn_fields:
                if name == 'pending':
                    continue
                a, b = dcols[name]
                if name in ('alive', 'from_specular', 'albedo_set'):
                    tf[name] = Pf[:, a] != 0.0
                elif w == 1:
                    tf[name] = Pf[:, a]
                else:
                    tf[name] = Pf[:, a:b]
            for k in ('rand_idx', 'rays', 'c_stype', 'c_tri', 'c_bucket',
                      'c_cum'):
                tf[k] = fin[k]

        final = final._replace(
            state=final.state._replace(accucolor=tf['accucolor']),
            albedo_add=tf['albedo_add'], albedo_inc=tf['albedo_inc'],
            rand_idx=tf['rand_idx'], rays_traced=tf['rays'],
            alive=tf['alive'],
            cache=SampleCache(stype=tf['c_stype'], tri=tf['c_tri'],
                              bucket=tf['c_bucket'], cum_mask=tf['c_cum']))

    # guiding update (src/pathtracer.h:292-296). With defer_guide the raw
    # bucket sums are returned instead, so a band-split render can combine
    # partial sums and apply the (nonlinear) EMA exactly once per sample.
    # guide_off statically removes the whole scatter: the reference gates the
    # update kernels on the host (HCACHE && converge && sampleIndex < 100,
    # pathtracer.h:292), and the host knows all three — samples past the
    # 100-sample training window shouldn't keep paying the segment-sum.
    n_tris = radiance.cache.shape[0]

    def _per_sample_sums():
        """Per-sample bucket sums from ONE scatter: segment ids offset by
        sample index (tri + s*n_tris), so the scatter structure and cost
        match the combined path exactly while the sums come back per
        sample (per-sample accumulate_buckets instances would multiply the
        band program's scatters by spp)."""
        from .guiding import accumulate_buckets
        s_vec = jnp.arange(spp * B, dtype=jnp.int32) // B
        off = final.cache._replace(
            tri=final.cache.tri + s_vec[None, :] * n_tris)
        se, sw = accumulate_buckets(n_tris * spp, off,
                                    final.state.accucolor)
        return (se.reshape(spp, n_tris, -1), sw.reshape(spp, n_tris, -1))

    # spp > 1: the nonlinear EMA is applied ONCE PER SAMPLE, like the
    # reference's per-sample kernel_propagate_buckets (pathtracer.h:292-296)
    # — a batched dispatch returns per-sample sums (deferred) or folds the
    # EMA sequentially (inline). Same total scatter work; only the [T,8]
    # elementwise propagate repeats.
    if defer_guide:
        if guide_off:
            z = jnp.zeros((n_tris, radiance.cache.shape[1]), jnp.float32)
            radiance2 = (z, z) if spp == 1 else \
                (jnp.zeros((spp,) + z.shape, jnp.float32),
                 jnp.zeros((spp,) + z.shape, jnp.float32))
        else:
            from .guiding import accumulate_buckets
            if spp == 1:
                radiance2 = accumulate_buckets(n_tris, final.cache,
                                               final.state.accucolor)
            else:
                radiance2 = _per_sample_sums()
    elif guide_off:
        radiance2 = radiance
    else:
        if spp == 1:
            radiance2 = update_radiance_state(radiance, final.cache,
                                              final.state.accucolor,
                                              guide_enabled,
                                              axis_name=guide_axis)
        else:
            from .guiding import propagate as _propagate
            se, sw = _per_sample_sums()
            if guide_axis is not None:
                se = jax.lax.psum(se, guide_axis)
                sw = jax.lax.psum(sw, guide_axis)
            radiance2 = radiance
            for s in range(spp):
                radiance2 = _propagate(radiance2, se[s], sw[s],
                                       guide_enabled)

    if spp > 1:
        # reduce the sample-major lane blocks back to per-pixel sums
        acc = jnp.sum(final.state.accucolor.reshape(spp, B, 3), axis=0)
        aadd = jnp.sum(final.albedo_add.reshape(spp, B, 3), axis=0)
        ainc = jnp.sum(final.albedo_inc.reshape(spp, B), axis=0)
        rand_out = final.rand_idx + jnp.uint32((spp - 1) * RSTRIDE)
    else:
        acc, aadd, ainc = (final.state.accucolor, final.albedo_add,
                           final.albedo_inc)
        rand_out = final.rand_idx
    lum2 = film.accumulate(lum, acc, n_samples=float(spp))
    alb2 = film.accumulate_albedo(alb, aadd, ainc)
    # host randIdx advanced once per bounce + once for generate; return the
    # loop's final value (past the last sample's window) so the next sample
    # continues the stream
    return lum2, alb2, radiance2, rand_out, final.rays_traced


class Pathtracer:
    """Progressive interactive renderer (the Application subclass,
    src/pathtracer.h:46-71). Host-side state machine; all compute is jitted.
    """

    # a single dispatch handles at most this many ray lanes; larger frames
    # are rendered in horizontal bands (bounded device memory). One band of
    # 1080p at 2 spp (4,147,200 lanes) measured 60% faster than 9 bands of
    # 120 rows on an H100, with 1.56 GB of temporaries (PERF.md)
    MAX_LANES_PER_DISPATCH = int(_os.environ.get('CPT_MAX_LANES', '4147200'))

    # converge samples batched per dispatch (render_sample spp): amortizes
    # per-bounce fixed costs
    SPP_PER_DISPATCH = int(_os.environ.get('CPT_SPP', '1'))

    def __init__(self, scene, width: int = 640, height: int = 480,
                 skydome: str | None = None, blue_noise: str | None = None,
                 spp: int | None = None):
        self.scene = scene
        self.width = width
        self.height = height
        self.spp = spp if spp is not None else self.SPP_PER_DISPATCH
        # the lane cap bounds TOTAL lanes per dispatch (pixels x spp): spp
        # batching narrows the band so one dispatch covers spp samples of
        # 1/spp of the rows at the same working-set size
        lanes_per_row = width * self.spp
        rows_per_band = max(1, self.MAX_LANES_PER_DISPATCH // lanes_per_row)
        bands = -(-height // rows_per_band)
        while height % bands:        # bands must divide the height evenly
            bands += 1
        # the tile lane order wants 8-row-aligned bands; relax the lane cap
        # a little to find one
        if width % 16 == 0 and height % 8 == 0:
            b = bands
            while b >= 1 and not (height % b == 0 and (height // b) % 8 == 0):
                b -= 1
            if b >= 1 and (height // b) * lanes_per_row <= self.MAX_LANES_PER_DISPATCH * 1.3:
                bands = b
        self._set_bands(bands)
        self.nee = True        # HNEE (src/pathtracer.h:213)
        self.cache = True      # HCACHE
        self.arrays = scene.to_device(skydome=skydome, blue_noise=blue_noise)
        self.dyn = scene.dynamic_arrays()
        n_tris = int(self.arrays.tri_mat.shape[0])
        self.radiance = init_radiance_state(n_tris)
        self.lum, self.alb = film.clear_accumulators(width * height)
        self.sample_idx = 0
        self.rand_idx = 0
        self.rays_traced = 0.0   # perf counter (not in the reference)

    def _set_bands(self, bands: int):
        """Fix the band geometry (bands must divide the height). Recomputes
        the tile-order permutation; safe to call again after __init__ (the
        sharded engine aligns the band count to its mesh size)."""
        import numpy as _np
        assert self.height % bands == 0, (self.height, bands)
        self.bands = bands
        self.band_h = self.height // bands
        self.tile_order = (self.width % 16 == 0) and (self.band_h % 8 == 0)
        self._bn_cache = None

    def _bn_bands(self):
        """Per-band per-lane blue-noise values, hoisted out of render_sample
        (a 2D gather per band-sample otherwise). Lane ->
        pixel mapping mirrors render_sample's."""
        if self._bn_cache is not None:
            return self._bn_cache
        import numpy as _np
        bn = _np.asarray(self.arrays.blue_noise)
        bh, bw = bn.shape[0], bn.shape[1]
        W, bandh = self.width, self.band_h
        bands = []
        lanes = _np.arange(W * bandh)
        for b in range(self.bands):
            if self.tile_order:
                tpr = W // 16
                g, wl = lanes // 128, lanes % 128
                xs = (g % tpr) * 16 + wl % 16
                ys = (g // tpr) * 8 + wl // 16 + b * bandh
            else:
                xs = lanes % W
                ys = lanes // W + b * bandh
            bands.append(jnp.asarray(bn[ys % bh, xs % bw]))
        self._bn_cache = bands
        return bands

    def init(self):  # API parity with Application::Init
        pass

    def render(self, camera, current_time: float = 0.0,
               frame_time: float = 0.0, should_clear: bool = False):
        """One display frame (Pathtracer::Render, src/pathtracer.h:224-302)."""
        if should_clear:
            self.dyn = self.scene.dynamic_arrays()
            self.lum, self.alb = film.clear_accumulators(self.width * self.height)
            self.sample_idx = 0
            self.rand_idx = 0

        n_samples = self.scene.interactive_depth if should_clear else 1
        if self.nee:
            max_bounces = self.scene.interactive_depth if should_clear else MAX_RAY_DEPTH
        else:
            max_bounces = (self.scene.interactive_depth + 1) if should_clear \
                else MAX_RAY_DEPTH

        # interactive (clear) frames render spp=1 for latency; converge
        # frames batch self.spp samples into one dispatch per band
        use_spp = 1 if should_clear else self.spp
        for _ in range(n_samples):
            # host-static guiding gate (HCACHE && converge && sampleIdx<100,
            # src/pathtracer.h:292): all three terms are host state, so the
            # jit specializes guiding away entirely outside the training
            # window (one extra compile at the 100-sample boundary)
            g_on = ((not should_clear) and self.cache
                    and self.sample_idx < GUIDE_TRAIN_SAMPLES)
            # a batch straddling the training boundary is clamped so
            # guiding never trains past the reference's window (one extra
            # compile variant for the final training batch)
            if g_on and self.sample_idx + use_spp > GUIDE_TRAIN_SAMPLES:
                use_spp = max(1, GUIDE_TRAIN_SAMPLES - self.sample_idx)
            guide = jnp.asarray(g_on)
            ridx, rays = self._sample_dispatch(camera, guide, g_on,
                                               max_bounces, use_spp)
            # keep counters as device scalars: no host sync per sample, so
            # samples pipeline asynchronously like the reference's stream
            self.rand_idx = ridx
            self.sample_idx += use_spp
            self.rays_traced = self.rays_traced + rays

    def _sample_dispatch(self, camera, guide, g_on: bool, max_bounces: int,
                         use_spp: int):
        """One sample over the whole frame: band-split render_sample calls
        with deferred guiding partial sums, EMA applied exactly once. The
        multi-chip engine (parallel/mesh.ShardedPathtracer) overrides ONLY
        this method, sharding the same banded dispatch over its mesh — the
        per-band computation is identical."""
        from .guiding import propagate as guide_propagate
        bn_bands = self._bn_bands()
        if self.bands == 1:
            self.lum, self.alb, self.radiance, ridx, rays = render_sample(
                self.arrays, self.dyn, camera, self.radiance,
                self.lum, self.alb,
                jnp.asarray(self.sample_idx, jnp.uint32),
                jnp.asarray(self.rand_idx, jnp.uint32),
                guide, bn_bands[0],
                nee=self.nee, cache_on=self.cache,
                max_bounces=max_bounces,
                width=self.width, height=self.height,
                tile_order=self.tile_order, spp=use_spp,
                guide_off=not g_on)
            return ridx, rays
        # band-split frame: partial guiding sums combined, EMA once
        lum_parts, alb_parts = [], []
        gsum = gcnt = None
        ridx = jnp.asarray(self.rand_idx, jnp.uint32)
        rays = jnp.zeros((), jnp.float32)
        bl = self.band_h * self.width
        for b in range(self.bands):
            sl = slice(b * bl, (b + 1) * bl)
            lum_b, alb_b, (s_b, c_b), ridx_b, rays_b = render_sample(
                self.arrays, self.dyn, camera, self.radiance,
                self.lum[sl], self.alb[sl],
                jnp.asarray(self.sample_idx, jnp.uint32),
                jnp.asarray(self.rand_idx, jnp.uint32),
                guide, bn_bands[b],
                nee=self.nee, cache_on=self.cache,
                max_bounces=max_bounces,
                width=self.width, height=self.band_h,
                full_height=self.height,
                row_offset=b * self.band_h,
                defer_guide=True,
                tile_order=self.tile_order, spp=use_spp,
                guide_off=not g_on)
            lum_parts.append(lum_b)
            alb_parts.append(alb_b)
            gsum = s_b if gsum is None else gsum + s_b
            gcnt = c_b if gcnt is None else gcnt + c_b
            ridx = jnp.maximum(ridx, ridx_b)
            rays = rays + rays_b
        self.lum = jnp.concatenate(lum_parts)
        self.alb = jnp.concatenate(alb_parts)
        if use_spp > 1:
            # per-sample sums: the nonlinear EMA runs once per sample
            for s in range(use_spp):
                self.radiance = guide_propagate(self.radiance, gsum[s],
                                                gcnt[s], guide)
        else:
            self.radiance = guide_propagate(self.radiance, gsum, gcnt, guide)
        return ridx, rays

    def finish(self):
        """Application::Finish — device sync (src/pathtracer.h:305-310)."""
        self.lum.block_until_ready()

    # ---- output helpers ----

    def accumulators_pixel_order(self):
        """(lum, alb) in pixel (row-major) order regardless of the internal
        tile-lane layout — for goldens, checkpoints and display."""
        if self.tile_order:
            return (tile_unpermute(self.lum, self.width, self.band_h,
                                   self.bands),
                    tile_unpermute(self.alb, self.width, self.band_h,
                                   self.bands))
        return self.lum, self.alb

    def image(self, blur: bool = False):
        # tile-ordered lanes -> pixel order (a reshape/transpose, not a
        # gather — see tile_unpermute)
        lum, alb = self.accumulators_pixel_order()
        return film.display(lum, alb, float(self.sample_idx),
                            self.width, self.height, blur=blur)

    def energy(self):
        total, has_nan, has_neg = film.energy_audit(self.lum)
        return float(total), bool(has_nan), bool(has_neg)
