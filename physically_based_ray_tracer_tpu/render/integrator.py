"""Wavefront path-tracing integrator.

The wavefront rebuild of ``Renderer::Trace`` (Core/Renderer.cpp:150-406).
The reference's per-ray recursion becomes an unrolled bounce loop over SoA
ray batches: every path vertex does one closest-hit traversal, one fused
shading/NEE block (two batched occlusion traversals), and one continuation
sample. Lanes die by masking; XLA fuses all elementwise math between the
traversal loops.

Faithfully replicated reference semantics (bias-for-bias, SURVEY.md §7):
  * stochastic NEE light-type lottery P = {point .3, directional .5, spot .2}
    (Core/Renderer.cpp:205-214), contribution divided by pick probability;
  * point lights: color * cos / dist falloff (note: 1/dist, not 1/dist^2 —
    Core/Renderer.cpp:251-253) and shadow tmax = dist^2 - EPSILON (the
    reference passes squared distance as the ray limit, :257);
  * specular NEE from one randomly chosen point light with the nonuniform
    pick ``int(u*10) % 4`` (Core/Renderer.cpp:267);
  * directional light evaluated toward a position (:273), no falloff;
  * spot light: hard cone ``dot(L, rot) > 0.9``, 1/d^2 falloff (:295-301);
  * emissive added with throughput (:196); gamma sqrt happens in film.py;
  * dielectric fast path (transmissivness == 1): the reference traces BOTH
    reflection and refraction recursively (:331-372) — a tree. Here it is a
    Fresnel-weighted russian roulette between the two (equal in expectation;
    an intentional, unbiased deviation documented in SURVEY.md §7), and the
    vertex's own emissive+NEE contribution is discarded exactly like the
    reference's early ``return``;
  * mirror fast path (metal==1, rough==0) forces the specular lobe (:376);
  * diffuse/specular lobe RIS with getBrdfProbability and 1/p weighting
    (:380-392);
  * rays offset by EPSILON = 0.01 along the travel direction (:404).

Extensions beyond the reference: first-class area-light NEE (the reference
declares AreaLight but never instantiates it) using physically correct
solid-angle conversion, and arbitrary point-light counts.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from physically_based_ray_tracer_tpu.config import (EPSILON, BVH_FAR, P_DIRECTIONAL,
                                                    P_POINT, P_SPOT, RenderConfig,
                                                    RenderMode)
from physically_based_ray_tracer_tpu.ops import brdf as brdf_ops
from physically_based_ray_tracer_tpu.ops.intersect import Hit
from physically_based_ray_tracer_tpu.ops.traverse import (intersect_any,
                                                          intersect_closest,
                                                          refine_hit)
from physically_based_ray_tracer_tpu.ops.traverse_packet import (
    intersect_any_packet, intersect_closest_packet)
from physically_based_ray_tracer_tpu.scene.camera import Camera, primary_rays, sample_skybox
from physically_based_ray_tracer_tpu.scene.lights import sample_area_rect
from physically_based_ray_tracer_tpu.scene.material import (
    gather_hit_attrs, geometry_normal, material_at_hit, material_packed,
    packed_tables, shading_normal, shading_normal_packed)
from physically_based_ray_tracer_tpu.utils import rng
from physically_based_ray_tracer_tpu.utils.math import dot, normalize, reflect, refract
from physically_based_ray_tracer_tpu.utils.rng import Purpose


class Accel(NamedTuple):
    """Acceleration-structure bundle handed to the traversal dispatch:
    the classic 2-wide BVH (XLA engines) + the dense-leaf BVH (default)."""

    bvh: object   # BVHArrays
    dense: object  # bvh.dense.DenseBVH


def _closest(accel: Accel, cfg: RenderConfig, o, d, t_max=None, sort=False):
    """Traversal dispatch: "dense" (default: the CUDA kernel on the card,
    the plain traversal elsewhere, ops/traverse_dense.py), "wave" (XLA
    packet + decoupled dense leaf phase), "packet" (inline leaf tests), or
    "lane" (per-ray stack).

    ``sort=True`` runs on octant+Morton-sorted rays — essential for
    incoherent bounce and shadow wavefronts, skippable for primary rays
    already in Morton pixel order."""
    bvh = accel.bvh
    if cfg.traversal == "dense":
        from physically_based_ray_tracer_tpu.ops.traverse_dense import (
            intersect_closest_dense, sorted_closest_dense)
        fn = sorted_closest_dense if (sort and cfg.sort_rays) \
            else intersect_closest_dense
        return fn(accel.dense, o, d, t_max, stack_depth=cfg.max_stack_depth)
    kw = dict(tile=cfg.packet_tile, stack_depth=cfg.max_stack_depth,
              leaf_size=cfg.leaf_size)
    if cfg.traversal == "wave":
        from physically_based_ray_tracer_tpu.ops.traverse_packet import (
            intersect_closest_wave, sorted_closest)
        kw.update(dense=cfg.dense, shrink=cfg.wave_shrink)
        if sort and cfg.sort_rays:
            return sorted_closest(intersect_closest_wave, bvh, o, d, t_max, **kw)
        return intersect_closest_wave(bvh, o, d, t_max, **kw)
    if cfg.traversal == "packet":
        from physically_based_ray_tracer_tpu.ops.traverse_packet import sorted_closest
        if sort and cfg.sort_rays:
            return sorted_closest(intersect_closest_packet, bvh, o, d, t_max, **kw)
        return intersect_closest_packet(bvh, o, d, t_max, **kw)
    return intersect_closest(bvh, o, d, t_max, stack_depth=cfg.max_stack_depth,
                             leaf_size=cfg.leaf_size)


def _anyhit(accel: Accel, cfg: RenderConfig, o, d, t_max, sort=False):
    bvh = accel.bvh
    if cfg.traversal == "dense":
        from physically_based_ray_tracer_tpu.ops.traverse_dense import (
            intersect_any_dense, sorted_any_dense)
        fn = sorted_any_dense if (sort and cfg.sort_rays) else intersect_any_dense
        return fn(accel.dense, o, d, t_max, stack_depth=cfg.max_stack_depth)
    kw = dict(tile=cfg.packet_tile, stack_depth=cfg.max_stack_depth,
              leaf_size=cfg.leaf_size)
    if cfg.traversal == "wave":
        from physically_based_ray_tracer_tpu.ops.traverse_packet import (
            intersect_any_wave, sorted_any)
        kw.update(dense=cfg.dense, shrink=cfg.wave_shrink)
        if sort and cfg.sort_rays:
            return sorted_any(intersect_any_wave, bvh, o, d, t_max, **kw)
        return intersect_any_wave(bvh, o, d, t_max, **kw)
    if cfg.traversal == "packet":
        from physically_based_ray_tracer_tpu.ops.traverse_packet import sorted_any
        if sort and cfg.sort_rays:
            return sorted_any(intersect_any_packet, bvh, o, d, t_max, **kw)
        return intersect_any_packet(bvh, o, d, t_max, **kw)
    return intersect_any(bvh, o, d, t_max, stack_depth=cfg.max_stack_depth,
                         leaf_size=cfg.leaf_size)


def _light_type_weights(lights):
    """Active-light-type probabilities: the reference's 0.3/0.5/0.2 mix
    (plus 0.3 for the area extension), renormalised over present types so
    scene1 (point+dir+spot) keeps exactly the reference lottery."""
    w = [P_POINT * (lights.n_point > 0), P_DIRECTIONAL * (lights.n_dir > 0),
         P_SPOT * (lights.n_spot > 0), 0.3 * (lights.n_area > 0)]
    total = sum(w)
    if total == 0:
        return None
    return [x / total for x in w]


def select_one_hot(onehot, x):
    """(B, N) one-hot rows select from (B, N, C): an elementwise multiply
    and a sum, exact in f32 (a contraction could run in TF32 on the card)."""
    return jnp.sum(onehot[..., None] * x, axis=1)


def direct_lighting(scene, cfg: RenderConfig, point, shading_n, v, material,
                    pixel_id, key, sample, depth, alive=None,
                    count_shadow: bool = False):
    """Stochastic next-event estimation (Core/Renderer.cpp:198-326).

    Returns the radiance contribution at this vertex (throughput NOT applied).
    Two batched occlusion launches: one for the (lane, n_point) point-light
    shadow rays, one for the per-lane selected dir/spot/area shadow ray.
    ``count_shadow=True`` additionally returns the number of shadow rays
    ACTUALLY traced (tmax > 0 lanes; zero-contribution rays are masked
    off, see the shared pass) — the honest-metric calibration tap.
    """
    lights = scene.lights
    B = point.shape[0]
    zeros = jnp.zeros((B, 3), point.dtype)
    n_traced = jnp.zeros((), jnp.int32)
    # dead lanes shade at a finite dummy point (see trace_paths): their
    # occlusion rays must still be tmax=0 no-ops or they traverse like live
    # rays (frame-measured 1.3x regression when they did)
    live = jnp.ones((B,), bool) if alive is None else alive

    weights = _light_type_weights(lights)
    if weights is None or not cfg.lighted:
        return (zeros, n_traced) if count_shadow else zeros

    if cfg.stochastic_lights:
        u_pick = rng.uniform1(key, pixel_id, sample, depth, Purpose.LIGHT_TYPE)
        p_point, p_dir, p_spot, p_area = weights
        pick_point = u_pick < p_point
        pick_dir = (~pick_point) & (u_pick < p_point + p_dir)
        pick_spot = (~pick_point) & (~pick_dir) & (u_pick < p_point + p_dir + p_spot)
        pick_area = (~pick_point) & (~pick_dir) & (~pick_spot) & (p_area > 0)
    else:
        # non-stochastic fallback: directional only (Core/Renderer.cpp:312-326)
        if lights.n_dir == 0:
            return (zeros, n_traced) if count_shadow else zeros
        p_dir = 1.0
        p_point = p_spot = p_area = 0.0
        pick_point = jnp.zeros((B,), bool)
        pick_dir = jnp.ones((B,), bool)
        pick_spot = jnp.zeros((B,), bool)
        pick_area = jnp.zeros((B,), bool)

    result = zeros

    # one-shadow-ray estimator state (folded into the shared pass below)
    point_one = None

    # ---- point lights: (B, NP) evaluation + one flattened occlusion pass ---
    if lights.n_point > 0 and p_point > 0 and cfg.one_shadow_ray:
        # single-sample estimator: pick ONE light uniformly, weight by NP —
        # unbiased for the reference's sum over NP lights, and it costs ONE
        # occlusion lane per vertex instead of NP (cfg.one_shadow_ray)
        np_ = lights.n_point
        lvec = lights.point_pos[None, :, :] - point[:, None, :]      # (B, NP, 3)
        dist_sq = jnp.sum(lvec * lvec, axis=-1)
        dist = jnp.sqrt(jnp.maximum(dist_sq, 1e-20))
        ldir = lvec / dist[..., None]
        cosa = jnp.maximum(jnp.sum(shading_n[:, None, :] * ldir, axis=-1), 0.0)
        inv_dist = 1.0 / dist
        falloff = inv_dist * inv_dist if cfg.exact_point_falloff else inv_dist
        contrib = (lights.point_color[None] * lights.point_active[None, :, None]
                   * (falloff * cosa)[..., None])                     # (B, NP, 3)
        u_sel = rng.uniform1(key, pixel_id, sample, depth, Purpose.LIGHT_SELECT)
        which = jnp.minimum((u_sel * np_).astype(jnp.int32), np_ - 1)
        # 1-of-NP selection as a one-hot multiply-sum over NP (small): it
        # fuses into the surrounding elementwise block instead of a gather
        onehot = (jnp.arange(np_, dtype=jnp.int32)[None, :]
                  == which[:, None]).astype(point.dtype)      # (B, NP)
        l_sel = select_one_hot(onehot, ldir)
        c_sel = select_one_hot(onehot, contrib) * np_
        # reference quirk: tmax = dist^2 (squared!, Core/Renderer.cpp:257)
        # — an occluder BEYOND the light still blocks it, and shadow rays
        # traverse far past the light. exact_shadow_tmax bounds the ray at
        # the light (physically consistent, like the rest of the
        # one_shadow_ray estimator) and prunes that excess traversal.
        src = dist if cfg.exact_shadow_tmax else dist_sq
        t_sel = jnp.sum(onehot * src, axis=1)
        point_one = (l_sel, t_sel - EPSILON, c_sel / p_point)
    elif lights.n_point > 0 and p_point > 0:
        np_ = lights.n_point
        lvec = lights.point_pos[None, :, :] - point[:, None, :]      # (B, NP, 3)
        dist_sq = jnp.sum(lvec * lvec, axis=-1)
        dist = jnp.sqrt(jnp.maximum(dist_sq, 1e-20))
        ldir = lvec / dist[..., None]
        cosa = jnp.maximum(jnp.sum(shading_n[:, None, :] * ldir, axis=-1), 0.0)
        inv_dist = 1.0 / dist
        # reference falloff: color * cos / dist (Core/Renderer.cpp:251-253);
        # exact_point_falloff switches to physical 1/d^2
        falloff = inv_dist * inv_dist if cfg.exact_point_falloff else inv_dist
        contrib = (lights.point_color[None] * lights.point_active[None, :, None]
                   * (falloff * cosa)[..., None])                     # (B, NP, 3)

        sg = jax.lax.stop_gradient
        accel_sg = jax.tree.map(sg, Accel(scene.bvh, scene.dense))
        # all NP shadow rays in one flattened occlusion pass, LIGHT-major so
        # each packet tile shares one light (coherent directions); frame
        # chunking in render/renderer.py bounds the live (NP*B,) state
        so = sg(jnp.swapaxes(point[:, None, :] + ldir * EPSILON, 0, 1)
                .reshape(np_ * B, 3))
        sd = sg(jnp.swapaxes(ldir, 0, 1).reshape(np_ * B, 3))
        # reference quirk: tmax = dist^2 - EPSILON (squared; Core/Renderer.cpp:257)
        shadow_len = dist if cfg.exact_shadow_tmax else dist_sq
        # per-(lane, light) zero-contribution mask: see the shared pass —
        # a visible verdict multiplies into contrib == 0 anyway
        tmax = sg(jnp.swapaxes(
            jnp.where((pick_point & live)[:, None]
                      & (jnp.sum(contrib, axis=-1) > 0),
                      shadow_len - EPSILON, 0.0),
            0, 1).reshape(np_ * B))
        if count_shadow:
            n_traced = n_traced + jnp.sum((tmax > 0).astype(jnp.int32))
        occ = jnp.swapaxes(_anyhit(accel_sg, cfg, so, sd, tmax, sort=True)
                           .reshape(np_, B), 0, 1)
        visible = (~occ) & pick_point[:, None]
        point_contrib = jnp.sum(jnp.where(visible[..., None], contrib, 0.0), axis=1)
        point_contrib = point_contrib / p_point

        # specular BRDF from ONE randomly chosen light: int(u*10) % NP
        u_sel = rng.uniform1(key, pixel_id, sample, depth, Purpose.LIGHT_SELECT)
        which = (u_sel * 10.0).astype(jnp.int32) % np_
        onehot = (jnp.arange(np_, dtype=jnp.int32)[None, :]
                  == which[:, None]).astype(point.dtype)
        l_sel = select_one_hot(onehot, ldir)
        bsdf = brdf_ops.eval_combined_brdf(shading_n, l_sel, v, material, cfg.brdf)
        result = result + jnp.where(pick_point[:, None], bsdf * point_contrib, 0.0)

    # ---- directional / spot / area (+ single-ray point): one shared
    # per-lane occlusion pass ------------------------------------------------
    any_other = (lights.n_dir > 0 and p_dir > 0) or (lights.n_spot > 0 and p_spot > 0) \
        or (lights.n_area > 0 and p_area > 0) or point_one is not None
    if any_other:
        l_dir = jnp.zeros((B, 3), point.dtype)
        t_other = jnp.zeros((B,), point.dtype)
        contrib_other = zeros
        if point_one is not None:
            l_sel, t_sel, c_sel = point_one
            l_dir = jnp.where(pick_point[:, None], l_sel, l_dir)
            t_other = jnp.where(pick_point, t_sel, t_other)
            contrib_other = jnp.where(pick_point[:, None], c_sel, contrib_other)
        # area-light sampling shares the lane's slot in the occlusion pass
        if lights.n_dir > 0 and p_dir > 0:
            lvec = lights.dir_pos[0][None, :] - point
            dist = jnp.sqrt(jnp.maximum(jnp.sum(lvec * lvec, axis=-1), 1e-20))
            ld = lvec / dist[:, None]
            cosa = jnp.maximum(0.0, dot(shading_n, ld))
            c = lights.dir_color[0][None, :] * cosa[:, None] / p_dir
            l_dir = jnp.where(pick_dir[:, None], ld, l_dir)
            t_other = jnp.where(pick_dir, dist - EPSILON, t_other)
            contrib_other = jnp.where(pick_dir[:, None], c, contrib_other)
        if lights.n_spot > 0 and p_spot > 0:
            lvec = lights.spot_pos[0][None, :] - point
            dist = jnp.sqrt(jnp.maximum(jnp.sum(lvec * lvec, axis=-1), 1e-20))
            ld = lvec / dist[:, None]
            cosa = jnp.maximum(0.0, dot(shading_n, ld))
            factor = dot(ld, lights.spot_rot[0][None, :])
            c = (lights.spot_color[0][None, :] * (cosa / (dist * dist))[:, None]
                 * (factor > 0.9)[:, None].astype(point.dtype)) / p_spot
            l_dir = jnp.where(pick_spot[:, None], ld, l_dir)
            t_other = jnp.where(pick_spot, dist - EPSILON, t_other)
            contrib_other = jnp.where(pick_spot[:, None], c, contrib_other)
        if lights.n_area > 0 and p_area > 0:
            u_area = rng.uniform2(key, pixel_id, sample, depth, Purpose.AREA_LIGHT)
            u_sel = rng.uniform1(key, pixel_id, sample, depth, Purpose.LIGHT_SELECT)
            which = (u_sel * lights.n_area).astype(jnp.int32) % lights.n_area
            q, ln, pdf_area = sample_area_rect(lights, which, u_area)
            lvec = q - point
            dist_sq = jnp.maximum(jnp.sum(lvec * lvec, axis=-1), 1e-20)
            dist = jnp.sqrt(dist_sq)
            ld = lvec / dist[:, None]
            cos_light = jnp.maximum(0.0, -dot(ld, ln))
            col = jnp.take(lights.area_color, which, axis=0, mode="clip")
            # physically-correct area NEE: radiance * cosL / (d^2 * pdf_area);
            # the surface cosine lives inside evalCombinedBRDF
            c = col * (cos_light / (dist_sq * pdf_area * p_area
                                    * float(lights.n_area)))[:, None] * float(lights.n_area)
            # (pick 1-of-NA uniformly: the two NA factors cancel; kept for clarity)
            l_dir = jnp.where(pick_area[:, None], ld, l_dir)
            t_other = jnp.where(pick_area, dist - EPSILON, t_other)
            contrib_other = jnp.where(pick_area[:, None], c, contrib_other)

        sg = jax.lax.stop_gradient
        so = point + l_dir * EPSILON
        # zero-contribution shadow rays are pure waste: occ multiplies
        # into where(..., bsdf * contrib_other, 0), and every contrib term
        # is built from clamped nonnegative factors, so contrib == 0 (the
        # backfacing cos, out-of-cone spot, inactive padded light cases)
        # makes the verdict unobservable — mask tmax EXACTLY there and the
        # kernel's dead-flagged sort folds those lanes into dead tiles.
        # Image-identical by construction.
        t_other = jnp.where(live & (jnp.sum(contrib_other, axis=-1) > 0),
                            t_other, 0.0)
        if count_shadow:
            n_traced = n_traced + jnp.sum((t_other > 0).astype(jnp.int32))
        occ = _anyhit(jax.tree.map(sg, Accel(scene.bvh, scene.dense)), cfg,
                      sg(so), sg(l_dir), sg(t_other), sort=True)
        bsdf = brdf_ops.eval_combined_brdf(shading_n, l_dir, v, material, cfg.brdf)
        picked = pick_dir | pick_spot | pick_area
        if point_one is not None:
            picked = picked | pick_point
        other = jnp.where(((~occ) & picked)[:, None],
                          bsdf * contrib_other, 0.0)
        result = result + other

    return (result, n_traced) if count_shadow else result


def _snap_subtiles(B: int, target_w: int) -> int:
    """Sub-tile count for the gated shading block: the divisor of B whose
    quotient is nearest cfg.shade_tile (static Python — resolved at trace
    time). 1 = full-width (disabled, or B too small to split)."""
    if target_w <= 0 or B <= target_w:
        return 1
    s0 = max(1, round(B / target_w))
    for ds in range(s0):
        for s in (s0 + ds, s0 - ds):
            if 1 < s <= B and B % s == 0:
                return s
    return 1


def trace_paths(scene, cfg: RenderConfig, o, d, pixel_id, key, sample,
                collect_debug: bool = False, collect_live: bool = False):
    """Trace a batch of paths to completion; returns (radiance (B,3), primary Hit).

    One ``lax.scan`` over path vertices with a uniform body — the compiled
    program contains a single copy of the traversal/shading pipeline
    regardless of ``cfg.bounces`` (bounded compile time; the reference's
    recursion depth is a runtime constant here).

    ``collect_debug=True`` additionally stacks a per-bounce diagnostic dict
    (the single-ray DebugBreak analogue, Core/Renderer.cpp:49-52 /
    Core/UserInterface.cpp:141-236) and returns it as a third output —
    same integrator, observed rather than re-implemented.
    """
    B = o.shape[0]

    # Traversal is a discrete search: keep gradients out of the while-loops
    # (detached-sampling estimator, SURVEY.md §7). Differentiable (t, u, v)
    # are recomputed analytically from the hit triangle below.
    sg = jax.lax.stop_gradient
    accel_sg = jax.tree.map(sg, Accel(scene.bvh, scene.dense))
    # per-prim attribute packs: built ONCE per trace (linear concats, CSE'd
    # across bounces) so the shading block pays 2-3 wide gathers per bounce
    # instead of ~25 row gathers. Values are identical to the unpacked path.
    packs = packed_tables(scene)

    # Cross-chip ray re-sharding (SURVEY §2.5 ring row): inside shard_map,
    # each bounce donates up to cfg.reshard_block surplus live rays to the
    # ring neighbour before the vertex work and routes the results home
    # after — per-lane results are pure functions of (ray, pixel_id, RNG
    # ids), so rebalancing never changes the image. Enabled by
    # sharded_frame(..., reshard_block=N); a no-op when reshard_axis is None
    # or on a 1-chip mesh.
    resharding = (cfg.reshard_axis is not None and cfg.reshard_ndev > 1
                  and not collect_debug)
    if resharding:
        from physically_based_ray_tracer_tpu.parallel.resharding import (
            ring_donate, ring_restore)
    pixel_id0 = pixel_id

    def body(carry, depth):
        def vertex(carry):
            return _vertex(carry, depth)

        if collect_debug or resharding:
            # debug wants per-bounce records even when everything is dead;
            # under cross-chip resharding the gate predicate is shard-local
            # and the branch contains collectives — gating would deadlock
            # devices whose predicates disagree
            return vertex(carry)

        def skip(carry):
            dbg = ((jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
                   if collect_live else None)
            return carry, dbg

        # bounce gate: a fully-dead wavefront chunk (sky chunks after the
        # first bounce) would still pay full-width sorts, traversal and
        # shading. One scalar any() per bounce skips them.
        return jax.lax.cond(jnp.any(carry[4]), vertex, skip, carry)

    def _vertex(carry, depth):
        o, d, radiance, throughput, alive, primary_t = carry

        if resharding:
            lanes = dict(o=o, d=d, radiance=radiance, throughput=throughput,
                         primary_t=primary_t,
                         pixel_id=pixel_id0, alive_f=alive)
            lanes, live2, meta = ring_donate(
                lanes, alive, cfg.reshard_axis, cfg.reshard_ndev,
                min(cfg.reshard_block, B))
            o, d = lanes["o"], lanes["d"]
            radiance, throughput = lanes["radiance"], lanes["throughput"]
            primary_t = lanes["primary_t"]
            pixel_id = lanes["pixel_id"]
            alive = live2
        else:
            pixel_id = pixel_id0

        # each traversal pass sorts its own rays (closest and occlusion
        # wavefronts have different directions, so one shared order would
        # mix shadow directions within a warp)
        alive_in = alive
        t_init = jnp.where(alive, BVH_FAR, 0.0)
        hit = _closest(accel_sg, cfg, sg(o), sg(d), sg(t_init), sort=True)
        prim = jnp.maximum(hit.prim, 0)
        found0 = hit.prim >= 0
        o_prev, d_prev = o, d

        def shade(args):
            o, d = args["o"], args["d"]
            radiance, throughput = args["radiance"], args["throughput"]
            alive, primary_t = args["alive"], args["primary_t"]
            hit_t0, prim = args["hit_t"], args["prim"]
            found0, alive_in = args["found0"], args["alive_in"]
            pixel_id = args["pixel_id"]
            # differentiable re-intersection against the original-order
            # triangle
            attrs = gather_hit_attrs(scene, packs, prim)
            rt, ru, rv = refine_hit(o, d, attrs["v0"], attrs["e1"],
                                    attrs["e2"], mask=found0)
            # a refined winner more than a rounding apron outside its
            # triangle is dropped, and barycentrics are clamped to the
            # simplex so UV/normal interpolation never extrapolates
            inside = (jnp.minimum(jnp.minimum(ru, rv), 1.0 - ru - rv) > -0.02)
            found = found0 & inside
            ru = jnp.clip(ru, 0.0, 1.0)
            rv = jnp.clip(rv, 0.0, jnp.maximum(1.0 - ru, 0.0))
            hit_t = jnp.where(found, rt, hit_t0)
            hit_u = jnp.where(found, ru, 0.0)
            hit_v = jnp.where(found, rv, 0.0)
            primary_t = jnp.where(depth == 0, hit_t, primary_t)

            miss = alive & ~found
            if cfg.skybox and scene.sky.shape[0] > 1:
                radiance = radiance + jnp.where(
                    miss[:, None], throughput * sample_skybox(scene.sky, d),
                    0.0)
            alive = alive & found

            # dead/missed lanes carry hit_t = BVH_FAR: o + 1e30*d overflows
            # to inf and the NEE math's LOCAL Jacobians (e.g. d|lvec|/dlvec =
            # lvec/inf) turn NaN — which the masked `where`s do NOT stop in
            # the backward pass (0 cotangent x NaN Jacobian = NaN). A finite
            # dummy point keeps every masked lane's math finite; its value is
            # never used (all contributions gate on `alive`).
            point = o + d * jnp.where(found, hit_t, 1.0)[:, None]
            v = -d
            geom_n = attrs["face_n"]
            shad_n = shading_normal_packed(scene, attrs, hit_u, hit_v,
                                           cfg.normal_mapped)
            material = material_packed(scene, attrs, hit_u, hit_v)

            vertex_rad = throughput * material.emissive
            dl = direct_lighting(
                scene, cfg, point, shad_n, v, material, pixel_id, key, sample,
                depth, alive=alive, count_shadow=collect_live)
            n_shadow = None
            if collect_live:
                dl, n_shadow = dl
            vertex_rad = vertex_rad + throughput * dl

            last = depth == cfg.bounces - 1
            # reference: the dielectric branch discards this vertex's own
            # emissive+NEE via its early return (Core/Renderer.cpp:331-372) —
            # except at the last vertex, where :329 returns `result` first
            is_dielectric = (material.transmissivness == 1.0) & ~last
            radiance = radiance + jnp.where((alive & ~is_dielectric)[:, None],
                                            vertex_rad, 0.0)

            # ---- dielectric continuation: Fresnel russian roulette ---------
            n1, n2 = 1.0, 1.46
            cos_theta = jnp.clip(-dot(d, shad_n), 0.0, 1.0)
            eta = n1 / n2
            k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
            r0 = ((n1 - n2) / (n1 + n2)) ** 2
            fresnel = r0 + (1.0 - r0) * jnp.power(1.0 - cos_theta, 5.0)
            fresnel = jnp.where(k <= 0.0, 1.0, fresnel)
            u_diel = rng.uniform1(key, pixel_id, sample, depth,
                                  Purpose.DIELECTRIC)
            take_reflect = u_diel < fresnel
            refl_dir = reflect(d, shad_n)
            refr_dir = refract(d, shad_n, eta)
            diel_dir = jnp.where(take_reflect[:, None], refl_dir, refr_dir)
            diel_org = jnp.where(take_reflect[:, None],
                                 point + shad_n * EPSILON,
                                 point - shad_n * EPSILON)

            # ---- lobe selection (mirror fast path + RIS lottery) -----------
            is_mirror = (material.metalness == 1.0) & (material.roughness == 0.0)
            p_spec = brdf_ops.get_brdf_probability(material, v, shad_n)
            u_lobe = rng.uniform1(key, pixel_id, sample, depth,
                                  Purpose.LOBE_SELECT)
            pick_spec = (u_lobe < p_spec) | is_mirror
            lobe_div = jnp.where(is_mirror, 1.0,
                                 jnp.where(pick_spec, p_spec, 1.0 - p_spec))
            brdf_type = jnp.where(pick_spec, brdf_ops.SPECULAR_TYPE,
                                  brdf_ops.DIFFUSE_TYPE).astype(jnp.int32)

            u2 = rng.uniform2(key, pixel_id, sample, depth,
                              Purpose.BRDF_SAMPLE)
            bounce_dir, weight, valid = brdf_ops.eval_indirect_combined_brdf(
                u2, shad_n, geom_n, v, material, brdf_type, cfg.brdf)

            w_scaled = weight / lobe_div[:, None]
            throughput = throughput * jnp.where(is_dielectric[:, None], 1.0,
                                                w_scaled)
            o = jnp.where(is_dielectric[:, None], diel_org,
                          point + bounce_dir * EPSILON)
            d = jnp.where(is_dielectric[:, None], diel_dir, bounce_dir)
            alive = alive & jnp.where(is_dielectric, True, valid)
            extras = None
            if collect_live:
                # shadow count = rays ACTUALLY traced (zero-contribution
                # rays are tmax-masked and excluded)
                extras = (jnp.sum(alive_in.astype(jnp.int32)), n_shadow)
            if collect_debug:
                extras = {
                    "hit_t": hit_t,
                    "hit_prim": jnp.where(found, prim, -1),
                    "hit_u": hit_u, "hit_v": hit_v,
                    "point": point, "geom_n": geom_n, "shad_n": shad_n,
                    "base_color": material.base_color,
                    "metalness": material.metalness,
                    "roughness": material.roughness,
                    "vertex_radiance": jnp.where(
                        (alive_in & ~is_dielectric)[:, None], vertex_rad, 0.0),
                    "is_dielectric": is_dielectric,
                    "picked_specular": pick_spec,
                }
            return dict(o=o, d=d, radiance=radiance, throughput=throughput,
                        alive=alive, primary_t=primary_t), extras

        def skip_shade(args):
            # no lane hit anything: every alive lane missed — settle the
            # miss bookkeeping (sky radiance, primary depth) and kill the
            # wavefront without touching the shading/NEE/continuation block
            o, d = args["o"], args["d"]
            radiance, throughput = args["radiance"], args["throughput"]
            alive, primary_t = args["alive"], args["primary_t"]
            primary_t = jnp.where(depth == 0, args["hit_t"], primary_t)
            if cfg.skybox and scene.sky.shape[0] > 1:
                radiance = radiance + jnp.where(
                    alive[:, None], throughput * sample_skybox(scene.sky, d),
                    0.0)
            alive = jnp.zeros_like(alive)
            extras = None
            if collect_live:
                extras = (jnp.sum(args["alive_in"].astype(jnp.int32)),
                          jnp.zeros((), jnp.int32))
            return dict(o=o, d=d, radiance=radiance, throughput=throughput,
                        alive=alive, primary_t=primary_t), extras

        def dead_skip(args):
            # nothing alive at all in this slice: pure pass-through (the
            # primary_t settle is identity from bounce 1 on, where alone a
            # fully-dead slice can occur)
            primary_t = jnp.where(depth == 0, args["hit_t"],
                                  args["primary_t"])
            extras = None
            if collect_live:
                extras = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
            return dict(o=args["o"], d=args["d"], radiance=args["radiance"],
                        throughput=args["throughput"], alive=args["alive"],
                        primary_t=primary_t), extras

        def gated(args):
            # post-hit gate: a slice whose every lane misses skips the
            # entire shading block (the bounce-level gate only helps from
            # bounce 1 on); a fully-dead slice skips even the sky
            # bookkeeping. Branches are collective-free, so shard-local
            # predicates are safe even under resharding.
            def hit_or_miss(args):
                return jax.lax.cond(jnp.any(args["found0"]), shade,
                                    skip_shade, args)
            return jax.lax.cond(jnp.any(args["alive_in"]), hit_or_miss,
                                dead_skip, args)

        lanes = dict(o=o, d=d, radiance=radiance, throughput=throughput,
                     alive=alive, primary_t=primary_t, hit_t=hit.t,
                     prim=prim, found0=found0, alive_in=alive_in,
                     pixel_id=pixel_id)
        if collect_debug:
            out, extras = shade(lanes)
        else:
            # sub-tile shade gate (cfg.shade_tile > 0): Morton pixel order
            # makes contiguous W-lane slices square screen blocks, so dead
            # lanes cluster — lax.map over slices turns the per-chunk any()
            # gates into per-block gates and skips the shading/NEE work
            # (occlusion launches included) of all-dead blocks. Off by
            # default: each slice adds a fixed cost per bounce.
            S = _snap_subtiles(B, cfg.shade_tile)
            if S > 1:
                sub = jax.tree.map(
                    lambda x: x.reshape((S, B // S) + x.shape[1:]), lanes)
                out, extras = jax.lax.map(gated, sub)
                out = jax.tree.map(
                    lambda x: x.reshape((B,) + x.shape[2:]), out)
                if collect_live:
                    extras = tuple(jnp.sum(e) for e in extras)
            else:
                out, extras = gated(lanes)
        o, d = out["o"], out["d"]
        radiance, throughput = out["radiance"], out["throughput"]
        alive, primary_t = out["alive"], out["primary_t"]
        if resharding:
            out = ring_restore(
                dict(o=o, d=d, radiance=radiance, throughput=throughput,
                     primary_t=primary_t, alive_f=alive),
                meta, cfg.reshard_axis, cfg.reshard_ndev)
            o, d = out["o"], out["d"]
            radiance, throughput = out["radiance"], out["throughput"]
            primary_t, alive = out["primary_t"], out["alive_f"]
        # (collect_live) extras = (extension-ray lanes, shadow-ray lanes)
        # per bounce — the tap calibrating the honest rays/s metric
        # (utils/timer.ray_count). (collect_debug) extras = the per-bounce
        # record dict from shade(); completed with the ray inputs here.
        dbg = extras
        if collect_debug:
            dbg = dict(extras, ray_o=o_prev, ray_d=d_prev,
                       hit_inst=hit.inst, throughput_out=throughput,
                       alive_out=alive, next_dir=d)
        return (o, d, radiance, throughput, alive, primary_t), dbg

    init = (o, d, jnp.zeros((B, 3), o.dtype), jnp.ones((B, 3), o.dtype),
            jnp.ones((B,), bool), jnp.full((B,), BVH_FAR, o.dtype))
    (o, d, radiance, throughput, alive, primary_t), debug = jax.lax.scan(
        body, init, jnp.arange(cfg.bounces))

    neg1 = jnp.full((B,), -1, jnp.int32)
    primary_hit = Hit(t=primary_t, u=jnp.zeros((B,), o.dtype),
                      v=jnp.zeros((B,), o.dtype), prim=neg1, inst=neg1)
    if collect_debug or collect_live:
        return radiance, primary_hit, debug
    return radiance, primary_hit


def render_aov(scene, cfg: RenderConfig, o, d):
    """Debug AOV views (Core/Renderer.cpp:170-194), evaluated at primary hits."""
    hit = _closest(Accel(scene.bvh, scene.dense), cfg, o, d)
    prim = jnp.maximum(hit.prim, 0)
    ok = (hit.prim >= 0)[:, None]
    mode = cfg.rendering_mode
    if mode == RenderMode.BASECOLOR:
        out = material_at_hit(scene, prim, hit.u, hit.v).base_color
    elif mode == RenderMode.METAL:
        out = material_at_hit(scene, prim, hit.u, hit.v).metalness[:, None] * jnp.ones((1, 3))
    elif mode == RenderMode.ROUGHNESS:
        out = material_at_hit(scene, prim, hit.u, hit.v).roughness[:, None] * jnp.ones((1, 3))
    elif mode == RenderMode.EMMISIVE:
        out = material_at_hit(scene, prim, hit.u, hit.v).emissive
    elif mode == RenderMode.GEOMETRYNORMAL:
        out = (geometry_normal(scene, prim) + 1.0) * 0.5
    elif mode == RenderMode.SHADINGNORMAL:
        out = (shading_normal(scene, prim, hit.u, hit.v, cfg.normal_mapped) + 1.0) * 0.5
    elif mode == RenderMode.DEPTH:
        t = jnp.where(hit.prim >= 0, hit.t, 0.0)
        out = (t / jnp.maximum(jnp.max(t), 1e-9))[:, None] * jnp.ones((1, 3))
    elif mode == RenderMode.PRIMID:
        h = (hit.prim.astype(jnp.uint32) * jnp.uint32(2654435761))
        out = jnp.stack([(h & 0xFF), ((h >> 8) & 0xFF), ((h >> 16) & 0xFF)],
                        axis=-1).astype(jnp.float32) / 255.0
    else:
        raise ValueError(mode)
    return jnp.where(ok, out, 0.0), hit


def render_sample(scene, cam: Camera, cfg: RenderConfig, key, sample, pixel_ids):
    """One sample for a batch of pixels.

    Mirrors the per-pixel work of Renderer::Tick's loop (Core/Renderer.cpp:
    43-141): primary ray at integer pixel coords, optional second jittered AA
    ray averaged 50/50 (:59-66). Returns (color (B,3), primary_t (B,)).
    """
    xs = (pixel_ids % cfg.width).astype(jnp.float32)
    ys = (pixel_ids // cfg.width).astype(jnp.float32)

    o1, d1 = primary_rays(cam, xs, ys, cfg.width, cfg.height,
                          panini=cfg.post_processed)

    if cfg.rendering_mode != RenderMode.BRDF:
        color, hit = render_aov(scene, cfg, o1, d1)
        return color, hit.t

    if cfg.antialias:
        # both AA sub-rays trace in ONE doubled batch (half the compiled
        # graph of two sequential trace_paths calls); the second half gets
        # disjoint RNG streams via pixel_id + n_pixels
        b = pixel_ids.shape[0]
        j = rng.uniform2(key, pixel_ids, sample, 0, Purpose.AA_JITTER)
        o2, d2 = primary_rays(cam, xs + j[:, 0], ys + j[:, 1],
                              cfg.width, cfg.height, panini=cfg.post_processed)
        o = jnp.concatenate([o1, o2])
        d = jnp.concatenate([d1, d2])
        pid2 = jnp.concatenate([pixel_ids, pixel_ids + cfg.n_pixels])
        r, hit = trace_paths(scene, cfg, o, d, pid2, key, sample)
        color = 0.5 * (r[:b] + r[b:])
        primary_t = hit.t[:b]
    else:
        color, hit = trace_paths(scene, cfg, o1, d1, pixel_ids, key, sample)
        primary_t = hit.t
    return color, primary_t
