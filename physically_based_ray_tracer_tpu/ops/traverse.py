"""Per-lane wavefront BVH traversal (the "lane" engine, plain XLA).

Replacement for tinybvh's AVX2 traversal
(BVH8_CPU::Intersect/IsOccluded, Core/tiny_bvh.h:6302-6636). Instead of
per-ray recursion with octant-specialised SIMD, the whole ray batch steps a
2-wide Aila/Laine BVH in lockstep inside one ``lax.while_loop``:

* every lane holds its own short stack ``(B, S)`` and stack pointer;
* one traversal step = one (12-float) node-box gather + ordered child visit,
  OR one (K x 9-float) leaf gather + K masked Möller-Trumbore tests;
* lanes that finish go inactive; the loop ends when all lanes are done
  (`jnp.any(active)`), i.e. divergence costs masked work, never wrong work.

Ordered traversal (near child first, far child pushed) plus a shrinking
``t_max`` reproduces the early-termination behaviour of the reference's
perm8 octant ordering (Core/tiny_bvh.h:4573-4590) without per-ray code
specialisation. The any-hit variant exits a lane on its first accepted hit
exactly like ``IsOccludedTLAS`` (Core/tiny_bvh.h:2611-2666). Closest hit
does not depend on the visit order: of triangles at exactly the same t, the
lowest primitive id wins, as in ``brute_force_intersect``.

All functions are jit-compatible and differentiable-by-exclusion: hit
topology carries no gradients (ints); differentiable (t, u, v) are
recomputed from hit prims by ``refine_hit``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from physically_based_ray_tracer_tpu.bvh.types import BVHArrays, LEAF_COUNT_BITS, LEAF_COUNT_MASK
from physically_based_ray_tracer_tpu.config import BVH_FAR
from physically_based_ray_tracer_tpu.ops.intersect import Hit, intersect_tri, safe_rcp

DONE = jnp.int32(0x7FFFFFFF)


def _gather_rows(arr, idx):
    """Row gather arr[(B,), ...] -> (B, row)."""
    return jnp.take(arr, idx, axis=0, indices_are_sorted=False, unique_indices=False,
                    mode="clip")


def _leaf_decode(c):
    m = -(c + 1)
    return m >> LEAF_COUNT_BITS, m & LEAF_COUNT_MASK


def _slab(o, rd, bmin, bmax, t_max):
    """A box entered exactly at t_max is hit: closest hit may find a
    triangle tied with the best there."""
    t1 = (bmin - o) * rd
    t2 = (bmax - o) * rd
    tnear = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tfar = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tfar >= tnear) & (tnear <= t_max) & (tfar > 0.0)
    return jnp.where(hit, jnp.maximum(tnear, 0.0), BVH_FAR), hit


def intersect_closest(bvh: BVHArrays, o, d, t_max=None, *,
                      stack_depth: int = 48, leaf_size: int = 4) -> Hit:
    """Closest-hit traversal for a ray batch.

    o, d: (B, 3). t_max: optional (B,) initial clip distance. Returns Hit
    with prim = index into the *original* triangle order (via prim_index).
    """
    B = o.shape[0]
    rd = safe_rcp(d)
    t0 = jnp.full((B,), BVH_FAR, o.dtype) if t_max is None else t_max

    def body(state):
        cur, sp, stack, t, u, v, prim, active = state

        is_leaf = cur < 0
        node_idx = jnp.where(is_leaf | ~active, 0, cur)

        # ---- internal-node step -------------------------------------------
        box = _gather_rows(bvh.nodes_box, node_idx)           # (B, 12)
        child = _gather_rows(bvh.nodes_child, node_idx)       # (B, 2)
        d0, h0 = _slab(o, rd, box[:, 0:3], box[:, 3:6], t)
        d1, h1 = _slab(o, rd, box[:, 6:9], box[:, 9:12], t)
        # empty-leaf child slots (count==0) never hit
        c0, c1 = child[:, 0], child[:, 1]
        e0 = (c0 < 0) & (((-(c0 + 1)) & LEAF_COUNT_MASK) == 0)
        e1 = (c1 < 0) & (((-(c1 + 1)) & LEAF_COUNT_MASK) == 0)
        h0 &= ~e0
        h1 &= ~e1
        swap = d1 < d0
        near = jnp.where(swap, c1, c0)
        far = jnp.where(swap, c0, c1)
        near_hit = jnp.where(swap, h1, h0)
        far_hit = jnp.where(swap, h0, h1)
        both = near_hit & far_hit
        internal_next = jnp.where(near_hit, near, jnp.where(far_hit, far, DONE))
        push = both & active & ~is_leaf

        # ---- leaf step: one (B, K) gather + vectorised MT ------------------
        # a triangle at exactly the best t so far wins by lower prim id
        first, count = _leaf_decode(jnp.where(is_leaf, cur, -1))
        slots = jnp.where(is_leaf[:, None],
                          first[:, None] + jnp.arange(leaf_size)[None, :], 0)
        rows = _gather_rows(bvh.tris, slots)
        kp = _gather_rows(bvh.prim_index, slots)
        kt, ku, kv, khit = intersect_tri(
            o[:, None, :], d[:, None, :],
            rows[:, :, 0:3], rows[:, :, 3:6], rows[:, :, 6:9], jnp.inf)
        kvalid = khit & (jnp.arange(leaf_size)[None, :] < count[:, None]) \
            & (is_leaf & active)[:, None] \
            & ((kt < t[:, None])
               | ((kt == t[:, None]) & (prim >= 0)[:, None]
                  & (kp < prim[:, None])))
        kt = jnp.where(kvalid, kt, jnp.inf)
        kt_b = jnp.min(kt, axis=1)
        kbest = jnp.argmin(jnp.where(kvalid & (kt == kt_b[:, None]), kp,
                                     jnp.iinfo(jnp.int32).max), axis=1)
        take = jnp.any(kvalid, axis=1)
        pick = lambda x: jnp.take_along_axis(x, kbest[:, None], axis=1)[:, 0]
        lt = jnp.where(take, kt_b, t)
        lu = jnp.where(take, pick(ku), u)
        lv = jnp.where(take, pick(kv), v)
        lp = jnp.where(take, pick(kp), prim)

        # ---- merge + stack ------------------------------------------------
        nxt = jnp.where(is_leaf, DONE, internal_next)

        sidx = jax.lax.broadcasted_iota(jnp.int32, stack.shape, 1)
        stack = jnp.where((sidx == sp[:, None]) & push[:, None], far[:, None], stack)
        sp = sp + jnp.where(push, 1, 0)

        need_pop = (nxt == DONE) & active
        can_pop = need_pop & (sp > 0)
        sp_pop = jnp.maximum(sp - 1, 0)
        top = jnp.take_along_axis(stack, sp_pop[:, None], axis=1)[:, 0]
        nxt = jnp.where(can_pop, top, nxt)
        sp = jnp.where(can_pop, sp_pop, sp)
        active = active & ~(need_pop & ~can_pop)
        nxt = jnp.where(active, nxt, DONE)

        return nxt, sp, stack, lt, lu, lv, lp, active

    def cond(state):
        return jnp.any(state[-1])

    init = (
        jnp.zeros((B,), jnp.int32),                   # cur = root
        jnp.zeros((B,), jnp.int32),                   # sp
        jnp.full((B, stack_depth), DONE, jnp.int32),  # stack
        t0,
        jnp.zeros((B,), o.dtype),
        jnp.zeros((B,), o.dtype),
        jnp.full((B,), -1, jnp.int32),
        jnp.ones((B,), bool),
    )
    _, _, _, t, u, v, prim, _ = jax.lax.while_loop(cond, body, init)
    return Hit(t=t, u=u, v=v, prim=prim, inst=jnp.where(prim >= 0, 0, -1))


def intersect_any(bvh: BVHArrays, o, d, t_max, *,
                  stack_depth: int = 48, leaf_size: int = 4) -> jnp.ndarray:
    """Occlusion query: True where any hit exists with t in (0, t_max).

    Mirrors IsOccludedTLAS semantics (early-out per lane on first hit).
    """
    B = o.shape[0]
    rd = safe_rcp(d)

    def body(state):
        cur, sp, stack, occluded, active = state
        is_leaf = cur < 0
        node_idx = jnp.where(is_leaf | ~active, 0, cur)

        box = _gather_rows(bvh.nodes_box, node_idx)
        child = _gather_rows(bvh.nodes_child, node_idx)
        _, h0 = _slab(o, rd, box[:, 0:3], box[:, 3:6], t_max)
        _, h1 = _slab(o, rd, box[:, 6:9], box[:, 9:12], t_max)
        c0, c1 = child[:, 0], child[:, 1]
        e0 = (c0 < 0) & (((-(c0 + 1)) & LEAF_COUNT_MASK) == 0)
        e1 = (c1 < 0) & (((-(c1 + 1)) & LEAF_COUNT_MASK) == 0)
        h0 &= ~e0
        h1 &= ~e1
        both = h0 & h1
        internal_next = jnp.where(h0, c0, jnp.where(h1, c1, DONE))
        push = both & active & ~is_leaf

        first, count = _leaf_decode(jnp.where(is_leaf, cur, -1))
        slots = first[:, None] + jnp.arange(leaf_size)[None, :]
        rows = _gather_rows(bvh.tris, jnp.where(is_leaf[:, None], slots, 0))
        _, _, _, khit = intersect_tri(
            o[:, None, :], d[:, None, :],
            rows[:, :, 0:3], rows[:, :, 3:6], rows[:, :, 6:9], t_max[:, None])
        kvalid = khit & (jnp.arange(leaf_size)[None, :] < count[:, None]) \
            & (is_leaf & active)[:, None]
        occ = occluded | jnp.any(kvalid, axis=1)

        nxt = jnp.where(is_leaf, DONE, internal_next)

        sidx = jax.lax.broadcasted_iota(jnp.int32, stack.shape, 1)
        stack = jnp.where((sidx == sp[:, None]) & push[:, None], c1[:, None], stack)
        sp = sp + jnp.where(push, 1, 0)

        need_pop = (nxt == DONE) & active
        can_pop = need_pop & (sp > 0)
        sp_pop = jnp.maximum(sp - 1, 0)
        top = jnp.take_along_axis(stack, sp_pop[:, None], axis=1)[:, 0]
        nxt = jnp.where(can_pop, top, nxt)
        sp = jnp.where(can_pop, sp_pop, sp)
        active = active & ~(need_pop & ~can_pop) & ~occ
        nxt = jnp.where(active, nxt, DONE)
        return nxt, sp, stack, occ, active

    def cond(state):
        return jnp.any(state[-1])

    init = (
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B, stack_depth), DONE, jnp.int32),
        jnp.zeros((B,), bool),
        jnp.ones((B,), bool),
    )
    _, _, _, occluded, _ = jax.lax.while_loop(cond, body, init)
    return occluded


def refine_hit(o, d, v0, e1, e2, mask=None):
    """Differentiable (t, u, v) for a known hit triangle.

    Gradients flow through ray origin/direction and triangle vertices (and
    hence through object transforms); hit *topology* stays discrete — the
    detached-sampling estimator of SURVEY.md §7.

    ``mask`` marks lanes with a real hit. Masked-out lanes get sanitised
    inputs BEFORE the division so their (unused) cotangents can't produce
    inf*0 = NaN in the backward pass (the classic ``where`` gradient trap).
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    if mask is not None:
        det = jnp.where(mask, det, 1.0)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    if mask is not None:
        t = jnp.where(mask, t, 0.0)
        u = jnp.where(mask, u, 0.0)
        v = jnp.where(mask, v, 0.0)
    return t, u, v
