"""Packet BVH traversal: one shared stack per ray tile.

The per-lane while-loop traversal (ops/traverse.py) spends its time on
per-lane gathers. This module is an array-scale rebuild of tinybvh's
coherent packet traversal
(BVH::Intersect256Rays, Core/tiny_bvh.h:2675-2846) at array scale:

* rays are grouped into tiles of W (default 256); each TILE owns one
  traversal stack and one current-node cursor — node fetches become
  (n_tiles,)-wide gathers, W times fewer than per-lane traversal;
* node culling uses a conservative interval test over the tile's origin
  box and direction bounds (Wald-style frustum culling generalised to
  arbitrary ray sets: mixed-sign direction intervals widen to (-inf, inf),
  so correctness never depends on coherence — only culling quality does);
* leaf visits test ALL W rays against the leaf's triangles densely —
  exact per-ray Möller-Trumbore, vectorised with no divergence;
* per-tile t_max pruning uses the max of the lanes' current best hits.

Sorting rays by direction octant + origin Morton code (``morton_order``)
makes tiles coherent; primary and shadow rays are naturally coherent in
scanline order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from physically_based_ray_tracer_tpu.bvh.types import BVHArrays, LEAF_COUNT_BITS, LEAF_COUNT_MASK
from physically_based_ray_tracer_tpu.config import BVH_FAR
from physically_based_ray_tracer_tpu.ops.intersect import Hit, intersect_tri, safe_rcp

DONE = jnp.int32(0x7FFFFFFF)
BIG = jnp.float32(1e30)


def _leaf_decode(c):
    m = -(c + 1)
    return m >> LEAF_COUNT_BITS, m & LEAF_COUNT_MASK


def mt_dense(o_t, d_t, rows, t_clip):
    """Dense Möller-Trumbore, fully fused component math.

    o_t, d_t: (T, W, 3) rays; rows: (T, K, 9) packed (v0, e1, e2) triangles;
    t_clip: (T, W) current clip distance. Returns (t, u, v, hit) each (T, W, K).

    Written with explicit scalar components (no jnp.cross / stack) so XLA
    fuses the whole pipeline into one elementwise kernel — the (T, W, K)
    intermediates never reach device memory. With jnp.cross the concatenates break
    fusion and each intermediate materializes (hundreds of MB per pass).
    """
    ox, oy, oz = (o_t[:, :, None, i] for i in range(3))      # (T, W, 1)
    dx, dy, dz = (d_t[:, :, None, i] for i in range(3))
    v0x, v0y, v0z = (rows[:, None, :, i] for i in range(3))  # (T, 1, K)
    e1x, e1y, e1z = (rows[:, None, :, 3 + i] for i in range(3))
    e2x, e2y, e2z = (rows[:, None, :, 6 + i] for i in range(3))

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((jnp.abs(det) > 1e-9) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < t_clip[:, :, None]))
    return t, u, v, hit


def _gather_rows(arr, idx):
    return jnp.take(arr, idx, axis=0, mode="clip")


def _interval_slab(box, o_lo, o_hi, rd_lo, rd_hi, t_max_tile):
    """Conservative tile-vs-AABB test.

    box: (T, 6) child AABB; o_lo/o_hi: (T, 3) tile origin bounds;
    rd_lo/rd_hi: (T, 3) reciprocal-direction interval (already widened to
    +/-BIG when the tile's direction interval spans zero).
    Returns (entry_lower_bound (T,), may_hit (T,)).
    """
    bmin = box[:, 0:3]
    bmax = box[:, 3:6]

    def iprod(a_lo, a_hi, b_lo, b_hi):
        p1 = a_lo * b_lo
        p2 = a_lo * b_hi
        p3 = a_hi * b_lo
        p4 = a_hi * b_hi
        return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
                jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))

    # t intervals for both slab planes per axis
    a1_lo = bmin - o_hi
    a1_hi = bmin - o_lo
    a2_lo = bmax - o_hi
    a2_hi = bmax - o_lo
    t1_lo, t1_hi = iprod(a1_lo, a1_hi, rd_lo, rd_hi)
    t2_lo, t2_hi = iprod(a2_lo, a2_hi, rd_lo, rd_hi)
    # per-ray tnear_axis = min(t1,t2) >= min of lower bounds
    lo_axis = jnp.minimum(t1_lo, t2_lo)       # (T, 3)
    hi_axis = jnp.maximum(t1_hi, t2_hi)
    enter_lb = jnp.max(lo_axis, axis=-1)      # lower bound of per-ray tnear
    exit_ub = jnp.min(hi_axis, axis=-1)       # upper bound of per-ray tfar
    may_hit = (enter_lb <= exit_ub) & (exit_ub > 0.0) & (enter_lb < t_max_tile)
    return enter_lb, may_hit


def _tile_bounds(o, d):
    """Per-tile origin box + reciprocal-direction interval. o,d: (T, W, 3).

    The reciprocal of a direction interval [a, b] must respect the pole at 0:
      a > 0          -> [1/b, 1/a]
      b < 0          -> [1/b, 1/a]
      a == 0, b > 0  -> [1/b, +BIG]       (rays arbitrarily slow, same sign)
      a < 0, b == 0  -> [-BIG, 1/a]
      a < 0 < b      -> [-BIG, +BIG]      (mixed signs: no useful bound)
    Naively min/maxing 1/a, 1/b gets the sign wrong at the zero boundary and
    makes the conservative slab test REJECT nodes that contain real hits.
    """
    o_lo = jnp.min(o, axis=1)
    o_hi = jnp.max(o, axis=1)
    d_lo = jnp.min(d, axis=1)
    d_hi = jnp.max(d, axis=1)
    rd_a = safe_rcp(d_lo)
    rd_b = safe_rcp(d_hi)
    same_sign = (d_lo > 0.0) | (d_hi < 0.0)
    rd_lo = jnp.where(same_sign, rd_b,
                      jnp.where((d_lo == 0.0) & (d_hi > 0.0), rd_b, -BIG))
    rd_hi = jnp.where(same_sign, rd_a,
                      jnp.where((d_hi == 0.0) & (d_lo < 0.0), rd_a, BIG))
    return o_lo, o_hi, rd_lo, rd_hi


def _pad_tiles(o, d, extra, tile):
    b = o.shape[0]
    n_tiles = -(-b // tile)
    pad = n_tiles * tile - b
    pads = lambda x: [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    # rays padded edge-mode (clones of the last ray) so the last tile's
    # conservative bounds aren't inflated; their t_max pads to 0 (inactive)
    o = jnp.pad(o, pads(o), mode="edge").reshape(n_tiles, tile, 3)
    d = jnp.pad(d, pads(d), mode="edge").reshape(n_tiles, tile, 3)
    extra = [jnp.pad(x, pads(x), constant_values=0) for x in extra]
    extra = [x.reshape((n_tiles, tile) + x.shape[1:]) for x in extra]
    return o, d, extra, b, n_tiles


def intersect_closest_packet(bvh: BVHArrays, o, d, t_max=None, *,
                             tile: int = 256, stack_depth: int = 48,
                             leaf_size: int = 4) -> Hit:
    """Closest-hit packet traversal. o, d: (B, 3); returns per-ray Hit."""
    B0 = o.shape[0]
    if t_max is None:
        t_max = jnp.full((B0,), BVH_FAR, o.dtype)
    o_t, d_t, (tmax_t,), b, T = _pad_tiles(o, d, [t_max], tile)
    # padded lanes: t_max 0 -> they never hit and never widen pruning? note
    # tile t_max is a max over lanes; pad with 0 so they don't widen it.
    rd_t = safe_rcp(d_t)
    o_lo, o_hi, rd_lo, rd_hi = _tile_bounds(o_t, d_t)

    def body(state):
        cur, sp, stack, t, u, v, prim, active = state
        # t: (T, W) current best; tile pruning distance:
        t_tile = jnp.max(jnp.minimum(t, tmax_t), axis=1)          # (T,)

        is_leaf = cur < 0
        node_idx = jnp.where(is_leaf | ~active, 0, cur)
        box = _gather_rows(bvh.nodes_box, node_idx)               # (T, 12)
        child = _gather_rows(bvh.nodes_child, node_idx)           # (T, 2)
        d0, h0 = _interval_slab(box[:, 0:6], o_lo, o_hi, rd_lo, rd_hi, t_tile)
        d1, h1 = _interval_slab(box[:, 6:12], o_lo, o_hi, rd_lo, rd_hi, t_tile)
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

        # ---- leaf: dense W x leaf_size Möller-Trumbore -------------------
        first, count = _leaf_decode(jnp.where(is_leaf, cur, -1))
        slots = first[:, None] + jnp.arange(leaf_size)[None, :]   # (T, K)
        rows = _gather_rows(bvh.tris, jnp.where(is_leaf[:, None], slots, 0))
        # rows: (T, K, 9); broadcast against lanes: (T, W, K)
        kt, ku, kv, khit = mt_dense(o_t, d_t, rows, jnp.minimum(t, tmax_t))
        valid = (jnp.arange(leaf_size)[None, None, :] < count[:, None, None]) \
            & (is_leaf & active)[:, None, None] & khit
        for k in range(leaf_size):
            take = valid[:, :, k] & (kt[:, :, k] < jnp.minimum(t, tmax_t))
            t = jnp.where(take, kt[:, :, k], t)
            u = jnp.where(take, ku[:, :, k], u)
            v = jnp.where(take, kv[:, :, k], v)
            prim = jnp.where(take, first[:, None] + k, prim)

        # ---- stack ---------------------------------------------------------
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
        return nxt, sp, stack, t, u, v, prim, active

    def cond(state):
        return jnp.any(state[-1])

    W = tile
    init = (
        jnp.zeros((T,), jnp.int32),
        jnp.zeros((T,), jnp.int32),
        jnp.full((T, stack_depth), DONE, jnp.int32),
        jnp.full((T, W), BVH_FAR, o.dtype),
        jnp.zeros((T, W), o.dtype),
        jnp.zeros((T, W), o.dtype),
        jnp.full((T, W), -1, jnp.int32),
        jnp.ones((T,), bool),
    )
    _, _, _, t, u, v, prim_slot, _ = jax.lax.while_loop(cond, body, init)

    t = t.reshape(-1)[:b]
    u = u.reshape(-1)[:b]
    v = v.reshape(-1)[:b]
    prim_slot = prim_slot.reshape(-1)[:b]
    found = (prim_slot >= 0) & (t < t_max)
    prim = jnp.where(found, _gather_rows(bvh.prim_index,
                                         jnp.maximum(prim_slot, 0)), -1)
    t = jnp.where(found, t, BVH_FAR)
    return Hit(t=t, u=jnp.where(found, u, 0.0), v=jnp.where(found, v, 0.0),
               prim=prim, inst=jnp.where(found, 0, -1))


def intersect_any_packet(bvh: BVHArrays, o, d, t_max, *,
                         tile: int = 256, stack_depth: int = 48,
                         leaf_size: int = 4) -> jnp.ndarray:
    """Occlusion packet query: True where any hit exists with t in (0, t_max)."""
    B0 = o.shape[0]
    o_t, d_t, (tmax_t,), b, T = _pad_tiles(o, d, [t_max], tile)
    o_lo, o_hi, rd_lo, rd_hi = _tile_bounds(o_t, d_t)
    W = tile

    def body(state):
        cur, sp, stack, occ, active = state
        pending = (~occ) & (tmax_t > 0.0)
        t_tile = jnp.max(jnp.where(pending, tmax_t, 0.0), axis=1)

        is_leaf = cur < 0
        node_idx = jnp.where(is_leaf | ~active, 0, cur)
        box = _gather_rows(bvh.nodes_box, node_idx)
        child = _gather_rows(bvh.nodes_child, node_idx)
        _, h0 = _interval_slab(box[:, 0:6], o_lo, o_hi, rd_lo, rd_hi, t_tile)
        _, h1 = _interval_slab(box[:, 6:12], o_lo, o_hi, rd_lo, rd_hi, t_tile)
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
        _, _, _, khit = mt_dense(o_t, d_t, rows, tmax_t)
        valid = (jnp.arange(leaf_size)[None, None, :] < count[:, None, None]) \
            & (is_leaf & active)[:, None, None] & khit
        occ = occ | jnp.any(valid, axis=2)

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
        all_occluded = jnp.all(occ | (tmax_t <= 0.0), axis=1)
        active = active & ~(need_pop & ~can_pop) & ~all_occluded
        nxt = jnp.where(active, nxt, DONE)
        return nxt, sp, stack, occ, active

    def cond(state):
        return jnp.any(state[-1])

    init = (
        jnp.zeros((T,), jnp.int32),
        jnp.zeros((T,), jnp.int32),
        jnp.full((T, stack_depth), DONE, jnp.int32),
        jnp.zeros((T, W), bool),
        jnp.ones((T,), bool),
    )
    _, _, _, occ, _ = jax.lax.while_loop(cond, body, init)
    return occ.reshape(-1)[:b]


def _w1_from_rows(rows_w, K_tot):
    """(T, K, 12) Woop rows -> (T, 4, 3K) matmul weights, columns grouped
    axis-major: [all-x | all-y | all-z] so the epilogue slices contiguously."""
    T = rows_w.shape[0]
    r = rows_w.reshape(T, K_tot, 3, 4)           # [j, axis, f]
    return jnp.transpose(r, (0, 3, 2, 1)).reshape(T, 4, 3 * K_tot)


def woop_dense(o_t, d_t, w1, t_clip):
    """Dense tile x leaf intersection as one batched matmul.

    o_t, d_t: (T, W, 3); w1: (T, 4, 3K) Woop weights; t_clip: (T, W).
    One batched matmul maps [o,1] and [d,0] of every lane through every
    triangle's unit-triangle transform; the elementwise epilogue is ~10 ops/pair
    (vs ~60 for Moller-Trumbore). Returns (t, u, v, hit) each (T, W, K).
    """
    T, W, _ = o_t.shape
    K = w1.shape[2] // 3
    ones = jnp.ones((T, W, 1), o_t.dtype)
    zeros = jnp.zeros((T, W, 1), o_t.dtype)
    feats = jnp.concatenate(
        [jnp.concatenate([o_t, ones], axis=-1),
         jnp.concatenate([d_t, zeros], axis=-1)], axis=1)      # (T, 2W, 4)
    PQ = jax.lax.dot_general(feats, w1, (((2,), (1,)), ((0,), (0,))),
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)  # (T, 2W, 3K)
    P, Q = PQ[:, :W], PQ[:, W:]
    px, py, pz = P[..., 0:K], P[..., K:2 * K], P[..., 2 * K:3 * K]
    qx, qy, qz = Q[..., 0:K], Q[..., K:2 * K], Q[..., 2 * K:3 * K]
    ok = jnp.abs(qz) > 1e-12
    t = -pz / jnp.where(ok, qz, 1.0)
    u = px + t * qx
    v = py + t * qy
    # small barycentric slack: the transform's rounding differs from MT's, so
    # exact-zero bounds would open cracks along shared edges (a ray grazing
    # an edge can get u or v == -1e-7 on BOTH triangles). Slack makes edges
    # watertight (double-hit resolves by min-t) instead of leaky.
    eps = 1e-5
    hit = (ok & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
           & (t > 0.0) & (t < t_clip[:, :, None]))
    return t, u, v, hit


def _mt_rows_dense(bvh, o_t, d_t, slots, col_ok, t_clip):
    """MT fallback dense phase over explicit (T, K_tot) slot ids."""
    rows = _gather_rows(bvh.tris, jnp.where(col_ok, slots, 0))
    return mt_dense(o_t, d_t, rows, t_clip)


def _woop_slots_dense(bvh, o_t, d_t, slots, col_ok, t_clip):
    rows_w = _gather_rows(bvh.tris_woop, jnp.where(col_ok, slots, 0))
    w1 = _w1_from_rows(rows_w, slots.shape[1])
    return woop_dense(o_t, d_t, w1, t_clip)


# ---------------------------------------------------------------------------
# Wave engine: node-stepping with buffered leaves, one fused dense phase per
# wave, and shrink-round compaction so total work tracks the sum of per-tile
# visits instead of T x (slowest tile). See intersect_closest_wave.
# ---------------------------------------------------------------------------

def _wave_node_scan(bvh, st, node_steps, leaf_cap, stack_shape):
    """Run node_steps node-only traversal steps, buffering leaf codes."""

    def node_step(carry, _):
        (cur, sp, stack, nleaf, leafbuf, t_tile, active,
         o_lo, o_hi, rd_lo, rd_hi) = carry
        is_leaf = cur < 0
        full = nleaf >= leaf_cap
        lidx = jax.lax.broadcasted_iota(jnp.int32, leafbuf.shape, 1)
        append = is_leaf & active & ~full
        leafbuf = jnp.where((lidx == nleaf[:, None]) & append[:, None],
                            cur[:, None], leafbuf)
        nleaf = nleaf + jnp.where(append, 1, 0)

        node_idx = jnp.where(is_leaf | ~active, 0, cur)
        box = _gather_rows(bvh.nodes_box, node_idx)
        child = _gather_rows(bvh.nodes_child, node_idx)
        d0, h0 = _interval_slab(box[:, 0:6], o_lo, o_hi, rd_lo, rd_hi, t_tile)
        d1, h1 = _interval_slab(box[:, 6:12], o_lo, o_hi, rd_lo, rd_hi, t_tile)
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

        sidx = jax.lax.broadcasted_iota(jnp.int32, stack.shape, 1)
        stack = jnp.where((sidx == sp[:, None]) & push[:, None],
                          far[:, None], stack)
        sp = sp + jnp.where(push, 1, 0)

        nxt = jnp.where(is_leaf, jnp.where(full, cur, DONE), internal_next)
        need_pop = (nxt == DONE) & active
        can_pop = need_pop & (sp > 0)
        sp_pop = jnp.maximum(sp - 1, 0)
        top = jnp.take_along_axis(stack, sp_pop[:, None], axis=1)[:, 0]
        nxt = jnp.where(can_pop, top, nxt)
        sp = jnp.where(can_pop, sp_pop, sp)
        active = active & ~(need_pop & ~can_pop)
        nxt = jnp.where(active, nxt, DONE)
        return (nxt, sp, stack, nleaf, leafbuf, t_tile, active,
                o_lo, o_hi, rd_lo, rd_hi), None

    T = st["cur"].shape[0]
    nleaf = jnp.zeros((T,), jnp.int32)
    leafbuf = jnp.full((T, leaf_cap), -1, jnp.int32)
    carry = (st["cur"], st["sp"], st["stack"], nleaf, leafbuf, st["t_tile"],
             st["active"], st["o_lo"], st["o_hi"], st["rd_lo"], st["rd_hi"])
    (cur, sp, stack, nleaf, leafbuf, _, active, *_), _ = jax.lax.scan(
        node_step, carry, None, length=node_steps)
    return cur, sp, stack, nleaf, leafbuf, active


def _leaf_columns(leafbuf, nleaf, leaf_size):
    """Expand the (T, L) leaf buffer into flat dense-test columns:
    slots (T, L*K) triangle slot ids + col_ok validity mask."""
    first, count = _leaf_decode(leafbuf)   # filler -1 decodes to count 0
    has = (jax.lax.broadcasted_iota(jnp.int32, leafbuf.shape, 1)
           < nleaf[:, None])                                    # (T, L)
    k = jnp.arange(leaf_size, dtype=jnp.int32)
    slots = (first[:, :, None] + k[None, None, :])              # (T, L, K)
    col_ok = has[:, :, None] & (k[None, None, :] < count[:, :, None])
    L, K = leafbuf.shape[1], leaf_size
    return (slots.reshape(-1, L * K), col_ok.reshape(-1, L * K))


def _wave_state(bvh, o_t, d_t, tmax_t, stack_depth, closest):
    T, W, _ = o_t.shape
    o_lo, o_hi, rd_lo, rd_hi = _tile_bounds(o_t, d_t)
    st = dict(
        o_t=o_t, d_t=d_t, tmax=tmax_t,
        o_lo=o_lo, o_hi=o_hi, rd_lo=rd_lo, rd_hi=rd_hi,
        cur=jnp.zeros((T,), jnp.int32),
        sp=jnp.zeros((T,), jnp.int32),
        stack=jnp.full((T, stack_depth), DONE, jnp.int32),
        active=jnp.ones((T,), bool),
        tile_id=jnp.arange(T, dtype=jnp.int32),
        t_tile=jnp.zeros((T,), o_t.dtype),
    )
    if closest:
        st.update(t=jnp.full((T, W), BVH_FAR, o_t.dtype),
                  u=jnp.zeros((T, W), o_t.dtype),
                  v=jnp.zeros((T, W), o_t.dtype),
                  prim=jnp.full((T, W), -1, jnp.int32))
        st["t_tile"] = jnp.max(jnp.minimum(st["t"], tmax_t), axis=1)
    else:
        st["occ"] = jnp.zeros((T, W), bool)
        st["t_tile"] = jnp.max(jnp.where(tmax_t > 0.0, tmax_t, 0.0), axis=1)
    return st


def _wave_run(bvh, st, *, closest, node_steps, leaf_cap, leaf_size,
              dense, min_active):
    """while(any active [and > min_active tiles active]): node scan + dense.

    ``min_active`` is the adaptive-cascade exit: once at most that many
    tiles remain active, control returns so the caller can compact them
    into a narrower array (guaranteed to fit) and keep iterating there."""
    dense_fn = _woop_slots_dense if dense == "woop" else _mt_rows_dense

    def wave(carry):
        i, st = carry
        cur, sp, stack, nleaf, leafbuf, active = _wave_node_scan(
            bvh, st, node_steps, leaf_cap, st["stack"].shape)
        st = dict(st, cur=cur, sp=sp, stack=stack, active=active)

        slots, col_ok = _leaf_columns(leafbuf, nleaf, leaf_size)
        if closest:
            t_clip = jnp.minimum(st["t"], st["tmax"])
            kt, ku, kv, khit = dense_fn(bvh, st["o_t"], st["d_t"], slots,
                                        col_ok, t_clip)
            khit = khit & col_ok[:, None, :]
            t, u, v, prim = st["t"], st["u"], st["v"], st["prim"]
            K_tot = slots.shape[1]
            for k in range(K_tot):
                take = khit[:, :, k] & (kt[:, :, k] < jnp.minimum(t, st["tmax"]))
                t = jnp.where(take, kt[:, :, k], t)
                u = jnp.where(take, ku[:, :, k], u)
                v = jnp.where(take, kv[:, :, k], v)
                prim = jnp.where(take, slots[:, None, k], prim)
            st = dict(st, t=t, u=u, v=v, prim=prim,
                      t_tile=jnp.max(jnp.minimum(t, st["tmax"]), axis=1))
        else:
            _, _, _, khit = dense_fn(bvh, st["o_t"], st["d_t"], slots,
                                     col_ok, st["tmax"])
            occ = st["occ"] | jnp.any(khit & col_ok[:, None, :], axis=2)
            all_occ = jnp.all(occ | (st["tmax"] <= 0.0), axis=1)
            st = dict(st, occ=occ, active=st["active"] & ~all_occ,
                      t_tile=jnp.max(jnp.where(~occ, st["tmax"], 0.0), axis=1))
        return i + 1, st

    if min_active:
        def cond(c):
            return jnp.sum(c[1]["active"]) > min_active
    else:
        def cond(c):
            return jnp.any(c[1]["active"])

    _, st = jax.lax.while_loop(cond, wave, (jnp.int32(0), st))
    return st


def _wave_engine(bvh, o, d, t_max, *, closest, tile, stack_depth, leaf_size,
                 node_steps, leaf_cap, dense, shrink):
    """Adaptive shrink cascade.

    Each level of width T_k iterates while more than T_k/shrink tiles are
    active, then stable-sorts actives to the front and continues in a
    T_k/shrink-wide array — the exit condition guarantees every active tile
    fits, so no backstop pass is needed. Total work tracks the sum of
    per-tile visits instead of T x (slowest tile), with no per-pass tuning:
    coherent primary tiles exit level 0 after a handful of waves while
    incoherent bounce stragglers cascade into cheap narrow levels.
    """
    o_t, d_t, (tmax_t,), b, T = _pad_tiles(o, d, [t_max], tile)
    st = _wave_state(bvh, o_t, d_t, tmax_t, stack_depth, closest)
    run = lambda s, min_active: _wave_run(
        bvh, s, closest=closest, node_steps=node_steps, leaf_cap=leaf_cap,
        leaf_size=leaf_size, dense=dense, min_active=min_active)

    segments = []
    T_k = T
    shrunk = shrink and shrink > 1
    while shrunk and T_k // shrink >= 16:
        st = run(st, T_k // shrink)
        order = jnp.argsort(~st["active"], stable=True)
        st = jax.tree.map(lambda a: jnp.take(a, order, axis=0), st)
        T_k //= shrink
        segments.append(jax.tree.map(lambda a: a[T_k:], st))
        st = jax.tree.map(lambda a: a[:T_k], st)
    st = run(st, 0)
    if segments:
        st = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                          st, *reversed(segments))
        # inverse permutation by argsort (cheap at T rows)
        inv = jnp.argsort(st["tile_id"])
        take = lambda x: jnp.take(x, inv, axis=0).reshape(-1)[:b]
    else:
        take = lambda x: x.reshape(-1)[:b]
    if closest:
        t = take(st["t"])
        prim_slot = take(st["prim"])
        found = (prim_slot >= 0) & (t < jnp.asarray(t_max))
        prim = jnp.where(found, _gather_rows(bvh.prim_index,
                                             jnp.maximum(prim_slot, 0)), -1)
        t = jnp.where(found, t, BVH_FAR)
        u = jnp.where(found, take(st["u"]), 0.0)
        v = jnp.where(found, take(st["v"]), 0.0)
        return Hit(t=t, u=u, v=v, prim=prim, inst=jnp.where(found, 0, -1))
    return take(st["occ"])


def intersect_closest_wave(bvh: BVHArrays, o, d, t_max=None, *,
                           tile: int = 128, stack_depth: int = 48,
                           leaf_size: int = 16, node_steps: int = 8,
                           leaf_cap: int = 4, dense: str = "mt",
                           shrink: int = 8) -> Hit:
    """Wave packet traversal: decoupled node-stepping and dense leaf phases.

    A rebuild of tinybvh's packet + 8-wide traversal ideas
    (Core/tiny_bvh.h:2675-2846, :6302-6475) as whole-array XLA steps:

    * each outer iteration runs ``node_steps`` cheap node-interval steps per
      tile, buffering up to ``leaf_cap`` leaves, then ONE dense phase tests
      all buffered leaves against all lanes — as a batched matmul through
      per-triangle Woop transforms (``dense='woop'``) or elementwise
      Moller-Trumbore (``dense='mt'``);
    * an adaptive shrink cascade compacts still-active tiles into
      1/``shrink``-width arrays as soon as they fit, so total work tracks
      the sum of per-tile visits, not T x (slowest tile).
    """
    B0 = o.shape[0]
    if t_max is None:
        t_max = jnp.full((B0,), BVH_FAR, o.dtype)
    return _wave_engine(bvh, o, d, t_max, closest=True, tile=tile,
                        stack_depth=stack_depth, leaf_size=leaf_size,
                        node_steps=node_steps, leaf_cap=leaf_cap, dense=dense,
                        shrink=shrink)


def intersect_any_wave(bvh: BVHArrays, o, d, t_max, *,
                       tile: int = 128, stack_depth: int = 48,
                       leaf_size: int = 16, node_steps: int = 8,
                       leaf_cap: int = 4, dense: str = "mt",
                       shrink: int = 8) -> jnp.ndarray:
    """Wave occlusion query (see intersect_closest_wave)."""
    return _wave_engine(bvh, o, d, t_max, closest=False, tile=tile,
                        stack_depth=stack_depth, leaf_size=leaf_size,
                        node_steps=node_steps, leaf_cap=leaf_cap, dense=dense,
                        shrink=shrink)


def morton_key(o, d, scene_lo, scene_hi, dead=None, mode="octant_major"):
    """The raw coherence sort key (uint32) for morton_order — exposed so
    callers can CO-SORT ray payloads with the key in one multi-operand
    lax.sort instead of argsort + (B,) permutation gathers.

    Modes (tile = 1024 consecutive rays after the sort):
      * "octant_major": 3-bit direction octant, then 21-bit origin Morton —
        the batch analogue of tinybvh's per-octant specialisation
        (Core/tiny_bvh.h:6302-6311). Splits each surface region across up
        to 8 tiles.
      * "morton_major": coarse 12-bit origin Morton, then octant, then the
        9 fine Morton bits — tiles stay spatially tight first and only
        split by direction within a region. Better when the shared-stack
        cost is dominated by the spatial union of the tile's rays.
      * "six_d": origin Morton interleaved with a 2-bit-per-axis direction
        code (6D locality).

    ``dead`` (optional bool (B,)): lanes that cannot hit (e.g. shadow rays
    with tmax == 0 from an unselected light branch). They sort to the back so
    they cluster into all-dead tiles that a traversal rejects at the root in
    one step, instead of being interleaved with live rays."""
    ext = jnp.maximum(scene_hi - scene_lo, 1e-20)
    q = jnp.clip(((o - scene_lo) / ext) * 127.0, 0.0, 127.0).astype(jnp.uint32)

    def spread(x):  # interleave 7 bits with stride 3
        out = jnp.zeros_like(x)
        for i in range(7):
            out = out | (((x >> i) & 1) << (3 * i))
        return out

    morton = spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)
    octant = ((d[..., 0] > 0).astype(jnp.uint32)
              | ((d[..., 1] > 0).astype(jnp.uint32) << 1)
              | ((d[..., 2] > 0).astype(jnp.uint32) << 2))
    if mode == "octant_major":
        key = (octant << 21) | morton
        dead_shift = 24
    elif mode == "morton_major":
        key = (((morton >> 9) << 12) | (octant << 9) | (morton & 0x1FF))
        dead_shift = 24
    elif mode == "six_d":
        qd = jnp.clip((d * 0.5 + 0.5) * 3.0, 0.0, 3.0).astype(jnp.uint32)

        def spread2(x):  # 2 bits, stride 3
            return (x & 1) | (((x >> 1) & 1) << 3)

        dmorton = (spread2(qd[..., 0]) | (spread2(qd[..., 1]) << 1)
                   | (spread2(qd[..., 2]) << 2))
        # merge: 15 coarse origin bits, 6 direction bits, 6 fine origin bits
        key = (((morton >> 6) << 12) | (dmorton << 6) | (morton & 0x3F))
        dead_shift = 27
    else:
        raise ValueError(f"unknown morton_order mode: {mode}")
    if dead is not None:
        key = key | (dead.astype(jnp.uint32) << dead_shift)
    return key


def morton_order(o, d, scene_lo, scene_hi, dead=None, mode="octant_major"):
    """Coherence permutation (argsort of morton_key); invert with
    jnp.argsort(perm) to unsort results. Kept for the packet/wave engines;
    the dense-engine wrappers co-sort payloads with morton_key directly."""
    return jnp.argsort(morton_key(o, d, scene_lo, scene_hi,
                                  dead=dead, mode=mode))


def _scene_bounds(bvh: BVHArrays):
    """Root AABB from node 0 (union of its two child boxes)."""
    root = bvh.nodes_box[0]
    lo = jnp.minimum(root[0:3], root[6:9])
    hi = jnp.maximum(root[3:6], root[9:12])
    return lo, hi


def sorted_closest(fn, bvh: BVHArrays, o, d, t_max=None, **kw) -> Hit:
    """Run a closest-hit traversal on octant+Morton-sorted rays, unsorting
    the hits — the batch-scale analogue of tinybvh's per-octant traversal
    specialisation (Core/tiny_bvh.h:6302-6311). Sorting restores the packet
    coherence the tile frusta depend on for bounce/shadow wavefronts: a tile
    of same-octant rays has sign-definite reciprocal-direction intervals, so
    node culling stays effective for incoherent ray sets."""
    if t_max is None:
        t_max = jnp.full((o.shape[0],), BVH_FAR, o.dtype)
    lo, hi = _scene_bounds(bvh)
    perm = morton_order(o, d, lo, hi)
    hit = fn(bvh, jnp.take(o, perm, axis=0), jnp.take(d, perm, axis=0),
             jnp.take(t_max, perm), **kw)
    n = perm.shape[0]
    inv = jnp.zeros((n,), perm.dtype).at[perm].set(
        jnp.arange(n, dtype=perm.dtype))
    return jax.tree.map(lambda x: jnp.take(x, inv, axis=0), hit)


def sorted_any(fn, bvh: BVHArrays, o, d, t_max, **kw) -> jnp.ndarray:
    """Occlusion variant of sorted_closest."""
    lo, hi = _scene_bounds(bvh)
    perm = morton_order(o, d, lo, hi)
    occ = fn(bvh, jnp.take(o, perm, axis=0), jnp.take(d, perm, axis=0),
             jnp.take(t_max, perm), **kw)
    n = perm.shape[0]
    inv = jnp.zeros((n,), perm.dtype).at[perm].set(
        jnp.arange(n, dtype=perm.dtype))
    return jnp.take(occ, inv, axis=0)
