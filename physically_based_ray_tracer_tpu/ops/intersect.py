"""Ray-triangle and ray-AABB intersection primitives (pure jnp, batched).

Counterparts of tinybvh's shared intersectors: Möller-Trumbore
(Core/tiny_bvh.h:7965-7993) and the slab test (Core/tiny_bvh.h:8070+). All
functions are elementwise over matching leading batch dims so XLA fuses them
into the traversal loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from physically_based_ray_tracer_tpu.config import BVH_FAR


class Hit(NamedTuple):
    """SoA hit record; mirrors tinybvh::Intersection {t, u, v, prim, inst}
    (Core/tiny_bvh.h:545-569)."""

    t: jnp.ndarray      # (...)
    u: jnp.ndarray      # (...)
    v: jnp.ndarray      # (...)
    prim: jnp.ndarray   # (...) int32, -1 = miss
    inst: jnp.ndarray   # (...) int32, -1 = miss

    @staticmethod
    def none(shape, dtype=jnp.float32):
        far = jnp.full(shape, BVH_FAR, dtype)
        zero = jnp.zeros(shape, dtype)
        neg = jnp.full(shape, -1, jnp.int32)
        return Hit(far, zero, zero, neg, neg)

    @property
    def valid(self):
        return self.prim >= 0


def _cross3(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _dot3(a, b):
    """a . b summed left to right; b is a 3-tuple of components."""
    return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]


def intersect_tri(o, d, v0, e1, e2, t_max, eps: float = 1e-9):
    """Möller-Trumbore. Returns (t, u, v, hit_mask).

    No backface culling, matching BVHBase::IntersectTri semantics. ``t_max``
    is the current-best distance; hits at >= t_max are rejected. Every
    product and sum is written out in the order the dense traversal
    (ops/traverse_dense.py and its CUDA kernel) uses, so both engines round
    alike and agree on hits at shared edges.
    """
    pvec = _cross3(d, e2)
    det = _dot3(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = o - v0
    u = _dot3(tvec, pvec) * inv_det
    qvec = _cross3(tvec, e1)
    v = _dot3(d, qvec) * inv_det
    t = _dot3(e2, qvec) * inv_det
    hit = ((jnp.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < t_max))
    return t, u, v, hit


def intersect_aabb(o, rd, bmin, bmax, t_max):
    """Slab test with precomputed reciprocal direction ``rd``.

    Returns (dist, hit_mask); dist = entry distance (clamped at 0) like
    tinybvh's IntersectAABB, BVH_FAR on miss.
    """
    t1 = (bmin - o) * rd
    t2 = (bmax - o) * rd
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= tmin) & (tmin < t_max) & (tmax > 0.0)
    dist = jnp.where(hit, jnp.maximum(tmin, 0.0), BVH_FAR)
    return dist, hit


def safe_rcp(d, eps: float = 1e-20):
    """Reciprocal direction with zero protection (tinybvh tinybvh_rcp)."""
    return 1.0 / jnp.where(jnp.abs(d) < eps, jnp.where(d < 0, -eps, eps), d)


def brute_force_intersect(o, d, tri_v0, tri_e1, tri_e2, t_max=None):
    """O(rays x tris) closest-hit reference (testing oracle; no BVH).

    o, d: (B, 3); tris: (P, 3). Returns a Hit with inst=0.
    """
    B = o.shape[0]
    if t_max is None:
        t_max = jnp.full((B,), BVH_FAR, o.dtype)
    t, u, v, hit = intersect_tri(
        o[:, None, :], d[:, None, :],
        tri_v0[None, :, :], tri_e1[None, :, :], tri_e2[None, :, :],
        t_max[:, None])
    t = jnp.where(hit, t, BVH_FAR)
    best = jnp.argmin(t, axis=1)
    bt = jnp.take_along_axis(t, best[:, None], axis=1)[:, 0]
    bu = jnp.take_along_axis(u, best[:, None], axis=1)[:, 0]
    bv = jnp.take_along_axis(v, best[:, None], axis=1)[:, 0]
    found = bt < BVH_FAR
    prim = jnp.where(found, best.astype(jnp.int32), -1)
    return Hit(t=bt, u=jnp.where(found, bu, 0.0), v=jnp.where(found, bv, 0.0),
               prim=prim, inst=jnp.where(found, 0, -1))
