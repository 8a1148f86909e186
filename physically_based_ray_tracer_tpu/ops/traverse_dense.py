"""Traversal of the dense-leaf BVH (bvh/dense.py): the default engine.

One algorithm, two lowerings, chosen by ``jax.lax.platform_dependent``:

  * on CUDA, the kernel in ops/csrc/traverse.cu (one thread per ray, a
    per-thread stack, while-while traversal; built and registered by
    ops/cuda_ffi.py). It is the only lowering there: no fallback.
  * on every other platform, ``plain_trace`` below: the same traversal
    written in jnp/lax as one ``lax.while_loop`` over the whole batch. It is
    the CPU engine and, run on the card, what XLA makes of the kernel.

Both follow the same visit order: near-first ordered descent (the child
with the smaller entry distance first, child 0 on ties), the far child
pushed when both are hit, leaf triangles tested in column order. Closest
hit does not depend on that order: of triangles at exactly the same t, the
first in (instance, primitive id) order wins, as in a brute-force argmin,
and a box entered exactly at the best t is still visited. At an
instance leaf the ray is rebased into object space and a RESTORE sentinel
is pushed below the BLAS subtree (bvh/dense.py documents the encoding).
The stack holds ``stack_depth`` entries; a push onto a full stack
overwrites the top entry and sets FLAG_STACK_OVERFLOW in the ray's flags.

Traversal is a discrete search: its inputs are detached
(``stop_gradient``), so differentiating a caller gives the hit record a
zero tangent. Differentiable (t, u, v) come from ops.traverse.refine_hit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from physically_based_ray_tracer_tpu.bvh.dense import (ABSENT, DenseBVH,
                                                       GROUP_ROWS, INST_F,
                                                       LEAF_W, NODE_F,
                                                       RESTORE_ID)
from physically_based_ray_tracer_tpu.config import BVH_FAR
from physically_based_ray_tracer_tpu.ops import cuda_ffi
from physically_based_ray_tracer_tpu.ops.intersect import Hit

DONE = 0x7FFFFFFF
RESTORE_CODE = -(2 * RESTORE_ID + 2)
MAX_STACK = 128          # largest stack the CUDA kernel is instantiated for
DEFAULT_STACK = 64
LEAF_CHUNK = 16          # triangles the plain traversal tests per step

FLAG_STACK_OVERFLOW = 1
FLAG_STEP_LIMIT = 2
FLAG_BAD_CODE = 4


def max_steps(dbvh: DenseBVH) -> int:
    """Per-ray bound on node + leaf visits (a guard against malformed
    tables, far above what a valid tree needs): each node is entered at
    most once per instance entry, and leaves are children of nodes."""
    n_nodes = dbvh.nodes16.shape[0] // NODE_F
    n_inst = dbvh.inst16.shape[0] // INST_F
    return min(16 * n_nodes * (n_inst + 1) + 64, 2**31 - 1)


def _check_stack(stack_depth: int) -> int:
    if not 1 <= stack_depth <= MAX_STACK:
        raise ValueError(f"stack_depth must be in [1, {MAX_STACK}], "
                         f"got {stack_depth}")
    return int(stack_depth)


def _rcp(d):
    eps = jnp.float32(1e-20)
    return 1.0 / jnp.where(jnp.abs(d) < eps, jnp.where(d < 0, -eps, eps), d)


def _slab(ray, lo, hi, t_clip):
    """Per-ray slab test of one child box; lo/hi are (B, 3)."""
    ox, oy, oz, _, _, _, rx, ry, rz = ray
    tx0 = (lo[:, 0] - ox) * rx
    tx1 = (hi[:, 0] - ox) * rx
    ty0 = (lo[:, 1] - oy) * ry
    ty1 = (hi[:, 1] - oy) * ry
    tz0 = (lo[:, 2] - oz) * rz
    tz1 = (hi[:, 2] - oz) * rz
    tn = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                     jnp.minimum(tz0, tz1))
    tf = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                     jnp.maximum(tz0, tz1))
    return (tn <= tf) & (tf > 0.0) & (tn <= t_clip) & (t_clip > 0.0), tn


def _moller_trumbore(ray, c):
    """Rays (B,) against K triangles each; c is (B, 10, K) leaf columns."""
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in ray[:6])
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (c[:, k] for k in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = jnp.abs(det) > 1e-9
    inv = 1.0 / jnp.where(det_ok, det, 1.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
    return uu, vv, tt, ok


def plain_trace(nodes16, groups, inst16, ox, oy, oz, dx, dy, dz, tmax, *,
                closest: bool, stack_depth: int, max_steps: int):
    """The traversal in jnp/lax. Returns (t, u, v, prim, inst, flags) for
    closest hit (prim mesh-local, inst -1 outside instances) or
    (occluded, flags) as int32 for any hit — the CUDA kernel's outputs."""
    cap = _check_stack(stack_depth)
    B = tmax.shape[0]
    n_nodes = nodes16.shape[0] // NODE_F
    n_groups = groups.shape[0] // GROUP_ROWS
    n_inst = inst16.shape[0] // INST_F
    nodes = nodes16.reshape(n_nodes, NODE_F)
    gflat = groups.reshape(-1)
    rows = jnp.arange(B)
    lane = jnp.arange(LEAF_CHUNK, dtype=jnp.int32)
    comp = jnp.arange(10, dtype=jnp.int32)
    world = (ox, oy, oz, dx, dy, dz, _rcp(dx), _rcp(dy), _rcp(dz))

    def body(s):
        cur, loff, sp, stack, cinst, ray, t, u, v, prim, iout, occ, flags, \
            steps = s
        active = cur != DONE
        visit = active & (loff == 0)            # a step that starts a visit
        limit = visit & (steps >= max_steps)
        flags = flags | jnp.where(limit, FLAG_STEP_LIMIT, 0)
        live = active & ~limit
        steps = steps + visit.astype(jnp.int32)

        # ---- internal node ------------------------------------------------
        is_node = live & (cur >= 0)
        bad_node = is_node & (cur >= n_nodes)
        is_node = is_node & ~bad_node
        row = nodes[jnp.where(is_node, cur, 0)]                  # (B, 16)
        t_clip = t if closest else tmax
        h0, tn0 = _slab(ray, row[:, 0:3], row[:, 3:6], t_clip)
        h1, tn1 = _slab(ray, row[:, 6:9], row[:, 9:12], t_clip)
        c0 = row[:, 12].astype(jnp.int32)
        c1 = row[:, 13].astype(jnp.int32)
        h0 = h0 & (c0 != ABSENT)
        h1 = h1 & (c1 != ABSENT)
        swap = h1 & (~h0 | (tn1 < tn0))
        near = jnp.where(swap, c1, c0)
        far = jnp.where(swap, c0, c1)
        near_ok = jnp.where(swap, h1, h0)
        far_ok = jnp.where(swap, h0, h1)
        node_push = is_node & near_ok & far_ok
        node_next = jnp.where(near_ok, near, jnp.where(far_ok, far, DONE))

        # ---- triangle leaf: LEAF_CHUNK columns per step ---------------------
        vcode = jnp.where(live & (cur < 0), -(cur + 1), 0)
        is_tri = live & (cur < 0) & (vcode % 2 == 0)
        gv = vcode // 2
        g = gv // 8
        count = jnp.left_shift(1, gv % 8)
        bad_tri = is_tri & (g >= n_groups)
        is_tri = is_tri & ~bad_tri
        cols = loff[:, None] + lane[None, :]                     # (B, K)
        col_ok = is_tri[:, None] & (cols < count[:, None])
        idx = (jnp.where(is_tri, g, 0)[:, None, None] * (GROUP_ROWS * LEAF_W)
               + comp[None, :, None] * LEAF_W
               + jnp.minimum(cols, LEAF_W - 1)[:, None, :])      # (B, 10, K)
        leaf = gflat[idx]
        uu, vv, tt, ok = _moller_trumbore(ray, leaf)
        if closest:
            pid = leaf[:, 9].astype(jnp.int32)                   # (B, K)
            tie_first = ((tt == t[:, None]) & (prim[:, None] >= 0)
                         & ((cinst < iout)[:, None]
                            | ((cinst == iout)[:, None]
                               & (pid < prim[:, None]))))
            acc = col_ok & ok & ((tt < t[:, None]) | tie_first)
            t_min = jnp.min(jnp.where(acc, tt, jnp.inf), axis=1)
            j = jnp.argmin(jnp.where(acc & (tt == t_min[:, None]), pid,
                                     jnp.iinfo(jnp.int32).max), axis=1)
            take = jnp.any(acc, axis=1)
            pick = lambda x: jnp.take_along_axis(x, j[:, None], axis=1)[:, 0]
            t = jnp.where(take, pick(tt), t)
            u = jnp.where(take, pick(uu), u)
            v = jnp.where(take, pick(vv), v)
            prim = jnp.where(take, pick(pid), prim)
            iout = jnp.where(take, cinst, iout)
        else:
            occ = occ | jnp.any(col_ok & ok & (tt < tmax[:, None]), axis=1)
        more = is_tri & (loff + LEAF_CHUNK < count)
        loff = jnp.where(more, loff + LEAF_CHUNK, 0)

        # ---- instance leaf: enter (push RESTORE, rebase) or restore --------
        is_inst = live & (cur < 0) & (vcode % 2 == 1)
        iid = vcode // 2
        is_restore = is_inst & (iid == RESTORE_ID)
        bad_inst = is_inst & ~is_restore & (iid >= n_inst)
        enter = is_inst & ~is_restore & ~bad_inst
        if n_inst > 0:
            m = inst16.reshape(n_inst, INST_F)[jnp.where(enter, iid, 0)]
            wo, wd = world[0:3], world[3:6]
            o_obj = [m[:, 4 * r] * wo[0] + m[:, 4 * r + 1] * wo[1]
                     + m[:, 4 * r + 2] * wo[2] + m[:, 4 * r + 3]
                     for r in range(3)]
            d_obj = [m[:, 4 * r] * wd[0] + m[:, 4 * r + 1] * wd[1]
                     + m[:, 4 * r + 2] * wd[2] for r in range(3)]
            entered = (*o_obj, *d_obj, *(_rcp(x) for x in d_obj))
            ray = tuple(jnp.where(enter, e, jnp.where(is_restore, w, r))
                        for e, w, r in zip(entered, world, ray))
            root = m[:, 12].astype(jnp.int32)
        else:
            root = jnp.zeros((B,), jnp.int32)
        cinst = jnp.where(enter, iid, jnp.where(is_restore, -1, cinst))

        # ---- stack push (far child or RESTORE sentinel), clamped ------------
        do_push = node_push | enter
        overflow = do_push & (sp >= cap)
        flags = flags | jnp.where(overflow, FLAG_STACK_OVERFLOW, 0)
        flags = flags | jnp.where(bad_node | bad_tri | bad_inst,
                                  FLAG_BAD_CODE, 0)
        code = jnp.where(node_push, far, RESTORE_CODE)
        widx = jnp.where(do_push, jnp.minimum(sp, cap - 1), cap)
        stack = stack.at[rows, widx].set(code, mode="drop")
        sp = jnp.where(do_push, jnp.minimum(sp + 1, cap), sp)

        nxt = jnp.where(is_node, node_next, DONE)
        nxt = jnp.where(more, cur, nxt)
        nxt = jnp.where(enter, root, nxt)
        stop = limit if closest else (occ | limit)   # any hit ends the ray
        nxt = jnp.where(stop, DONE, nxt)
        sp = jnp.where(stop, 0, sp)
        need_pop = active & (nxt == DONE) & (sp > 0)
        top = jnp.take_along_axis(stack, jnp.maximum(sp - 1, 0)[:, None],
                                  axis=1)[:, 0]
        nxt = jnp.where(need_pop, top, nxt)
        sp = jnp.where(need_pop, sp - 1, sp)
        return (nxt, loff, sp, stack, cinst, ray, t, u, v, prim, iout, occ,
                flags, steps)

    zf = jnp.zeros((B,), jnp.float32)
    zi = jnp.zeros((B,), jnp.int32)
    init = (zi, zi, zi, jnp.full((B, cap), DONE, jnp.int32),
            jnp.full((B,), -1, jnp.int32), world,
            tmax if closest else zf, zf, zf, jnp.full((B,), -1, jnp.int32),
            jnp.full((B,), -1, jnp.int32), jnp.zeros((B,), bool), zi, zi)
    out = jax.lax.while_loop(lambda s: jnp.any(s[0] != DONE), body, init)
    _, _, _, _, _, _, t, u, v, prim, iout, occ, flags, _ = out
    if closest:
        return t, u, v, prim, iout, flags
    return occ.astype(jnp.int32), flags


def ffi_trace(nodes16, groups, inst16, ox, oy, oz, dx, dy, dz, tmax, *,
              closest: bool, stack_depth: int, max_steps: int):
    """The CUDA kernel as a JAX operation (same outputs as plain_trace).
    Lowers only for CUDA; registering the targets builds the library."""
    _check_stack(stack_depth)
    if cuda_ffi.gpu_backend_present():
        cuda_ffi.ensure_registered()
    n = tmax.shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    if closest:
        target, outs = cuda_ffi.CLOSEST_TARGET, (f32, f32, f32, i32, i32, i32)
    else:
        target, outs = cuda_ffi.ANY_TARGET, (i32, i32)
    call = jax.ffi.ffi_call(target, outs)
    return tuple(call(nodes16, groups, inst16, ox, oy, oz, dx, dy, dz, tmax,
                      stack_depth=np.int64(stack_depth),
                      max_steps=np.int64(max_steps)))


def trace_dense(dbvh: DenseBVH, comps, tmax, *, closest: bool,
                stack_depth: int = DEFAULT_STACK):
    """Dispatch: the CUDA kernel on CUDA, the plain traversal elsewhere."""
    args = jax.lax.stop_gradient(
        (dbvh.nodes16, dbvh.groups, dbvh.inst16, *comps, tmax))
    kw = dict(closest=closest, stack_depth=stack_depth,
              max_steps=max_steps(dbvh))
    return jax.lax.platform_dependent(
        *args, cuda=lambda *a: ffi_trace(*a, **kw),
        default=lambda *a: plain_trace(*a, **kw))


def _split(o, d):
    return (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])


def hit_from_raw(dbvh: DenseBVH, t, u, v, prim, inst) -> Hit:
    """Map a closest-hit record to the scene's global prim order (shared
    BLAS prim ids are mesh-local; bvh/dense.py prim_base)."""
    found = prim >= 0
    base = jnp.take(dbvh.prim_base, jnp.maximum(inst, 0), mode="clip")
    return Hit(t=jnp.where(found, t, BVH_FAR),
               u=jnp.where(found, u, 0.0),
               v=jnp.where(found, v, 0.0),
               prim=jnp.where(found, prim + base, -1),
               inst=jnp.where(found, jnp.maximum(inst, 0), -1))


def intersect_closest_dense(dbvh: DenseBVH, o, d, t_max=None, *,
                            stack_depth: int = DEFAULT_STACK,
                            components=None) -> Hit:
    """Closest hit; o, d: (B, 3), or ``components`` = (ox, oy, oz, dx, dy,
    dz) already split. inst is the instance id (0 for single-level)."""
    comps = components if components is not None else _split(o, d)
    if t_max is None:
        t_max = jnp.full(comps[0].shape, BVH_FAR, jnp.float32)
    t, u, v, prim, inst, _ = trace_dense(dbvh, comps, t_max, closest=True,
                                         stack_depth=stack_depth)
    return hit_from_raw(dbvh, t, u, v, prim, inst)


def intersect_any_dense(dbvh: DenseBVH, o, d, t_max, *,
                        stack_depth: int = DEFAULT_STACK,
                        components=None) -> jnp.ndarray:
    """Occlusion: True where a hit exists with t in (0, t_max)."""
    comps = components if components is not None else _split(o, d)
    occ, _ = trace_dense(dbvh, comps, t_max, closest=False,
                         stack_depth=stack_depth)
    return occ > 0


def _cosort_rays(dbvh: DenseBVH, o, d, t_max, mode):
    """One multi-operand stable sort carries the key, the original index
    and the seven ray components into octant+Morton order (a stable
    co-sort gives the same permutation as argsort + gathers)."""
    from physically_based_ray_tracer_tpu.ops.traverse_packet import morton_key
    key = morton_key(o, d, dbvh.world_lo, dbvh.world_hi,
                     dead=t_max <= 0.0, mode=mode)
    idx = jnp.arange(t_max.shape[0], dtype=jnp.int32)
    _, idx_s, ox, oy, oz, dx, dy, dz, tm = jax.lax.sort(
        (key, idx, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
         t_max), num_keys=1)
    return idx_s, (ox, oy, oz, dx, dy, dz), tm


def sorted_closest_dense(dbvh: DenseBVH, o, d, t_max=None, *,
                         stack_depth: int = DEFAULT_STACK,
                         sort_mode: str = "octant_major") -> Hit:
    """Closest hit on octant+Morton-sorted rays (bounce/shadow wavefronts)."""
    if t_max is None:
        t_max = jnp.full((o.shape[0],), BVH_FAR, o.dtype)
    idx_s, comps, tm = _cosort_rays(dbvh, o, d, t_max, sort_mode)
    hit = intersect_closest_dense(dbvh, None, None, tm,
                                  stack_depth=stack_depth, components=comps)
    # unsort: co-sort the hit record back by original index
    _, t, u, v, prim, inst = jax.lax.sort(
        (idx_s, hit.t, hit.u, hit.v, hit.prim, hit.inst), num_keys=1)
    return Hit(t=t, u=u, v=v, prim=prim, inst=inst)


def sorted_any_dense(dbvh: DenseBVH, o, d, t_max, *,
                     stack_depth: int = DEFAULT_STACK,
                     sort_mode: str = "octant_major") -> jnp.ndarray:
    idx_s, comps, tm = _cosort_rays(dbvh, o, d, t_max, sort_mode)
    occ = intersect_any_dense(dbvh, None, None, tm, stack_depth=stack_depth,
                              components=comps)
    _, occ = jax.lax.sort((idx_s, occ.astype(jnp.int32)), num_keys=1)
    return occ > 0
