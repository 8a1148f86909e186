"""BVH refit for deformable geometry (BVH::Refit analogue, tiny_bvh.h:2298).

Vertex deformation (cloth, skinned meshes, morphing) moves triangles without
changing topology; a refit rewrites the stored triangle data in place and
recomputes node AABBs bottom-up — no re-split, orders of magnitude cheaper
than a rebuild and tree quality degrades only gradually. Runs host-side
(numpy) like the builders (SURVEY.md §7: build on host, traverse on device):
the per-frame upload is the same arrays a rebuild would upload.

Both layouts are supported:
  * refit_bvh    — classic 2-wide BVHArrays (bvh/types.py)
  * refit_dense  — dense-leaf single-level DenseBVH (bvh/dense.py); for
    two-level tables rigid motion is already covered by refresh_tlas
    (transform updates), so dense refit targets the single-level baked path.

Trees built with spatial splits (SBVH) refit conservatively: duplicated
references grow to the full triangle box (clip boxes are not retained), so
boxes stay valid but looser than a rebuild — the same trade tinybvh
documents for refitting BuildHQ trees.
"""

from __future__ import annotations

import numpy as np

from physically_based_ray_tracer_tpu.bvh.dense import (DenseBVH, GROUP_ROWS,
                                                       NODE_F)
from physically_based_ray_tracer_tpu.bvh.types import (BVHArrays,
                                                       LEAF_COUNT_BITS,
                                                       woop_from_tris)


def _levels(children: np.ndarray):
    """Nodes grouped by depth (root first); children (N, 2) int codes with
    internal >= 0."""
    N = children.shape[0]
    depth = np.full(N, -1, np.int64)
    depth[0] = 0
    order = [np.array([0])]
    cur = np.array([0])
    while True:
        c = children[cur].reshape(-1)
        nxt = c[c >= 0].astype(np.int64)
        nxt = nxt[depth[nxt] < 0] if len(nxt) else nxt
        if len(nxt) == 0:
            break
        depth[nxt] = len(order)
        order.append(nxt)
        cur = nxt
    return order


def refit_bvh(bvh: BVHArrays, new_tris: np.ndarray) -> BVHArrays:
    """Refit a classic 2-wide BVH to deformed triangles ((T,3,3) or (3T,3),
    original prim order). Returns a new BVHArrays (numpy leaves)."""
    tri = np.asarray(new_tris, np.float32)
    if tri.ndim == 2:
        tri = tri.reshape(-1, 3, 3)
    children = np.asarray(bvh.nodes_child)
    prim_index = np.asarray(bvh.prim_index)
    nodes_box = np.array(bvh.nodes_box, np.float32, copy=True)

    # rewrite packed triangle rows from the new positions
    pid = np.maximum(prim_index, 0)
    v0 = tri[pid, 0]
    packed = np.concatenate(
        [v0, tri[pid, 1] - v0, tri[pid, 2] - v0], axis=1).astype(np.float32)
    packed[prim_index < 0] = 0.0

    # per-row corner bounds (padding rows excluded via +-inf)
    c0 = packed[:, 0:3]
    c1 = packed[:, 0:3] + packed[:, 3:6]
    c2 = packed[:, 0:3] + packed[:, 6:9]
    row_lo = np.minimum(np.minimum(c0, c1), c2)
    row_hi = np.maximum(np.maximum(c0, c1), c2)
    row_lo[prim_index < 0] = np.inf
    row_hi[prim_index < 0] = -np.inf

    # bottom-up: leaves first, then internal unions, by depth levels
    levels = _levels(children)
    node_lo = np.empty((children.shape[0], 2, 3), np.float32)
    node_hi = np.empty((children.shape[0], 2, 3), np.float32)
    for lvl in reversed(levels):
        for side in (0, 1):
            code = children[lvl, side]
            leaf = code < 0
            m = -(code + 1)
            first = m >> LEAF_COUNT_BITS
            count = m & ((1 << LEAF_COUNT_BITS) - 1)
            # leaf bounds: union over its rows (width = max count this level)
            if leaf.any():
                wmax = int(count[leaf].max()) if leaf.any() else 0
                lo = np.full((len(lvl), 3), np.inf, np.float32)
                hi = np.full((len(lvl), 3), -np.inf, np.float32)
                for j in range(max(wmax, 0)):
                    rows = np.clip(first + j, 0, packed.shape[0] - 1)
                    take = leaf & (j < count)
                    lo[take] = np.minimum(lo[take], row_lo[rows[take]])
                    hi[take] = np.maximum(hi[take], row_hi[rows[take]])
                # empty leaves (count 0) keep a degenerate inverted box
                node_lo[lvl[leaf], side] = lo[leaf]
                node_hi[lvl[leaf], side] = hi[leaf]
            internal = ~leaf
            if internal.any():
                ci = code[internal].astype(np.int64)
                node_lo[lvl[internal], side] = np.minimum(
                    node_lo[ci, 0], node_lo[ci, 1])
                node_hi[lvl[internal], side] = np.maximum(
                    node_hi[ci, 0], node_hi[ci, 1])
    nodes_box[:, 0:3] = node_lo[:, 0]
    nodes_box[:, 3:6] = node_hi[:, 0]
    nodes_box[:, 6:9] = node_lo[:, 1]
    nodes_box[:, 9:12] = node_hi[:, 1]
    # empty leaf slots produced inverted inf boxes; store finite inverted
    # boxes instead (reject every ray without inf arithmetic)
    nodes_box[:, [0, 1, 2, 6, 7, 8]] = np.nan_to_num(
        nodes_box[:, [0, 1, 2, 6, 7, 8]], posinf=1e30, neginf=-1e30)
    nodes_box[:, [3, 4, 5, 9, 10, 11]] = np.nan_to_num(
        nodes_box[:, [3, 4, 5, 9, 10, 11]], posinf=1e30, neginf=-1e30)

    return BVHArrays(nodes_box, children, packed, prim_index,
                     woop_from_tris(packed))


def refit_dense(dbvh: DenseBVH, new_tris: np.ndarray) -> DenseBVH:
    """Refit a single-level dense-leaf BVH to deformed triangles."""
    import jax.numpy as jnp

    tri = np.asarray(new_tris, np.float32)
    if tri.ndim == 2:
        tri = tri.reshape(-1, 3, 3)
    assert dbvh.n_instances == 0, \
        "dense refit covers the single-level baked path; rigid instance " \
        "motion goes through refresh_tlas instead"

    groups = np.array(dbvh.groups, np.float32, copy=True)
    G = groups.shape[0] // GROUP_ROWS
    gview = groups.reshape(G, GROUP_ROWS, -1)
    pid = gview[:, 9, :].astype(np.int64)          # (G, 128)
    live = pid >= 0
    p = np.maximum(pid, 0)
    v0 = tri[p, 0]                                  # (G, 128, 3)
    e1 = tri[p, 1] - v0
    e2 = tri[p, 2] - v0
    for k in range(3):
        gview[:, 0 + k, :] = np.where(live, v0[..., k], 0.0)
        gview[:, 3 + k, :] = np.where(live, e1[..., k], 0.0)
        gview[:, 6 + k, :] = np.where(live, e2[..., k], 0.0)

    # per-group bounds over live lanes
    lo3 = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi3 = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    lo3 = np.where(live[..., None], lo3, np.inf)
    hi3 = np.where(live[..., None], hi3, -np.inf)
    g_lo = lo3.min(axis=1)                          # (G, 3)
    g_hi = hi3.max(axis=1)

    nodes = np.array(dbvh.nodes16, np.float32, copy=True).reshape(-1, NODE_F)
    children = np.rint(nodes[:, 12:14]).astype(np.int64)
    levels = _levels(np.where(children >= 0, children, -1).astype(np.int32))
    # child code decode for leaves: v = -(code+1); tri leaf payload v>>1
    node_lo = np.empty((nodes.shape[0], 2, 3), np.float32)
    node_hi = np.empty((nodes.shape[0], 2, 3), np.float32)
    for lvl in reversed(levels):
        for side in (0, 1):
            code = children[lvl, side]
            internal = code >= 0
            leafish = ~internal
            v = -(code + 1)
            is_tri = leafish & (v >= 0) & (v % 2 == 0)
            g = np.clip((v // 2) // 8, 0, G - 1)
            node_lo[lvl, side] = np.where(is_tri[:, None], g_lo[g], np.inf)
            node_hi[lvl, side] = np.where(is_tri[:, None], g_hi[g], -np.inf)
            if internal.any():
                ci = code[internal]
                node_lo[lvl[internal], side] = np.minimum(
                    node_lo[ci, 0], node_lo[ci, 1])
                node_hi[lvl[internal], side] = np.maximum(
                    node_hi[ci, 0], node_hi[ci, 1])
    nodes[:, 0:3] = node_lo[:, 0]
    nodes[:, 3:6] = node_hi[:, 0]
    nodes[:, 6:9] = node_lo[:, 1]
    nodes[:, 9:12] = node_hi[:, 1]
    nodes[:, 0:12] = np.nan_to_num(nodes[:, 0:12], posinf=1e30, neginf=-1e30)

    root_lo = np.minimum(nodes[0, 0:3], nodes[0, 6:9])
    root_hi = np.maximum(nodes[0, 3:6], nodes[0, 9:12])
    return DenseBVH(
        nodes16=jnp.asarray(nodes.reshape(-1)),
        groups=jnp.asarray(groups),
        inst16=dbvh.inst16,
        prim_base=dbvh.prim_base,
        world_lo=jnp.asarray(np.where(np.isfinite(root_lo), root_lo, 0.0)
                             .astype(np.float32)),
        world_hi=jnp.asarray(np.where(np.isfinite(root_hi), root_hi, 0.0)
                             .astype(np.float32)),
    )
