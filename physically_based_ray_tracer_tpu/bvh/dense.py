"""Dense-leaf BVH (+ two-level TLAS) for the default traversal engine
(ops/traverse_dense.py: the CUDA kernel on the card, the plain traversal
elsewhere). It takes the role of tinybvh's BVH8_CPU + TLAS
(Core/tiny_bvh.h:1183-1238, :1732-1770): a binary tree with fat leaves, each
leaf one component-major group of up to 128 triangles.

Layouts:
  * ``nodes16`` (N*16,) f32 flat, per node (four float4 rows):
      [c0min(3), c0max(3), c1min(3), c1max(3), child0, child1, pad, pad]
    children stored as *floats* (exact for |idx| < 2^24):
      code >= 0            -> internal node index
      code <  0, v=-(code+1):
        v & 1 == 0         -> triangle leaf, v >> 1 = group*8 + log2(period)
        v & 1 == 1         -> instance leaf, v >> 1 = instance id
                              (id RESTORE_ID is the traversal's ray-space
                              restore sentinel; never a real instance)
      code == ABSENT       -> no child in this slot (traversal rejects by
                              code — see ABSENT note below).
  * ``groups`` (G*16, 128) f32: group g occupies rows [16g, 16g+16); rows
    0..8 are v0.xyz, e1.xyz, e2.xyz (one triangle per column), row 9 is the
    primitive id as float (-1 for padding columns). Padding columns are
    all-zero triangles -> Möller-Trumbore det == 0 -> never hit.
  * ``inst16`` (I*16,) f32, per instance (BLASInstance analogue,
    Core/tiny_bvh.h:1243-1256): [0:12] = rows of the inverse (object from
    world) 3x4 transform, [12] = BLAS root node index, [13:16] pad.
  * ``prim_base`` (max(I,1),) i32: per-instance offset added to the
    mesh-local primitive ids baked in shared BLAS groups, mapping hits to
    the scene's global (per-instance-concatenated) primitive order.

Variable-count leaves: a leaf holding k triangles is padded to the next
power of two c = 2^ceil(log2 k) (degenerate all-zero triangles); log2(c)
rides in the leaf code and traversal tests the group's first c columns.
The c-block is also replicated cyclically across all 128 columns (slot
j = tri j mod c), which the refit and cache code rely on to recover c.

Two-level build (build_dense_tlas): each mesh's BVH is built once; the
TLAS is a small sweep-SAH BVH2 over instance world AABBs whose leaves are
instance codes. All tables merge into one node/group table (BLAS node ids
shifted past a fixed-capacity TLAS head region), so traversal needs no
separate dispatch — entering an instance just jumps to its BLAS root with
the ray re-based into object space. refresh_tlas() rewrites only the TLAS
head + inst16 when transforms change (the analogue of per-frame
Scene::BuildTLAS, Core/Scene.cpp:220-223) — BLAS nodes and the (big) group
table stay resident on device untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

BINS = 8
LEAF_W = 128          # triangle columns per leaf group
GROUP_ROWS = 16       # rows per group in the flat groups array (12 used)
NODE_F = 16           # floats per node in nodes16
INST_F = 16           # floats per instance in inst16
RESTORE_ID = (1 << 22) - 1   # reserved instance id: ray-space restore pop
ABSENT = -(1 << 30)          # child code of an absent slot (exact in f32).
# NOTE: absent slots need an explicit code check in traversal — the min/max
# slab test is symmetric in lo/hi, so an "inverted box" would ACCEPT every
# ray (both per-axis planes just swap), not reject it.
BIG = np.float32(1e30)
# Leaf size the scene builders target. Measured on the flagship frame
# (PERF.md): 4 and 8 tie, 16 is ~5% slower; 8 keeps the group table smaller.
DEFAULT_LEAF_TARGET = 8


def _tri_code(g: int, log2c: int) -> float:
    return float(-(2 * (g * 8 + log2c) + 1))


def _inst_code(iid: int) -> float:
    return float(-(2 * iid + 2))


class DenseBVH(NamedTuple):
    """Device-resident dense-leaf BVH (see module docstring for layouts)."""

    nodes16: jnp.ndarray    # (N*16,) f32
    groups: jnp.ndarray     # (G*16, 128) f32
    inst16: jnp.ndarray     # (I*16,) f32 (one zero row when single-level)
    prim_base: jnp.ndarray  # (max(I,1),) i32 global prim offset per instance
    world_lo: jnp.ndarray   # (3,) f32 root bounds (for Morton ray sorting)
    world_hi: jnp.ndarray   # (3,) f32

    @property
    def n_nodes(self):
        return self.nodes16.shape[0] // NODE_F

    @property
    def n_groups(self):
        return self.groups.shape[0] // GROUP_ROWS

    @property
    def n_instances(self):
        return self.inst16.shape[0] // INST_F


class TLASMeta(NamedTuple):
    """Host-side constants needed to refresh the TLAS without touching
    BLAS/group data (instance count and mesh assignment are fixed)."""

    tlas_cap: int          # nodes reserved for the TLAS at the table head
    inst_mesh: np.ndarray  # (I,) mesh index per instance
    blas_root: np.ndarray  # (B,) merged-table root node index per mesh
    blas_lo: np.ndarray    # (B, 3) object-space root bounds per mesh
    blas_hi: np.ndarray    # (B, 3)


def _surface_area(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                  + e[..., 2] * e[..., 0])


def _build_core(tri: np.ndarray, leaf_target: int):
    """Binned-SAH build (algorithm of Core/tiny_bvh.h:1841-1934) with fat
    dense leaves: a segment becomes a leaf group once count <= leaf_target
    (the leaf size is the tunable).

    Returns (nodes (n,16) np, leaf_segments, depth, root_lo, root_hi).
    """
    T = tri.shape[0]
    leaf_target = min(leaf_target, LEAF_W)

    bmin = tri.min(axis=1)
    bmax = tri.max(axis=1)
    centroid = (bmin + bmax) * 0.5
    order = np.arange(T, dtype=np.int64)

    max_nodes = max(4 * (T // max(leaf_target // 4, 1) + 2), 8)
    nodes = np.zeros((max_nodes, NODE_F), np.float32)
    nodes[:, 12:14] = ABSENT
    n_nodes = 1
    leaf_segments: list[np.ndarray] = []

    def seg_bounds(seg):
        return bmin[seg].min(axis=0), bmax[seg].max(axis=0)

    def make_leaf(parent, side, s, e):
        g = len(leaf_segments)
        seg = order[s:e].copy()
        leaf_segments.append(seg)
        log2c = max(int(np.ceil(np.log2(max(len(seg), 1)))), 0)
        nodes[parent, 12 + side] = _tri_code(g, log2c)

    def choose_split(s, e):
        """Best binned-SAH split of order[s:e]; returns mid or None."""
        seg = order[s:e]
        c = centroid[seg]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        if not np.any(ext > 1e-12):
            return s + (e - s) // 2 if (e - s) > LEAF_W else None
        scale = np.where(ext > 1e-12, BINS * 0.9999 / np.where(ext > 0, ext, 1.0), 0.0)
        bin_id = np.clip(((c - cmin) * scale).astype(np.int32), 0, BINS - 1)
        best = (np.inf, -1, -1)
        for ax in range(3):
            if ext[ax] <= 1e-12:
                continue
            ids = bin_id[:, ax]
            counts = np.bincount(ids, minlength=BINS)
            bb_min = np.full((BINS, 3), np.inf, np.float32)
            bb_max = np.full((BINS, 3), -np.inf, np.float32)
            np.minimum.at(bb_min, ids, bmin[seg])
            np.maximum.at(bb_max, ids, bmax[seg])
            lmin = np.minimum.accumulate(bb_min, axis=0)
            lmax = np.maximum.accumulate(bb_max, axis=0)
            rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]
            la = _surface_area(lmin[:-1], lmax[:-1])
            ra = _surface_area(rmin[1:], rmax[1:])
            cost = la * lcnt[:-1] + ra * rcnt[1:]
            cost = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, cost)
            b = int(np.argmin(cost))
            if cost[b] < best[0]:
                best = (float(cost[b]), ax, b)
        if best[1] < 0:
            return s + (e - s) // 2 if (e - s) > LEAF_W else None
        ax, b = best[1], best[2]
        go_left = bin_id[:, ax] <= b
        left = seg[go_left]
        right = seg[~go_left]
        if len(left) == 0 or len(right) == 0:
            return s + (e - s) // 2
        order[s:s + len(left)] = left
        order[s + len(left):e] = right
        return s + len(left)

    def alloc():
        nonlocal n_nodes
        i = n_nodes
        n_nodes += 1
        return i

    depth_max = 1
    # stack entries: (start, end, parent, side, depth)
    stack = [(0, T, -1, -1, 1)]
    while stack:
        s, e, parent, side, dep = stack.pop()
        depth_max = max(depth_max, dep)
        if (e - s) <= leaf_target:
            if parent < 0:
                # single-leaf scene: synthesize an internal root
                lo, hi = seg_bounds(order[s:e])
                nodes[0, 0:3] = lo
                nodes[0, 3:6] = hi
                make_leaf(0, 0, s, e)
            else:
                make_leaf(parent, side, s, e)
            continue
        mid = choose_split(s, e)
        if mid is None or mid <= s or mid >= e:
            if parent < 0:
                lo, hi = seg_bounds(order[s:e])
                nodes[0, 0:3] = lo
                nodes[0, 3:6] = hi
                make_leaf(0, 0, s, e)
            else:
                make_leaf(parent, side, s, e)
            continue
        node = 0 if parent < 0 else alloc()
        if parent >= 0:
            nodes[parent, 12 + side] = float(node)
        lmin_, lmax_ = seg_bounds(order[s:mid])
        rmin_, rmax_ = seg_bounds(order[mid:e])
        nodes[node, 0:3] = lmin_
        nodes[node, 3:6] = lmax_
        nodes[node, 6:9] = rmin_
        nodes[node, 9:12] = rmax_
        stack.append((s, mid, node, 0, dep + 1))
        stack.append((mid, e, node, 1, dep + 1))

    # choose_split force-splits any segment over LEAF_W (median fallback on
    # degenerate distributions), so every leaf fits one group
    assert all(len(s) <= LEAF_W for s in leaf_segments)
    if int(np.rint(nodes[0, 13])) == ABSENT:      # single-leaf root
        root_lo, root_hi = nodes[0, 0:3].copy(), nodes[0, 3:6].copy()
    else:
        root_lo = np.minimum(nodes[0, 0:3], nodes[0, 6:9])
        root_hi = np.maximum(nodes[0, 3:6], nodes[0, 9:12])
    return nodes[:n_nodes], leaf_segments, depth_max, root_lo, root_hi


def _build_core_hq(tri: np.ndarray, leaf_target: int):
    """SBVH build of the dense-leaf tree via the native spatial-split
    builder (csrc/sbvh_builder.cpp, BuildHQ analogue) — same return
    contract as _build_core. Returns None when the native toolchain is
    unavailable (callers fall back to the binned-SAH numpy core)."""
    from physically_based_ray_tracer_tpu.bvh import native

    out = native.build_sbvh_generic(tri, min(leaf_target, LEAF_W),
                                    dense_mode=True)
    if out is None:
        return None
    nodes_box, children, segments = out
    N = nodes_box.shape[0]
    INT32_MIN = np.iinfo(np.int32).min

    nodes = np.zeros((N, NODE_F), np.float32)
    nodes[:, 0:12] = nodes_box
    for n in range(N):
        for side in range(2):
            c = int(children[n, side])
            if c >= 0:
                nodes[n, 12 + side] = float(c)
            elif c == INT32_MIN:
                nodes[n, 12 + side] = ABSENT
            else:
                s = -(c + 1)
                log2c = max(int(np.ceil(np.log2(max(len(segments[s]), 1)))), 0)
                nodes[n, 12 + side] = _tri_code(s, log2c)

    # depth + root bounds by walking the tree
    depth = 1
    stack = [(0, 1)]
    while stack:
        n, d = stack.pop()
        depth = max(depth, d)
        for side in range(2):
            c = int(children[n, side])
            if c >= 0:
                stack.append((c, d + 1))
    if int(children[0, 1]) == INT32_MIN:   # single-leaf root
        root_lo, root_hi = nodes[0, 0:3].copy(), nodes[0, 3:6].copy()
    else:
        root_lo = np.minimum(nodes[0, 0:3], nodes[0, 6:9])
        root_hi = np.maximum(nodes[0, 3:6], nodes[0, 9:12])
    return nodes, segments, depth, root_lo, root_hi


def _pack_groups(tri: np.ndarray, segments: list[np.ndarray]) -> np.ndarray:
    """Component-major leaf groups with cyclic power-of-two replication."""
    v0 = tri[:, 0]
    G = max(len(segments), 1)
    groups = np.zeros((G * GROUP_ROWS, LEAF_W), np.float32)
    groups[9::GROUP_ROWS, :] = -1.0   # prim row default: padding
    for g, seg in enumerate(segments):
        k = len(seg)
        r = g * GROUP_ROWS
        c = 1 << max(int(np.ceil(np.log2(max(k, 1)))), 0)
        # cyclic replication with period c (c | 128): slot j = tri j mod c,
        # padding slots within the c-block are degenerate zero triangles
        data = np.zeros((10, c), np.float32)
        data[9, :] = -1.0
        p0 = v0[seg]
        data[0:3, :k] = p0.T
        data[3:6, :k] = (tri[seg, 1] - p0).T
        data[6:9, :k] = (tri[seg, 2] - p0).T
        data[9, :k] = seg.astype(np.float32)
        groups[r:r + 10, :] = np.tile(data, (1, LEAF_W // c))
    return groups


# single-level stub: shorter than one INST_F row, so traversal sees no
# instances
_NO_INST = np.zeros((1,), np.float32)


def _build_core_any(tri: np.ndarray, leaf_target: int, hq: bool):
    if hq:
        out = _build_core_hq(tri, leaf_target)
        if out is not None:
            return out
    return _build_core(tri, leaf_target)


def build_dense(triangles: np.ndarray, leaf_target: int = 64,
                hq: bool = False) -> tuple["DenseBVH", int]:
    """Single-level build over one triangle soup (prim ids global).

    hq=True uses the native SBVH core (spatial splits, BuildHQ analogue)
    when the toolchain is available. Returns (DenseBVH, depth).
    """
    tri = np.asarray(triangles, np.float32)
    if tri.ndim == 2:
        tri = tri.reshape(-1, 3, 3)
    nodes, segments, depth, root_lo, root_hi = _build_core_any(
        tri, leaf_target, hq)
    groups = _pack_groups(tri, segments)
    dbvh = DenseBVH(
        nodes16=jnp.asarray(nodes.reshape(-1)),
        groups=jnp.asarray(groups),
        inst16=jnp.asarray(_NO_INST),
        prim_base=jnp.zeros((1,), jnp.int32),
        world_lo=jnp.asarray(root_lo),
        world_hi=jnp.asarray(root_hi),
    )
    return dbvh, depth


# ---------------------------------------------------------------------------
# Two-level (TLAS) build
# ---------------------------------------------------------------------------

def _instance_aabbs(meta_lo, meta_hi, inst_mesh, transforms):
    """World AABB per instance: transform the 8 corners of the BLAS root
    bounds (BLASInstance::Update, Core/tiny_bvh.h:7868-7881)."""
    I = len(inst_mesh)
    lo = np.empty((I, 3), np.float32)
    hi = np.empty((I, 3), np.float32)
    for i, m in enumerate(inst_mesh):
        bl, bh = meta_lo[m], meta_hi[m]
        cs = np.array([[x, y, z] for x in (bl[0], bh[0])
                       for y in (bl[1], bh[1]) for z in (bl[2], bh[2])],
                      np.float32)
        w = cs @ transforms[i][:3, :3].T + transforms[i][:3, 3]
        lo[i] = w.min(axis=0)
        hi[i] = w.max(axis=0)
    return lo, hi


def _build_tlas_nodes(lo: np.ndarray, hi: np.ndarray, cap: int) -> np.ndarray:
    """Sweep-SAH BVH2 over instance AABBs; leaves are instance codes.
    Small input (tens of instances) — full per-axis sorted sweep, the
    quality end of what binned SAH approximates."""
    I = lo.shape[0]
    nodes = np.zeros((cap, NODE_F), np.float32)
    nodes[:, 12:14] = ABSENT
    cent = (lo + hi) * 0.5
    n_nodes = [1]

    def alloc():
        i = n_nodes[0]
        n_nodes[0] += 1
        return i

    def set_child(node, side, idx):
        part_lo = lo[idx].min(axis=0)
        part_hi = hi[idx].max(axis=0)
        nodes[node, 6 * side:6 * side + 3] = part_lo
        nodes[node, 6 * side + 3:6 * side + 6] = part_hi
        if len(idx) == 1:
            nodes[node, 12 + side] = _inst_code(int(idx[0]))
        else:
            c = alloc()
            nodes[node, 12 + side] = float(c)
            split(idx, c)

    def split(idx, node):
        best = None
        for ax in range(3):
            o = idx[np.argsort(cent[idx, ax], kind="stable")]
            lmin = np.minimum.accumulate(lo[o], axis=0)
            lmax = np.maximum.accumulate(hi[o], axis=0)
            rmin = np.minimum.accumulate(lo[o][::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(hi[o][::-1], axis=0)[::-1]
            k = np.arange(1, len(o))
            cost = (_surface_area(lmin[:-1], lmax[:-1]) * k
                    + _surface_area(rmin[1:], rmax[1:]) * (len(o) - k))
            b = int(np.argmin(cost))
            if best is None or cost[b] < best[0]:
                best = (float(cost[b]), o, b + 1)
        _, o, m = best
        set_child(node, 0, o[:m])
        set_child(node, 1, o[m:])

    if I == 1:
        set_child(0, 0, np.array([0]))
    else:
        split(np.arange(I), 0)
    assert n_nodes[0] <= cap
    return nodes


def _inst_rows(inst_mesh, transforms, blas_root):
    I = len(inst_mesh)
    inst16 = np.zeros((I, INST_F), np.float32)
    for i, m in enumerate(inst_mesh):
        inv = np.linalg.inv(np.asarray(transforms[i], np.float64))
        inst16[i, 0:12] = inv[:3, :4].astype(np.float32).reshape(-1)
        inst16[i, 12] = float(blas_root[m])
    return inst16


def build_dense_tlas(mesh_tris: list[np.ndarray], inst_mesh, transforms,
                     leaf_target: int = 64, hq: bool = False,
                     ) -> tuple["DenseBVH", TLASMeta, int]:
    """Two-level build: one shared BLAS per mesh + TLAS over instances.

    mesh_tris: per-mesh (T, 3, 3) object-space triangles (each stored ONCE).
    inst_mesh: (I,) mesh index per instance.
    transforms: (I, 4, 4) world-from-object transforms.

    Group prim ids are mesh-local; prim_base maps (inst, local) -> the
    global per-instance-concatenated prim order used by SceneData.

    Returns (DenseBVH, TLASMeta, depth) where depth = TLAS + max BLAS depth
    (feeds the traversal stack bound; +1 for the restore sentinel).
    """
    inst_mesh = np.asarray(inst_mesh, np.int64)
    transforms = np.asarray(transforms, np.float32)
    I = len(inst_mesh)
    B = len(mesh_tris)
    tlas_cap = max(I - 1, 1)

    blas_nodes, blas_groups, blas_lo, blas_hi = [], [], [], []
    depth_blas = 1
    for tri in mesh_tris:
        tri = np.asarray(tri, np.float32)
        if tri.ndim == 2:
            tri = tri.reshape(-1, 3, 3)
        nodes, segments, dep, rlo, rhi = _build_core_any(tri, leaf_target, hq)
        blas_nodes.append(nodes)
        blas_groups.append(_pack_groups(tri, segments))
        blas_lo.append(rlo)
        blas_hi.append(rhi)
        depth_blas = max(depth_blas, dep)
    blas_lo = np.stack(blas_lo)
    blas_hi = np.stack(blas_hi)

    # merged-table offsets
    node_off = np.empty(B, np.int64)
    group_off = np.empty(B, np.int64)
    n = tlas_cap
    g = 0
    for b in range(B):
        node_off[b] = n
        group_off[b] = g
        n += blas_nodes[b].shape[0]
        g += blas_groups[b].shape[0] // GROUP_ROWS

    merged = []
    for b in range(B):
        nn = blas_nodes[b].copy()
        for k in (12, 13):
            col = np.rint(nn[:, k]).astype(np.int64)
            internal = col >= 0
            out = col.copy()
            out[internal] = col[internal] + node_off[b]
            leaf = (col < 0) & (col != ABSENT)  # BLAS leaves: all tri leaves
            v = -(col[leaf] + 1)
            g8l = v // 2                 # group*8 + log2(period)
            regrouped = (g8l // 8 + group_off[b]) * 8 + g8l % 8
            out[leaf] = -(2 * regrouped + 1)
            nn[:, k] = out.astype(np.float32)
        merged.append(nn)

    inst16 = _inst_rows(inst_mesh, transforms, node_off)
    lo, hi = _instance_aabbs(blas_lo, blas_hi, inst_mesh, transforms)
    tlas = _build_tlas_nodes(lo, hi, tlas_cap)

    all_nodes = np.concatenate([tlas] + merged, axis=0)
    all_groups = np.concatenate(blas_groups, axis=0)

    counts = np.array([mesh_tris[m].reshape(-1, 3, 3).shape[0]
                       if np.asarray(mesh_tris[m]).ndim == 3
                       else np.asarray(mesh_tris[m]).shape[0] // 3
                       for m in inst_mesh], np.int64)
    prim_base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)

    meta = TLASMeta(tlas_cap=tlas_cap, inst_mesh=inst_mesh,
                    blas_root=node_off.copy(), blas_lo=blas_lo,
                    blas_hi=blas_hi)
    dbvh = DenseBVH(
        nodes16=jnp.asarray(all_nodes.reshape(-1)),
        groups=jnp.asarray(all_groups),
        inst16=jnp.asarray(inst16.reshape(-1)),
        prim_base=jnp.asarray(prim_base),
        world_lo=jnp.asarray(lo.min(axis=0)),
        world_hi=jnp.asarray(hi.max(axis=0)),
    )
    # depth: TLAS chain worst case + blas depth + restore sentinel
    depth = tlas_cap.bit_length() + depth_blas + 2
    return dbvh, meta, depth


def refresh_tlas(dbvh: DenseBVH, meta: TLASMeta, transforms) -> DenseBVH:
    """Per-frame TLAS refresh after instance transform changes — rewrites
    only the TLAS head of the node table + the instance rows; BLAS nodes
    and leaf groups stay untouched on device (Scene::BuildTLAS analogue,
    Core/Scene.cpp:220-223 + BLASInstance::Update, tiny_bvh.h:7868)."""
    transforms = np.asarray(transforms, np.float32)
    lo, hi = _instance_aabbs(meta.blas_lo, meta.blas_hi, meta.inst_mesh,
                             transforms)
    tlas = _build_tlas_nodes(lo, hi, meta.tlas_cap)
    inst16 = _inst_rows(meta.inst_mesh, transforms, meta.blas_root)
    return dbvh._replace(
        nodes16=dbvh.nodes16.at[:meta.tlas_cap * NODE_F]
                            .set(jnp.asarray(tlas.reshape(-1))),
        inst16=jnp.asarray(inst16.reshape(-1)),
        world_lo=jnp.asarray(lo.min(axis=0)),
        world_hi=jnp.asarray(hi.max(axis=0)),
    )
