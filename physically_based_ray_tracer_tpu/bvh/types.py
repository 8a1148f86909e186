"""Device-side BVH array layout.

Re-design of tinybvh's node layouts (Core/tiny_bvh.h:701-1238).
Instead of the reference's 8-wide AVX2 nodes we use an Aila/Laine-style
2-wide layout where each internal node stores BOTH children's AABBs — one
row gather per traversal step instead of two (the layout tinybvh calls
``BVH_GPU``, Core/tiny_bvh.h:869-904, rebuilt here as SoA jnp arrays).

Child/leaf encoding in ``nodes_child[n, 0..1]`` (int32):
    c >= 0  -> internal node index
    c <  0  -> leaf: m = -(c+1); first = m >> 4; count = m & 15
A count of 0 encodes an empty slot (used to pad a root-leaf BVH).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# 7 bits of leaf count: packet traversal wants fat leaves (16-64 tris) so
# each leaf visit is one productive dense (tile x leaf) intersection batch
LEAF_COUNT_BITS = 7
LEAF_COUNT_MASK = (1 << LEAF_COUNT_BITS) - 1


def encode_leaf(first: int, count: int) -> int:
    assert 0 <= count <= LEAF_COUNT_MASK
    return -((first << LEAF_COUNT_BITS | count) + 1)


def decode_leaf(c):
    m = -(c + 1)
    return m >> LEAF_COUNT_BITS, m & LEAF_COUNT_MASK


class BVHArrays(NamedTuple):
    """Flattened BVH + reordered fat-triangle arrays (device-resident).

    Triangle data is stored leaf-contiguous in traversal order so that a leaf
    visit is one contiguous (K, 9) gather. ``prim_index`` maps a reordered
    slot back to the original triangle id for shading-attribute lookups.
    """

    nodes_box: jnp.ndarray    # (N, 12) f32: c0min, c0max, c1min, c1max
    nodes_child: jnp.ndarray  # (N, 2) i32: child codes (see module docstring)
    tris: jnp.ndarray         # (P, 9) f32: v0, e1, e2 (padded rows are degenerate)
    prim_index: jnp.ndarray   # (P,) i32: original prim id (-1 for padding)
    # Woop unit-triangle transform per slot, laid out axis-major for a matmul
    # leaf test (ops/traverse_packet.woop_dense): row j is
    # [M[0,:], c[0], M[1,:], c[1], M[2,:], c[2]] with M = inv([e1 e2 n]),
    # c = -M v0 — so that o' = M o + c, d' = M d put the triangle at the
    # unit right triangle in z=0 and t/u/v fall out of 2 fused matmuls.
    tris_woop: jnp.ndarray    # (P, 12) f32 (zero rows reject: d'_z == 0)

    @property
    def n_nodes(self):
        return self.nodes_box.shape[0]

    @property
    def n_prims(self):
        return self.tris.shape[0]

    def to_device(self) -> "BVHArrays":
        return BVHArrays(*(jnp.asarray(a) for a in self))

    @staticmethod
    def from_numpy(nodes_box, nodes_child, tris, prim_index) -> "BVHArrays":
        return BVHArrays(
            np.ascontiguousarray(nodes_box, np.float32),
            np.ascontiguousarray(nodes_child, np.int32),
            np.ascontiguousarray(tris, np.float32),
            np.ascontiguousarray(prim_index, np.int32),
            woop_from_tris(tris),
        )


def woop_from_tris(tris: np.ndarray) -> np.ndarray:
    """Per-slot Woop transform (P, 12) from packed (v0, e1, e2) rows.

    M = inv([e1 e2 n]) with n = e1 x e2; c = -M v0. A point p = v0 + u e1 +
    v e2 maps to (u, v, 0), and the ray parameter t is preserved, so the
    leaf test reduces to t = -o'_z / d'_z, u = o'_x + t d'_x, v = o'_y +
    t d'_y (Woop et al. 2013 unit-triangle intersection). Degenerate /
    padded rows get M = 0, which yields d'_z = 0 and auto-rejects.
    """
    tris = np.asarray(tris, np.float64)
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=-1)               # columns [e1 e2 n]
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-18
    A_safe = np.where(ok[:, None, None], A, np.eye(3)[None])
    M = np.where(ok[:, None, None], np.linalg.inv(A_safe), 0.0)
    c = -np.einsum("pij,pj->pi", M, v0)
    out = np.concatenate([M[:, 0, :], c[:, 0:1],
                          M[:, 1, :], c[:, 1:2],
                          M[:, 2, :], c[:, 2:3]], axis=1)
    return np.ascontiguousarray(out, np.float32)


def sah_cost(nodes_box: np.ndarray, nodes_child: np.ndarray,
             c_trav: float = 1.0, c_int: float = 1.0) -> float:
    """Diagnostic SAH cost (the analogue of BVH::SAHCost, tiny_bvh.h:1532)."""
    def area(box):
        e = np.maximum(box[3:6] - box[0:3], 0.0)
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    root = np.asarray(nodes_box[0])
    root_min = np.minimum(root[0:3], root[6:9])
    root_max = np.maximum(root[3:6], root[9:12])
    root_area = area(np.concatenate([root_min, root_max]))
    if root_area <= 0:
        return 0.0
    cost = 0.0
    for n in range(nodes_box.shape[0]):
        for side in range(2):
            c = int(nodes_child[n, side])
            box = nodes_box[n, side * 6:(side + 1) * 6]
            a = area(box)
            if c >= 0:
                cost += c_trav * a
            else:
                _, count = decode_leaf(c)
                cost += c_int * a * count
    return cost / root_area
