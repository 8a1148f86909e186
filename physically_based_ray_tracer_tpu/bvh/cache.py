"""Versioned BVH save/load cache (BVH::Save/Load analogue,
tiny_bvh.h:1393-1445).

With SBVH builds (bvh/csrc/sbvh_builder.cpp) host build time is no longer
negligible for big meshes, so built trees can be persisted next to the
asset. The format is a .npz with a version header and a content hash of the
source triangles — a stale or layout-incompatible cache silently rebuilds
(the same contract as tinybvh's version-checked Load, :1397-1426).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from physically_based_ray_tracer_tpu.bvh.dense import DenseBVH
from physically_based_ray_tracer_tpu.bvh.types import BVHArrays

FORMAT_VERSION = 4   # v4: f32 dense tables only; older caches silently
#      rebuild


def _norm(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; normalise so save and
    load always agree on the on-disk name (an extensionless
    cache_path otherwise always missed on load and silently rebuilt)."""
    return path if path.endswith(".npz") else path + ".npz"


def _tri_hash(triangles: np.ndarray, extra: str = "") -> str:
    tri = np.ascontiguousarray(np.asarray(triangles, np.float32))
    h = hashlib.sha256()
    h.update(tri.tobytes())
    h.update(extra.encode())
    return h.hexdigest()[:32]


def save_bvh(path: str, bvh: BVHArrays, triangles=None, params: str = ""):
    """Persist a classic 2-wide BVH. ``triangles``/``params`` bind the cache
    to its source geometry + build options."""
    np.savez_compressed(
        _norm(path),
        version=np.int64(FORMAT_VERSION), layout="bvh2",
        content=_tri_hash(triangles, params) if triangles is not None else "",
        nodes_box=np.asarray(bvh.nodes_box),
        nodes_child=np.asarray(bvh.nodes_child),
        tris=np.asarray(bvh.tris),
        prim_index=np.asarray(bvh.prim_index))


def load_bvh(path: str, triangles=None, params: str = "") -> BVHArrays | None:
    """Load a cached BVH; None when missing, version-mismatched, or built
    from different geometry/options (callers then rebuild)."""
    path = _norm(path)
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path, allow_pickle=False)
        if int(z["version"]) != FORMAT_VERSION or str(z["layout"]) != "bvh2":
            return None
        if triangles is not None and str(z["content"]) != _tri_hash(triangles, params):
            return None
        return BVHArrays.from_numpy(z["nodes_box"], z["nodes_child"],
                                    z["tris"], z["prim_index"])
    except (OSError, KeyError, ValueError):
        return None


def save_dense(path: str, dbvh: DenseBVH, triangles=None, params: str = ""):
    """Persist a dense-leaf BVH table."""
    np.savez_compressed(
        _norm(path),
        version=np.int64(FORMAT_VERSION), layout="dense",
        content=_tri_hash(triangles, params) if triangles is not None else "",
        nodes16=np.asarray(dbvh.nodes16), groups=np.asarray(dbvh.groups),
        inst16=np.asarray(dbvh.inst16), prim_base=np.asarray(dbvh.prim_base),
        world_lo=np.asarray(dbvh.world_lo), world_hi=np.asarray(dbvh.world_hi))


def load_dense(path: str, triangles=None, params: str = "") -> DenseBVH | None:
    path = _norm(path)
    if not os.path.exists(path):
        return None
    try:
        import jax.numpy as jnp
        z = np.load(path, allow_pickle=False)
        if int(z["version"]) != FORMAT_VERSION or str(z["layout"]) != "dense":
            return None
        if triangles is not None and str(z["content"]) != _tri_hash(triangles, params):
            return None
        return DenseBVH(*(jnp.asarray(z[k]) for k in
                          ("nodes16", "groups", "inst16", "prim_base",
                           "world_lo", "world_hi")))
    except (OSError, KeyError, ValueError):
        return None


def cached_build_bvh(cache_path: str, triangles, builder, params: str = ""):
    """Load-or-build-and-save. ``builder(triangles) -> BVHArrays``."""
    hit = load_bvh(cache_path, triangles, params)
    if hit is not None:
        return hit, True
    bvh = builder(triangles)
    save_bvh(cache_path, bvh, triangles, params)
    return bvh, False
