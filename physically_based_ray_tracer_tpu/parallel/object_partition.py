"""Tensor-parallel analogue for scenes beyond one device's memory:
instance-partitioned tracing (SURVEY.md §2.5).

The memory that outgrows a chip is the acceleration structure + leaf
geometry (the 1M-triangle benchmark's tables are ~10x its shading
arrays). The TP recipe from the scaling playbook — shard the big
parameter tables, replicate the small activations, insert one collective
— maps cleanly onto a two-level scene:

  * INSTANCES are round-robined across the mesh axis; each device builds
    a dense TLAS+BLAS over ITS subset only (1/D of nodes + leaf groups —
    the per-device memory footprint is the point).
  * RAYS are replicated (they are the "activations": a wavefront chunk
    is a few MB against table gigabytes).
  * Each device traces all rays against its sub-scene, then ONE
    collective round combines per-ray results: closest = min-t with a
    deterministic lowest-shard tie-break (pmin + masked psum), occlusion
    = any (pmax). Per-lane results are pure functions of (ray, sub-
    scene), so the combined record equals a single-device trace of the
    union scene wherever the winner is unique (cross-instance EXACT
    t-ties fall to the lowest shard instead of in-kernel traversal
    order — the same class of arbitrary tie the single-device engines
    already break by schedule).

Reference role: the TLAS over BLASInstances (tiny_bvh.h:1243-1256,
:2500-2565) — here the TLAS itself is partitioned across chips.
Compute overhead vs one chip: each device pays root descents for rays
its subset cannot hit; the union of per-device traversal work is the
single-device work plus D-1 cheap root rejections per ray — the classic
object-decomposition trade, bought for a D-fold table-memory scaling.

Each shard traces with the default dense engine (ops/traverse_dense.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from physically_based_ray_tracer_tpu.bvh.dense import DenseBVH, build_dense_tlas
from physically_based_ray_tracer_tpu.config import BVH_FAR
from physically_based_ray_tracer_tpu.ops.intersect import Hit


class PartitionedScene(NamedTuple):
    """Shard-stacked dense scene: every DenseBVH field carries a leading
    (n_shards,) axis (zero-padded to the largest shard; padded nodes and
    groups are unreachable from each root)."""

    dbvh: DenseBVH            # each field (S, ...)
    inst_gmap: jnp.ndarray    # (S, Imax) i32: local inst -> global inst
    prim_off: jnp.ndarray     # (S, Imax) i32: + local->global prim delta
    n_shards: int
    max_depth: int


def _pad_to(a: np.ndarray, rows: int, fill=0.0) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


def partition_instances(mesh_tris, inst_mesh, transforms, n_shards: int,
                        leaf_target: int = 16) -> PartitionedScene:
    """Round-robin the instances over ``n_shards`` sub-scenes.

    Shards beyond the instance count get one scale-zero dummy instance
    (degenerate triangles: every leaf test rejects on |det|, so they can
    never produce a hit)."""
    inst_mesh = np.asarray(inst_mesh, np.int64)
    transforms = np.asarray(transforms, np.float32)
    I = len(inst_mesh)

    # global per-instance prim offsets (the SceneData convention:
    # instances concatenated in global order)
    counts = np.array([len(mesh_tris[m]) for m in inst_mesh], np.int64)
    g_base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)

    shard_dbs, shard_gmap, shard_poff, depths = [], [], [], []
    for s in range(n_shards):
        sel = np.arange(I)[s::n_shards]
        if len(sel) == 0:
            # dummy shard: one epsilon-scale instance of the smallest
            # mesh — its triangles are degenerate at f32 (areas ~1e-24,
            # under every |det| cutoff) so it can never produce a hit,
            # while the transform stays invertible for the builder
            m_small = int(np.argmin([len(t) for t in mesh_tris]))
            tiny = np.diag([1e-12, 1e-12, 1e-12, 1.0]).astype(np.float32)
            db, _meta, dep = build_dense_tlas(
                [mesh_tris[m_small]], np.array([0], np.int64),
                tiny[None], leaf_target=leaf_target)
            gmap = np.zeros(1, np.int32)
            poff = np.zeros(1, np.int32)
        else:
            # ship ONLY the meshes this shard's instances use — the BLAS
            # leaf groups are where the memory is; a shard of a
            # many-distinct-mesh scene holds ~1/n_shards of the geometry
            used = np.unique(inst_mesh[sel])
            remap = np.full(len(mesh_tris), -1, np.int64)
            remap[used] = np.arange(len(used))
            db, _meta, dep = build_dense_tlas(
                [mesh_tris[m] for m in used], remap[inst_mesh[sel]],
                transforms[sel], leaf_target=leaf_target)
            l_base = np.asarray(db.prim_base, np.int64)
            gmap = sel.astype(np.int32)
            poff = (g_base[sel] - l_base[: len(sel)]).astype(np.int32)
        shard_dbs.append(db)
        shard_gmap.append(gmap)
        shard_poff.append(poff)
        depths.append(dep)

    rows = {f: max(np.asarray(getattr(db, f)).shape[0] for db in shard_dbs)
            for f in ("nodes16", "groups", "inst16", "prim_base")}
    imax = max(g.shape[0] for g in shard_gmap)

    def stack(f, fill=0.0):
        return jnp.asarray(np.stack(
            [_pad_to(np.asarray(getattr(db, f)), rows.get(f,
             np.asarray(getattr(db, f)).shape[0]), fill)
             for db in shard_dbs]))

    dbvh = DenseBVH(
        nodes16=stack("nodes16"), groups=stack("groups"),
        inst16=stack("inst16"), prim_base=stack("prim_base"),
        world_lo=stack("world_lo"), world_hi=stack("world_hi"))
    gmap = jnp.asarray(np.stack([_pad_to(g, imax) for g in shard_gmap]))
    poff = jnp.asarray(np.stack([_pad_to(p, imax) for p in shard_poff]))
    return PartitionedScene(dbvh=dbvh, inst_gmap=gmap, prim_off=poff,
                            n_shards=n_shards, max_depth=max(depths))


def _local_to_global(ps_gmap, ps_poff, hit: Hit) -> Hit:
    li = jnp.maximum(hit.inst, 0)
    found = hit.prim >= 0
    gi = jnp.take(ps_gmap, li, mode="clip")
    gp = hit.prim + jnp.take(ps_poff, li, mode="clip")
    return hit._replace(prim=jnp.where(found, gp, -1),
                        inst=jnp.where(found, gi, -1))


def _combine_closest(hit: Hit, axis: str, n_shards: int) -> Hit:
    """min-t across the shard axis; exact ties to the lowest shard."""
    found = hit.prim >= 0
    t = jnp.where(found, hit.t, BVH_FAR)
    tmin = jax.lax.pmin(t, axis)
    found_any = tmin < BVH_FAR * 0.5
    win = found & (t <= tmin)
    idx = jax.lax.axis_index(axis)
    rank = jnp.where(win, idx, n_shards)
    keep = win & (idx == jax.lax.pmin(rank, axis))

    def sel(x):
        return jax.lax.psum(jnp.where(keep, x, jnp.zeros_like(x)), axis)

    return Hit(t=jnp.where(found_any, tmin, BVH_FAR),
               u=sel(hit.u), v=sel(hit.v),
               prim=jnp.where(found_any, sel(hit.prim * keep), -1),
               inst=jnp.where(found_any, sel(hit.inst * keep), -1))


def partitioned_closest(ps: PartitionedScene, mesh: Mesh, o, d, t_max=None,
                        axis: str = "obj", sort: bool = True) -> Hit:
    """Closest hit of replicated rays against the shard-partitioned scene;
    the returned record uses GLOBAL prim/inst ids (replicated output)."""
    from jax import shard_map

    from physically_based_ray_tracer_tpu.ops.traverse_dense import (
        intersect_closest_dense, sorted_closest_dense)
    if t_max is None:
        t_max = jnp.full((o.shape[0],), BVH_FAR, o.dtype)
    fn = sorted_closest_dense if sort else intersect_closest_dense
    n = ps.n_shards

    def local(db, gmap, poff, o, d, tm):
        db = jax.tree.map(lambda x: x[0], db)
        hit = fn(db, o, d, tm)
        hit = _local_to_global(gmap[0], poff[0], hit)
        return _combine_closest(hit, axis, n)

    spec_s = jax.tree.map(lambda _: P(axis), ps.dbvh)
    return shard_map(
        local, mesh=mesh,
        in_specs=(spec_s, P(axis), P(axis), P(), P(), P()),
        out_specs=P(), check_vma=False,
    )(ps.dbvh, ps.inst_gmap, ps.prim_off, o, d, t_max)


def partitioned_any(ps: PartitionedScene, mesh: Mesh, o, d, t_max,
                    axis: str = "obj", sort: bool = True) -> jnp.ndarray:
    """Occlusion of replicated rays: any shard's occluder blocks."""
    from jax import shard_map

    from physically_based_ray_tracer_tpu.ops.traverse_dense import (
        intersect_any_dense, sorted_any_dense)
    fn = sorted_any_dense if sort else intersect_any_dense

    def local(db, o, d, tm):
        db = jax.tree.map(lambda x: x[0], db)
        occ = fn(db, o, d, tm)
        return jax.lax.pmax(occ.astype(jnp.int32), axis)

    spec_s = jax.tree.map(lambda _: P(axis), ps.dbvh)
    return shard_map(
        local, mesh=mesh, in_specs=(spec_s, P(), P(), P()),
        out_specs=P(), check_vma=False,
    )(ps.dbvh, o, d, t_max) > 0
