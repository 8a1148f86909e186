"""Scene assembly: models + instances -> device-resident SceneData.

Re-design of the reference's Scene/Model/GameObject stack
(Core/Scene.cpp, Core/Model.cpp, Core/GameObject.cpp). Two build modes:

  * build_scene (static): bakes instance transforms into world space on the
    host and builds ONE flattened BVH — single-level traversal is the
    cheapest when nothing moves.
  * build_scene_instanced (dynamic): shared BLAS per model + TLAS over
    instances in the dense-leaf structure (the reference's
    BLASInstance/TLAS design, Core/tiny_bvh.h:1732-1770) — each mesh's BVH
    is stored ONCE, and rebuild_scene() refreshes only the TLAS head +
    instance table + the small world-space shading arrays when transforms
    change (the analogue of the per-frame Scene::BuildTLAS,
    Core/Scene.cpp:220-223).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from physically_based_ray_tracer_tpu.bvh.builder import build_bvh, bvh_depth
from physically_based_ray_tracer_tpu.bvh.dense import (DEFAULT_LEAF_TARGET,
                                                       DenseBVH, TLASMeta,
                                                       build_dense,
                                                       build_dense_tlas,
                                                       refresh_tlas)
from physically_based_ray_tracer_tpu.bvh.types import BVHArrays
from physically_based_ray_tracer_tpu.scene.lights import LightSet
from physically_based_ray_tracer_tpu.utils.math import (compose_trs,
                                                        inverse_transpose_3x3,
                                                        transform_points,
                                                        transform_vectors)


@dataclass
class MeshModel:
    """Host-side model: fat corner arrays + material + optional textures.

    Mirror of Model (Core/Model.h): ``corners`` is the de-indexed (3T, 3)
    triangle-corner array (Core/Model.cpp:25-48), textures are packed uint32
    ARGB rasters like the reference's Surface pixels.
    """

    corners: np.ndarray                      # (3T, 3) f32
    normals: np.ndarray                      # (3T, 3) f32
    uvs: np.ndarray                          # (3T, 2) f32
    face_normals: np.ndarray                 # (T, 3) f32
    name: str = "model"
    base_color: tuple = (0.8, 0.8, 0.8)
    metalness: float = 0.0
    roughness: float = 0.5
    emissive: tuple = (0.0, 0.0, 0.0)
    transmissivness: float = 0.0
    reflectance: float = 0.5
    opacity: float = 1.0
    albedo_texture: Optional[np.ndarray] = None    # (H, W) uint32 ARGB
    normal_texture: Optional[np.ndarray] = None
    rma_texture: Optional[np.ndarray] = None
    emission_texture: Optional[np.ndarray] = None

    @property
    def n_tris(self) -> int:
        return self.corners.shape[0] // 3

    @staticmethod
    def from_fat(fat, **kw) -> "MeshModel":
        corners, normals, uvs, face_normals = fat
        return MeshModel(corners=corners, normals=normals, uvs=uvs,
                         face_normals=face_normals, **kw)


@dataclass
class Instance:
    """GameObject analogue: model index + TRS (Core/GameObject.cpp:55-69)."""

    model: int
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)   # Euler radians (JSON stores degrees? see serialization)
    scale: tuple = (1.0, 1.0, 1.0)
    name: str = "object"

    @property
    def transform(self) -> np.ndarray:
        return compose_trs(self.position, self.rotation, self.scale)


class SceneData(NamedTuple):
    """Everything the integrator needs, as device arrays (replicated per chip)."""

    bvh: BVHArrays
    dense: DenseBVH            # fat-leaf BVH for the default (dense) engine
    # original-order world-space geometry (for shading + differentiable refine)
    tri_v0: jnp.ndarray        # (P, 3)
    tri_e1: jnp.ndarray        # (P, 3)
    tri_e2: jnp.ndarray        # (P, 3)
    face_normal: jnp.ndarray   # (P, 3) world, normalized
    corner_normal: jnp.ndarray  # (3P, 3) world
    corner_uv: jnp.ndarray     # (3P, 2)
    prim_model: jnp.ndarray    # (P,) i32
    prim_inst: jnp.ndarray     # (P,) i32
    # per-model material table
    mat_base: jnp.ndarray         # (M, 3)
    mat_metal: jnp.ndarray        # (M,)
    mat_rough: jnp.ndarray        # (M,)
    mat_emissive: jnp.ndarray     # (M, 3)
    mat_transmissive: jnp.ndarray  # (M,)
    mat_reflectance: jnp.ndarray  # (M,)
    mat_opacity: jnp.ndarray      # (M,)
    tex_record: jnp.ndarray       # (M, 4, 3) i32: offset(-1=none), width, height
    texel_pool: jnp.ndarray       # (K,) uint32
    lights: LightSet
    sky: jnp.ndarray              # (Hs, Ws, 3) f32; (1,1,3) zeros if absent

    @property
    def n_prims(self):
        return self.tri_v0.shape[0]


def _bake_world(models, instances):
    """World-space shading arrays in per-instance-concatenated prim order
    (Core/GameObject.cpp:55-69 transform composition applied host-side)."""
    all_corners, all_normals, all_uvs, all_face_n = [], [], [], []
    prim_model, prim_inst = [], []
    for inst_id, inst in enumerate(instances):
        mdl = models[inst.model]
        m = inst.transform
        nrm_m = inverse_transpose_3x3(m)
        wc = transform_points(m, mdl.corners)
        wn = mdl.normals @ nrm_m.T
        wn /= np.maximum(np.linalg.norm(wn, axis=1, keepdims=True), 1e-20)
        wf = mdl.face_normals @ nrm_m.T
        wf /= np.maximum(np.linalg.norm(wf, axis=1, keepdims=True), 1e-20)
        all_corners.append(wc.astype(np.float32))
        all_normals.append(wn.astype(np.float32))
        all_uvs.append(mdl.uvs.astype(np.float32))
        all_face_n.append(wf.astype(np.float32))
        prim_model.append(np.full(mdl.n_tris, inst.model, np.int32))
        prim_inst.append(np.full(mdl.n_tris, inst_id, np.int32))
    corners = np.concatenate(all_corners)
    tri = corners.reshape(-1, 3, 3)
    return dict(
        tri=tri,
        face_n=np.concatenate(all_face_n),
        normals=np.concatenate(all_normals),
        uvs=np.concatenate(all_uvs),
        prim_model=np.concatenate(prim_model),
        prim_inst=np.concatenate(prim_inst),
    )


def _texture_pool(models):
    pool_parts: list[np.ndarray] = []
    tex_record = np.full((len(models), 4, 3), -1, np.int32)
    offset = 0
    for mi, mdl in enumerate(models):
        for ki, raster in enumerate([mdl.albedo_texture, mdl.normal_texture,
                                     mdl.rma_texture, mdl.emission_texture]):
            if raster is None:
                continue
            r = np.ascontiguousarray(raster, np.uint32)
            h, w = r.shape
            tex_record[mi, ki] = (offset, w, h)
            pool_parts.append(r.reshape(-1))
            offset += w * h
    texel_pool = (np.concatenate(pool_parts) if pool_parts
                  else np.zeros((1,), np.uint32))
    return tex_record, texel_pool


def _assemble(models, bvh, dense, baked, lights, sky):
    tri = baked["tri"]
    v0 = tri[:, 0]
    tex_record, texel_pool = _texture_pool(models)
    if sky is None:
        sky = np.zeros((1, 1, 3), np.float32)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    return SceneData(
        bvh=bvh,
        dense=dense,
        tri_v0=f32(v0), tri_e1=f32(tri[:, 1] - v0), tri_e2=f32(tri[:, 2] - v0),
        face_normal=f32(baked["face_n"]),
        corner_normal=f32(baked["normals"]),
        corner_uv=f32(baked["uvs"]),
        prim_model=jnp.asarray(baked["prim_model"]),
        prim_inst=jnp.asarray(baked["prim_inst"]),
        mat_base=f32([m.base_color for m in models]),
        mat_metal=f32([m.metalness for m in models]),
        mat_rough=f32([m.roughness for m in models]),
        mat_emissive=f32([m.emissive for m in models]),
        mat_transmissive=f32([m.transmissivness for m in models]),
        mat_reflectance=f32([m.reflectance for m in models]),
        mat_opacity=f32([m.opacity for m in models]),
        tex_record=jnp.asarray(tex_record),
        texel_pool=jnp.asarray(texel_pool),
        lights=(lights if lights is not None else LightSet.make()),
        sky=f32(sky),
    )


def build_scene(models: list[MeshModel], instances: list[Instance],
                lights: LightSet | None = None, sky: np.ndarray | None = None,
                leaf_size: int = 16, dense_leaf_target: int = DEFAULT_LEAF_TARGET,
                ) -> tuple[SceneData, int]:
    """Bake instances to world space, build the flattened BVH, upload.

    Returns (scene_data, bvh_depth) — the depth feeds the static traversal
    stack bound.
    """
    baked = _bake_world(models, instances)
    bvh = build_bvh(baked["tri"], leaf_size=leaf_size)
    depth = bvh_depth(bvh)
    dense, _ = build_dense(baked["tri"], leaf_target=dense_leaf_target)
    data = _assemble(models, bvh.to_device(), dense, baked, lights, sky)
    return data, depth


@dataclass
class InstancedScene:
    """Host-side handle for a two-level scene: what rebuild_scene() needs to
    track instance motion without re-uploading BLAS/group tables."""

    models: list[MeshModel]
    instances: list[Instance]
    tlas_meta: TLASMeta | None      # None = flattened (world-baked) layout
    leaf_size: int
    legacy_bvh: bool
    prim_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    prim_count: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    dense_leaf_target: int = DEFAULT_LEAF_TARGET


def _instance_offsets(models, instances):
    counts = np.array([models[i.model].n_tris for i in instances], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return starts, counts


def _bake_one(mdl: MeshModel, inst: Instance):
    """World-space shading arrays for ONE instance (the unit of incremental
    refresh)."""
    m = inst.transform
    nrm_m = inverse_transpose_3x3(m)
    wc = transform_points(m, mdl.corners).astype(np.float32)
    wn = mdl.normals @ nrm_m.T
    wn /= np.maximum(np.linalg.norm(wn, axis=1, keepdims=True), 1e-20)
    wf = mdl.face_normals @ nrm_m.T
    wf /= np.maximum(np.linalg.norm(wf, axis=1, keepdims=True), 1e-20)
    tri = wc.reshape(-1, 3, 3)
    v0 = tri[:, 0]
    return (v0, tri[:, 1] - v0, tri[:, 2] - v0,
            wf.astype(np.float32), wn.astype(np.float32))


# Scene-adaptive layout policy: a two-level TLAS pays an instance re-entry
# (ray rebase + BLAS root descent) for every overlapping instance a ray
# meets; flattening to ONE world-baked tree removes it but replicates the
# leaf groups and nodes of every instance. flatten="auto" world-bakes a
# scene only under these count caps.
FLATTEN_MAX_INSTANCES = 128
FLATTEN_MAX_TRIS = 1 << 18


def build_scene_instanced(models: list[MeshModel], instances: list[Instance],
                          lights: LightSet | None = None,
                          sky: np.ndarray | None = None,
                          leaf_size: int = 16, dense_leaf_target: int = DEFAULT_LEAF_TARGET,
                          legacy_bvh: bool = True,
                          flatten: bool | str = False,
                          ) -> tuple[SceneData, InstancedScene, int]:
    """Two-level build: shared BLAS per model + TLAS over instances.

    Each model's triangles live ONCE in the dense-leaf structure (the
    BLASInstance design, Core/tiny_bvh.h:1243-1256); only the small
    world-space shading arrays are per-instance. ``legacy_bvh=False`` skips
    the world-baked classic BVH used by the wave/packet/lane engines (pass
    it only when cfg.traversal == "dense"); a 1-triangle placeholder keeps
    the pytree shape.

    ``flatten``: False keeps the two-level structure (the choice for scenes
    that move every frame — rebuild_scene stays O(instances)); "auto" lets
    the engine world-bake small scenes (<= FLATTEN_MAX_INSTANCES instances,
    <= FLATTEN_MAX_TRIS flattened triangles) into ONE single-level tree —
    markedly faster to traverse; rebuild_scene then falls back to a full
    dense rebuild on motion; True forces flattening.

    Returns (scene_data, instanced_handle, depth).
    """
    baked = _bake_world(models, instances)
    do_flatten = (flatten is True) or (
        flatten == "auto" and len(instances) <= FLATTEN_MAX_INSTANCES
        and baked["tri"].shape[0] <= FLATTEN_MAX_TRIS)
    if do_flatten:
        dense, ddepth = build_dense(baked["tri"],
                                    leaf_target=dense_leaf_target)
        meta = None
    else:
        mesh_tris = [m.corners.reshape(-1, 3, 3).astype(np.float32)
                     for m in models]
        inst_mesh = np.array([i.model for i in instances], np.int64)
        transforms = np.stack([i.transform
                               for i in instances]).astype(np.float32)
        dense, meta, ddepth = build_dense_tlas(mesh_tris, inst_mesh,
                                               transforms,
                                               leaf_target=dense_leaf_target)
    if legacy_bvh:
        bvh = build_bvh(baked["tri"], leaf_size=leaf_size)
        depth = max(bvh_depth(bvh), ddepth)
    else:
        bvh = build_bvh(np.zeros((1, 3, 3), np.float32) , leaf_size=leaf_size)
        depth = ddepth
    data = _assemble(models, bvh.to_device(), dense, baked, lights, sky)
    starts, counts = _instance_offsets(models, instances)
    handle = InstancedScene(models=models, instances=list(instances),
                            tlas_meta=meta, leaf_size=leaf_size,
                            legacy_bvh=legacy_bvh,
                            prim_start=starts, prim_count=counts,
                            dense_leaf_target=dense_leaf_target)
    return data, handle, depth


def rebuild_scene(data: SceneData, handle: InstancedScene,
                  instances: list[Instance]) -> SceneData:
    """Refresh after instance transform changes (Scene::BuildTLAS analogue,
    Core/Scene.cpp:220-223): rewrites the TLAS head + instance table on the
    existing dense structure and re-bakes only the MOVED instances' slices
    of the world shading arrays — the per-frame cost is O(instances) for
    the TLAS head + O(moved triangles) for the shading update; BLAS nodes
    and leaf groups are never touched.

    Mesh membership must be unchanged (same models per instance slot).

    Flattened scenes (handle.tlas_meta is None, the small-static layout of
    build_scene_instanced(flatten=...)) have no TLAS to refresh: instance
    motion triggers a full dense rebuild over the updated world triangles —
    the documented trade for the faster single-level traversal."""
    assert len(instances) == len(handle.instances)
    assert all(a.model == b.model for a, b in zip(instances, handle.instances))

    moved = [i for i, (a, b) in enumerate(zip(instances, handle.instances))
             if not np.allclose(a.transform, b.transform)]
    handle.instances = list(instances)
    tri_v0, tri_e1, tri_e2 = data.tri_v0, data.tri_e1, data.tri_e2
    face_n, corner_n = data.face_normal, data.corner_normal
    if moved:
        # one batched scatter per array (not one dispatch per instance):
        # the update cost is O(moved triangles) host bake + 5 device ops
        parts = [_bake_one(handle.models[instances[i].model], instances[i])
                 for i in moved]
        idx = np.concatenate([np.arange(handle.prim_start[i],
                                        handle.prim_start[i] + handle.prim_count[i])
                              for i in moved])
        cidx = jnp.asarray(np.concatenate([3 * idx, 3 * idx + 1, 3 * idx + 2]))
        idx = jnp.asarray(idx)
        cat = [np.concatenate([p[k] for p in parts]) for k in range(5)]
        tri_v0 = tri_v0.at[idx].set(jnp.asarray(cat[0]))
        tri_e1 = tri_e1.at[idx].set(jnp.asarray(cat[1]))
        tri_e2 = tri_e2.at[idx].set(jnp.asarray(cat[2]))
        face_n = face_n.at[idx].set(jnp.asarray(cat[3]))
        wn = np.concatenate([p[4] for p in parts])
        corner_n = corner_n.at[cidx].set(jnp.asarray(
            wn.reshape(-1, 3, 3).swapaxes(0, 1).reshape(-1, 3)))
    if handle.tlas_meta is not None:
        transforms = np.stack([i.transform
                               for i in instances]).astype(np.float32)
        dense = refresh_tlas(data.dense, handle.tlas_meta, transforms)
    elif moved:
        tri = np.stack([np.asarray(tri_v0),
                        np.asarray(tri_v0) + np.asarray(tri_e1),
                        np.asarray(tri_v0) + np.asarray(tri_e2)], axis=1)
        dense, _ = build_dense(tri, leaf_target=handle.dense_leaf_target)
    else:
        dense = data.dense
    if handle.legacy_bvh:
        # wave/packet/lane engines traverse the world-baked BVH: full rebuild
        tri = np.stack([np.asarray(tri_v0),
                        np.asarray(tri_v0) + np.asarray(tri_e1),
                        np.asarray(tri_v0) + np.asarray(tri_e2)], axis=1)
        bvh = build_bvh(tri, leaf_size=handle.leaf_size).to_device()
    else:
        bvh = data.bvh
    return data._replace(
        bvh=bvh, dense=dense,
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
        face_normal=face_n, corner_normal=corner_n,
    )
