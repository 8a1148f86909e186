"""Hit-point shading queries: normals + material fetch.

Counterpart of Scene::GetGeometryNormal / GetShadingNormal /
GetMaterialBRDF (Core/Scene.cpp:47-218). All lookups are batched gathers over
SoA attribute arrays; texture taps are nearest-neighbour uint32 texel fetches
from a flat texel pool, decoded with the reference's channel conventions
(albedo = sRGB->linear RGB, RMA: G = roughness, B = metalness
Core/Scene.cpp:179-180, emission = raw RGB, normal map = 2c/255 - 1).
"""

from __future__ import annotations

import jax.numpy as jnp

from physically_based_ray_tracer_tpu.ops.brdf import MaterialProperties
from physically_based_ray_tracer_tpu.utils.math import normalize, srgb_to_linear

# texture-kind indices in SceneData.tex_record
TEX_ALBEDO = 0
TEX_NORMAL = 1
TEX_RMA = 2
TEX_EMISSION = 3


def _take(arr, idx):
    return jnp.take(arr, idx, axis=0, mode="clip")


def _decode_rgb(texel):
    """uint32 ARGB -> float RGB in [0,1] (Scene::MakeColorFromTexel,
    Core/Scene.cpp:225-229)."""
    s = 1.0 / 255.0
    r = ((texel >> 16) & 0xFF).astype(jnp.float32) * s
    g = ((texel >> 8) & 0xFF).astype(jnp.float32) * s
    b = (texel & 0xFF).astype(jnp.float32) * s
    return jnp.stack([r, g, b], axis=-1)


def _decode_normal(texel):
    """uint32 ARGB -> tangent-space normal in [-1,1] (Core/Scene.cpp:231-235)."""
    s = 2.0 / 255.0
    r = ((texel >> 16) & 0xFF).astype(jnp.float32) * s - 1.0
    g = ((texel >> 8) & 0xFF).astype(jnp.float32) * s - 1.0
    b = (texel & 0xFF).astype(jnp.float32) * s - 1.0
    return jnp.stack([r, g, b], axis=-1)


def fetch_texel(pool, record, uv):
    """Nearest-neighbour tap. record: (..., 3) = (offset, width, height);
    offset < 0 means "no texture". Returns (texel_u32, has_texture_mask).

    Index math mirrors Core/Scene.cpp:163-165: iu = int(u*W) % W.
    """
    offset, w, h = record[..., 0], record[..., 1], record[..., 2]
    has = offset >= 0
    ws = jnp.maximum(w, 1)
    hs = jnp.maximum(h, 1)
    iu = (uv[..., 0] * ws).astype(jnp.int32) % ws
    iv = (uv[..., 1] * hs).astype(jnp.int32) % hs
    idx = jnp.maximum(offset, 0) + iu + iv * ws
    return _take(pool, idx), has


def interpolate_uv(scene, prim, u, v):
    """Barycentric UV: v*uv[c2] + u*uv[c1] + w*uv[c0] (Core/Scene.cpp:156-158)."""
    c0 = prim * 3
    w = 1.0 - u - v
    uv0 = _take(scene.corner_uv, c0)
    uv1 = _take(scene.corner_uv, c0 + 1)
    uv2 = _take(scene.corner_uv, c0 + 2)
    return w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2


def geometry_normal(scene, prim):
    """World-space face normal (Scene::GetGeometryNormal, Core/Scene.cpp:47-58;
    transforms are baked at scene build since the world BVH is pre-transformed)."""
    return _take(scene.face_normal, prim)


def shading_normal(scene, prim, u, v, normal_mapped: bool = True):
    """Interpolated vertex normal, optional TBN normal mapping
    (Scene::GetShadingNormal, Core/Scene.cpp:60-138)."""
    c0 = prim * 3
    w = 1.0 - u - v
    n0 = _take(scene.corner_normal, c0)
    n1 = _take(scene.corner_normal, c0 + 1)
    n2 = _take(scene.corner_normal, c0 + 2)
    n = w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2

    if not normal_mapped:
        return normalize(n)

    model = _take(scene.prim_model, prim)
    rec = _take(scene.tex_record, model)[..., TEX_NORMAL, :]
    uv = interpolate_uv(scene, prim, u, v)
    texel, has = fetch_texel(scene.texel_pool, rec, uv)
    ncol = _decode_normal(texel)

    # tangent frame from world edges + uv deltas (Core/Scene.cpp:93-103)
    e1 = _take(scene.tri_e1, prim)
    e2 = _take(scene.tri_e2, prim)
    uv0 = _take(scene.corner_uv, c0)
    duv1 = _take(scene.corner_uv, c0 + 1) - uv0
    duv2 = _take(scene.corner_uv, c0 + 2) - uv0
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    t = normalize(inv_det[..., None] * (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2))
    b = normalize(inv_det[..., None] * (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2))
    nw = normalize(n)
    mapped = normalize(ncol[..., 0:1] * t + ncol[..., 1:2] * b + ncol[..., 2:3] * nw)
    return jnp.where(has[..., None], mapped, normalize(n))


def material_at_hit(scene, prim, u, v) -> MaterialProperties:
    """Material fetch (Scene::GetMaterialBRDF, Core/Scene.cpp:140-218)."""
    model = _take(scene.prim_model, prim)
    uv = interpolate_uv(scene, prim, u, v)
    recs = _take(scene.tex_record, model)          # (..., 4, 3)

    albedo_texel, has_albedo = fetch_texel(scene.texel_pool, recs[..., TEX_ALBEDO, :], uv)
    base_tex = srgb_to_linear(_decode_rgb(albedo_texel))
    base = jnp.where(has_albedo[..., None], base_tex, _take(scene.mat_base, model))

    rma_texel, has_rma = fetch_texel(scene.texel_pool, recs[..., TEX_RMA, :], uv)
    rma = _decode_rgb(rma_texel)
    rough = jnp.where(has_rma, rma[..., 1], _take(scene.mat_rough, model))
    metal = jnp.where(has_rma, rma[..., 2], _take(scene.mat_metal, model))

    emis_texel, has_emis = fetch_texel(scene.texel_pool, recs[..., TEX_EMISSION, :], uv)
    emissive = jnp.where(has_emis[..., None], _decode_rgb(emis_texel),
                         _take(scene.mat_emissive, model))

    return MaterialProperties(
        base_color=base, metalness=metal, emissive=emissive, roughness=rough,
        transmissivness=_take(scene.mat_transmissive, model),
        reflectance=_take(scene.mat_reflectance, model),
        opacity=_take(scene.mat_opacity, model))


# ---------------------------------------------------------------------------
# Packed-table shading path: the per-bounce shading block would otherwise do
# ~25-30 per-lane row gathers. The packs below concatenate the per-prim attributes ONCE per trace (cheap linear
# copies, CSE'd across bounces) so each bounce pays 2 wide gathers + the
# genuine texture taps instead. Values are bit-identical to the unpacked
# functions above (same rows, same math), which stay for AOV/debug callers.
# ---------------------------------------------------------------------------

def packed_tables(scene):
    """(geom_pack (P,13), shade_pack (P,15), mat_pack (M,11)).

    The per-prim model id rides in the geom pack as an f32 column (exact
    for any realistic model count), so it costs no separate (B,) i32
    take. The texture records ride the mat pack as 12 f32 columns for the
    same reason whenever every offset is f32-exact (< 2^24 — always true for texel
    pools under 64 MTexels; larger pools keep the int gather)."""
    P = scene.tri_v0.shape[0]
    geom = jnp.concatenate([scene.tri_v0, scene.tri_e1, scene.tri_e2,
                            scene.face_normal,
                            scene.prim_model.astype(jnp.float32)[:, None]],
                           axis=1)
    shade = jnp.concatenate([scene.corner_normal.reshape(P, 9),
                             scene.corner_uv.reshape(P, 6)], axis=1)
    mat_cols = [scene.mat_base,
                scene.mat_metal[:, None],
                scene.mat_rough[:, None],
                scene.mat_emissive,
                scene.mat_transmissive[:, None],
                scene.mat_reflectance[:, None],
                scene.mat_opacity[:, None]]
    recs_packed = int(scene.texel_pool.shape[0]) < (1 << 24)
    if recs_packed:
        M = scene.tex_record.shape[0]
        mat_cols.append(scene.tex_record.reshape(M, 12).astype(jnp.float32))
    mat = jnp.concatenate(mat_cols, axis=1)
    # ONE-pack mode: a per-lane row gather costs about the same per ROW
    # whatever its width, so the three takes below (geom by prim, shade
    # by prim, mat by model) cost more than one wider take. Denormalize the small per-model mat table to per-prim
    # and concatenate everything into one (P, 51) pack — ONE row gather
    # per bounce. Gated by prim count: the denormalized pack costs
    # P*51*4 B of device memory (7.8 MB for the 38k-tri bench; skipped for
    # 1M-tri-class scenes where 200 MB is not worth the gather saving).
    if P <= MERGED_PACK_MAX_PRIMS:
        mat_pp = jnp.take(mat, scene.prim_model, axis=0, mode="clip")
        merged = jnp.concatenate([geom, shade, mat_pp], axis=1)
        return merged, None, None, recs_packed
    return geom, shade, mat, recs_packed


MERGED_PACK_MAX_PRIMS = 262144


def gather_hit_attrs(scene, packs, prim):
    """One gather (merged pack) or one per pack for a batch of hit prims;
    returns a dict of the per-hit attribute slices every shading consumer
    needs."""
    geom, shade, mat, recs_packed = packs
    B = prim.shape[0]
    if shade is None:
        gs = jnp.take(geom, prim, axis=0, mode="clip")   # (B, 51)
        g, s, m = gs[:, 0:13], gs[:, 13:28], gs[:, 28:]
    else:
        g = jnp.take(geom, prim, axis=0, mode="clip")    # (B, 13)
        s = jnp.take(shade, prim, axis=0, mode="clip")   # (B, 15)
        model = g[:, 12].astype(jnp.int32)
        m = jnp.take(mat, model, axis=0, mode="clip")    # (B, 11[+12])
    if recs_packed:
        recs = jnp.round(m[:, 11:23]).astype(jnp.int32).reshape(B, 4, 3)
    else:
        model = g[:, 12].astype(jnp.int32)
        recs = _take(scene.tex_record, model)            # (B, 4, 3)
    return dict(v0=g[:, 0:3], e1=g[:, 3:6], e2=g[:, 6:9],
                face_n=g[:, 9:12],
                n0=s[:, 0:3], n1=s[:, 3:6], n2=s[:, 6:9],
                uv0=s[:, 9:11], uv1=s[:, 11:13], uv2=s[:, 13:15],
                mat=m, recs=recs)


def _interp_uv_attr(a, u, v):
    w = 1.0 - u - v
    return (w[..., None] * a["uv0"] + u[..., None] * a["uv1"]
            + v[..., None] * a["uv2"])


def shading_normal_packed(scene, a, u, v, normal_mapped: bool = True):
    """shading_normal from pre-gathered attrs (identical math/values)."""
    w = 1.0 - u - v
    n = (w[..., None] * a["n0"] + u[..., None] * a["n1"]
         + v[..., None] * a["n2"])
    if not normal_mapped:
        return normalize(n)
    rec = a["recs"][..., TEX_NORMAL, :]
    uv = _interp_uv_attr(a, u, v)
    texel, has = fetch_texel(scene.texel_pool, rec, uv)
    ncol = _decode_normal(texel)
    duv1 = a["uv1"] - a["uv0"]
    duv2 = a["uv2"] - a["uv0"]
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    t = normalize(inv_det[..., None]
                  * (duv2[..., 1:2] * a["e1"] - duv1[..., 1:2] * a["e2"]))
    b = normalize(inv_det[..., None]
                  * (-duv2[..., 0:1] * a["e1"] + duv1[..., 0:1] * a["e2"]))
    nw = normalize(n)
    mapped = normalize(ncol[..., 0:1] * t + ncol[..., 1:2] * b
                       + ncol[..., 2:3] * nw)
    return jnp.where(has[..., None], mapped, normalize(n))


def material_packed(scene, a, u, v) -> MaterialProperties:
    """material_at_hit from pre-gathered attrs (identical math/values)."""
    m = a["mat"]
    recs = a["recs"]
    uv = _interp_uv_attr(a, u, v)
    albedo_texel, has_albedo = fetch_texel(scene.texel_pool,
                                           recs[..., TEX_ALBEDO, :], uv)
    base_tex = srgb_to_linear(_decode_rgb(albedo_texel))
    base = jnp.where(has_albedo[..., None], base_tex, m[:, 0:3])
    rma_texel, has_rma = fetch_texel(scene.texel_pool,
                                     recs[..., TEX_RMA, :], uv)
    rma = _decode_rgb(rma_texel)
    rough = jnp.where(has_rma, rma[..., 1], m[:, 4])
    metal = jnp.where(has_rma, rma[..., 2], m[:, 3])
    emis_texel, has_emis = fetch_texel(scene.texel_pool,
                                       recs[..., TEX_EMISSION, :], uv)
    emissive = jnp.where(has_emis[..., None], _decode_rgb(emis_texel),
                         m[:, 5:8])
    return MaterialProperties(
        base_color=base, metalness=metal, emissive=emissive, roughness=rough,
        transmissivness=m[:, 8], reflectance=m[:, 9], opacity=m[:, 10])
