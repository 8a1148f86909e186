"""The full microfacet BRDF stack, batched over arbitrary leading dims.

Math parity target: Core/BRDF.cpp / Core/BRDF.h (a port of boksa's "Crash
Course in BRDF Implementation"). Every formula is reproduced including the
reference's deliberate quirks:

* ``MIN_DIELECTRICS_F0 = 0.4`` — not the physically common 0.04
  (Core/BRDF.h:65), and ``shadowedF90`` divides by it (Core/BRDF.cpp:100-104).
* ``prepareBRDFData`` computes an sRGB->linear conversion of baseColor and
  then never uses it (Core/BRDF.cpp:422-426) — F0/diffuse use the raw
  baseColor (which the Scene already linearised at texture-fetch time).
* The default configuration is GGX NDF + height-correlated Lagarde G2
  pre-divided by the specular denominator + Schlick Fresnel + Lambert diffuse
  + Heitz VNDF sampling (Core/BRDF.h:42-160 macro matrix).

Everything is expressed on SoA batches: a million shading points evaluate as
a handful of fused element-wise ops instead of the reference's per-ray
scalar recursion.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from physically_based_ray_tracer_tpu.config import (MIN_DIELECTRICS_F0, BRDFConfig,
                                                    DiffuseModel, NDF, SpecularModel)
from physically_based_ray_tracer_tpu.ops import sampling
from physically_based_ray_tracer_tpu.utils.math import dot, lerp, normalize, saturate

PI = sampling.PI
ONE_OVER_PI = sampling.ONE_OVER_PI

DIFFUSE_TYPE = 1
SPECULAR_TYPE = 2


class MaterialProperties(NamedTuple):
    """SoA mirror of MaterialProperties (Core/BRDF.h:165-176)."""

    base_color: jnp.ndarray      # (..., 3)
    metalness: jnp.ndarray       # (...)
    emissive: jnp.ndarray        # (..., 3)
    roughness: jnp.ndarray       # (...)
    transmissivness: jnp.ndarray  # (...)
    reflectance: jnp.ndarray     # (...)
    opacity: jnp.ndarray         # (...)

    @staticmethod
    def make(base_color, metalness=0.0, emissive=(0.0, 0.0, 0.0), roughness=0.5,
             transmissivness=0.0, reflectance=0.5, opacity=1.0, batch=()):  # noqa: D102
        f = lambda v, d: jnp.broadcast_to(jnp.asarray(v, jnp.float32), batch + d)
        return MaterialProperties(
            f(base_color, (3,)), f(metalness, ()), f(emissive, (3,)), f(roughness, ()),
            f(transmissivness, ()), f(reflectance, ()), f(opacity, ()))


class BrdfData(NamedTuple):
    """Precomputed shading terms; mirror of BrdfData (Core/BRDF.h:178-208)."""

    specular_f0: jnp.ndarray
    diffuse_reflectance: jnp.ndarray
    roughness: jnp.ndarray
    alpha: jnp.ndarray
    alpha_squared: jnp.ndarray
    f: jnp.ndarray
    v: jnp.ndarray
    n: jnp.ndarray
    h: jnp.ndarray
    l: jnp.ndarray
    ndotl: jnp.ndarray
    ndotv: jnp.ndarray
    ldoth: jnp.ndarray
    ndoth: jnp.ndarray
    vdoth: jnp.ndarray
    v_backfacing: jnp.ndarray
    l_backfacing: jnp.ndarray


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luminance (Core/BRDF.cpp:16-19)."""
    return dot(rgb, jnp.asarray([0.2126, 0.7152, 0.0722], dtype=rgb.dtype))


def base_color_to_specular_f0(base_color, metalness, reflectance=0.5,
                              cfg: BRDFConfig = BRDFConfig()):
    """lerp(minF0, baseColor, metalness); Core/BRDF.cpp:21-30."""
    if cfg.use_reflectance_parameter:
        min_f0 = 0.16 * reflectance * reflectance
        min_f0 = jnp.broadcast_to(min_f0[..., None], base_color.shape)
    else:
        min_f0 = jnp.full_like(base_color, MIN_DIELECTRICS_F0)
    return lerp(min_f0, base_color, metalness[..., None])


def base_color_to_diffuse_reflectance(base_color, metalness):
    """baseColor * (1 - metalness); Core/BRDF.cpp:32-35."""
    return base_color * (1.0 - metalness[..., None])


def eval_fresnel_schlick(f0, f90, ndots):
    """Schlick approximation; Core/BRDF.cpp:84-87. f90 scalar-ish, ndots (...)."""
    p = jnp.power(jnp.maximum(1.0 - ndots, 0.0), 5.0)
    return f0 + (jnp.expand_dims(f90, -1) - f0) * p[..., None]


def shadowed_f90(f0):
    """Schuler's shadowed F90 trick: min(1, lum(F0)/MIN_F0); Core/BRDF.cpp:100-104."""
    return jnp.minimum(1.0, (1.0 / MIN_DIELECTRICS_F0) * luminance(f0))


# ---------------------------------------------------------------------------
# Smith masking/shadowing
# ---------------------------------------------------------------------------

def smith_g_a(alpha, ndots):
    """a = NdotS / (alpha * sqrt(1 - NdotS^2)); Core/BRDF.cpp:117-120."""
    return ndots / (jnp.maximum(0.00001, alpha)
                    * jnp.sqrt(1.0 - jnp.minimum(0.99999, ndots * ndots)))


def smith_g_lambda_ggx(a):
    """Core/BRDF.cpp:122-125."""
    return (-1.0 + jnp.sqrt(1.0 + 1.0 / (a * a))) * 0.5


def smith_g_lambda_beckmann_walter(a):
    """Walter's rational fit; Core/BRDF.cpp:127-136."""
    return jnp.where(
        a < 1.6,
        (1.0 - (1.259 - 0.396 * a) * a) / ((3.535 + 2.181 * a) * a),
        0.0)


def smith_g1_ggx(alpha_squared, ndots_squared):
    """Optimized GGX G1; Core/BRDF.cpp:149-154."""
    return 2.0 / (jnp.sqrt(((alpha_squared * (1.0 - ndots_squared)) + ndots_squared)
                           / jnp.maximum(ndots_squared, 1e-30)) + 1.0)


def smith_g2_height_correlated(alpha, ndotl, ndotv, ndf: NDF = NDF.GGX):
    """Non-optimized height-correlated G2; Core/BRDF.cpp:156-161."""
    lam = smith_g_lambda_ggx if ndf == NDF.GGX else smith_g_lambda_beckmann_walter
    al = smith_g_a(alpha, ndotl)
    av = smith_g_a(alpha, ndotv)
    return 1.0 / (1.0 + lam(al) + lam(av))


def smith_g2_separable_ggx_lagarde(alpha_squared, ndotl, ndotv):
    """Separable Lagarde G2 / denominator; Core/BRDF.cpp:163-168."""
    a = ndotv + jnp.sqrt(alpha_squared + ndotv * (ndotv - alpha_squared * ndotv))
    b = ndotl + jnp.sqrt(alpha_squared + ndotl * (ndotl - alpha_squared * ndotl))
    return 1.0 / (a * b)


def smith_g2_height_correlated_ggx_lagarde(alpha_squared, ndotl, ndotv):
    """Height-correlated Lagarde G2 / denominator; Core/BRDF.cpp:170-175."""
    a = ndotv * jnp.sqrt(alpha_squared + ndotl * (ndotl - alpha_squared * ndotl))
    b = ndotl * jnp.sqrt(alpha_squared + ndotv * (ndotv - alpha_squared * ndotv))
    return 0.5 / (a + b)


def smith_g2_height_correlated_ggx_hammon(alpha, ndotl, ndotv):
    """Hammon's lerp approximation; Core/BRDF.cpp:177-180."""
    return 0.5 / lerp(2.0 * ndotl * ndotv, ndotl + ndotv, alpha)


def smith_g2_over_g1_height_correlated(alpha, alpha_squared, ndotl, ndotv):
    """G2/G1 for VNDF sample weights; Core/BRDF.cpp:182-187."""
    del alpha
    g1v = smith_g1_ggx(alpha_squared, ndotv * ndotv)
    g1l = smith_g1_ggx(alpha_squared, ndotl * ndotl)
    return g1l / (g1v + g1l - g1v * g1l)


def smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg: BRDFConfig = BRDFConfig()):
    """Dispatch mirroring BRDF::Smith_G2 (Core/BRDF.cpp:189-208).

    With the default config (optimized + GGX) the returned value is
    G2 / (4 NdotL NdotV) — callers must not divide again.
    """
    if cfg.use_optimized_g2 and cfg.ndf == NDF.GGX:
        if cfg.use_height_correlated_g2:
            return smith_g2_height_correlated_ggx_lagarde(alpha_squared, ndotl, ndotv)
        return smith_g2_separable_ggx_lagarde(alpha_squared, ndotl, ndotv)
    if cfg.use_height_correlated_g2:
        return smith_g2_height_correlated(alpha, ndotl, ndotv, cfg.ndf)
    raise NotImplementedError("separable non-optimized G2 (reference lacks it too)")


def g2_divided_by_denominator(cfg: BRDFConfig = BRDFConfig()) -> bool:
    return cfg.use_optimized_g2 and cfg.ndf == NDF.GGX


# ---------------------------------------------------------------------------
# Normal distribution functions
# ---------------------------------------------------------------------------

def ggx_d(alpha_squared, ndoth):
    """Trowbridge-Reitz; Core/BRDF.cpp:218-222."""
    b = (alpha_squared - 1.0) * ndoth * ndoth + 1.0
    return alpha_squared / (PI * b * b)


def beckmann_d(alpha_squared, ndoth):
    """Core/BRDF.cpp:210-216."""
    cos2 = ndoth * ndoth
    return jnp.exp((cos2 - 1.0) / (alpha_squared * cos2)) / (PI * alpha_squared * cos2 * cos2)


def microfacet_d(alpha_squared, ndoth, cfg: BRDFConfig = BRDFConfig()):
    return (ggx_d if cfg.ndf == NDF.GGX else beckmann_d)(alpha_squared, ndoth)


# ---------------------------------------------------------------------------
# Sample PDFs and weights
# ---------------------------------------------------------------------------

def sample_ggx_vndf_reflection_pdf(alpha, alpha_squared, ndoth, ndotv, ldoth):
    """(D * G1) / (4 NdotV); Core/BRDF.cpp:271-277."""
    del alpha, ldoth
    ndoth = jnp.maximum(0.00001, ndoth)
    ndotv = jnp.maximum(0.00001, ndotv)
    return (ggx_d(jnp.maximum(0.00001, alpha_squared), ndoth)
            * smith_g1_ggx(alpha_squared, ndotv * ndotv)) / (4.0 * ndotv)


def sample_walter_reflection_pdf(alpha, alpha_squared, ndoth, ndotv, ldoth,
                                 cfg: BRDFConfig = BRDFConfig()):
    """D * NdotH / (4 LdotH); Core/BRDF.cpp:284-291."""
    del alpha, ndotv
    ndoth = jnp.maximum(0.00001, ndoth)
    ldoth = jnp.maximum(0.00001, ldoth)
    return microfacet_d(jnp.maximum(0.00001, alpha_squared), ndoth, cfg) * ndoth / (4.0 * ldoth)


def specular_sample_weight_ggx_vndf(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth,
                                    cfg: BRDFConfig = BRDFConfig()):
    """Core/BRDF.cpp:326-335."""
    del hdotl, ndoth
    if cfg.use_height_correlated_g2:
        return smith_g2_over_g1_height_correlated(alpha, alpha_squared, ndotl, ndotv)
    return smith_g1_ggx(alpha_squared, ndotl * ndotl)


def specular_sample_weight_ggx_walter(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth,
                                      cfg: BRDFConfig = BRDFConfig()):
    """Core/BRDF.cpp:342-349."""
    if cfg.use_optimized_g2:
        return (ndotl * hdotl * smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg) * 4.0) / ndoth
    return (hdotl * smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg)) / (ndotv * ndoth)


def specular_sample_weight_beckmann_walter(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth,
                                           cfg: BRDFConfig = BRDFConfig()):
    """Core/BRDF.cpp:337-340."""
    return (hdotl * smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg)) / (ndotv * ndoth)


def _sample_half_vector(vlocal, alpha2d, u, cfg: BRDFConfig):
    if cfg.ndf == NDF.BECKMANN:
        return sampling.sample_beckmann_walter(vlocal, alpha2d, u)
    if not cfg.use_vndf_sampling:
        return sampling.sample_ggx_walter(vlocal, alpha2d, u)
    if cfg.use_spherical_caps_vndf:
        return sampling.sample_ggx_vndf_spherical_caps(vlocal, alpha2d, u)
    return sampling.sample_ggx_vndf_heitz(vlocal, alpha2d, u)


def _specular_sample_weight(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg: BRDFConfig):
    if cfg.ndf == NDF.BECKMANN:
        return specular_sample_weight_beckmann_walter(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg)
    if cfg.use_vndf_sampling:
        return specular_sample_weight_ggx_vndf(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg)
    return specular_sample_weight_ggx_walter(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg)


def sample_specular_microfacet(vlocal, alpha, alpha_squared, specular_f0, u,
                               cfg: BRDFConfig = BRDFConfig()):
    """Sample a reflection direction + weight in local space; Core/BRDF.cpp:351-383.

    Returns (l_local, weight). The zero-roughness fast path yields the mirror
    direction deterministically.
    """
    alpha2d = jnp.stack([alpha, alpha], axis=-1)
    h_rough = _sample_half_vector(vlocal, alpha2d, u, cfg)
    h_mirror = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], dtype=vlocal.dtype), h_rough.shape)
    h = jnp.where((alpha == 0.0)[..., None], h_mirror, h_rough)

    # reflect(-V, H) = -(-V) + 2*dot(-V,H)*(-H)... use standard: 2(V.H)H - V
    l = 2.0 * dot(vlocal, h)[..., None] * h - vlocal

    hdotl = jnp.clip(dot(h, l), 0.00001, 1.0)
    ndotl = jnp.clip(l[..., 2], 0.00001, 1.0)
    ndotv = jnp.clip(vlocal[..., 2], 0.00001, 1.0)
    ndoth = jnp.clip(h[..., 2], 0.00001, 1.0)
    f = eval_fresnel_schlick(specular_f0, shadowed_f90(specular_f0), hdotl)
    weight = f * _specular_sample_weight(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg)[..., None]
    return l, weight


# ---------------------------------------------------------------------------
# Diffuse models
# ---------------------------------------------------------------------------

def diffuse_term(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    """Diffuse reflectance scale, pre-divided by the cosine-hemisphere pdf.

    Lambert: 1 (Core/BRDF.cpp:106-110). Oren-Nayar / Disney / Frostbite are
    genuine implementations (the reference declares but never defines them —
    its macro matrix would not compile with those selections).
    """
    if cfg.diffuse == DiffuseModel.NONE:
        return jnp.zeros_like(data.ndotl)
    if cfg.diffuse == DiffuseModel.LAMBERTIAN:
        return jnp.ones_like(data.ndotl)
    if cfg.diffuse == DiffuseModel.OREN_NAYAR:
        sigma2 = data.alpha * data.alpha
        a = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
        b = 0.45 * sigma2 / (sigma2 + 0.09)
        # angles via dots; cos(phi_v - phi_l) term from tangent-plane projections
        sin_v = jnp.sqrt(jnp.maximum(0.0, 1.0 - data.ndotv * data.ndotv))
        sin_l = jnp.sqrt(jnp.maximum(0.0, 1.0 - data.ndotl * data.ndotl))
        tv = normalize(data.v - data.ndotv[..., None] * data.n)
        tl = normalize(data.l - data.ndotl[..., None] * data.n)
        cos_dphi = jnp.maximum(0.0, dot(tv, tl))
        sin_alpha = jnp.maximum(sin_v, sin_l)
        tan_beta = jnp.minimum(sin_v / jnp.maximum(data.ndotv, 1e-4),
                               sin_l / jnp.maximum(data.ndotl, 1e-4))
        return a + b * cos_dphi * sin_alpha * tan_beta
    if cfg.diffuse == DiffuseModel.DISNEY:
        fd90 = 0.5 + 2.0 * data.roughness * data.ldoth * data.ldoth
        fl = jnp.power(1.0 - data.ndotl, 5.0)
        fv = jnp.power(1.0 - data.ndotv, 5.0)
        return (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    if cfg.diffuse == DiffuseModel.FROSTBITE:
        energy_bias = lerp(0.0, 0.5, data.roughness)
        energy_factor = lerp(1.0, 1.0 / 1.51, data.roughness)
        fd90 = energy_bias + 2.0 * data.roughness * data.ldoth * data.ldoth
        fl = jnp.power(1.0 - data.ndotl, 5.0)
        fv = jnp.power(1.0 - data.ndotv, 5.0)
        return (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv) * energy_factor
    raise ValueError(cfg.diffuse)


def eval_diffuse(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    """diffuseReflectance * term * NdotL / pi (Core/BRDF.cpp:112-115 pattern)."""
    return data.diffuse_reflectance * (diffuse_term(data, cfg) * ONE_OVER_PI * data.ndotl)[..., None]


def eval_microfacet(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    """Specular microfacet eval; Core/BRDF.cpp:385-396."""
    d = microfacet_d(jnp.maximum(0.00001, data.alpha_squared), data.ndoth, cfg)
    g2 = smith_g2(data.alpha, data.alpha_squared, data.ndotl, data.ndotv, cfg)
    if g2_divided_by_denominator(cfg):
        return data.f * (g2 * d * data.ndotl)[..., None]
    return data.f * ((g2 * d) / (4.0 * jnp.maximum(data.ndotv, 1e-5)))[..., None]


def eval_phong(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    """Normalized Phong specular (reference selects it via SPECULAR_BRDF==PHONG
    but ships no implementation; provided here for completeness)."""
    shininess = 2.0 / jnp.maximum(data.alpha_squared, 1e-5) - 2.0
    r = 2.0 * data.ndotv[..., None] * data.n - data.v  # reflect V about N
    rdotl = jnp.maximum(0.0, dot(normalize(r), data.l))
    norm = (shininess + 2.0) / (2.0 * PI)
    return data.specular_f0 * (norm * jnp.power(rdotl, shininess) * data.ndotl)[..., None]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def prepare_brdf_data(n, l, v, material: MaterialProperties,
                      cfg: BRDFConfig = BRDFConfig()) -> BrdfData:
    """Precompute shading terms; Core/BRDF.cpp:398-437."""
    h = normalize(l + v)
    ndotl_raw = dot(n, l)
    ndotv_raw = dot(n, v)
    ndotl = jnp.clip(ndotl_raw, 0.00001, 1.0)
    ndotv = jnp.clip(ndotv_raw, 0.00001, 1.0)
    ldoth = saturate(dot(l, h))
    ndoth = saturate(dot(n, h))
    vdoth = saturate(dot(v, h))

    specular_f0 = base_color_to_specular_f0(
        material.base_color, material.metalness, material.reflectance, cfg)
    diffuse_reflectance = base_color_to_diffuse_reflectance(
        material.base_color, material.metalness)
    alpha = material.roughness * material.roughness
    f = eval_fresnel_schlick(specular_f0, shadowed_f90(specular_f0), ldoth)

    return BrdfData(
        specular_f0=specular_f0, diffuse_reflectance=diffuse_reflectance,
        roughness=material.roughness, alpha=alpha, alpha_squared=alpha * alpha,
        f=f, v=v, n=n, h=h, l=l, ndotl=ndotl, ndotv=ndotv,
        ldoth=ldoth, ndoth=ndoth, vdoth=vdoth,
        v_backfacing=(ndotv_raw <= 0.0), l_backfacing=(ndotl_raw <= 0.0))


def eval_combined_brdf(n, l, v, material: MaterialProperties,
                       cfg: BRDFConfig = BRDFConfig()):
    """Direct-light BRDF: (1-F)*diffuse + specular, zero if backfacing;
    Core/BRDF.cpp:439-452."""
    data = prepare_brdf_data(n, l, v, material, cfg)
    if cfg.specular == SpecularModel.MICROFACET:
        specular = eval_microfacet(data, cfg)
    elif cfg.specular == SpecularModel.PHONG:
        specular = eval_phong(data, cfg)
    else:
        specular = jnp.zeros_like(data.f)
    diffuse = eval_diffuse(data, cfg)
    if cfg.combine_brdfs_with_fresnel:
        combined = (1.0 - data.f) * diffuse + specular
    else:
        combined = diffuse + specular
    mask = jnp.logical_or(data.v_backfacing, data.l_backfacing)
    return jnp.where(mask[..., None], 0.0, combined)


def eval_indirect_combined_brdf(u, shading_normal, geometry_normal, v,
                                material: MaterialProperties, brdf_type,
                                cfg: BRDFConfig = BRDFConfig()):
    """Sample the continuation ray; Core/BRDF.cpp:454-502.

    ``brdf_type`` is an integer array (1=diffuse, 2=specular). Returns
    (ray_direction, sample_weight, valid_mask). Both lobes are evaluated and
    selected with ``where``: two fused element-wise pipelines instead of
    divergent control flow.
    """
    del geometry_normal  # reference ignores it too (commented-out guards)
    q_rot = jnp.asarray(  # getRotationToZAxis on shading normal
        _rotation_to_z(shading_normal))
    v_local = _rotate(q_rot, v)

    # --- diffuse lobe: cosine hemisphere + Fresnel-complement tint ----------
    dir_diffuse, _ = sampling.sample_hemisphere_cosine(u)
    data_d = prepare_brdf_data(
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], v.dtype), v_local.shape),
        dir_diffuse, v_local, material, cfg)
    w_diffuse = data_d.diffuse_reflectance * diffuse_term(data_d, cfg)[..., None]
    h_spec = _sample_half_vector(
        v_local, jnp.stack([data_d.alpha, data_d.alpha], axis=-1), u, cfg)
    vdoth = jnp.clip(dot(v_local, h_spec), 0.00001, 1.0)
    w_diffuse = w_diffuse * (1.0 - eval_fresnel_schlick(
        data_d.specular_f0, shadowed_f90(data_d.specular_f0), vdoth))

    # --- specular lobe ------------------------------------------------------
    dir_specular, w_specular = sample_specular_microfacet(
        v_local, data_d.alpha, data_d.alpha_squared, data_d.specular_f0, u, cfg)

    is_spec = (brdf_type == SPECULAR_TYPE)
    ray_local = jnp.where(is_spec[..., None], dir_specular, dir_diffuse)
    weight = jnp.where(is_spec[..., None], w_specular, w_diffuse)

    valid = luminance(weight) != 0.0
    ray_dir = normalize(_rotate(_invert(q_rot), ray_local))
    return ray_dir, weight, valid


def get_brdf_probability(material: MaterialProperties, v, shading_normal):
    """Specular-vs-diffuse lottery probability; Core/BRDF.cpp:504-526."""
    f0 = luminance(base_color_to_specular_f0(material.base_color, material.metalness,
                                             material.reflectance))
    diff_refl = luminance(base_color_to_diffuse_reflectance(material.base_color,
                                                            material.metalness))
    fresnel_factor = jnp.maximum(0.0, dot(v, shading_normal))
    # scalar-F0 Fresnel: evaluate on a 1-channel "rgb"
    f0_rgb = jnp.stack([f0, f0, f0], axis=-1)
    fres = saturate(luminance(eval_fresnel_schlick(f0_rgb, shadowed_f90(f0_rgb),
                                                   fresnel_factor)))
    adjusted = fres * 0.5
    specular = adjusted
    diffuse = diff_refl * (1.0 - adjusted) * 1.5
    p = specular / jnp.maximum(0.0001, specular + diffuse)
    return jnp.clip(p, 0.05, 0.7)


def srgb_to_linear(c):
    """Core/BRDF.cpp:527-534."""
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))


# local aliases to avoid circular import noise
from physically_based_ray_tracer_tpu.utils.math import (  # noqa: E402
    quat_invert as _invert, quat_rotate as _rotate, quat_rotation_to_z as _rotation_to_z)
