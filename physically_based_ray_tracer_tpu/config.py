"""Render configuration.

The reference engine configures itself through three tiers (SURVEY.md §5):
compile-time ``#define``s (``template/common.h``, ``Core/BRDF.h:42-160``),
runtime flags on the Renderer singleton (``Core/Renderer.h:33-49``) and JSON
asset files. Here a single frozen dataclass mirrors those flags 1:1 so every
reference configuration is expressible, while remaining a static (hashable)
argument to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import enum


class RenderMode(enum.IntEnum):
    """AOV selector; mirrors ``RENDER_STATES`` (Core/Renderer.h:37-46)."""

    BRDF = 0
    BASECOLOR = 1
    GEOMETRYNORMAL = 2
    SHADINGNORMAL = 3
    METAL = 4
    ROUGHNESS = 5
    EMMISIVE = 6
    DEPTH = 7        # extra AOV (not in reference): hit distance
    PRIMID = 8       # extra AOV (not in reference): primitive id visualisation


class NDF(enum.IntEnum):
    """Microfacet normal distribution (Core/BRDF.h:8-9)."""

    GGX = 1
    BECKMANN = 2


class DiffuseModel(enum.IntEnum):
    """Diffuse BRDF selector (Core/BRDF.h:16-19)."""

    NONE = 0
    LAMBERTIAN = 1
    OREN_NAYAR = 2
    DISNEY = 3
    FROSTBITE = 4


class SpecularModel(enum.IntEnum):
    """Specular BRDF selector (Core/BRDF.h:12-13)."""

    NONE = 0
    MICROFACET = 1
    PHONG = 2


# Compile-time constants of the reference (template/common.h, Core/BRDF.h:65).
EPSILON = 0.01               # ray-offset epsilon (template/common.h:26)
MIN_DIELECTRICS_F0 = 0.4     # reference quirk: 0.4, not the usual 0.04 (Core/BRDF.h:65)
POINTLIGHTS = 4              # SIMD point-light count (template/common.h:17)
BVH_FAR = 1e30               # "miss" sentinel distance (Core/tiny_bvh.h:131)

# Stochastic NEE light-type selection probabilities (Core/Renderer.cpp:205-207).
P_POINT = 0.3
P_DIRECTIONAL = 0.5
P_SPOT = 0.2


@dataclasses.dataclass(frozen=True)
class BRDFConfig:
    """Static BRDF model selection; mirrors the macro matrix Core/BRDF.h:42-160."""

    ndf: NDF = NDF.GGX
    specular: SpecularModel = SpecularModel.MICROFACET
    diffuse: DiffuseModel = DiffuseModel.LAMBERTIAN
    use_vndf_sampling: bool = True          # !USE_WALTER_GGX_SAMPLING default
    use_spherical_caps_vndf: bool = False   # !USE_VNDF_WITH_SPHERICAL_CAPS default
    use_height_correlated_g2: bool = True   # USE_HEIGHT_CORRELATED_G2 (Core/BRDF.h:80)
    use_optimized_g2: bool = True           # USE_OPTIMIZED_G2 (Core/BRDF.h:77)
    use_reflectance_parameter: bool = False  # USE_REFLECTANCE_PARAMETER (Core/BRDF.h:68)
    combine_brdfs_with_fresnel: bool = True  # COMBINE_BRDFS_WITH_FRESNEL (Core/BRDF.h:72-74)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Runtime render flags; mirrors Renderer singleton state (Core/Renderer.h:33-49).

    This object is static under jit: changing it triggers recompilation, the
    same way toggling the reference's ImGui checkboxes changes the traced code
    path.
    """

    width: int = 1280                 # SCRWIDTH (template/common.h:8)
    height: int = 720                 # SCRHEIGHT (template/common.h:9)
    bounces: int = 2                  # path vertices (Core/Renderer.h:36)
    rendering_mode: RenderMode = RenderMode.BRDF
    lighted: bool = True              # LIGHTED
    gamma_corrected: bool = True      # GAMMACORRECTED: sqrt tonemap (Core/Renderer.cpp:73-79)
    normal_mapped: bool = True        # NORMALMAPPED
    skybox: bool = True               # SKYBOX
    antialias: bool = True            # AA: 2 jittered rays/pixel (Core/Renderer.cpp:59-66)
    post_processed: bool = False      # isPostProcessed: panini + vignette + aberration
    post_preset: int = 2              # named post chain preset (Core/Camera.h:11-29
    #   P1/P2; UserInterface.cpp:238-318 Preset buttons). 2 = engine defaults
    stochastic_lights: bool = True    # isStochastic: NEE light-type lottery
    accumulate: bool = True           # accumulates: depth-keyed running mean
    samples_per_pixel: int = 1        # wavefront batch factor (reference: 1 frame = 1 spp)
    brdf: BRDFConfig = dataclasses.field(default_factory=BRDFConfig)
    # Deviation switches (all default to reference-faithful behaviour):
    exact_point_falloff: bool = False  # reference uses color/dist (not 1/d^2) for point lights
    exact_shadow_tmax: bool = False    # point-shadow ray length: dist (physical)
    #   instead of the reference's dist^2 quirk (Core/Renderer.cpp:257) —
    #   with d>1 the quirk makes occluders BEYOND the light block it and
    #   traverses far past it; the physical bound prunes that traversal
    one_shadow_ray: bool = False       # point NEE: 1 uniformly-picked light ×NP
    #   (unbiased single-sample estimator) instead of the reference's NP
    #   shadow rays (Core/Renderer.cpp:220-261) — 1 occlusion lane per vertex.
    #   NOTE: this estimator converges to the physically
    #   consistent per-light sum  Σ_j bsdf(l_j)·contrib_j, whereas the
    #   reference's quirk evaluates bsdf at ONE random light against the
    #   summed contributions (bsdf(l_sel)·Σ_j contrib_j,
    #   Core/Renderer.cpp:264-268). The two differ in expectation on
    #   glossy surfaces — an intentional deviation, not a regression
    #   (docs/PARITY.md quirk list).
    depth_keyed_accum: bool = True     # depth-keyed accumulation reset
    #   heuristic (Core/Renderer.cpp:82-99); False = plain running mean
    chunk_pixels: int = 65536          # wavefront chunk: bounds live device
    #   memory per frame (frames run as a lax.map over chunks of this size)
    shade_tile: int = 0                # sub-tile width for the gated shading
    #   block: >0 runs the shade/NEE stage of each bounce as a lax.map
    #   over ~this-many-lane sub-tiles, each behind a scalar any() gate
    #   (Morton order clusters dead lanes into square screen blocks).
    #   Off by default: each slice adds a fixed per-bounce cost (its own
    #   occlusion launch, co-sort and scan step). Bit-identical either way.
    traversal: str = "dense"           # "dense" (default: dense-leaf BVH —
    #   the CUDA kernel on the GPU, the plain traversal elsewhere,
    #   ops/traverse_dense.py) | "wave" | "packet" | "lane" (XLA engines
    #   over the classic BVH, ops/traverse*.py)
    sort_rays: bool = True             # octant+Morton sort of bounce/shadow wavefronts
    packet_tile: int = 128             # rays per packet tile (wave/packet engines)
    dense: str = "mt"                  # wave leaf test: "mt" (Moller-Trumbore,
    #   elementwise) | "woop" (per-triangle Woop transform as a batched matmul)
    wave_shrink: int = 8               # adaptive compaction width divisor (0 disables)
    pixel_order: str = "morton"        # "morton" (square coherent tiles) | "scanline"
    # Cross-chip ray re-sharding (parallel/resharding.py): when reshard_axis
    # names a live shard_map mesh axis, every bounce donates up to
    # reshard_block surplus live rays to the ring neighbour before tracing
    # and routes results home after (the ring-attention-shaped load balance
    # of SURVEY.md §2.5). sharded_frame(..., reshard_block=N) sets these.
    reshard_axis: str | None = None
    reshard_ndev: int = 0
    reshard_block: int = 1024
    max_stack_depth: int = 48          # per-ray traversal stack bound (static)
    leaf_size: int = 16                # tris per BVH leaf (packet traversal wants fat leaves)
    dtype: str = "float32"

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
