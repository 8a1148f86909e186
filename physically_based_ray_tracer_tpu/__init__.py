"""physically-based-ray-tracer.

A differentiable, physically-based path-tracing framework written in
JAX/XLA, with a CUDA BVH traversal kernel for NVIDIA GPUs (sm_90a).
Feature parity target is the reference
CPU engine ``Iancic/Physically-Based-Ray-Tracer`` (C++ / tinybvh / OpenMP /
AVX2); the architecture is not a port: everything is a pure-functional
wavefront program over SoA arrays, sharded across devices with
``jax.sharding`` and compiled by XLA.

Layout:
    utils/     math, RNG, images, timing
    ops/       BRDF stack, sampling, intersection, BVH traversal (XLA + CUDA)
    bvh/       host-side SAH BVH builders (numpy + native C++), TLAS
    scene/     camera, lights, materials, scene assembly, JSON serialization
    models/    glTF/GLB asset loading, textures, resource cache
    render/    wavefront integrator, film/accumulation, AOVs, post-processing
    parallel/  device meshes, tile-sharded rendering, scaling harness
    diff/      differentiable rendering + inverse rendering
"""

__version__ = "0.1.0"

from physically_based_ray_tracer_tpu.config import RenderConfig, RenderMode

__all__ = ["RenderConfig", "RenderMode", "__version__"]
