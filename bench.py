"""Frame benchmark on the GPU: frame time and Mrays/s of the flagship scene.

    python bench.py                       # default engine, one JSON line
    python bench.py --traversal lane      # another engine (dense|wave|packet|lane)
    python bench.py --lt 16               # dense leaf target
    python bench.py --sweep               # engines + dense leaf-size sweep,
                                          # one JSON line per configuration

Before its JSON the script prints the device JAX reports and the card's
name and power limit (``nvidia-smi``). It exits non-zero, printing no rate,
when JAX's device is not a GPU.

Rays counted are the expected LIVE rays traced (primary + AA + live bounce
extensions + live NEE shadow rays), from per-bounce live fractions measured
once per scene on the CPU (docs/LIVE_RAYS_*.json; scene properties, not
device numbers). Without that file the lane-slot upper bound is used.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_bench_scene(dense_leaf_target: int | None = None,
                      flatten: str = "auto", legacy_bvh: bool = False):
    """The flagship: 9 instanced spheres + a floor, ~38k world triangles."""
    from physically_based_ray_tracer_tpu.bvh.dense import DEFAULT_LEAF_TARGET
    from physically_based_ray_tracer_tpu.scene.camera import Camera
    from physically_based_ray_tracer_tpu.scene.lights import LightSet
    from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere
    from physically_based_ray_tracer_tpu.scene.scene import (Instance, MeshModel,
                                                             build_scene_instanced)

    if dense_leaf_target is None:
        dense_leaf_target = DEFAULT_LEAF_TARGET
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=32, lon=64),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4, metalness=0.2)
    floor = MeshModel.from_fat(
        make_quad([-8, -1, -8], [8, -1, -8], [8, -1, 8], [-8, -1, 8]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(
        point_pos=[[2, 3, 2], [-2, 3, -1], [0, 5, 0], [3, 2, -3]],
        point_color=[[20, 20, 20], [10, 12, 14], [6, 6, 6], [8, 4, 2]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]],
        spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
    )
    instances = [Instance(0, position=(dx, 0, dz))
                 for dx in (-2.2, 0.0, 2.2) for dz in (-2.2, 0.0, 2.2)]
    instances.append(Instance(1))
    # flatten="auto": this small static scene (10 instances, 38k world
    # tris) is world-baked into ONE single-level dense tree
    scene, _handle, depth = build_scene_instanced(
        [sphere, floor], instances, lights, legacy_bvh=legacy_bvh,
        dense_leaf_target=dense_leaf_target, flatten=flatten)
    cam = Camera.make(pos=(0, 2.5, 7), target=(0, 0, 0))
    return scene, cam, depth


def flagship_config(**kw):
    """1280x720, 4 bounces, stochastic NEE with one shadow ray, 2x AA."""
    from physically_based_ray_tracer_tpu.config import RenderConfig

    base = dict(width=1280, height=720, bounces=4, antialias=True,
                skybox=False, max_stack_depth=32, one_shadow_ray=True)
    base.update(kw)
    return RenderConfig(**base)


def load_live_fractions(which="spheres"):
    """Per-bounce live-lane fractions measured once per scene on the CPU
    with the integrator's collect_live tap; None when absent."""
    base = "LIVE_RAYS" if which == "spheres" else "LIVE_RAYS_SCENE1"
    docs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs")
    for rev in ("r05", "r04"):   # prefer the freshest calibration
        cand = os.path.join(docs, f"{base}_{rev}.json")
        if os.path.exists(cand):
            with open(cand) as f:
                d = json.load(f)
            return (d["extension_live_fraction"], d["shadow_live_fraction"],
                    os.path.basename(cand))
    return None


def build_scene1(width=1920, height=1080):
    """BASELINE config #3: the real scene1 assets (SciFiHelmet + scene
    JSON lights) with ALL FOUR light types at full 1080p — the capture
    configuration of Core/Renderer.cpp:437-465 at the editor window's
    aspect (template/common.h:8-9 scaled to 1080p). Needs the reference
    assets, which are not in this tree."""
    import numpy as np
    from physically_based_ray_tracer_tpu.scene.lights import LightSet
    from physically_based_ray_tracer_tpu.scene.loader import load_reference_scene

    scene, cam, depth = load_reference_scene("/root/reference/assets")
    L = scene.lights
    lights = LightSet.make(
        point_pos=[[2, 2, 2], [-2, 2, -1], [0, 3, 0], [2, 1, -2]],
        point_color=[[6, 6, 6], [3, 4, 5], [2, 2, 2], [3, 1, 1]],
        dir_pos=np.array(L.dir_pos), dir_color=np.array(L.dir_color),
        spot_pos=np.array(L.spot_pos), spot_color=np.array(L.spot_color),
        spot_rot=np.array(L.spot_rot),
        area_pos=[[0.0, 2.5, 0.0]], area_color=[[6.0, 5.0, 3.0]],
        area_u=[[0.5, 0.0, 0.0]], area_v=[[0.0, 0.0, 0.5]])
    return scene._replace(lights=lights), cam, depth


def time_frames(scene, cam, cfg, iters: int = 3):
    """(compile_s, median frame seconds) of the jitted frame function."""
    import functools

    import jax
    import jax.numpy as jnp

    from physically_based_ray_tracer_tpu.render.film import FilmState
    from physically_based_ray_tracer_tpu.render.renderer import frame_fn

    pixel_ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    film = FilmState.zeros(cfg.n_pixels)
    key = jax.random.key(0)
    frame = jax.jit(functools.partial(frame_fn, cfg=cfg))
    t0 = time.perf_counter()
    film, avg = frame(scene, cam, film=film, key=key, sample=0,
                      pixel_ids=pixel_ids)
    jax.block_until_ready(avg)
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        film, avg = frame(scene, cam, film=film, key=key, sample=i + 1,
                          pixel_ids=pixel_ids)
        jax.block_until_ready(avg)
        times.append(time.perf_counter() - t0)
    times.sort()
    return compile_s, times[len(times) // 2]


def result(scene, cfg, which, t_med, compile_s, stamp, smi, extra):
    from physically_based_ray_tracer_tpu.utils.timer import (live_ray_count,
                                                             ray_count)

    n_point = int(scene.lights.n_point)
    frac = load_live_fractions(which)
    if frac is not None:
        rays = live_ray_count(cfg, cfg.n_pixels, frac[0], frac[1])
        counted = ("expected live rays traced, live fractions from "
                   f"docs/{frac[2]} (CPU-calibrated scene property)")
    else:
        rays = ray_count(cfg, cfg.n_pixels, n_point_lights=n_point)
        counted = "lane slots launched (upper bound; calibration missing)"
    slots = ray_count(cfg, cfg.n_pixels, n_point_lights=n_point)
    label = "scene1 1920x1080" if which == "scene1" else "1280x720"
    return {
        "metric": f"Mrays/s ({label}, {cfg.bounces}-bounce path trace, NEE, "
                  f"AA, traversal={cfg.traversal})",
        "value": rays / t_med / 1e6,
        "unit": "Mrays/s",
        "frame_ms": t_med * 1e3,
        "compile_s": compile_s,
        "counted": counted,
        "lane_slot_mrays": slots / t_med / 1e6,
        "device": stamp,
        "gpu": smi,
        **extra,
    }


def _arg(name, default, cast=str):
    return cast(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv \
        else default


def main():
    from physically_based_ray_tracer_tpu.bvh.dense import DEFAULT_LEAF_TARGET
    from physically_based_ray_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    from physically_based_ray_tracer_tpu.utils.device import (nvidia_smi_line,
                                                              require_gpu)

    stamp = require_gpu()
    smi = nvidia_smi_line()
    print(f"device: {stamp}")
    print(f"nvidia-smi: {smi}")
    enable_compile_cache()

    which = _arg("--scene", "spheres")
    traversal = _arg("--traversal", "dense")
    lt = _arg("--lt", DEFAULT_LEAF_TARGET, int)
    common = dict(chunk_pixels=_arg("--chunk", 65536, int),
                  shade_tile=_arg("--shade-tile", 0, int),
                  exact_shadow_tmax="--exact-shadow" in sys.argv)

    if "--sweep" in sys.argv:
        runs = [("dense", 8), ("lane", 8), ("wave", 8), ("packet", 8),
                ("dense", 4), ("dense", 16), ("dense", 8)]
        for trav, t in runs:
            scene, cam, _ = build_bench_scene(dense_leaf_target=t,
                                              legacy_bvh=trav != "dense")
            cfg = flagship_config(traversal=trav, **common)
            compile_s, t_med = time_frames(scene, cam, cfg)
            print(json.dumps(result(scene, cfg, "spheres", t_med, compile_s,
                                    stamp, smi, {"dense_leaf_target": t})),
                  flush=True)
        return

    if which == "scene1":
        scene, cam, depth = build_scene1()
        cfg = flagship_config(width=1920, height=1080, traversal=traversal,
                              max_stack_depth=max(depth + 2, 40), **common)
    else:
        flat = True if "--flatten" in sys.argv else "auto"
        if "--no-flatten" in sys.argv:
            flat = False
        scene, cam, _ = build_bench_scene(
            dense_leaf_target=lt, flatten=flat,
            legacy_bvh=traversal != "dense")
        cfg = flagship_config(traversal=traversal, **common)
    compile_s, t_med = time_frames(scene, cam, cfg)
    print(json.dumps(result(scene, cfg, which, t_med, compile_s, stamp, smi,
                            {"dense_leaf_target": lt})))


if __name__ == "__main__":
    main()
