"""Dynamic-scene demo: the reference's physics-free per-frame loop.

Tick = move instances -> refresh TLAS (rebuild_scene) -> render
(Core/Renderer.cpp:22-41: Synchronise -> Scene::BuildTLAS -> trace;
Core/Scene.cpp:220-223), on the two-level dense-leaf structure.

Renders N frames of spheres orbiting over a floor and writes
  * animate_###.png frames (optional, --frames-out)
  * docs/DYNAMIC_SCENE.json — per-frame cost of the incremental
    rebuild_scene refresh (O(moved) shading re-bake + O(instances) TLAS
    head) vs a from-scratch build_scene_instanced.

Usage: python examples/animate.py [--frames 8] [--size 96] [--frames-out DIR]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def make_scene():
    from physically_based_ray_tracer_tpu.scene.camera import Camera
    from physically_based_ray_tracer_tpu.scene.lights import LightSet
    from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere
    from physically_based_ray_tracer_tpu.scene.scene import (Instance, MeshModel,
                                                             build_scene_instanced)

    sphere = MeshModel.from_fat(make_sphere(radius=0.5, lat=16, lon=24),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4,
                                metalness=0.2)
    # heavy static mesh: the incremental-refresh win scales with the ratio
    # of static to moved geometry (a real scene's environment vs its movers)
    floor = MeshModel.from_fat(
        make_sphere(center=(0.0, -5.0, 0.0), radius=4.3, lat=96, lon=192),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(
        point_pos=[[2, 3, 2]], point_color=[[20, 20, 20]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]]).pad_points(4)
    cam = Camera.make(pos=(0, 2.5, 6), target=(0, 0, 0))
    return [sphere, floor], lights, cam


def instances_at(t: float):
    from physically_based_ray_tracer_tpu.scene.scene import Instance
    out = []
    for k in range(4):
        a = t + k * np.pi / 2
        out.append(Instance(0, position=(2.0 * np.cos(a),
                                         0.3 + 0.2 * np.sin(2 * a),
                                         2.0 * np.sin(a))))
    out.append(Instance(1))       # static floor
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--frames-out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import jax

    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.renderer import Renderer
    from physically_based_ray_tracer_tpu.scene.scene import (build_scene_instanced,
                                                             rebuild_scene)
    from physically_based_ray_tracer_tpu.utils.image import write_png

    models, lights, cam = make_scene()
    insts0 = instances_at(0.0)
    scene, handle, depth = build_scene_instanced(models, insts0, lights,
                                                 legacy_bvh=False)
    cfg = RenderConfig(width=args.size, height=args.size, bounces=2,
                       antialias=False, skybox=False,
                       max_stack_depth=max(depth + 2, 32))
    r = Renderer(scene, cam, cfg)

    refresh_ms, full_ms = [], []
    for f in range(args.frames):
        t = 2 * np.pi * f / args.frames
        insts = instances_at(t)

        t0 = time.perf_counter()
        r.scene = rebuild_scene(r.scene, handle, insts)
        refresh_ms.append((time.perf_counter() - t0) * 1e3)

        t0 = time.perf_counter()
        build_scene_instanced(models, insts, lights, legacy_bvh=False)
        full_ms.append((time.perf_counter() - t0) * 1e3)

        r.reset_accumulation()    # camera/scene changed: reference memset
        img = r.tick(jax.random.key(0))
        if args.frames_out:
            os.makedirs(args.frames_out, exist_ok=True)
            write_png(os.path.join(args.frames_out, f"animate_{f:03d}.png"), img)
        print(f"frame {f}: refresh {refresh_ms[-1]:.1f} ms, "
              f"full build {full_ms[-1]:.1f} ms, "
              f"render {r.stats.frame_ms:.1f} ms", file=sys.stderr)

    out = {
        "frames": args.frames,
        "moved_instances_per_frame": 4,
        "static_instances": 1,
        "refresh_ms_median": float(np.median(refresh_ms)),
        "full_build_ms_median": float(np.median(full_ms)),
        "speedup": float(np.median(full_ms) / max(np.median(refresh_ms), 1e-9)),
        "note": "rebuild_scene = O(instances) TLAS head + O(moved tris) "
                "shading re-bake vs from-scratch two-level build",
    }
    docs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs")
    with open(os.path.join(docs, "DYNAMIC_SCENE.json"), "w") as fjson:
        json.dump(out, fjson, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
