"""Command-line renderer: the headless replacement for the reference's
ImGui editor + GL blit loop (SURVEY.md §2.4: "replace with CLI/config +
image outputs").

Usage:
    python -m physically_based_ray_tracer_tpu.cli --demo sphere --out out.png
    python -m physically_based_ray_tracer_tpu.cli --demo cornell --spp 64
    python -m physically_based_ray_tracer_tpu.cli --assets /path/to/assets \
        --scene scene1 --width 1920 --height 1080
Every reference render flag is exposed (bounces, AA, gamma, skybox, AOV, ...).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="physically-based path tracer")
    p.add_argument("--demo", choices=["sphere", "cornell"], default=None,
                   help="procedural demo scene")
    p.add_argument("--assets", default=None, help="reference-format assets root")
    p.add_argument("--scene", default="scene1", help="scene directory name")
    p.add_argument("--out", default=None, help="output PNG (default: timestamped)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=8, help="accumulated frames")
    p.add_argument("--bounces", type=int, default=2)
    p.add_argument("--aov", default="BRDF",
                   help="render mode: BRDF|BASECOLOR|GEOMETRYNORMAL|SHADINGNORMAL|"
                        "METAL|ROUGHNESS|EMMISIVE|DEPTH|PRIMID")
    p.add_argument("--no-aa", action="store_true")
    p.add_argument("--no-gamma", action="store_true")
    p.add_argument("--no-skybox", action="store_true")
    p.add_argument("--no-lights", action="store_true")
    p.add_argument("--no-normal-map", action="store_true")
    p.add_argument("--no-stochastic", action="store_true")
    p.add_argument("--post", action="store_true", help="Panini + vignette + aberration")
    p.add_argument("--post-preset", type=int, default=2, choices=(1, 2),
                   help="named post chain preset (Core/Camera.h P1/P2): "
                        "1 = wide-fov Panini + warm grade + strong vignette "
                        "+ aberration; 2 = engine defaults")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--debug-pixel", nargs=2, type=int, metavar=("X", "Y"),
                   default=None,
                   help="print a per-bounce trace of one pixel's path plus "
                        "its neighbourhood colour grid (the editor Debugger "
                        "tab analogue) instead of rendering a frame")
    p.add_argument("--draw-bvh", type=int, default=None, metavar="LEVEL",
                   help="overlay BVH node AABB wireframes at the given tree "
                        "level on the capture (debug-draw analogue)")
    p.add_argument("--session", action="store_true",
                   help="headless edit session over --assets: stdin commands "
                        "(move/light/cam/render/capture/watch/quit) mutate "
                        "live state AND write the scene JSONs back — the "
                        "editor live-edit loop without a window")
    return p


def run_session(args, cfg):
    """stdin-driven edit-render loop (see session.EditSession)."""
    from physically_based_ray_tracer_tpu.session import EditSession

    s = EditSession(args.assets, args.scene, cfg=cfg)
    print("session ready; commands: move NAME X Y Z | light KIND IDX "
          "pos|color X Y Z | cam PX PY PZ [TX TY TZ] | render [SPP] | "
          "capture [PATH] | watch | quit", file=sys.stderr)
    for line in sys.stdin:
        try:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "quit":
                break
            elif tok[0] == "move":
                s.edit_object(tok[1], position=[float(x) for x in tok[2:5]])
            elif tok[0] == "light":
                kw = {"pos": "position", "color": "color"}[tok[3]]
                s.edit_light(tok[1], int(tok[2]),
                             **{kw: [float(x) for x in tok[4:7]]})
            elif tok[0] == "cam":
                v = [float(x) for x in tok[1:]]
                s.edit_camera(pos=v[:3], target=v[3:6] if len(v) >= 6 else None)
            elif tok[0] == "render":
                s.render(samples=int(tok[1]) if len(tok) > 1 else 1)
                print(f"rendered: {s.renderer.stats.frame_ms:.1f} ms",
                      file=sys.stderr)
            elif tok[0] == "capture":
                print("wrote", s.capture(tok[1] if len(tok) > 1 else None))
            elif tok[0] == "watch":
                print("changed:", s.watch_once(), file=sys.stderr)
            else:
                print(f"unknown command: {tok[0]}", file=sys.stderr)
        except Exception as e:  # keep the session alive on bad input
            print(f"error: {e}", file=sys.stderr)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from physically_based_ray_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()

    from physically_based_ray_tracer_tpu.config import RenderConfig, RenderMode
    from physically_based_ray_tracer_tpu.render.renderer import Renderer

    cfg = RenderConfig(
        width=args.width, height=args.height, bounces=args.bounces,
        rendering_mode=RenderMode[args.aov],
        antialias=not args.no_aa, gamma_corrected=not args.no_gamma,
        skybox=not args.no_skybox, lighted=not args.no_lights,
        normal_mapped=not args.no_normal_map,
        stochastic_lights=not args.no_stochastic,
        post_processed=args.post, post_preset=args.post_preset)

    if args.session:
        if args.assets is None:
            print("--session requires --assets", file=sys.stderr)
            return
        run_session(args, cfg)
        return

    if args.demo == "cornell":
        from physically_based_ray_tracer_tpu.scene.presets import cornell_box
        scene, cam = cornell_box()
    elif args.demo == "sphere" or args.assets is None:
        from physically_based_ray_tracer_tpu.scene.presets import sphere_demo
        scene, cam = sphere_demo()
    else:
        from physically_based_ray_tracer_tpu.scene.loader import load_reference_scene
        scene, cam, _ = load_reference_scene(args.assets, args.scene)

    if args.post:
        # preset fov/distortion drive the Panini projection
        # (Core/Camera.h:20-23 P1/P2 values; fov only affects Panini)
        from physically_based_ray_tracer_tpu.ops.tonemap import POST_PRESETS
        import jax.numpy as _jnp
        pp = POST_PRESETS.get(args.post_preset, POST_PRESETS[2])
        cam = cam._replace(fov=_jnp.float32(pp["fov"]),
                           distortion=_jnp.float32(pp["distortion"]))

    if args.debug_pixel is not None:
        import numpy as np

        from physically_based_ray_tracer_tpu.render.debugger import (
            format_trace, pixel_grid, trace_pixel)
        x, y = args.debug_pixel
        print(format_trace(trace_pixel(scene, cam, cfg, x, y)))
        grid = pixel_grid(scene, cam, cfg, x, y)
        with np.printoptions(precision=3, suppress=True):
            print(f"colour grid around ({x},{y}):\n{grid}")
        return

    r = Renderer(scene, cam, cfg)
    import jax
    t0 = time.time()
    for s in range(args.spp):
        r.tick(jax.random.key(args.seed))
        print(f"frame {s + 1}/{args.spp}: {r.stats.frame_ms:.1f} ms, "
              f"{r.stats.mrays_per_s:.1f} Mrays/s", file=sys.stderr)
    if args.draw_bvh is not None:
        import numpy as np

        from physically_based_ray_tracer_tpu.utils.debug_draw import (
            bvh_level_boxes, draw_aabbs)
        from physically_based_ray_tracer_tpu.utils.image import write_png
        lo, hi = bvh_level_boxes(np.asarray(scene.bvh.nodes_box),
                                 np.asarray(scene.bvh.nodes_child),
                                 args.draw_bvh)
        img = draw_aabbs(np.asarray(r._current_image()), cam, lo, hi)
        out = args.out or f"capture_{int(time.time())}.png"
        write_png(out, img)
        print(f"wrote {out} with BVH level-{args.draw_bvh} overlay "
              f"({lo.shape[0]} boxes)")
        return

    out = r.capture(args.out)
    print(f"wrote {out} ({args.spp} spp, {time.time() - t0:.1f}s total)")


if __name__ == "__main__":
    main()
