"""Inverse rendering demo (BASELINE config #5, single-host version).

Renders a target image of the sphere demo scene, perturbs the material
albedo + roughness + light intensity, then recovers them by gradient descent
on the pixel loss. Runs on the GPU, or on the CPU with --cpu.
"""

import argparse
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=64)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.diff.grad import render_color
    from physically_based_ray_tracer_tpu.diff.inverse import fit
    from physically_based_ray_tracer_tpu.scene.presets import sphere_demo

    scene, cam = sphere_demo()
    cfg = RenderConfig(width=args.size, height=args.size, bounces=2,
                       antialias=False, skybox=False, gamma_corrected=False,
                       max_stack_depth=32)
    pixel_ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.key(0)

    target = render_color(scene, cam, cfg, key, 0, pixel_ids)
    true_albedo = np.asarray(scene.mat_base)

    wrong = {
        "base_color": scene.mat_base * 0.3 + 0.4,
        "roughness": jnp.clip(scene.mat_rough + 0.25, 0.05, 1.0),
        "point_color": scene.lights.point_color * 0.5,
    }
    params, losses = fit(scene, cam, cfg, wrong, target, pixel_ids,
                         steps=args.steps, lr=0.02, vary_sample=False,
                         verbose=True)
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}")
    print("recovered albedo (model 0):", np.round(np.asarray(params['base_color'])[0], 3),
          "true:", np.round(true_albedo[0], 3))
    print("recovered roughness:", np.round(np.asarray(params['roughness']), 3),
          "true:", np.round(np.asarray(scene.mat_rough), 3))


if __name__ == "__main__":
    main()
