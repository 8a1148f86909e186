"""Golden-image regression test on the real reference scene1 assets.

Renders /root/reference/assets scene1 (SciFiHelmet + the scene's JSON
lights, Core/Scene.cpp:10-28) through the full loader + integrator stack at
a fixed seed and compares against a committed golden PNG. This pins the
stochastic-NEE, texture, TBN and glTF paths end-to-end — the capture-parity
analogue of Renderer::Capture (Core/Renderer.cpp:437-465).

Regenerate after an *intentional* change with:
    PYTHONPATH=. python tests/test_golden_scene1.py regen
"""

import os
import sys

import numpy as np
import pytest

ASSETS = "/root/reference/assets"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "scene1_96.png")
W = H = 96


def _render():
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.renderer import Renderer
    from physically_based_ray_tracer_tpu.scene.loader import load_reference_scene

    scene, cam, depth = load_reference_scene(ASSETS)
    cfg = RenderConfig(width=W, height=H, bounces=2, antialias=False,
                       skybox=False, max_stack_depth=max(depth + 2, 32))
    r = Renderer(scene, cam, cfg)
    return r.tick()          # seed fixed inside tick (jax.random.key(0))


@pytest.mark.skipif(not os.path.isdir(ASSETS), reason="reference assets absent")
def test_scene1_matches_golden():
    from physically_based_ray_tracer_tpu.utils.image import read_image

    assert os.path.exists(GOLDEN), \
        "golden missing - run: PYTHONPATH=. python tests/test_golden_scene1.py regen"
    img = _render()
    assert img.mean() > 0.02, "image suspiciously dark - pipeline broke"
    ref = read_image(GOLDEN)[..., :3]
    assert ref.shape == img.shape
    # PNG quantization alone contributes up to (0.5/255)^2 ~ 3.8e-6 MSE;
    # gate at ~2.5x quantization noise plus a max-abs bound so that subtle
    # shading regressions (a wrong constant in one BRDF branch) cannot hide
    # under a loose threshold.
    mse = float(np.mean((img - ref) ** 2))
    assert mse < 1e-5, f"scene1 deviates from golden: MSE={mse:.2e}"
    mx = float(np.max(np.abs(img - ref)))
    assert mx < 6.0 / 255.0, f"scene1 max-abs deviation {mx:.4f}"


if __name__ == "__main__" and "regen" in sys.argv[1:]:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from physically_based_ray_tracer_tpu.utils.image import write_png
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    write_png(GOLDEN, _render())
    print("wrote", GOLDEN)
