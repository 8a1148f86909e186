"""Golden-image regression tests for BASELINE eval configs 2 and 4.

Config 2: Cornell box + AreaLight, 4-bounce NEE (BASELINE.json configs).
Config 4: pinball geometry + skydome IBL + glossy BRDFs
          (Core/Camera.cpp:43-74 skydome sampling; PinballMachine meshes).

Both render through the DEFAULT (dense) engine at a fixed seed and compare
against committed golden PNGs, like tests/test_golden_scene1.py (config 3's
anchor); the Cornell golden is also checked with the lane engine.
Regenerate after an intentional change with:
    PYTHONPATH=. python tests/test_golden_configs.py regen
"""

import os
import sys

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CORNELL_GOLDEN = os.path.join(GOLDEN_DIR, "cornell_64.png")
PINBALL_GOLDEN = os.path.join(GOLDEN_DIR, "pinball_96x64.png")
SKY_FIXTURE = os.path.join(GOLDEN_DIR, "sky_32x16.hdr")
PINBALL_DIR = "/root/reference/Core/assets/prefabs/models/PinballMachine/Meshes"


def _sky_fixture() -> np.ndarray:
    """Deterministic 32x16 HDR skydome: blue-to-orange gradient with a
    bright 'sun' disc — enough dynamic range to exercise the RGBE path and
    the bilinear equirect sampling (Core/Camera.cpp:43-74)."""
    from physically_based_ray_tracer_tpu.utils.image import read_hdr, write_hdr

    if not os.path.exists(SKY_FIXTURE):
        h, w = 16, 32
        ys = np.linspace(0, 1, h)[:, None, None]
        xs = np.linspace(0, 1, w)[None, :, None]
        sky = (np.concatenate([0.3 + 1.5 * ys, 0.4 + 0.8 * ys, 1.2 - 0.9 * ys],
                              axis=-1)
               * (0.6 + 0.4 * np.sin(2 * np.pi * xs)))
        sky[3:6, 7:10] = [40.0, 35.0, 25.0]       # sun
        write_hdr(SKY_FIXTURE, sky.astype(np.float32))
    return read_hdr(SKY_FIXTURE)


def _render_cornell(traversal: str = "dense"):
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.renderer import Renderer
    from tests.scenes import cornell_scene

    scene, cam = cornell_scene(area_light=True)
    cfg = RenderConfig(width=64, height=64, bounces=4, antialias=False,
                       skybox=False, max_stack_depth=32, traversal=traversal)
    return Renderer(scene, cam, cfg).tick()


def _render_pinball():
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.models.gltf import load_gltf
    from physically_based_ray_tracer_tpu.render.renderer import Renderer
    from physically_based_ray_tracer_tpu.scene.camera import Camera
    from physically_based_ray_tracer_tpu.scene.lights import LightSet
    from physically_based_ray_tracer_tpu.scene.scene import (Instance,
                                                             build_scene_instanced)

    names = ["Ball.glb", "Flipper.glb", "Bumper.glb"]
    models = []
    for n in names:
        m = load_gltf(os.path.join(PINBALL_DIR, n))
        m.metalness, m.roughness = 0.9, 0.15        # glossy BRDF stress
        models.append(m)
    # normalise each mesh to unit size at distinct positions
    insts = []
    for k, m in enumerate(models):
        c = m.corners.reshape(-1, 3)
        ext = float(np.max(c.max(0) - c.min(0)))
        mid = (c.max(0) + c.min(0)) / 2
        s = 1.0 / max(ext, 1e-6)
        insts.append(Instance(k, position=(k - 1.0, 0.0, 0.0),
                              scale=(s, s, s),
                              rotation=(0.0, 0.6 * k, 0.0)))
        m.corners = (c - mid).astype(np.float32)    # recentre host-side
    lights = LightSet.make(dir_pos=[[4, 6, 5]], dir_color=[[2, 2, 2]]) \
        .pad_points(4)
    scene, handle, depth = build_scene_instanced(models, insts, lights,
                                                 sky=_sky_fixture())
    cam = Camera.make(pos=(0, 0.6, 2.6), target=(0, 0, 0))
    cfg = RenderConfig(width=96, height=64, bounces=3, antialias=False,
                       skybox=True, max_stack_depth=max(depth + 2, 40))
    return Renderer(scene, cam, cfg).tick()


def _check(img, golden_path, tol=1e-5, max_abs=6.0 / 255.0, outliers=0):
    # ~2.5x PNG-quantization MSE + a max-abs gate: tight enough that a
    # wrong constant in one BRDF branch fails. ``outliers`` pixels may miss
    # the max-abs gate; they are left out of the MSE.
    from physically_based_ray_tracer_tpu.utils.image import read_image

    assert os.path.exists(golden_path), \
        f"golden missing - run: PYTHONPATH=. python {__file__} regen"
    ref = read_image(golden_path)[..., :3]
    assert ref.shape == img.shape
    err = np.abs(img - ref)
    over = err.max(axis=-1) >= max_abs
    assert over.sum() <= outliers, \
        f"{int(over.sum())} pixels deviate by >= {max_abs:.4f} " \
        f"(max {float(err.max()):.4f}, {outliers} allowed)"
    mse = float(np.mean(err[~over] ** 2))
    assert mse < tol, f"deviates from golden: MSE={mse:.2e}"


def test_cornell_area_light_golden():
    img = _render_cornell()
    assert img.mean() > 0.01, "Cornell render suspiciously dark"
    _check(img, CORNELL_GOLDEN)


def test_cornell_golden_lane_engine():
    """The golden holds for the independent per-lane engine over the
    classic BVH too, at the same bounds."""
    img = _render_cornell(traversal="lane")
    assert img.mean() > 0.01
    _check(img, CORNELL_GOLDEN)


@pytest.mark.skipif(not os.path.isdir(PINBALL_DIR),
                    reason="reference assets absent")
def test_pinball_ibl_glossy_golden():
    img = _render_pinball()
    assert img.mean() > 0.01, "pinball render suspiciously dark"
    _check(img, PINBALL_GOLDEN)


GAME_GOLDEN = os.path.join(GOLDEN_DIR, "scene1_game_480x270.png")


def _render_scene1_game():
    """BASELINE config 3 at the reference's GAME resolution (480x270,
    template/common.h:11-15): scene1 meshes + all four light types."""
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.renderer import Renderer
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
    scene = scene._replace(lights=lights)
    cfg = RenderConfig(width=480, height=270, bounces=2, antialias=False,
                       skybox=False, max_stack_depth=max(depth + 2, 40))
    return Renderer(scene, cam, cfg).tick()


@pytest.mark.skipif(not os.path.isdir("/root/reference/assets"),
                    reason="reference assets absent")
def test_scene1_game_resolution_golden():
    img = _render_scene1_game()
    assert img.mean() > 0.01
    _check(img, GAME_GOLDEN)


if __name__ == "__main__" and "regen" in sys.argv[1:]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from physically_based_ray_tracer_tpu.utils.image import write_png

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    write_png(CORNELL_GOLDEN, _render_cornell())
    print("wrote", CORNELL_GOLDEN)
    if os.path.isdir(PINBALL_DIR):
        write_png(PINBALL_GOLDEN, _render_pinball())
        print("wrote", PINBALL_GOLDEN)
    if os.path.isdir("/root/reference/assets"):
        write_png(GAME_GOLDEN, _render_scene1_game())
        print("wrote", GAME_GOLDEN)


DS4_GOLDEN = os.path.join(GOLDEN_DIR, "scene1_1080_ds4.png")


@pytest.mark.skipif(not os.path.exists(DS4_GOLDEN)
                    or not os.path.isdir("/root/reference/assets"),
                    reason="1080p certification artifact absent")
def test_scene1_1080p_downsample_consistent():
    """Ties the 1080p certification artifact (tests/golden/
    scene1_1080_ds4.png, a 4x box-filtered 1920x1080 render) to the
    CI-rendered 480x270 image. The two sample the
    image plane differently (16 averaged rays/pixel vs 1 centre ray), so
    the gate is aliasing-scale, not quantization-scale — it still fails on
    any lighting/geometry/semantic drift between the certified chip render
    and the current code."""
    from physically_based_ray_tracer_tpu.utils.image import read_image

    img = _render_scene1_game()
    ds4 = read_image(DS4_GOLDEN)[..., :3]
    assert ds4.shape == img.shape
    # The two renders differ by MORE than noise: (a) 1-spp stochastic-NEE
    # noise under different RNG streams (pixel ids differ per resolution),
    # and (b) genuine resolution-dependent signal — the 1080p render's 16
    # rays/output-pixel catch sub-pixel speculars that a 480x270 centre
    # ray misses (measured: +20% mean brightness, physically expected).
    # The gate therefore pools 8x8 blocks and bounds gross structure +
    # mean drift only — it fails on lighting/geometry/semantic changes,
    # not on sampling-theory differences.
    def pool(x):
        return x[:264, :].reshape(33, 8, 60, 8, 3).mean(axis=(1, 3))
    mse = float(np.mean((pool(img) - pool(ds4)) ** 2))
    assert mse < 2.5e-3, f"1080p artifact inconsistent with CI: {mse:.2e}"
    assert abs(float(img.mean()) - float(ds4.mean())) < 0.015
