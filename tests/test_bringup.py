"""What surrounds the GPU path and can be checked on the CPU: the compile
cache helper, the device refusal of bench.py and chip_smoke.py, the smoke
test's comparisons (run here with the plain traversal standing in for the
kernel), the four-device path on virtual CPU devices, the layout policy and
the exact one-hot light selection."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, timeout=300):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable] + code_or_args)
    return subprocess.run(args, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)


_CACHE_PROBE = """
import os, jax
from physically_based_ray_tracer_tpu.utils.compile_cache import enable_compile_cache
path = enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jax.numpy.sin(x) * 3.0 + x)(jax.numpy.arange(5.0)).block_until_ready()
print("PATH", path)
print("CONFIG", jax.config.jax_compilation_cache_dir)
print("FILES", len(os.listdir(path)) if os.path.isdir(path) else 0)
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, tmp_path):
    from physically_based_ray_tracer_tpu.utils import compile_cache

    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")} if env_set \
        else {}
    out = _run(_CACHE_PROBE, extra)
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines())
    want = str(tmp_path / "cc") if env_set else compile_cache.DEFAULT_DIR
    assert lines["PATH"] == want and lines["CONFIG"] == want
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    if env_set:
        assert int(lines["FILES"]) > 0     # the compiled program landed there


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_measure_without_gpu(script):
    out = _run([script])
    assert out.returncode != 0
    last = (out.stdout.strip().splitlines() or [""])[-1]
    assert '"ok": true' not in last and "Mrays" not in out.stdout


def test_comparisons_accept_ties_and_reject_misses():
    from physically_based_ray_tracer_tpu.ops.intersect import Hit

    n = 200_000
    t = np.linspace(1.0, 5.0, n).astype(np.float32)
    prim = np.arange(n, dtype=np.int32)
    a = Hit(t, t, t, prim, prim)
    tie = prim.copy()
    tie[:2] += 1                              # exact ties: tolerated
    assert chip_smoke.compare_closest(a, Hit(t, t, t, tie, tie))["ok"]
    miss = prim.copy()
    miss[0] = -1                              # a hit against a miss: never
    bad = chip_smoke.compare_closest(a, Hit(t, t, t, miss, miss))
    assert not bad["ok"] and bad["non_tie_mismatches"] == 1
    occ = np.zeros(n, bool)
    occ2 = occ.copy()
    occ2[:3] = True                           # 1.5e-5 > 1e-5 of the rays
    assert not chip_smoke.compare_any(occ, occ2)["ok"]


def _tiny_flagship(n_lat=8):
    from physically_based_ray_tracer_tpu.scene.camera import Camera
    from physically_based_ray_tracer_tpu.scene.lights import LightSet
    from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere
    from physically_based_ray_tracer_tpu.scene.scene import (Instance, MeshModel,
                                                             build_scene_instanced)

    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=n_lat, lon=12),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4)
    floor = MeshModel.from_fat(
        make_quad([-8, -1, -8], [8, -1, -8], [8, -1, 8], [-8, -1, 8]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(point_pos=[[2, 3, 2], [-2, 3, -1]],
                           point_color=[[20, 20, 20], [10, 12, 14]],
                           dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]])
    insts = [Instance(0, position=(dx, 0, 0)) for dx in (-2.2, 0.0, 2.2)]
    insts.append(Instance(1))
    scene, handle, depth = build_scene_instanced(
        [sphere, floor], insts, lights, flatten="auto")
    cam = Camera.make(pos=(0, 2.5, 7), target=(0, 0, 0))
    return scene, handle, cam


def test_smoke_kernel_vs_plain_on_cpu():
    """Phase 3's wavefronts and comparisons, the plain traversal standing
    in for the kernel."""
    from physically_based_ray_tracer_tpu.config import RenderConfig

    scene, _, cam = _tiny_flagship()
    cfg = RenderConfig(width=24, height=16, bounces=2, antialias=True,
                       max_stack_depth=32)
    rep = chip_smoke.kernel_vs_plain(scene, cam, cfg, kernel=False)
    assert rep["ok"], rep
    assert {"primary_closest", "bounce_closest", "bounce_any",
            "shadow_any"} <= set(rep)


def test_four_device_checks_on_virtual_cpus():
    """The --four-cards comparisons at a tiny size on 4 of the harness's
    virtual CPU devices."""
    from physically_based_ray_tracer_tpu.config import RenderConfig

    assert len(jax.devices()) >= 4
    scene, _, cam = _tiny_flagship(n_lat=6)
    cfg = RenderConfig(width=16, height=8, bounces=2, antialias=False,
                       skybox=False, max_stack_depth=24, one_shadow_ray=True)
    rep = chip_smoke.four_card_checks(scene, cam, cfg, jax.devices()[:4],
                                      part_rays=128, train_pixels=64,
                                      sphere_lat=6)
    assert rep["ok"], rep


def test_flatten_auto_decides_by_counts(monkeypatch):
    from physically_based_ray_tracer_tpu.scene import scene as scene_mod

    _, handle, _ = _tiny_flagship()
    assert handle.tlas_meta is None            # world-baked: under the caps
    monkeypatch.setattr(scene_mod, "FLATTEN_MAX_INSTANCES", 3)
    _, handle, _ = _tiny_flagship()
    assert handle.tlas_meta is not None        # 4 instances > 3: two-level


def test_one_hot_selection_is_an_exact_gather():
    from physically_based_ray_tracer_tpu.render.integrator import select_one_hot

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(513, 4, 3)).astype(np.float32) * 1e3)
    which = jnp.asarray(rng.integers(0, 4, 513))
    onehot = (jnp.arange(4)[None, :] == which[:, None]).astype(jnp.float32)
    got = np.asarray(jax.jit(select_one_hot)(onehot, x))
    want = np.asarray(jnp.take_along_axis(x, which[:, None, None], axis=1)[:, 0])
    assert np.array_equal(got, want)
