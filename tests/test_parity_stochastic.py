"""Per-pixel parity of the STOCHASTIC integrator paths vs the float64 oracle.

The light-type lottery, point/spot falloff quirks,
dielectric RR and lobe RIS were pinned only by self-generated goldens. Here
the scalar float64 oracle (tests/oracle.py trace_path_stochastic) re-derives
the full Trace semantics independently, consuming the SAME Purpose-stream
uniforms, and every sampled pixel's radiance must agree with trace_paths.

Float32-vs-float64 BRDF-sample directions diverge chaotically after a
bounce near silhouettes, so a small outlier fraction is tolerated; the
median must be tight (same policy as tests/test_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_ray_tracer_tpu.config import RenderConfig
from physically_based_ray_tracer_tpu.render.integrator import trace_paths
from physically_based_ray_tracer_tpu.scene.camera import Camera, primary_rays
from physically_based_ray_tracer_tpu.scene.lights import LightSet
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere
from physically_based_ray_tracer_tpu.scene.scene import Instance, MeshModel, build_scene
from physically_based_ray_tracer_tpu.utils import rng
from physically_based_ray_tracer_tpu.utils.rng import Purpose

from tests import oracle

W = H = 16
BOUNCES = 3


@pytest.fixture(scope="module")
def setup():
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=8, lon=12),
                                base_color=(0.8, 0.3, 0.2), roughness=0.5,
                                metalness=0.2)
    glass = MeshModel.from_fat(make_sphere(radius=0.5, lat=8, lon=12),
                               base_color=(0.9, 0.9, 0.9), roughness=0.1,
                               transmissivness=1.0)
    mirror = MeshModel.from_fat(make_sphere(radius=0.5, lat=8, lon=12),
                                base_color=(0.9, 0.9, 0.9), roughness=0.0,
                                metalness=1.0)
    floor = MeshModel.from_fat(
        make_quad([-6, -1.2, -6], [-6, -1.2, 6], [6, -1.2, 6], [6, -1.2, -6]),
        base_color=(0.5, 0.6, 0.7), roughness=0.9,
        emissive=(0.01, 0.01, 0.01))
    # all three lottery light types present -> the reference 0.3/0.5/0.2 mix
    lights = LightSet.make(
        point_pos=[[2.0, 3.0, 2.0], [-2.0, 2.0, 1.0]],
        point_color=[[6.0, 5.0, 4.0], [3.0, 3.0, 5.0]],
        dir_pos=[[4.0, 6.0, 3.0]], dir_color=[[1.5, 1.4, 1.2]],
        spot_pos=[[0.0, 4.0, 0.0]], spot_color=[[8.0, 8.0, 8.0]],
        spot_rot=[[0.0, -1.0, 0.0]])
    insts = [Instance(0), Instance(1, position=(-1.4, -0.6, 0.9)),
             Instance(2, position=(1.5, -0.5, 0.7)), Instance(3)]
    scene, _ = build_scene([sphere, glass, mirror, floor], insts, lights)
    cam = Camera.make(pos=(0.0, 1.0, 4.0), target=(0.0, 0.0, 0.0))
    return scene, cam


def _oracle_scene(scene):
    tris = np.stack([np.asarray(scene.tri_v0),
                     np.asarray(scene.tri_v0) + np.asarray(scene.tri_e1),
                     np.asarray(scene.tri_v0) + np.asarray(scene.tri_e2)],
                    axis=1).astype(float)
    pm = np.asarray(scene.prim_model)
    L = scene.lights
    return dict(
        tris=tris,
        corner_normals=np.asarray(scene.corner_normal, float),
        base=np.asarray(scene.mat_base, float)[pm],
        metal=np.asarray(scene.mat_metal, float)[pm],
        rough=np.asarray(scene.mat_rough, float)[pm],
        emissive=np.asarray(scene.mat_emissive, float)[pm],
        transmissive=np.asarray(scene.mat_transmissive, float)[pm],
        point_pos=np.asarray(L.point_pos, float)[:int(L.n_point)],
        point_color=np.asarray(L.point_color, float)[:int(L.n_point)],
        dir_pos=np.asarray(L.dir_pos, float)[:int(L.n_dir)],
        dir_color=np.asarray(L.dir_color, float)[:int(L.n_dir)],
        spot_pos=np.asarray(L.spot_pos, float)[:int(L.n_spot)],
        spot_color=np.asarray(L.spot_color, float)[:int(L.n_spot)],
        spot_rot=np.asarray(L.spot_rot, float)[:int(L.n_spot)],
    )


def test_stochastic_paths_match_oracle(setup):
    scene, cam = setup
    cfg = RenderConfig(width=W, height=H, bounces=BOUNCES, antialias=False,
                       skybox=False, stochastic_lights=True,
                       one_shadow_ray=True, max_stack_depth=24)
    ids = jnp.arange(W * H, dtype=jnp.int32)
    xs = (ids % W).astype(jnp.float32)
    ys = (ids // W).astype(jnp.float32)
    key = jax.random.key(7)
    o, d = primary_rays(cam, xs, ys, W, H)
    rad, _ = trace_paths(scene, cfg, o, d, ids, key, sample=0)
    rad = np.asarray(rad, float)

    # the integrator's exact Purpose-stream uniforms, shared with the oracle
    draws = []
    for b in range(BOUNCES):
        draws.append(dict(
            u_type=np.asarray(rng.uniform1(key, ids, 0, b, Purpose.LIGHT_TYPE),
                              float),
            u_sel=np.asarray(rng.uniform1(key, ids, 0, b, Purpose.LIGHT_SELECT),
                             float),
            u_lobe=np.asarray(rng.uniform1(key, ids, 0, b, Purpose.LOBE_SELECT),
                              float),
            u_diel=np.asarray(rng.uniform1(key, ids, 0, b, Purpose.DIELECTRIC),
                              float),
            u2=np.asarray(rng.uniform2(key, ids, 0, b, Purpose.BRDF_SAMPLE),
                          float),
        ))
    osc = _oracle_scene(scene)
    o_np = np.asarray(o, float)
    d_np = np.asarray(d, float)
    diffs = np.zeros(W * H)
    mags = np.zeros(W * H)
    for p in range(W * H):
        pd = [dict(u_type=draws[b]["u_type"][p], u_sel=draws[b]["u_sel"][p],
                   u_lobe=draws[b]["u_lobe"][p], u_diel=draws[b]["u_diel"][p],
                   u2=draws[b]["u2"][p]) for b in range(BOUNCES)]
        ref = oracle.trace_path_stochastic(o_np[p], d_np[p], osc, pd, BOUNCES)
        diffs[p] = np.max(np.abs(ref - rad[p]))
        mags[p] = max(np.max(np.abs(ref)), 1.0)
    rel = diffs / mags
    frac_loose = (rel > 2e-3).mean()
    assert frac_loose < 0.05, (
        f"{frac_loose:.3%} pixels disagree with the float64 oracle "
        f"(max rel {rel.max():.4f})")
    assert np.median(rel) < 2e-4, f"median rel diff {np.median(rel):.2e}"


def test_stochastic_covers_all_lottery_branches(setup):
    """The sampled pixel set must actually exercise point, dir and spot
    picks at bounce 0 (guards against a vacuous parity pass)."""
    ids = jnp.arange(W * H, dtype=jnp.int32)
    key = jax.random.key(7)
    u = np.asarray(rng.uniform1(key, ids, 0, 0, Purpose.LIGHT_TYPE), float)
    assert (u < 0.3).any() and ((u >= 0.3) & (u < 0.8)).any() \
        and (u >= 0.8).any()
