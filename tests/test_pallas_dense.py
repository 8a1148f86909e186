"""Dense-leaf BVH + its traversal vs the brute-force oracle.

Runs the plain traversal (the CPU lowering of the default engine); the CUDA
kernel is compared with it on the card by tests/test_gpu.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_ray_tracer_tpu.bvh.dense import LEAF_W, build_dense
from physically_based_ray_tracer_tpu.ops.intersect import brute_force_intersect
from physically_based_ray_tracer_tpu.ops.traverse_dense import (
    intersect_any_dense, intersect_closest_dense, sorted_closest_dense)
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere


def _scene_tris():
    sph = make_sphere(radius=1.0, lat=12, lon=18)[0].reshape(-1, 3, 3)
    quad = make_quad([-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4])[0]
    quad = quad.reshape(-1, 3, 3)
    return np.concatenate([sph, quad]).astype(np.float32)


def _rays(n, seed=0, radius=6.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    target = rng.normal(size=(n, 3)).astype(np.float32) * 0.7
    d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_build_dense_structure():
    tri = _scene_tris()
    dbvh, depth = build_dense(tri, leaf_target=32)
    assert dbvh.groups.shape[1] == LEAF_W
    assert dbvh.n_nodes >= 1 and depth >= 1
    # every original prim appears across groups (cyclic replication means a
    # prim may appear several times within its own group — never across two)
    grp = np.asarray(dbvh.groups).reshape(-1, 16, LEAF_W)[:, 9, :]
    real = np.unique(grp[grp >= 0]).astype(np.int64)
    np.testing.assert_array_equal(real, np.arange(tri.shape[0]))
    for row in grp:
        ids = np.unique(row[row >= 0])
        # within one group the replication is exact cyclic tiling
        k = len(ids)
        c = 1 << int(np.ceil(np.log2(max(k, 1))))
        block = row[:c]
        np.testing.assert_array_equal(row, np.tile(block, LEAF_W // c))


@pytest.mark.parametrize("n_rays", [777, 2048])
def test_closest_vs_brute_force(n_rays):
    tri = _scene_tris()
    dbvh, _ = build_dense(tri, leaf_target=32)
    o, d = _rays(n_rays)
    v0 = jnp.asarray(tri[:, 0])
    e1 = jnp.asarray(tri[:, 1] - tri[:, 0])
    e2 = jnp.asarray(tri[:, 2] - tri[:, 0])

    ref = brute_force_intersect(o, d, v0, e1, e2)
    got = intersect_closest_dense(dbvh, o, d)
    np.testing.assert_array_equal(np.asarray(got.prim >= 0),
                                  np.asarray(ref.prim >= 0))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-4, atol=1e-5)
    # u/v only comparable when both picked the same triangle (shared-edge
    # ties can legitimately resolve differently)
    same = np.asarray(got.prim) == np.asarray(ref.prim)
    assert same.mean() > 0.98
    np.testing.assert_allclose(np.asarray(got.u)[same], np.asarray(ref.u)[same],
                               rtol=1e-3, atol=1e-4)


def test_closest_respects_tmax():
    tri = _scene_tris()
    dbvh, _ = build_dense(tri)
    o, d = _rays(512, seed=3)
    ref = brute_force_intersect(o, d, jnp.asarray(tri[:, 0]),
                                jnp.asarray(tri[:, 1] - tri[:, 0]),
                                jnp.asarray(tri[:, 2] - tri[:, 0]))
    t_ref = np.asarray(ref.t)
    cut = np.where(t_ref < 1e29, t_ref * 0.5, 1.0).astype(np.float32)
    got = intersect_closest_dense(dbvh, o, d, jnp.asarray(cut))
    # nothing may be found at-or-beyond the clip
    found = np.asarray(got.prim) >= 0
    assert np.all(np.asarray(got.t)[found] < cut[found])


def test_anyhit_vs_brute_force():
    tri = _scene_tris()
    dbvh, _ = build_dense(tri, leaf_target=48)
    o, d = _rays(1024, seed=7)
    ref = brute_force_intersect(o, d, jnp.asarray(tri[:, 0]),
                                jnp.asarray(tri[:, 1] - tri[:, 0]),
                                jnp.asarray(tri[:, 2] - tri[:, 0]))
    t_ref = np.asarray(ref.t)
    # three tmax regimes: beyond hit (occluded), before hit (clear), zero
    for scale, expect_from_t in ((1.5, True), (0.5, False)):
        tmax = np.where(t_ref < 1e29, t_ref * scale, 100.0).astype(np.float32)
        occ = np.asarray(intersect_any_dense(dbvh, o, d, jnp.asarray(tmax)))
        has_hit = t_ref < 1e29
        if expect_from_t:
            np.testing.assert_array_equal(occ, has_hit)
        else:
            assert not occ[has_hit].any()
    occ0 = np.asarray(intersect_any_dense(
        dbvh, o, d, jnp.zeros((o.shape[0],), jnp.float32)))
    assert not occ0.any()


def test_sorted_wrapper_matches_unsorted():
    tri = _scene_tris()
    dbvh, _ = build_dense(tri)
    o, d = _rays(800, seed=11)
    a = intersect_closest_dense(dbvh, o, d)
    b = sorted_closest_dense(dbvh, o, d)
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.prim >= 0),
                                  np.asarray(b.prim >= 0))


def test_integrator_pallas_matches_wave():
    """Full 2-bounce frame: the default dense engine == wave traversal
    radiance (same predicate, different schedule)."""
    from tests.scenes import sphere_scene
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.integrator import render_sample

    scene, cam = sphere_scene()
    key = jax.random.key(0)
    ids = jnp.arange(24 * 24, dtype=jnp.int32)
    base = RenderConfig(width=24, height=24, bounces=2, antialias=False,
                        skybox=False, accumulate=False)
    c_wave, _ = render_sample(scene, cam, base.replace(traversal="wave"),
                              key, 0, ids)
    c_dense, _ = render_sample(scene, cam, base.replace(traversal="dense"),
                               key, 0, ids)
    np.testing.assert_allclose(np.asarray(c_dense), np.asarray(c_wave),
                               rtol=2e-4, atol=2e-5)
