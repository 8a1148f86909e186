"""Refit (deformable geometry) + versioned BVH cache.

Refit correctness bar: traversal of a refitted tree must match brute force
on the DEFORMED triangles exactly (boxes must stay conservative after any
deformation; topology unchanged)."""

import jax.numpy as jnp
import numpy as np

from physically_based_ray_tracer_tpu.bvh.builder import build_bvh
from physically_based_ray_tracer_tpu.bvh.cache import (FORMAT_VERSION,
                                                       cached_build_bvh,
                                                       load_bvh, load_dense,
                                                       save_bvh, save_dense)
from physically_based_ray_tracer_tpu.bvh.dense import build_dense
from physically_based_ray_tracer_tpu.bvh.refit import refit_bvh, refit_dense
from physically_based_ray_tracer_tpu.ops.intersect import brute_force_intersect
from physically_based_ray_tracer_tpu.ops.traverse_dense import \
    intersect_closest_dense
from physically_based_ray_tracer_tpu.ops.traverse import intersect_closest
from physically_based_ray_tracer_tpu.scene.procedural import make_sphere


def _deform(tri, amp=0.35, seed=1):
    """Smooth low-frequency deformation (breathing sphere + shear)."""
    t = tri.copy()
    t[..., 1] += amp * np.sin(3.0 * t[..., 0])
    t[..., 0] += 0.2 * t[..., 2]
    return t


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 5.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _oracle(tri, o, d):
    v0 = tri[:, 0]
    return brute_force_intersect(o, d, jnp.asarray(v0),
                                 jnp.asarray(tri[:, 1] - v0),
                                 jnp.asarray(tri[:, 2] - v0))


def test_refit_bvh_matches_brute_force_on_deformed():
    tri = make_sphere(radius=1.0, lat=14, lon=20)[0].reshape(-1, 3, 3)
    bvh = build_bvh(tri, leaf_size=4)
    tri2 = _deform(tri)
    re = refit_bvh(bvh, tri2).to_device()
    o, d = _rays(512)
    hit = intersect_closest(re, o, d)
    ref = _oracle(tri2, o, d)
    np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(ref.prim))
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(ref.t),
                               rtol=1e-4, atol=1e-5)


def test_refit_dense_matches_brute_force_on_deformed():
    tri = make_sphere(radius=1.0, lat=14, lon=20)[0].reshape(-1, 3, 3)
    dbvh, _ = build_dense(tri, leaf_target=32)
    tri2 = _deform(tri, amp=0.5, seed=3)
    re = refit_dense(dbvh, tri2)
    o, d = _rays(1024, seed=7)
    hit = intersect_closest_dense(re, o, d)
    ref = _oracle(tri2, o, d)
    np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(ref.prim))
    m = np.asarray(hit.prim) >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-4, atol=1e-5)


def test_refit_identity_keeps_boxes(tmp_path):
    tri = make_sphere(radius=1.0, lat=8, lon=10)[0].reshape(-1, 3, 3)
    bvh = build_bvh(tri, leaf_size=4)
    re = refit_bvh(bvh, tri)
    # identical geometry -> boxes can only tighten or stay equal
    assert np.all(np.asarray(re.nodes_box)[:, 0:3] >= np.asarray(bvh.nodes_box)[:, 0:3] - 1e-5)
    np.testing.assert_array_equal(np.asarray(re.nodes_child),
                                  np.asarray(bvh.nodes_child))


def test_cache_roundtrip_and_versioning(tmp_path):
    tri = make_sphere(radius=1.0, lat=8, lon=10)[0].reshape(-1, 3, 3)
    bvh = build_bvh(tri, leaf_size=4)
    p = str(tmp_path / "mesh.bvh.npz")
    save_bvh(p, bvh, tri, params="leaf4")
    got = load_bvh(p, tri, params="leaf4")
    assert got is not None
    np.testing.assert_array_equal(np.asarray(got.nodes_box),
                                  np.asarray(bvh.nodes_box))
    np.testing.assert_array_equal(np.asarray(got.prim_index),
                                  np.asarray(bvh.prim_index))
    # different build params -> miss
    assert load_bvh(p, tri, params="leaf16") is None
    # different geometry -> miss
    assert load_bvh(p, tri * 1.01, params="leaf4") is None
    # wrong layout -> miss
    dbvh, _ = build_dense(tri)
    pd = str(tmp_path / "mesh.dense.npz")
    save_dense(pd, dbvh, tri)
    assert load_bvh(pd, tri) is None
    got_d = load_dense(pd, tri)
    assert got_d is not None
    np.testing.assert_array_equal(np.asarray(got_d.nodes16),
                                  np.asarray(dbvh.nodes16))


def test_cached_build_helper(tmp_path):
    tri = make_sphere(radius=1.0, lat=6, lon=8)[0].reshape(-1, 3, 3)
    p = str(tmp_path / "c.npz")
    calls = []

    def builder(t):
        calls.append(1)
        return build_bvh(t, leaf_size=4)

    b1, hit1 = cached_build_bvh(p, tri, builder)
    b2, hit2 = cached_build_bvh(p, tri, builder)
    assert (hit1, hit2) == (False, True)
    assert len(calls) == 1
    np.testing.assert_array_equal(np.asarray(b1.nodes_box),
                                  np.asarray(b2.nodes_box))
