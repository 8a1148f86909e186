"""SBVH (spatial-split BuildHQ analogue) build + traversal correctness.

The native SBVH core (bvh/csrc/sbvh_builder.cpp) may reference one triangle
from several leaves; traversal must stay exact vs the brute-force oracle
(the leaf holding the fragment that contains the closest hit is always
visited, and the full triangle is intersected at every reference).
Quality bar: SAH cost at or below the binned-SAH builder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_ray_tracer_tpu.bvh import native
from physically_based_ray_tracer_tpu.bvh.builder import (build_bvh,
                                                         build_bvh_hq,
                                                         bvh_depth)
from physically_based_ray_tracer_tpu.bvh.dense import (LEAF_W, _build_core,
                                                       _build_core_hq,
                                                       build_dense)
from physically_based_ray_tracer_tpu.bvh.types import sah_cost
from physically_based_ray_tracer_tpu.ops.intersect import brute_force_intersect
from physically_based_ray_tracer_tpu.ops.traverse_dense import \
    intersect_closest_dense
from physically_based_ray_tracer_tpu.ops.traverse import (intersect_any,
                                                          intersect_closest)
from physically_based_ray_tracer_tpu.scene.procedural import (make_quad,
                                                              make_sphere)

pytestmark = pytest.mark.skipif(not native.sbvh_available(),
                                reason="native toolchain unavailable")


def _mixed_tris(n_long=60, seed=3):
    """Scene engineered to have centroid-split overlap: long thin diagonal
    triangles spanning the volume (the case spatial splits exist for) mixed
    with a sphere + floor."""
    rng = np.random.default_rng(seed)
    sph = make_sphere(radius=1.0, lat=10, lon=14)[0].reshape(-1, 3, 3)
    quad = make_quad([-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4])[0]
    a = rng.uniform(-3, 3, (n_long, 1, 3))
    b = a + rng.uniform(2.0, 5.0, (n_long, 1, 3)) * rng.choice(
        [-1.0, 1.0], (n_long, 1, 3))
    c = a + rng.uniform(-0.05, 0.05, (n_long, 1, 3))
    long_tris = np.concatenate([a, b, c], axis=1)
    return np.concatenate([sph, quad.reshape(-1, 3, 3),
                           long_tris]).astype(np.float32)


def _rays(n, seed=0, radius=7.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    target = rng.normal(size=(n, 3)).astype(np.float32)
    d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _oracle(tri, o, d):
    v0 = tri[:, 0]
    return brute_force_intersect(o, d, jnp.asarray(v0),
                                 jnp.asarray(tri[:, 1] - v0),
                                 jnp.asarray(tri[:, 2] - v0))


def test_sbvh_duplicates_referenced():
    tri = _mixed_tris()
    bvh = build_bvh_hq(tri, leaf_size=4)
    pid = np.asarray(bvh.prim_index)
    real = pid[pid >= 0]
    # every prim present, and spatial splits produced at least one duplicate
    np.testing.assert_array_equal(np.unique(real), np.arange(tri.shape[0]))
    assert len(real) > tri.shape[0]


def test_sbvh_closest_matches_brute_force():
    tri = _mixed_tris()
    bvh = build_bvh_hq(tri, leaf_size=4).to_device()
    o, d = _rays(512)
    hit = jax.jit(lambda o, d: intersect_closest(bvh, o, d))(o, d)
    ref = _oracle(tri, o, d)
    np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(ref.prim))
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(ref.t),
                               rtol=1e-4, atol=1e-5)


def test_sbvh_anyhit_matches_brute_force():
    tri = _mixed_tris()
    bvh = build_bvh_hq(tri, leaf_size=4).to_device()
    o, d = _rays(512, seed=5)
    ref = _oracle(tri, o, d)
    occ = intersect_any(bvh, o, d, jnp.full((512,), 1e30, jnp.float32))
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref.prim) >= 0)


def test_sbvh_sah_not_worse_than_binned():
    tri = _mixed_tris()
    b_std = build_bvh(tri, leaf_size=4)
    b_hq = build_bvh_hq(tri, leaf_size=4)
    c_std = sah_cost(np.asarray(b_std.nodes_box), np.asarray(b_std.nodes_child))
    c_hq = sah_cost(np.asarray(b_hq.nodes_box), np.asarray(b_hq.nodes_child))
    assert c_hq <= c_std * 1.001, (c_hq, c_std)
    assert bvh_depth(b_hq) < 64


def test_dense_hq_core_contract():
    tri = _mixed_tris()
    out = _build_core_hq(tri, 64)
    assert out is not None
    nodes, segments, depth, lo, hi = out
    assert all(len(s) <= LEAF_W for s in segments)
    ids = np.unique(np.concatenate(segments))
    np.testing.assert_array_equal(ids, np.arange(tri.shape[0]))
    n_std = _build_core(tri, 64)[0]
    # same root bounds as the standard core (geometry unchanged)
    np.testing.assert_allclose(lo, _build_core(tri, 64)[3], atol=1e-5)


def test_dense_hq_closest_vs_brute_force():
    tri = _mixed_tris()
    dbvh, depth = build_dense(tri, leaf_target=32, hq=True)
    o, d = _rays(1024, seed=11)
    ref = _oracle(tri, o, d)
    hit = intersect_closest_dense(dbvh, o, d)
    np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(ref.prim))
    m = np.asarray(hit.prim) >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-4, atol=1e-5)
