"""BVH build + traversal correctness vs a brute-force oracle.

The reference has no tests (SURVEY.md §4); this suite anchors the BVH on
exhaustive comparison against O(rays x tris) intersection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_ray_tracer_tpu.bvh.builder import build_bvh, bvh_depth
from physically_based_ray_tracer_tpu.bvh.types import decode_leaf, encode_leaf
from physically_based_ray_tracer_tpu.ops.intersect import brute_force_intersect
from physically_based_ray_tracer_tpu.ops.traverse import intersect_any, intersect_closest


def random_tris(rng, n, spread=0.05):
    c = rng.uniform(0, 1, (n, 1, 3))
    return (c + rng.uniform(-spread, spread, (n, 3, 3))).astype(np.float32)


def random_rays(rng, b):
    o = rng.uniform(-0.2, 1.2, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def oracle(tri, o, d):
    v0 = tri[:, 0]
    return brute_force_intersect(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
        jnp.asarray(tri[:, 1] - v0), jnp.asarray(tri[:, 2] - v0))


def test_leaf_encoding_roundtrip():
    for first, count in [(0, 0), (0, 4), (123456, 3), (10_000_000, 15)]:
        f, c = decode_leaf(encode_leaf(first, count))
        assert (f, c) == (first, count)


@pytest.mark.parametrize("n_tris", [1, 3, 4, 5, 37, 500])
def test_closest_hit_matches_brute_force(n_tris):
    rng = np.random.default_rng(n_tris)
    tri = random_tris(rng, n_tris)
    bvh = build_bvh(tri).to_device()
    o, d = random_rays(rng, 128)
    hit = jax.jit(lambda o, d: intersect_closest(bvh, o, d))(o, d)
    ref = oracle(tri, o, d)
    np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(ref.prim))
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(ref.t), rtol=1e-4, atol=1e-5)
    m = np.asarray(hit.prim) >= 0
    np.testing.assert_allclose(np.asarray(hit.u)[m], np.asarray(ref.u)[m], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(hit.v)[m], np.asarray(ref.v)[m], rtol=1e-3, atol=1e-4)


def test_any_hit_matches_closest_validity():
    rng = np.random.default_rng(7)
    tri = random_tris(rng, 200)
    bvh = build_bvh(tri).to_device()
    o, d = random_rays(rng, 128)
    hit = intersect_closest(bvh, o, d)
    occ = intersect_any(bvh, o, d, jnp.full((128,), 1e30, jnp.float32))
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(hit.prim) >= 0)


def test_any_hit_respects_tmax():
    # single triangle at z=1, rays from origin along +z with varying tmax
    tri = np.asarray([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32)
    bvh = build_bvh(tri).to_device()
    o = np.zeros((2, 3), np.float32)
    d = np.tile(np.asarray([0, 0, 1], np.float32), (2, 1))
    occ = intersect_any(bvh, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray([0.5, 2.0], jnp.float32))
    assert not bool(occ[0]) and bool(occ[1])


def test_tmax_clips_closest():
    tri = np.asarray([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32)
    bvh = build_bvh(tri).to_device()
    o = jnp.zeros((1, 3), jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    near = intersect_closest(bvh, o, d, t_max=jnp.asarray([0.5], jnp.float32))
    assert int(near.prim[0]) == -1


def test_depth_within_stack_bound():
    rng = np.random.default_rng(3)
    tri = random_tris(rng, 2000)
    bvh = build_bvh(tri)
    assert bvh_depth(bvh) < 48


def test_clustered_geometry():
    # degenerate-ish: all centroids nearly identical forces median splits
    rng = np.random.default_rng(11)
    tri = random_tris(rng, 64, spread=1e-7) + np.float32(0.5)
    bvh = build_bvh(tri).to_device()
    o, d = random_rays(rng, 64)
    hit = intersect_closest(bvh, o, d)
    ref = oracle(tri, o, d)
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(ref.t), rtol=1e-4, atol=1e-5)


def test_optimize_bvh_rotations():
    """Tree-rotation optimizer (tinybvh Optimize analogue): SAH does not
    increase and traversal results are unchanged."""
    import jax.numpy as jnp

    from physically_based_ray_tracer_tpu.bvh.builder import (build_bvh,
                                                             optimize_bvh)
    from physically_based_ray_tracer_tpu.bvh.types import BVHArrays, sah_cost
    from physically_based_ray_tracer_tpu.ops.traverse import intersect_closest

    rng = np.random.default_rng(7)
    cl = []
    for _ in range(25):
        c = rng.uniform(-4, 4, 3)
        m = int(rng.integers(5, 80))
        p = c + rng.normal(0, 0.5, (m, 3))
        cl.append(np.stack([p, p + rng.normal(0, 0.1, (m, 3)),
                            p + rng.normal(0, 0.1, (m, 3))], 1))
    tri = np.concatenate(cl).astype(np.float32)
    bvh = build_bvh(tri, leaf_size=4, use_native=False)
    nb = np.array(bvh.nodes_box)
    nc = np.array(bvh.nodes_child)
    c0 = sah_cost(nb, nc)
    n_rot = optimize_bvh(nb, nc, passes=6)
    c1 = sah_cost(nb, nc)
    assert n_rot > 0
    assert c1 <= c0 + 1e-5

    bvh2 = BVHArrays.from_numpy(nb, nc, np.asarray(bvh.tris),
                                np.asarray(bvh.prim_index)).to_device()
    o = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h0 = intersect_closest(bvh.to_device(), jnp.asarray(o), jnp.asarray(d),
                           stack_depth=64, leaf_size=4)
    h1 = intersect_closest(bvh2, jnp.asarray(o), jnp.asarray(d),
                           stack_depth=64, leaf_size=4)
    np.testing.assert_array_equal(np.asarray(h0.prim), np.asarray(h1.prim))
