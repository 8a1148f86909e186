"""Instance-partitioned (TP-analogue) tracing: equality vs the
single-device union trace on the virtual 8-device mesh, memory scaling,
and occlusion semantics (SURVEY.md §2.5, parallel/object_partition.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from physically_based_ray_tracer_tpu.bvh.dense import build_dense_tlas
from physically_based_ray_tracer_tpu.config import BVH_FAR
from physically_based_ray_tracer_tpu.ops.traverse_dense import (
    intersect_any_dense, intersect_closest_dense)
from physically_based_ray_tracer_tpu.parallel.object_partition import (
    partition_instances, partitioned_any, partitioned_closest)
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere


def _scene(n_inst=6):
    """n_inst well-separated instances of two meshes + a floor quad —
    separation guarantees unique closest winners (no cross-instance
    t-ties), so partitioned == single-device EXACTLY."""
    sph = make_sphere(radius=0.8, lat=10, lon=14)[0].reshape(-1, 3, 3)
    quad = make_quad([-9, -1, -9], [9, -1, -9], [9, -1, 9],
                     [-9, -1, 9])[0].reshape(-1, 3, 3)
    mesh_tris = [sph.astype(np.float32), quad.astype(np.float32)]
    inst_mesh, tf = [], []
    for i in range(n_inst):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = (i % 3) * 2.5 - 2.5
        t[2, 3] = (i // 3) * 2.5 - 1.25
        inst_mesh.append(i % 2)
        tf.append(t)
    return mesh_tris, np.array(inst_mesh), np.stack(tf)


def _rays(B=1024):
    rng = np.random.RandomState(5)
    o = np.tile(np.array([[0.0, 2.0, 8.0]], np.float32), (B, 1))
    o += rng.randn(B, 3).astype(np.float32) * 0.3
    aim = rng.uniform(-3.5, 3.5, (B, 3)).astype(np.float32)
    aim[:, 1] = rng.uniform(-1.0, 1.5, B)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def setup():
    mesh_tris, inst_mesh, tf = _scene()
    mesh = Mesh(np.array(jax.devices()[:8]), ("obj",))
    ps = partition_instances(mesh_tris, inst_mesh, tf, n_shards=8)
    gdb, _meta, _dep = build_dense_tlas(mesh_tris, inst_mesh, tf,
                                        leaf_target=16)
    return mesh, ps, gdb


def test_partitioned_closest_equals_union(setup):
    mesh, ps, gdb = setup
    o, d = _rays()
    ref = intersect_closest_dense(gdb, o, d)
    got = partitioned_closest(ps, mesh, o, d, sort=False)
    assert (np.asarray(ref.prim >= 0).mean() > 0.5), "scene mostly hit"
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))
    np.testing.assert_array_equal(np.asarray(got.inst), np.asarray(ref.inst))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u))
    np.testing.assert_allclose(np.asarray(got.v), np.asarray(ref.v))


def test_partitioned_any_equals_union(setup):
    mesh, ps, gdb = setup
    o, d = _rays()
    tmax = jnp.full((o.shape[0],), 6.0, jnp.float32)
    ref = intersect_any_dense(gdb, o, d, tmax)
    got = partitioned_any(ps, mesh, o, d, tmax, sort=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # dead rays never occlude
    got0 = partitioned_any(ps, mesh, o, d, jnp.zeros_like(tmax),
                           sort=False)
    assert not np.asarray(got0).any()


def test_partitioned_memory_scales(setup):
    """The point of the TP analogue: per-shard tables are a FRACTION of
    the union scene's (each shard ships only its instances' meshes)."""
    _mesh, ps, gdb = setup
    per_shard_groups = ps.dbvh.groups.shape[1]
    union_groups = gdb.groups.shape[0]
    assert per_shard_groups < union_groups, (per_shard_groups, union_groups)


def test_partitioned_empty_shards():
    """More shards than instances: dummy shards never contribute hits."""
    mesh_tris, inst_mesh, tf = _scene(n_inst=3)
    mesh = Mesh(np.array(jax.devices()[:8]), ("obj",))
    ps = partition_instances(mesh_tris, inst_mesh, tf, n_shards=8)
    gdb, _m, _d = build_dense_tlas(mesh_tris, inst_mesh, tf,
                                   leaf_target=16)
    o, d = _rays(512)
    ref = intersect_closest_dense(gdb, o, d)
    got = partitioned_closest(ps, mesh, o, d, sort=False)
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))
    np.testing.assert_array_equal(
        np.asarray(got.t < BVH_FAR * 0.5), np.asarray(ref.t < BVH_FAR * 0.5))
