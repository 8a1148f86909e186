"""Two-level (TLAS) dense BVH vs brute force over baked world geometry.

Covers the role of tinybvh's IntersectTLAS/IsOccludedTLAS
(Core/tiny_bvh.h:2500-2565, :2611-2666): shared BLAS per mesh, per-instance
inverse transforms, restore-sentinel stack discipline, prim_base mapping,
and the cheap refresh_tlas() transform update."""

import jax.numpy as jnp
import numpy as np

from physically_based_ray_tracer_tpu.bvh.dense import (build_dense_tlas,
                                                       refresh_tlas)
from physically_based_ray_tracer_tpu.ops.intersect import brute_force_intersect
from physically_based_ray_tracer_tpu.ops.traverse_dense import (
    intersect_any_dense, intersect_closest_dense)
from physically_based_ray_tracer_tpu.scene.procedural import (make_quad,
                                                              make_sphere)
from physically_based_ray_tracer_tpu.utils.math import compose_trs


def _meshes():
    sph = make_sphere(radius=1.0, lat=10, lon=14)[0].reshape(-1, 3, 3)
    quad = make_quad([-9, -1, -9], [9, -1, -9], [9, -1, 9], [-9, -1, 9])[0]
    return [sph.astype(np.float32), quad.reshape(-1, 3, 3).astype(np.float32)]


def _instances():
    """3x3 sphere grid (one shared BLAS) + one floor quad, varied TRS."""
    inst_mesh, tf = [], []
    for gx in range(3):
        for gz in range(3):
            inst_mesh.append(0)
            s = 0.5 + 0.25 * ((gx + gz) % 3)
            tf.append(compose_trs((2.5 * gx - 2.5, 0.0, 2.5 * gz - 2.5),
                                  (0.0, 0.4 * gx, 0.2 * gz), (s, s, s)))
    inst_mesh.append(1)
    tf.append(compose_trs((0, 0, 0), (0, 0, 0), (1, 1, 1)))
    return np.asarray(inst_mesh), np.stack(tf).astype(np.float32)


def _bake(meshes, inst_mesh, tf):
    """World triangles in the global per-instance-concatenated prim order."""
    out = []
    for i, m in enumerate(inst_mesh):
        tri = meshes[m]
        w = tri.reshape(-1, 3) @ tf[i][:3, :3].T + tf[i][:3, 3]
        out.append(w.reshape(-1, 3, 3))
    return np.concatenate(out).astype(np.float32)


def _rays(n, seed=0, radius=10.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    target = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_tlas_closest_vs_brute_force():
    meshes = _meshes()
    inst_mesh, tf = _instances()
    dbvh, meta, depth = build_dense_tlas(meshes, inst_mesh, tf,
                                         leaf_target=32)
    assert depth >= 2
    world = _bake(meshes, inst_mesh, tf)
    o, d = _rays(1500)
    ref = brute_force_intersect(o, d, jnp.asarray(world[:, 0]),
                                jnp.asarray(world[:, 1] - world[:, 0]),
                                jnp.asarray(world[:, 2] - world[:, 0]))
    got = intersect_closest_dense(dbvh, o, d)
    np.testing.assert_array_equal(np.asarray(got.prim >= 0),
                                  np.asarray(ref.prim >= 0))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=2e-4, atol=2e-5)
    same = np.asarray(got.prim) == np.asarray(ref.prim)
    assert same.mean() > 0.98
    # instance ids must match the baked prim ranges
    counts = [meshes[m].shape[0] for m in inst_mesh]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    gp = np.asarray(got.prim)
    gi = np.asarray(got.inst)
    ok = gp >= 0
    expect_inst = np.searchsorted(starts, gp[ok], side="right") - 1
    np.testing.assert_array_equal(gi[ok], expect_inst)


def test_tlas_anyhit():
    meshes = _meshes()
    inst_mesh, tf = _instances()
    dbvh, _, _ = build_dense_tlas(meshes, inst_mesh, tf, leaf_target=32)
    world = _bake(meshes, inst_mesh, tf)
    o, d = _rays(1024, seed=5)
    ref = brute_force_intersect(o, d, jnp.asarray(world[:, 0]),
                                jnp.asarray(world[:, 1] - world[:, 0]),
                                jnp.asarray(world[:, 2] - world[:, 0]))
    t_ref = np.asarray(ref.t)
    has = t_ref < 1e29
    tmax = np.where(has, t_ref * 1.5, 100.0).astype(np.float32)
    occ = np.asarray(intersect_any_dense(dbvh, o, d, jnp.asarray(tmax)))
    np.testing.assert_array_equal(occ, has)
    tmax = np.where(has, t_ref * 0.5, 0.0).astype(np.float32)
    occ = np.asarray(intersect_any_dense(dbvh, o, d, jnp.asarray(tmax)))
    assert not occ.any()


def test_refresh_tlas_moves_instance():
    """Move one instance; refresh (no BLAS/group rebuild) must track it."""
    meshes = _meshes()
    inst_mesh, tf = _instances()
    dbvh, meta, _ = build_dense_tlas(meshes, inst_mesh, tf, leaf_target=32)
    groups_before = dbvh.groups  # same device buffer must survive refresh

    tf2 = tf.copy()
    tf2[4] = compose_trs((0.0, 5.0, 0.0), (0, 0, 0), (1.2, 1.2, 1.2))
    dbvh2 = refresh_tlas(dbvh, meta, tf2)
    assert dbvh2.groups is groups_before

    world = _bake(meshes, inst_mesh, tf2)
    o, d = _rays(900, seed=9)
    ref = brute_force_intersect(o, d, jnp.asarray(world[:, 0]),
                                jnp.asarray(world[:, 1] - world[:, 0]),
                                jnp.asarray(world[:, 2] - world[:, 0]))
    got = intersect_closest_dense(dbvh2, o, d)
    np.testing.assert_array_equal(np.asarray(got.prim >= 0),
                                  np.asarray(ref.prim >= 0))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=2e-4, atol=2e-5)


def test_instanced_scene_renders_like_baked():
    """Full frame through the dense engine: instanced (TLAS) scene ==
    world-baked scene, and rebuild_scene tracks a moved instance."""
    import jax
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.integrator import render_sample
    from physically_based_ray_tracer_tpu.scene.camera import Camera
    from physically_based_ray_tracer_tpu.scene.lights import LightSet
    from physically_based_ray_tracer_tpu.scene.procedural import (make_quad,
                                                                  make_sphere)
    from physically_based_ray_tracer_tpu.scene.scene import (
        Instance, MeshModel, build_scene, build_scene_instanced, rebuild_scene)

    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=10, lon=14),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4)
    floor = MeshModel.from_fat(
        make_quad([-6, -1, -6], [6, -1, -6], [6, -1, 6], [-6, -1, 6]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(point_pos=[[2, 3, 2]],
                           point_color=[[20, 20, 20]]).pad_points(4)
    insts = [Instance(0, position=(-1.5, 0, 0)),
             Instance(0, position=(1.5, 0, 0), scale=(0.7, 0.7, 0.7)),
             Instance(1)]
    cam = Camera.make(pos=(0, 1.5, 5), target=(0, 0, 0))
    cfg = RenderConfig(width=24, height=24, bounces=2, antialias=False,
                       skybox=False, accumulate=False, traversal="dense",
                       max_stack_depth=24)
    key = jax.random.key(0)
    ids = jnp.arange(24 * 24, dtype=jnp.int32)

    baked, _ = build_scene([sphere, floor], insts, lights)
    inst_sc, handle, _ = build_scene_instanced([sphere, floor], insts, lights)
    c_baked, _ = render_sample(baked, cam, cfg, key, 0, ids)
    c_inst, _ = render_sample(inst_sc, cam, cfg, key, 0, ids)
    np.testing.assert_allclose(np.asarray(c_inst), np.asarray(c_baked),
                               rtol=1e-3, atol=1e-4)

    # move one sphere; refresh (no BLAS/group rebuild) vs from-scratch bake
    moved = [Instance(0, position=(-1.5, 0.8, 0.3)),
             insts[1], insts[2]]
    inst_sc2 = rebuild_scene(inst_sc, handle, moved)
    assert inst_sc2.dense.groups is inst_sc.dense.groups
    baked2, _ = build_scene([sphere, floor], moved, lights)
    c_moved, _ = render_sample(inst_sc2, cam, cfg, key, 0, ids)
    c_ref, _ = render_sample(baked2, cam, cfg, key, 0, ids)
    np.testing.assert_allclose(np.asarray(c_moved), np.asarray(c_ref),
                               rtol=1e-3, atol=1e-4)
