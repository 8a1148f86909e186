"""The default engine's plain traversal and the CUDA kernel's wrapper.

The plain traversal (ops/traverse_dense.plain_trace) is checked against the
brute-force oracle; the kernel itself runs only on the card
(tests/test_gpu.py), so here its wrapper is checked through lowering: the
FFI call's operands and attributes, the dispatch per platform, the nvcc
command and the failure when the toolchain is missing."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_ray_tracer_tpu.bvh.dense import build_dense, build_dense_tlas
from physically_based_ray_tracer_tpu.ops import cuda_ffi, traverse_dense as td
from physically_based_ray_tracer_tpu.ops.intersect import brute_force_intersect
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere
from physically_based_ray_tracer_tpu.utils.math import compose_trs


def _tlas_scene():
    sph = make_sphere(radius=1.0, lat=8, lon=12)[0].reshape(-1, 3, 3)
    quad = make_quad([-6, -1, -6], [6, -1, -6], [6, -1, 6],
                     [-6, -1, 6])[0].reshape(-1, 3, 3)
    meshes = [sph.astype(np.float32), quad.astype(np.float32)]
    inst_mesh = np.array([0, 0, 0, 1])
    tfs = np.stack([compose_trs((-2.0, 0, 0), (0, 0.3, 0), (0.8, 0.8, 0.8)),
                    compose_trs((0.0, 0.5, 1.0), (0.2, 0, 0), (1, 1, 1)),
                    compose_trs((2.0, 0, -1.0), (0, 0, 0.4), (0.6, 1.2, 0.6)),
                    compose_trs((0, 0, 0), (0, 0, 0), (1, 1, 1))])
    world = np.concatenate([
        (meshes[m].reshape(-1, 3) @ tfs[i][:3, :3].T + tfs[i][:3, 3])
        .reshape(-1, 3, 3) for i, m in enumerate(inst_mesh)]).astype(np.float32)
    dbvh, _, _ = build_dense_tlas(meshes, inst_mesh, tfs.astype(np.float32),
                                  leaf_target=16)
    return dbvh, world


def _rays(n, seed=0, radius=9.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    d = rng.normal(size=(n, 3)).astype(np.float32) * 1.5 - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _brute(world, o, d):
    return brute_force_intersect(o, d, jnp.asarray(world[:, 0]),
                                 jnp.asarray(world[:, 1] - world[:, 0]),
                                 jnp.asarray(world[:, 2] - world[:, 0]))


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_two_level_vs_world_baked_brute_force(mode):
    dbvh, world = _tlas_scene()
    o, d = _rays(700, seed=3)
    ref = _brute(world, o, d)
    t_ref = np.asarray(ref.t)
    has = t_ref < 1e29
    if mode == "closest":
        got = td.intersect_closest_dense(dbvh, o, d)
        np.testing.assert_array_equal(np.asarray(got.prim >= 0), has)
        np.testing.assert_allclose(np.asarray(got.t)[has], t_ref[has],
                                   rtol=2e-4)
        assert (np.asarray(got.prim) == np.asarray(ref.prim)).mean() > 0.98
    else:
        tmax = jnp.asarray(np.where(has, t_ref * 1.01, 50.0), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(td.intersect_any_dense(dbvh, o, d, tmax)), has)
        tmax = jnp.asarray(np.where(has, t_ref * 0.99, 0.0), jnp.float32)
        assert not np.asarray(td.intersect_any_dense(dbvh, o, d, tmax)).any()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_parallel_directions(axis):
    """Directions with two exactly-zero components (the slab test's
    reciprocal clamp) hit what brute force hits."""
    tri = np.concatenate([
        make_sphere(radius=1.0, lat=8, lon=12)[0].reshape(-1, 3, 3),
        make_quad([-3, -1.5, -3], [3, -1.5, -3], [3, -1.5, 3],
                  [-3, -1.5, 3])[0].reshape(-1, 3, 3)]).astype(np.float32)
    dbvh, _ = build_dense(tri, leaf_target=8)
    # off the mesh's vertex coordinates: a ray lying exactly in a box face
    # plane is culled (exit distance 0), while brute force may graze an edge
    g = np.linspace(-1.4, 1.4, 15, dtype=np.float32) + np.float32(0.0123)
    u, v = np.meshgrid(g, g)
    o = np.zeros((u.size * 2, 3), np.float32)
    other = [a for a in range(3) if a != axis]
    o[:, other[0]] = np.tile(u.ravel(), 2)
    o[:, other[1]] = np.tile(v.ravel(), 2)
    o[:, axis] = np.repeat([-5.0, 5.0], u.size)
    d = np.zeros_like(o)
    d[:, axis] = np.repeat([1.0, -1.0], u.size)
    o, d = jnp.asarray(o), jnp.asarray(d)
    ref = _brute(tri, o, d)
    got = td.intersect_closest_dense(dbvh, o, d)
    np.testing.assert_array_equal(np.asarray(got.prim >= 0),
                                  np.asarray(ref.prim >= 0))
    hit = np.asarray(ref.prim) >= 0
    assert hit.any()
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)


@pytest.mark.parametrize("engine", ["dense", "lane"])
def test_exact_ties_go_to_the_lowest_prim_id(engine):
    """Every triangle of a sphere appears twice under shuffled ids, so each
    hit is an exact t tie; both engines return the lowest id, as brute
    force does, whatever order their trees visit the copies in."""
    from physically_based_ray_tracer_tpu.bvh.builder import build_bvh
    from physically_based_ray_tracer_tpu.ops.traverse import intersect_closest

    sph = make_sphere(radius=1.0, lat=8, lon=12)[0].reshape(-1, 3, 3)
    tri = np.concatenate([sph, sph]).astype(np.float32)
    tri = tri[np.random.default_rng(7).permutation(len(tri))]
    o, d = _rays(400, seed=11, radius=4.0)
    ref = _brute(tri, o, d)
    if engine == "dense":
        got = td.intersect_closest_dense(build_dense(tri, leaf_target=4)[0],
                                         o, d)
    else:
        got = intersect_closest(build_bvh(tri, leaf_size=4).to_device(), o, d,
                                leaf_size=4)
    hit = np.asarray(ref.prim) >= 0
    assert hit.sum() > 50
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))


def test_stack_overflow_clamped_and_flagged():
    tri = make_sphere(radius=1.0, lat=12, lon=18)[0].reshape(-1, 3, 3)
    dbvh, depth = build_dense(tri.astype(np.float32), leaf_target=1)
    assert depth > 4
    o, d = _rays(256, seed=5, radius=4.0)
    comps = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    tmax = jnp.full((256,), 1e30, jnp.float32)
    args = (dbvh.nodes16, dbvh.groups, dbvh.inst16, *comps, tmax)
    kw = dict(closest=True, max_steps=td.max_steps(dbvh))
    *_, flags_small = td.plain_trace(*args, stack_depth=1, **kw)
    t, u, v, prim, inst, flags_big = td.plain_trace(*args, stack_depth=64,
                                                    **kw)
    flags_small, flags_big = np.asarray(flags_small), np.asarray(flags_big)
    assert (flags_small & td.FLAG_STACK_OVERFLOW).any()
    assert not flags_big.any()
    # the full-depth result is the brute-force answer
    ref = _brute(tri.astype(np.float32), o, d)
    np.testing.assert_array_equal(np.asarray(prim) >= 0,
                                  np.asarray(ref.prim) >= 0)
    with pytest.raises(ValueError):
        td.plain_trace(*args, stack_depth=td.MAX_STACK + 1, **kw)


def _lowered_text(fn, *args, platform):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


def test_ffi_call_operands_and_attributes():
    """The wrapper hands the kernel the three tables and seven (B,) ray
    component arrays, asks for six (B,) results, and passes the stack
    depth and step bound as its only attributes."""
    tri = make_sphere(radius=1.0, lat=6, lon=8)[0].reshape(-1, 3, 3)
    dbvh, _ = build_dense(tri.astype(np.float32))
    o, d = _rays(37)

    def f(o, d):
        return td.intersect_closest_dense(dbvh, o, d, stack_depth=40)

    txt = _lowered_text(f, o, d, platform="cuda")
    line = next(ln for ln in txt.splitlines()
                if f"@{cuda_ffi.CLOSEST_TARGET}(" in ln)
    assert line.count("%") >= 10
    assert "stack_depth = 40" in line and "block" not in line
    assert f"max_steps = {td.max_steps(dbvh)}" in line
    sig = line.split(" : ")[-1]
    assert sig.count("tensor<37xf32>") == 7 + 3    # 7 ray inputs, t/u/v
    assert sig.count("tensor<37xi32>") == 3        # prim, inst, flags


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_engine_dispatch_per_platform(platform):
    """traversal="dense" lowers to the FFI kernel for CUDA and to the plain
    while-loop traversal elsewhere."""
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.integrator import (Accel,
                                                                   _anyhit,
                                                                   _closest)
    tri = make_sphere(radius=1.0, lat=6, lon=8)[0].reshape(-1, 3, 3)
    dbvh, _ = build_dense(tri.astype(np.float32))
    accel = Accel(None, dbvh)
    cfg = RenderConfig(traversal="dense", max_stack_depth=24)
    o, d = _rays(64)

    def f(o, d):
        hit = _closest(accel, cfg, o, d, sort=True)
        occ = _anyhit(accel, cfg, o, d, hit.t * 0.5, sort=True)
        return hit.t, occ

    txt = _lowered_text(f, o, d, platform=platform)
    has_ffi = (cuda_ffi.CLOSEST_TARGET in txt, cuda_ffi.ANY_TARGET in txt)
    if platform == "cuda":
        assert has_ffi == (True, True)
    else:
        assert has_ffi == (False, False)
        assert "stablehlo.while" in txt


def test_nvcc_command_targets_hopper_from_tracked_source():
    cmd = cuda_ffi.nvcc_command("/usr/local/cuda/bin/nvcc", "/x/lib.so")
    joined = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in joined
    assert "--use_fast_math" not in joined and "--fmad=false" in cmd
    assert cmd[-1] == cuda_ffi.SOURCE and os.path.exists(cuda_ffi.SOURCE)
    assert cuda_ffi.SOURCE.startswith(cuda_ffi.PKG_DIR)
    assert jax.ffi.include_dir() in cmd
    lib = cuda_ffi.library_path()
    assert os.path.dirname(lib) == os.path.join(cuda_ffi.REPO_DIR, "build")
    assert cuda_ffi.source_digest() in os.path.basename(lib)


def test_missing_toolchain_raises_on_gpu_backend(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_ffi, "gpu_backend_present", lambda: True)
    monkeypatch.setattr(cuda_ffi, "nvcc_path", lambda: None)
    monkeypatch.setattr(cuda_ffi, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_ffi, "_registered", False)
    tri = make_sphere(radius=1.0, lat=6, lon=8)[0].reshape(-1, 3, 3)
    dbvh, _ = build_dense(tri.astype(np.float32))
    o, d = _rays(8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        jax.jit(lambda o, d: td.intersect_closest_dense(dbvh, o, d).t
                ).trace(o, d)


def test_zero_tangent_through_traversal():
    """Traversal inputs are detached: differentiating through a hit record
    gives zero, not an error, on every lowering."""
    tri = make_sphere(radius=1.0, lat=6, lon=8)[0].reshape(-1, 3, 3)
    dbvh, _ = build_dense(tri.astype(np.float32))
    o, d = _rays(16)
    def f(o):
        hit = td.intersect_closest_dense(dbvh, o, d)
        return jnp.sum(jnp.where(hit.prim >= 0, hit.t + hit.u, 0.0))

    g = jax.grad(f)(o)
    assert np.array_equal(np.asarray(g), np.zeros_like(np.asarray(o)))


def test_gradient_step_lowers_with_kernel():
    """jax.grad of the render loss traces and lowers for CUDA with the FFI
    kernel in place (the integrator detaches traversal inputs)."""
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.diff.grad import (apply_params,
                                                           render_color)
    from tests.scenes import sphere_scene

    scene, cam = sphere_scene()
    cfg = RenderConfig(width=8, height=8, bounces=1, antialias=False,
                       skybox=False, max_stack_depth=24)
    ids = jnp.arange(64, dtype=jnp.int32)

    def loss(base):
        s, c = apply_params(scene, cam, {"base_color": base})
        return jnp.mean(render_color(s, c, cfg, jax.random.key(0), 0, ids))

    txt = _lowered_text(jax.grad(loss), scene.mat_base, platform="cuda")
    assert cuda_ffi.CLOSEST_TARGET in txt and cuda_ffi.ANY_TARGET in txt
