"""Smoke test of the renderer on one NVIDIA GPU (H100 class).

    python chip_smoke.py                # all one-card phases, in order
    python chip_smoke.py --four-cards   # only the four-card path (4 GPUs)

One-card phases, one JAX process:
  1. device: JAX's platform / kind / count and the card's name and power
     limit (nvidia-smi); fails unless the platform is "gpu";
  2. build: the CUDA traversal library (set-up time);
  3. kernel vs plain: the flagship scene's primary (1280x720x2), cosine
     bounce and point-light shadow wavefronts through the CUDA kernel, the
     plain dense traversal and the lane engine, closest and any hit;
  4. frame: three Renderer.tick() frames of the flagship config; the
     compiled frame must hold the FFI custom calls; the image is compared
     with the same frames under traversal="lane"; then the CLI once;
  5. gradient: one inverse-rendering train step, compared with the same
     step under traversal="lane";
  6. card-only tests: pytest -m gpu, in this process.
The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
and it is printed only when every phase passed.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# Agreement bounds (f32). Kernel vs the plain dense traversal: prim equal on
# >= 99.999% of rays, every mismatch a tie (both hit, t within 1e-5
# relative), t of equal prims within 1e-6 relative; occlusion flags equal on
# >= 99.999%. Against the lane engine the same, except t of equal prims
# within 1e-5: its Moller-Trumbore (ops/intersect.py) associates the dot
# products differently, so t differs by a few rounding steps.
PRIM_AGREE = 0.99999
TIE_RTOL = 1e-5
T_RTOL = 1e-6
T_RTOL_LANE = 1e-5
OCC_AGREE = 0.99999
# Frame vs traversal="lane": the goldens' own bounds
# (tests/test_golden_configs.py _check).
IMG_MSE = 1e-5
IMG_MAX_ABS = 6.0 / 255.0
# Four cards, tile-sharded and ring-resharded frames vs the one-card frame
# (max abs of the HDR pixel values). Each is another XLA program, which
# fuses and rounds the shading arithmetic its own way, so a path's last bits
# differ: on four H100s up to 1.0e-4 over ~1,300 pixels, with every traced
# path taking the same hits (PERF.md). A lane sent to the wrong pixel moves
# that pixel by ~0.1.
FOUR_CARD_MAX_ABS = 2e-4
# Gradient step vs traversal="lane" (and the sharded step vs the one-card
# step): relative L2 error of each gradient leaf and relative error of the
# loss. Measured on H100s: at most 3.5e-6; f32 products rounded to TF32
# would drift by ~1e-3.
GRAD_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# comparisons (pure numpy; also exercised on the CPU by the tests)
# --------------------------------------------------------------------------

def compare_closest(a, b, t_rtol: float = T_RTOL) -> dict:
    """a, b: Hit records (global prim ids) of the same rays."""
    pa, pb = np.asarray(a.prim), np.asarray(b.prim)
    ta, tb = np.asarray(a.t, np.float64), np.asarray(b.t, np.float64)
    eq = pa == pb
    both = (pa >= 0) & (pb >= 0)
    scale = np.maximum(np.maximum(np.abs(ta), np.abs(tb)), 1e-30)
    tie = both & (np.abs(ta - tb) <= TIE_RTOL * scale)
    bad = ~eq & ~tie
    hit_eq = eq & (pa >= 0)
    t_rel = float(np.max(np.abs(ta - tb)[hit_eq] / scale[hit_eq])) \
        if hit_eq.any() else 0.0
    agree = float(eq.mean())
    return {"rays": int(pa.size), "prim_agree": agree,
            "mismatches": int((~eq).sum()), "non_tie_mismatches": int(bad.sum()),
            "max_t_rel_equal_prim": t_rel,
            "ok": bool(agree >= PRIM_AGREE and bad.sum() == 0
                       and t_rel <= t_rtol)}


def compare_any(a, b) -> dict:
    a, b = np.asarray(a), np.asarray(b)
    agree = float((a == b).mean())
    return {"rays": int(a.size), "occ_agree": agree,
            "mismatches": int((a != b).sum()), "ok": bool(agree >= OCC_AGREE)}


def compare_images(a, b) -> dict:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    mx = float(np.max(np.abs(a - b)))
    return {"mse": mse, "max_abs": mx,
            "ok": bool(mse < IMG_MSE and mx < IMG_MAX_ABS)}


def compare_grads(loss_a, grads_a, loss_b, grads_b) -> dict:
    import jax

    rel = {}
    for path, ga in jax.tree_util.tree_leaves_with_path(grads_a):
        gb = dict(jax.tree_util.tree_leaves_with_path(grads_b))[path]
        ga, gb = np.asarray(ga, np.float64), np.asarray(gb, np.float64)
        rel[jax.tree_util.keystr(path)] = float(
            np.linalg.norm(ga - gb) / max(np.linalg.norm(gb), 1e-30))
    la, lb = float(loss_a), float(loss_b)
    loss_rel = abs(la - lb) / max(abs(lb), 1e-30)
    finite = bool(np.isfinite(la) and all(
        np.isfinite(np.asarray(g)).all()
        for g in jax.tree_util.tree_leaves(grads_a)))
    # a comparison of all-zero gradients would prove nothing
    nonzero = any(np.any(np.asarray(g) != 0)
                  for g in jax.tree_util.tree_leaves(grads_b))
    return {"loss": la, "loss_ref": lb, "loss_rel": loss_rel,
            "grad_rel_l2": rel, "finite": finite, "nonzero": nonzero,
            "ok": bool(finite and nonzero and loss_rel <= GRAD_RTOL
                       and max(rel.values()) <= GRAD_RTOL)}


# --------------------------------------------------------------------------
# wavefronts of the flagship scene
# --------------------------------------------------------------------------

def primary_wavefront(cam, cfg):
    """Both AA sub-rays of every pixel, in Morton pixel order (as the
    Renderer issues them): (o, d) of length 2 * W * H."""
    import jax
    import jax.numpy as jnp

    from physically_based_ray_tracer_tpu.render.renderer import morton_pixel_order
    from physically_based_ray_tracer_tpu.scene.camera import primary_rays
    from physically_based_ray_tracer_tpu.utils import rng

    ids = jnp.asarray(morton_pixel_order(cfg.width, cfg.height))
    xs = (ids % cfg.width).astype(jnp.float32)
    ys = (ids // cfg.width).astype(jnp.float32)
    j = rng.uniform2(jax.random.key(0), ids, 0, 0, rng.Purpose.AA_JITTER)
    o1, d1 = primary_rays(cam, xs, ys, cfg.width, cfg.height)
    o2, d2 = primary_rays(cam, xs + j[:, 0], ys + j[:, 1], cfg.width,
                          cfg.height)
    return jnp.concatenate([o1, o2]), jnp.concatenate([d1, d2])


def secondary_wavefronts(scene, o, d, hit, seed: int = 1):
    """From closest hits: one cosine-sampled bounce ray and one shadow ray
    to a uniformly picked point light per hit (t_max = dist^2 - EPSILON,
    the reference's quirk the flagship config keeps). Missed rays get
    t_max = 0. Returns ((o, d, tmax) bounce, (o, d, tmax) shadow)."""
    import jax
    import jax.numpy as jnp

    from physically_based_ray_tracer_tpu.config import EPSILON

    found = hit.prim >= 0
    prim = jnp.maximum(hit.prim, 0)
    p = o + d * jnp.where(found, hit.t, 0.0)[:, None]
    n = scene.face_normal[prim]
    n = jnp.where((jnp.sum(n * d, axis=1) > 0)[:, None], -n, n)
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    u1 = jax.random.uniform(k1, found.shape)
    u2 = jax.random.uniform(k2, found.shape)
    r, phi = jnp.sqrt(u1), 2.0 * jnp.pi * u2
    a = jnp.where(jnp.abs(n[:, :1]) > 0.9, jnp.array([[0.0, 1.0, 0.0]]),
                  jnp.array([[1.0, 0.0, 0.0]]))
    tng = jnp.cross(n, a)
    tng = tng / jnp.linalg.norm(tng, axis=1, keepdims=True)
    btg = jnp.cross(n, tng)
    bd = (tng * (r * jnp.cos(phi))[:, None] + btg * (r * jnp.sin(phi))[:, None]
          + n * jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))[:, None])
    bo = p + n * EPSILON
    btmax = jnp.where(found, 1e30, 0.0)

    lights = scene.lights.point_pos
    which = jax.random.randint(k3, found.shape, 0, lights.shape[0])
    lvec = lights[which] - p
    dist_sq = jnp.sum(lvec * lvec, axis=1)
    sd = lvec / jnp.sqrt(jnp.maximum(dist_sq, 1e-20))[:, None]
    so = p + sd * EPSILON
    stmax = jnp.where(found, dist_sq - EPSILON, 0.0)
    return (bo, bd, btmax), (so, sd, stmax)


def sort_wavefront(dbvh, o, d, tmax):
    """The octant+Morton order the integrator traces bounce and shadow
    wavefronts in (ops/traverse_dense._cosort_rays)."""
    import jax.numpy as jnp

    from physically_based_ray_tracer_tpu.ops.traverse_dense import _cosort_rays

    _, comps, tm = _cosort_rays(dbvh, o, d, tmax, "octant_major")
    return jnp.stack(comps[:3], 1), jnp.stack(comps[3:], 1), tm


def timed(fn, *args, iters: int = 3):
    """(result, compile+first-run seconds, median run seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, first, sorted(ts)[len(ts) // 2]


def engine_fns(dbvh, bvh, stack_depth: int, kernel: bool):
    """jitted closest/any functions of (o, d, tmax) for the three engines.
    ``kernel`` False stands the plain traversal in for the kernel (CPU)."""
    import functools

    import jax

    from physically_based_ray_tracer_tpu.ops import traverse_dense as td
    from physically_based_ray_tracer_tpu.ops.traverse import (intersect_any,
                                                              intersect_closest)

    ms = td.max_steps(dbvh)

    def raw(impl, closest, o, d, tmax):
        comps = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
        out = impl(dbvh.nodes16, dbvh.groups, dbvh.inst16, *comps, tmax,
                   closest=closest, stack_depth=stack_depth, max_steps=ms)
        if closest:
            return td.hit_from_raw(dbvh, *out[:5])
        return out[0] > 0

    kern = td.ffi_trace if kernel else td.plain_trace
    return {
        "kernel": (jax.jit(functools.partial(raw, kern, True)),
                   jax.jit(functools.partial(raw, kern, False))),
        "plain": (jax.jit(functools.partial(raw, td.plain_trace, True)),
                  jax.jit(functools.partial(raw, td.plain_trace, False))),
        "lane": (jax.jit(lambda o, d, t: intersect_closest(
                     bvh, o, d, t, stack_depth=stack_depth, leaf_size=16)),
                 jax.jit(lambda o, d, t: intersect_any(
                     bvh, o, d, t, stack_depth=stack_depth, leaf_size=16))),
    }


def kernel_vs_plain(scene, cam, cfg, kernel: bool = True) -> dict:
    """Phase 3: every wavefront through kernel, plain and lane."""
    fns = engine_fns(scene.dense, scene.bvh, cfg.max_stack_depth, kernel)
    report = {}

    def run(name, mode, o, d, tmax):
        idx = 0 if mode == "closest" else 1
        res, outs = {}, {}
        for eng, pair in fns.items():
            outs[eng], first, med = timed(pair[idx], o, d, tmax)
            res[f"{eng}_first_s"] = first
            res[f"{eng}_ms"] = med * 1e3
        if mode == "closest":
            res["vs_plain"] = compare_closest(outs["kernel"], outs["plain"])
            res["vs_lane"] = compare_closest(outs["kernel"], outs["lane"],
                                             T_RTOL_LANE)
        else:
            res["vs_plain"] = compare_any(outs["kernel"], outs["plain"])
            res["vs_lane"] = compare_any(outs["kernel"], outs["lane"])
        report[f"{name}_{mode}"] = res
        log(f"  {name} {mode}: {json.dumps(res)}")
        return outs["plain"]

    o, d = primary_wavefront(cam, cfg)
    tmax = np.full((o.shape[0],), 1e30, np.float32)
    hit = run("primary", "closest", o, d, tmax)
    bounce, shadow = secondary_wavefronts(scene, o, d, hit)
    bounce = sort_wavefront(scene.dense, *bounce)
    run("bounce", "closest", *bounce)
    run("bounce", "any", *bounce)
    run("shadow", "any", *sort_wavefront(scene.dense, *shadow))
    ok = all(r["vs_plain"]["ok"] and r["vs_lane"]["ok"]
             for r in report.values())
    for eng in ("kernel", "plain"):
        ma = fns[eng][0].lower(o, d, tmax).compile().memory_analysis()
        report[f"memory_analysis_{eng}"] = str(ma)
        log(f"  memory_analysis closest/{eng}: {ma}")
    report["ok"] = bool(ok)
    return report


# --------------------------------------------------------------------------
# the phases
# --------------------------------------------------------------------------

def flagship(legacy_bvh: bool = True):
    sys.path.insert(0, REPO)
    from bench import build_bench_scene, flagship_config

    scene, cam, _ = build_bench_scene(legacy_bvh=legacy_bvh)
    return scene, cam, flagship_config()


def phase_frame(scene, cam, cfg) -> dict:
    import jax

    from physically_based_ray_tracer_tpu import cli
    from physically_based_ray_tracer_tpu.ops import cuda_ffi
    from physically_based_ray_tracer_tpu.render.renderer import Renderer

    key = jax.random.key(0)
    images, report = {}, {}
    for trav in ("dense", "lane"):
        r = Renderer(scene, cam, cfg.replace(traversal=trav))
        if trav == "dense":
            hlo = r._frame.lower(
                r.scene, r.camera, film=r.film, key=key, sample=0,
                pixel_ids=r._pixel_ids).compile().as_text()
            calls = {t: hlo.count(t) for t in (cuda_ffi.CLOSEST_TARGET,
                                               cuda_ffi.ANY_TARGET)}
            report["ffi_custom_calls_in_hlo"] = calls
            log(f"  custom calls in the compiled frame: {calls}")
            if not all(calls.values()):
                raise AssertionError("compiled frame lacks the FFI kernel")
        ms = []
        for _ in range(3):
            img = r.tick(key)
            ms.append(r.stats.frame_ms)
        images[trav] = img
        report[f"{trav}_frame_ms"] = ms
        log(f"  {trav}: frame ms {ms}, mean {float(img.mean()):.4f}")
    img = images["dense"]
    report["finite"] = bool(np.isfinite(img).all())
    report["mean"] = float(img.mean())
    report["vs_lane"] = compare_images(img, images["lane"])
    os.makedirs(OUT_DIR, exist_ok=True)
    from physically_based_ray_tracer_tpu.utils.image import write_png
    write_png(os.path.join(OUT_DIR, "smoke_frame.png"), img)
    t0 = time.perf_counter()
    cli.main(["--demo", "sphere", "--width", "320", "--height", "180",
              "--spp", "2", "--bounces", "4",
              "--out", os.path.join(OUT_DIR, "smoke_cli.png")])
    report["cli_s"] = time.perf_counter() - t0
    report["ok"] = bool(report["finite"] and report["mean"] > 0.01
                        and report["vs_lane"]["ok"])
    return report


def grad_capture():
    """An optax transformation that applies no update and keeps the
    (reduced) gradient as its state, so one real train step returns its
    exact gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def flagship_params(scene):
    return {"base_color": scene.mat_base, "roughness": scene.mat_rough,
            "point_color": scene.lights.point_color}


def train_step_outputs(scene, cam, cfg, pixel_ids, target):
    """(loss, gradients) of one inverse-rendering train step
    (diff/inverse.make_train_step)."""
    import jax

    from physically_based_ray_tracer_tpu.diff.inverse import make_train_step

    params = flagship_params(scene)
    opt = grad_capture()
    step = jax.jit(make_train_step(scene, cam, cfg, opt))
    _, grads, loss = step(params, opt.init(params), jax.random.key(0), 0,
                          pixel_ids, target)
    return loss, grads


def strided_pixels(cfg, n: int):
    """n pixel ids spread over the whole image (every k-th pixel)."""
    import jax.numpy as jnp

    return jnp.arange(0, cfg.n_pixels, max(cfg.n_pixels // n, 1),
                      dtype=jnp.int32)[:n]


def phase_gradient(scene, cam, cfg, n_pixels: int = 65536) -> dict:
    import jax.numpy as jnp

    ids = strided_pixels(cfg, n_pixels)
    target = jnp.full((n_pixels, 3), 0.25, jnp.float32)
    out = {}
    for trav in ("dense", "lane"):
        out[trav] = train_step_outputs(scene, cam, cfg.replace(traversal=trav),
                                       ids, target)
    rep = compare_grads(*out["dense"], *out["lane"])
    rep["pixels"] = n_pixels
    return rep


def phase_gpu_tests() -> dict:
    import pytest

    os.environ["PBRT_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", os.path.join(REPO, "tests")])
    return {"pytest_rc": int(rc), "ok": int(rc) == 0}


def four_card_checks(scene, cam, cfg, devices, part_rays: int,
                     train_pixels: int, sphere_lat: int = 32) -> dict:
    """The multi-device path and what it is compared with: the sharded
    frame (plain and ring-resharded) vs the one-device frame, instance-
    partitioned tracing vs the union trace, and the sharded train step vs
    the one-device step."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from physically_based_ray_tracer_tpu.bvh.dense import build_dense_tlas
    from physically_based_ray_tracer_tpu.diff.inverse import (
        make_sharded_train_step, make_train_step)
    from physically_based_ray_tracer_tpu.ops.traverse_dense import (
        intersect_any_dense, intersect_closest_dense)
    from physically_based_ray_tracer_tpu.parallel.object_partition import (
        partition_instances, partitioned_any, partitioned_closest)
    from physically_based_ray_tracer_tpu.parallel.shard import sharded_frame
    from physically_based_ray_tracer_tpu.render.film import FilmState
    from physically_based_ray_tracer_tpu.render.renderer import frame_fn

    n = len(devices)
    rep = {}
    key = jax.random.key(0)
    ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    film = FilmState.zeros(cfg.n_pixels)
    one = jax.jit(functools.partial(frame_fn, cfg=cfg))
    _, ref = one(scene, cam, film, key, 0, ids)
    ref = np.asarray(ref)
    mesh = Mesh(np.array(devices), ("tiles",))
    for name, block in (("sharded", 0),
                        ("resharded", max(cfg.n_pixels // n // 8, 8))):
        step = sharded_frame(mesh, cfg, reshard_block=block)
        _, avg = step(scene, cam, film, key, 0, ids)
        cmp = compare_images(avg, ref)
        rep[f"{name}_frame_vs_1"] = cmp
        rep[f"{name}_ok"] = cmp["max_abs"] <= FOUR_CARD_MAX_ABS
        log(f"  {name} frame vs one device: {cmp}")

    # instance-partitioned tracing vs the union (two-level) trace
    from physically_based_ray_tracer_tpu.scene.procedural import (make_quad,
                                                                  make_sphere)
    from physically_based_ray_tracer_tpu.utils.math import compose_trs
    sph = make_sphere(radius=1.0, lat=sphere_lat,
                      lon=2 * sphere_lat)[0].reshape(-1, 3, 3)
    quad = make_quad([-8, -1, -8], [8, -1, -8], [8, -1, 8],
                     [-8, -1, 8])[0].reshape(-1, 3, 3)
    meshes = [sph.astype(np.float32), quad.astype(np.float32)]
    tfs = [compose_trs((dx, 0, dz), (0, 0, 0), (1, 1, 1))
           for dx in (-2.2, 0.0, 2.2) for dz in (-2.2, 0.0, 2.2)]
    tfs.append(np.eye(4, dtype=np.float32))
    inst_mesh = np.array([0] * 9 + [1])
    tfs = np.stack(tfs).astype(np.float32)
    ps = partition_instances(meshes, inst_mesh, tfs, n_shards=n)
    gdb, _, _ = build_dense_tlas(meshes, inst_mesh, tfs, leaf_target=16)
    obj_mesh = Mesh(np.array(devices), ("obj",))
    o, d = primary_wavefront(cam, cfg)
    o, d = o[:part_rays], d[:part_rays]
    got = partitioned_closest(ps, obj_mesh, o, d, sort=False)
    want = intersect_closest_dense(gdb, o, d)
    rep["partitioned_closest"] = compare_closest(got, want)
    tmax = jnp.where(want.prim >= 0, want.t * 0.999, 6.0)
    got_a = partitioned_any(ps, obj_mesh, o, d, tmax, sort=False)
    want_a = intersect_any_dense(gdb, o, d, tmax)
    rep["partitioned_any"] = compare_any(got_a, want_a)
    log(f"  partitioned closest: {rep['partitioned_closest']}")
    log(f"  partitioned any: {rep['partitioned_any']}")

    # sharded train step vs the one-device step
    params = flagship_params(scene)
    opt = grad_capture()
    tids = strided_pixels(cfg, train_pixels)
    target = jnp.full((train_pixels, 3), 0.25, jnp.float32)
    sharded = make_sharded_train_step(mesh, scene, cam, cfg, opt)
    _, g_s, loss_s = sharded(params, opt.init(params), key, 0, tids, target)
    single = jax.jit(make_train_step(scene, cam, cfg, opt))
    _, g_1, loss_1 = single(params, opt.init(params), key, 0, tids, target)
    rep["train_step"] = compare_grads(loss_s, g_s, loss_1, g_1)
    log(f"  train step: {rep['train_step']}")
    rep["ok"] = bool(rep["sharded_ok"] and rep["resharded_ok"]
                     and rep["partitioned_closest"]["ok"]
                     and rep["partitioned_any"]["ok"]
                     and rep["train_step"]["ok"])
    return rep


def main(argv) -> int:
    import jax

    four = "--four-cards" in argv

    # ---- 1. device ------------------------------------------------------
    from physically_based_ray_tracer_tpu.utils.device import (device_stamp,
                                                              nvidia_smi_line)
    stamp = device_stamp()
    smi = nvidia_smi_line()
    log(f"[1] device: {stamp}")
    log("[1] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(smi)
    if stamp["platform"] != "gpu":
        log("FAIL: JAX found no GPU")
        return 1
    from physically_based_ray_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    log(f"    compile cache: {enable_compile_cache()}")

    # ---- 2. build ---------------------------------------------------------
    from physically_based_ray_tracer_tpu.ops import cuda_ffi
    reused = os.path.exists(cuda_ffi.library_path())
    t0 = time.perf_counter()
    lib = cuda_ffi.build()
    cuda_ffi.ensure_registered()
    log(f"[2] build: {lib} {'reused' if reused else 'built'}, set-up "
        f"{time.perf_counter() - t0:.1f} s")

    results = {}
    if four:
        if stamp["count"] < 4:
            log(f"FAIL: --four-cards needs 4 GPUs, JAX sees {stamp['count']}")
            return 1
        scene, cam, cfg = flagship(legacy_bvh=False)
        log("[4x] four-card path")
        results["four_cards"] = four_card_checks(
            scene, cam, cfg, jax.devices()[:4], part_rays=cfg.n_pixels,
            train_pixels=4 * 65536)
    else:
        scene, cam, cfg = flagship(legacy_bvh=True)
        log("[3] kernel vs plain vs lane (flagship wavefronts)")
        results["kernel_vs_plain"] = kernel_vs_plain(scene, cam, cfg)
        log("[4] frame")
        results["frame"] = phase_frame(scene, cam, cfg)
        log(f"    {json.dumps(results['frame'])}")
        log("[5] gradient")
        results["gradient"] = phase_gradient(scene, cam, cfg)
        log(f"    {json.dumps(results['gradient'])}")
        log("[6] card-only tests (pytest -m gpu)")
        results["gpu_tests"] = phase_gpu_tests()

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": stamp, "gpu": smi, "results": results}, f,
                  indent=1, default=str)
    failed = [k for k, v in results.items() if not v.get("ok")]
    if failed:
        log(f"FAIL: phases {failed}")
        return 1
    log(smi)
    print(json.dumps({"ok": True, "device": stamp}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
