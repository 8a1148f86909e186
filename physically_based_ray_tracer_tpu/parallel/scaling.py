"""Scaling-efficiency harness.

Measures rays/s at 1, 2, ..., N devices over the same total frame and
reports efficiency vs linear scaling — the BASELINE.json ">90% rays/s
scaling efficiency" criterion, runnable on the virtual CPU mesh (tests) or a
real multi-chip slice. The reference has no multi-device story to compare
against (SURVEY.md §2.5: single-node OpenMP only).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from physically_based_ray_tracer_tpu.config import RenderConfig
from physically_based_ray_tracer_tpu.parallel.mesh import make_mesh
from physically_based_ray_tracer_tpu.parallel.shard import sharded_frame
from physically_based_ray_tracer_tpu.render.film import FilmState
from physically_based_ray_tracer_tpu.utils.timer import ray_count


def measure_scaling(scene, cam, cfg: RenderConfig, device_counts=None,
                    iters: int = 3, key=None):
    """Returns [{'devices': n, 'ms': t, 'mrays_per_s': r, 'efficiency': e}].

    Efficiency is rays/s(n) / (n * rays/s(1)). The per-shard pixel count must
    stay a multiple of cfg.packet_tile for bit-identical packets (asserted).
    """
    if device_counts is None:
        n = len(jax.devices())
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n]
    if key is None:
        key = jax.random.key(0)

    n_pix = cfg.n_pixels
    pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
    rays = ray_count(cfg, n_pix, n_point_lights=int(scene.lights.n_point))

    results = []
    base_rate = None
    for nd in device_counts:
        assert n_pix % nd == 0, f"{n_pix} pixels not divisible by {nd} devices"
        mesh = make_mesh(nd)
        step = sharded_frame(mesh, cfg)
        film = FilmState.zeros(n_pix)

        out = step(scene, cam, film, key, 0, pixel_ids)
        jax.block_until_ready(out)
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            out = step(scene, cam, film, key, i + 1, pixel_ids)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        t = sorted(times)[len(times) // 2]
        rate = rays / t / 1e6
        if base_rate is None:
            base_rate = rate
        results.append({
            "devices": nd,
            "ms": t * 1e3,
            "mrays_per_s": rate,
            "efficiency": rate / (nd * base_rate),
        })
    return results


def measure_work_invariance(scene, cam, cfg: RenderConfig, divisors=(1, 2, 4, 8),
                            iters: int = 3, key=None):
    """Dispatch/contention-free scaling evidence.

    The virtual-CPU-mesh wall-clock table conflates the sharded program's
    cost with host-core contention (N virtual devices share 2 physical
    cores). This measures the thing the mesh cannot: the UNSHARDED cost of
    exactly the pixel subset each shard would own. If cost(B/n) ~= cost(B)/n
    (normalized ratio ~= 1), the per-device program work is invariant under
    sharding — and since the forward frame has zero cross-chip collectives,
    real-slice efficiency = work-invariance x (1 - launch skew), with no
    term that grows with device count.

    Returns [{'divisor': n, 'ms': t, 'normalized_cost': cost_n/(cost_1/n)}].
    """
    if key is None:
        key = jax.random.key(0)
    n_pix = cfg.n_pixels
    from physically_based_ray_tracer_tpu.render.renderer import frame_fn
    import functools

    results = []
    base = None
    for nd in divisors:
        assert n_pix % nd == 0
        # STRIDED 1/nd subset: every nd-th pixel — a load-balanced shard's
        # work (a contiguous slice can land on a cheap sky region and read
        # sublinear; imbalance between real contiguous shards is what the
        # per-bounce ring resharding addresses)
        ids = jnp.arange(0, n_pix, nd, dtype=jnp.int32)
        film = FilmState.zeros(n_pix // nd)
        step = jax.jit(functools.partial(frame_fn, cfg=cfg))

        out = step(scene, cam, film=film, key=key, sample=0, pixel_ids=ids)
        jax.block_until_ready(out)
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            out = step(scene, cam, film=film, key=key, sample=i + 1,
                       pixel_ids=ids)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        t = sorted(times)[len(times) // 2]
        if base is None:
            base = t
        results.append({"divisor": nd, "ms": t * 1e3,
                        "normalized_cost": t / (base / nd)})
    return results
