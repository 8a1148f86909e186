"""Timing + throughput accounting.

The reference's on-screen perf readout reports "Mrays/s" that is really
pixels/ms (Core/Renderer.cpp:467-474, SURVEY.md §6). Here rays/s is computed
from the *actual* traced ray count (primary + AA + shadow + bounce rays), and
frame timing uses ``block_until_ready`` so device work is fully measured.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax


@dataclass
class FrameStats:
    frame_ms: float = 0.0
    rays: int = 0
    ema_ms: float = 10.0       # matches Renderer::Debug's EMA start (Core/Renderer.cpp:469)
    alpha: float = 1.0

    @property
    def fps(self) -> float:
        return 1000.0 / max(self.ema_ms, 1e-9)

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.frame_ms, 1e-9) / 1e3

    def update(self, frame_ms: float, rays: int):
        self.frame_ms = frame_ms
        self.rays = rays
        # EMA schedule of Renderer::Debug (Core/Renderer.cpp:469-471).
        self.ema_ms = (1 - self.alpha) * self.ema_ms + self.alpha * frame_ms
        if self.alpha > 0.05:
            self.alpha *= 0.5


def ray_count(config, n_pixels: int, spp: int = 1,
              n_point_lights: int = 4) -> int:
    """LANE-SLOT count per frame — the accounting shared by FrameStats and
    parallel/scaling.py (still not the reference's pixels/ms readout,
    Core/Renderer.cpp:473, which ignores AA/shadow/bounces entirely).

    Per path vertex (per AA sub-path, per bounce):
      * 1 closest-hit extension LANE (the first one is the primary ray).
        Lanes whose path already died at a miss still count here — this is
        an UPPER bound on live extension rays. For the
        honest expected-live-rays metric use ``live_ray_count`` with
        per-bounce live fractions (docs/LIVE_RAYS_*.json; bench.py does);
      * stochastic NEE (Core/Renderer.cpp:205-214): with prob P_POINT the
        point branch traces ``n_point_lights`` shadow rays; otherwise the
        dir/spot/area branch traces 1. Expectation: 0.3*NP + 0.7. Dead
        occlusion lanes (tmax=0, no-op tiles) are NOT counted;
      * non-stochastic fallback traces 1 directional shadow ray.
    """
    from physically_based_ray_tracer_tpu.config import P_POINT

    paths = n_pixels * spp * (2 if config.antialias else 1)
    vertices = paths * config.bounces
    if not config.lighted:
        shadow = 0.0
    elif config.stochastic_lights and not config.one_shadow_ray:
        shadow = vertices * (P_POINT * n_point_lights + (1.0 - P_POINT))
    else:
        # one_shadow_ray estimator / non-stochastic: exactly 1 per vertex
        shadow = float(vertices)
    return int(vertices + shadow)


def live_ray_count(config, n_pixels: int, ext_fractions, shadow_fractions,
                   spp: int = 1) -> int:
    """Expected rays ACTUALLY traced per frame, from measured per-bounce
    live-lane fractions (the ``collect_live`` tap in ``trace_paths``,
    calibrated once per scene, docs/LIVE_RAYS_*.json).

    ``ext_fractions[b]``: fraction of lanes whose bounce-``b`` extension ray
    is live (``ext_fractions[0]`` = 1.0 — every primary ray traces).
    ``shadow_fractions[b]``: fraction tracing a live NEE shadow ray at
    vertex ``b`` (dead lanes' occlusion rays are tmax=0 no-ops and excluded).
    """
    lanes = n_pixels * spp * (2 if config.antialias else 1)
    ext = sum(ext_fractions)
    shadow = sum(shadow_fractions) if config.lighted else 0.0
    return int(lanes * (ext + shadow))


class DeviceTimer:
    """Context manager timing device work to completion."""

    def __init__(self):
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def time_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall ms of ``fn(*args)`` with block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]
