"""Frame orchestration: the ``Renderer``.

Replaces the reference's singleton + mutable frame loop (Core/Renderer.cpp:
22-148) with a host-side orchestrator around one jitted, pure frame function:
``film' , image = frame(scene, camera, film, key, sample)``. Physics stepping
and TLAS rebuild (reference Tick steps 1-4) are out of scope / host-side;
everything from primary rays to post-processing runs on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from physically_based_ray_tracer_tpu.config import RenderConfig, RenderMode
from physically_based_ray_tracer_tpu.ops.tonemap import post_process
from physically_based_ray_tracer_tpu.render import film as film_mod
from physically_based_ray_tracer_tpu.render.integrator import render_sample
from physically_based_ray_tracer_tpu.scene.camera import Camera
from physically_based_ray_tracer_tpu.utils import image as image_utils
from physically_based_ray_tracer_tpu.utils.timer import DeviceTimer, FrameStats, ray_count


def frame_fn(scene, cam: Camera, film: film_mod.FilmState,
             key, sample, pixel_ids, *, cfg: RenderConfig):
    """Pure frame step for an arbitrary pixel subset (sharding-friendly).

    Pixels are processed in sequential wavefront chunks (``lax.map``) of
    ``cfg.chunk_pixels`` so live device memory stays bounded regardless of
    resolution — the analogue of the reference's scanline batching.

    Returns (new_film, averaged_color (B, 3)).
    """
    color, primary_t = render_chunked(scene, cam, cfg, key, sample, pixel_ids)
    new_film, avg = film_mod.update(film, color, primary_t, cfg)
    return new_film, avg


def _render_spp(scene, cam: Camera, cfg: RenderConfig, key, sample, pixel_ids):
    """render_sample averaged over cfg.samples_per_pixel in-frame samples
    (a lax.scan so the compiled graph holds ONE copy of the integrator)."""
    spp = max(1, cfg.samples_per_pixel)
    if spp == 1:
        return render_sample(scene, cam, cfg, key, sample, pixel_ids)

    def body(carry, s):
        acc, t0 = carry
        c, t = render_sample(scene, cam, cfg, key, sample * spp + s, pixel_ids)
        t0 = jnp.where(s == 0, t, t0)
        return (acc + c, t0), None

    b = pixel_ids.shape[0]
    (acc, t0), _ = jax.lax.scan(
        body, (jnp.zeros((b, 3), jnp.float32), jnp.zeros((b,), jnp.float32)),
        jnp.arange(spp))
    return acc / spp, t0


def render_chunked(scene, cam: Camera, cfg: RenderConfig, key, sample, pixel_ids):
    """_render_spp over sequential chunks; returns (color (B,3), t (B,))."""
    b = pixel_ids.shape[0]
    if b <= cfg.chunk_pixels:
        return _render_spp(scene, cam, cfg, key, sample, pixel_ids)
    n_chunks = -(-b // cfg.chunk_pixels)
    chunk = -(-b // n_chunks)
    padded = chunk * n_chunks
    ids = jnp.pad(pixel_ids, (0, padded - b), mode="edge").reshape(n_chunks, chunk)
    color, t = jax.lax.map(
        lambda c_ids: _render_spp(scene, cam, cfg, key, sample, c_ids), ids)
    return color.reshape(padded, 3)[:b], t.reshape(padded)[:b]


def morton_pixel_order(width: int, height: int) -> np.ndarray:
    """Pixel ids in Morton (Z-curve) order: packet tiles become square screen
    blocks instead of scanline strips, which tightens the conservative tile
    frusta and cuts traversal steps (SURVEY.md §7 octant bucketing)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.uint64)

    def part1by1(x):
        x &= 0xFFFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    code = part1by1(xs) | (part1by1(ys) << 1)
    flat_ids = (ys * width + xs).ravel()
    order = np.argsort(code.ravel(), kind="stable")
    return flat_ids[order].astype(np.int32)


class Renderer:
    """Host-side convenience wrapper: owns film state, compiles the frame fn."""

    def __init__(self, scene, camera: Camera, config: RenderConfig):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.film = film_mod.FilmState.zeros(config.n_pixels)
        self.stats = FrameStats()
        self.sample = 0
        if config.pixel_order == "morton":
            self._pixel_ids_np = morton_pixel_order(config.width, config.height)
        else:
            self._pixel_ids_np = np.arange(config.n_pixels, dtype=np.int32)
        self._pixel_ids = jnp.asarray(self._pixel_ids_np)
        self._frame = jax.jit(
            functools.partial(frame_fn, cfg=config),
            static_argnames=())

    def reset_accumulation(self):
        """memset(accumulator) analogue (Core/Renderer.cpp:147)."""
        self.film = film_mod.FilmState.zeros(self.config.n_pixels)
        self.sample = 0

    def tick(self, key=None) -> np.ndarray:
        """Render one frame (1 sample/pixel [+AA]), update accumulation, and
        return the display image (H, W, 3) float in [0, 1]."""
        if key is None:
            key = jax.random.key(0)
        with DeviceTimer() as t:
            self.film, avg = self._frame(
                self.scene, self.camera, film=self.film, key=key,
                sample=self.sample, pixel_ids=self._pixel_ids)
            jax.block_until_ready(avg)
        self.sample += 1
        self.stats.update(t.ms, ray_count(self.config, self.config.n_pixels,
                                          n_point_lights=int(self.scene.lights.n_point)))
        return self._assemble(np.asarray(avg))

    def _assemble(self, avg_flat: np.ndarray) -> np.ndarray:
        """Scatter film-order samples back into raster order, post-process."""
        img_flat = np.empty_like(avg_flat)
        img_flat[self._pixel_ids_np] = avg_flat
        img = img_flat.reshape(self.config.height, self.config.width, 3)
        if self.config.post_processed:
            from physically_based_ray_tracer_tpu.ops.tonemap import POST_PRESETS
            pp = POST_PRESETS.get(self.config.post_preset, POST_PRESETS[2])
            img = np.asarray(post_process(
                jnp.asarray(img),
                aberration_intensity=pp["aberration_intensity"],
                vignette_intensity=pp["vignette_intensity"],
                vignette_radius=pp["vignette_radius"],
                grading=pp["grading"]))
        return np.clip(img, 0.0, 1.0)

    def render(self, samples: int = 1, seed: int = 0) -> np.ndarray:
        """Accumulate ``samples`` frames and return the final image."""
        img = None
        for s in range(samples):
            img = self.tick(jax.random.key(seed))
        return img

    def capture(self, path: str | None = None) -> str:
        """PNG export (Renderer::Capture, Core/Renderer.cpp:437-465)."""
        img = self.render(samples=1) if self.sample == 0 else self._current_image()
        path = path or image_utils.capture_path()
        return image_utils.write_png(path, img)

    def _current_image(self) -> np.ndarray:
        avg = np.asarray(self.film.accum) / np.maximum(
            np.asarray(self.film.spp)[:, None], 1.0)
        return self._assemble(avg)
