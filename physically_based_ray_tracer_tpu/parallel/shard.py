"""Tile-sharded rendering over a device mesh.

Replacement for the OpenMP scanline loop (Core/Renderer.cpp:43-44):
the flat pixel array is sharded over the ``tiles`` mesh axis with
``shard_map``; the scene (BVH, geometry, materials, textures, lights, sky) is
replicated per chip — the sharding layout prescribed by BASELINE.json. The
per-pixel RNG depends only on global pixel ids, so renders are bit-identical
for every device count (tested in tests/test_parallel.py).

No collectives are needed in the forward pass (the framebuffer stays
sharded); gradient reductions in diff/ use ``psum`` over the same axis.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from physically_based_ray_tracer_tpu.config import RenderConfig
from physically_based_ray_tracer_tpu.render.film import FilmState
from physically_based_ray_tracer_tpu.render.renderer import frame_fn


def pad_to_devices(n: int, n_devices: int) -> int:
    """Pixels padded so the flat array divides evenly across devices."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def sharded_frame(mesh: Mesh, cfg: RenderConfig, axis: str = "tiles",
                  reshard_block: int = 0):
    """Build a jitted, sharded frame function.

    Returns ``step(scene, cam, film, key, sample, pixel_ids) -> (film', avg)``
    where ``film``/``pixel_ids``/outputs are sharded over ``axis`` and
    everything else is replicated.

    ``reshard_block > 0`` enables per-bounce ring ray donation
    (parallel/resharding.py): each bounce rebalances up to that many live
    rays toward the ring neighbour — the bounce-depth load-balance analogue
    of ring attention's KV rotation. Results are lane-deterministic, so the
    image is unchanged.
    """
    tiles = P(axis)
    repl = P()
    if reshard_block > 0:
        cfg = cfg.replace(reshard_axis=axis, reshard_ndev=int(mesh.shape[axis]),
                          reshard_block=reshard_block)

    def local_frame(scene, cam, film, key, sample, pixel_ids):
        return frame_fn(scene, cam, film, key, sample, pixel_ids, cfg=cfg)

    film_spec = FilmState(accum=tiles, spp=tiles, dist=tiles)
    mapped = shard_map(
        local_frame, mesh=mesh,
        in_specs=(repl,       # scene (pytree prefix: every leaf replicated)
                  repl,       # camera
                  film_spec,  # film
                  repl,       # key
                  repl,       # sample
                  tiles),     # pixel ids
        out_specs=(film_spec, tiles), check_vma=False)
    return jax.jit(mapped)


def shard_film(mesh: Mesh, film: FilmState, axis: str = "tiles") -> FilmState:
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sh), film)


def replicate(mesh: Mesh, tree):
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)
