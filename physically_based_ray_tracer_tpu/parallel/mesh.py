"""Device mesh construction.

The reference's only parallelism is one OpenMP loop on one CPU
(Core/Renderer.cpp:43); here parallelism is a first-class axis layout:

* ``tiles`` — image-tile / ray-wavefront data parallelism (the DP analogue
  of SURVEY.md §2.5): pixels sharded, scene replicated, collectives only for
  gradient/framebuffer reductions.

Multi-host slices extend the same mesh over all processes
(``jax.distributed``); XLA hands the collectives to NCCL on GPUs.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "tiles",
              devices=None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def tile_sharding(mesh: Mesh, axis: str = "tiles") -> NamedSharding:
    """Shard the leading (pixel/ray) dimension."""
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def distribute_init(coordinator: str | None = None, num_processes: int | None = None,
                    process_id: int | None = None):
    """Multi-host bring-up (no-op when single-process). Counterpart of the
    reference's... nothing: it has no multi-node story (SURVEY.md §2.5)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
