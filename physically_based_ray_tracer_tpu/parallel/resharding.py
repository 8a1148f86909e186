"""Cross-chip ray re-sharding: ppermute ring donation of surplus live rays.

The ring-attention-shaped piece of SURVEY.md §2.5: deep bounce wavefronts
kill rays unevenly across chips (a chip whose tile looks at the sky is idle
while a chip facing dense geometry still traces), so per-chip live-ray
populations diverge with bounce depth. The reference has nothing comparable
(single CPU, OpenMP dynamic scheduling rebalances for free —
Core/Renderer.cpp:43); on a device mesh rebalancing must be an explicit
collective. XLA requires static shapes, so the exchange is a fixed-capacity
*donation block*:

  1. each chip packs its live rays first (stable argsort of the dead mask);
  2. chips with more than the mesh-mean live count donate up to ``block``
     surplus rays to their ring neighbour (``lax.ppermute`` shift +1) —
     dead-marking the donated lanes locally;
  3. every chip traces its local (N) + received (block) lanes in one batch;
  4. donated results ride the reverse permute (shift -1) home and scatter
     back into their origin lanes.

One round moves work only to the next neighbour — a deliberate first cut:
rounds compose (call again for shift +2, etc.) the way ring attention
pipelines KV blocks. All collectives are XLA ``ppermute``/``all_gather``;
there is no host round-trip.

Use inside ``shard_map`` over the ``tiles`` axis. All functions are
pytree-generic: rays are any pytree of (N, ...) leading-axis arrays.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class DonationMeta(NamedTuple):
    """Bookkeeping to route donated results home (all static-shape)."""

    perm: jnp.ndarray        # (N,) live-first packing permutation
    donated_src: jnp.ndarray  # (B,) original lane id of each donated slot
    donated_valid: jnp.ndarray  # (B,) bool: slot actually carries a ray
    recv_valid: jnp.ndarray  # (B,) bool: received slot carries a ray


def _shift(x, axis_name, offset, n_dev):
    """ppermute ring shift by ``offset`` (wraps)."""
    pairs = [(i, (i + offset) % n_dev) for i in range(n_dev)]
    return jax.lax.ppermute(x, axis_name, perm=pairs)


def ring_donate(rays: Any, live: jnp.ndarray, axis_name: str, n_dev: int,
                block: int) -> tuple[Any, jnp.ndarray, DonationMeta]:
    """Donate up to ``block`` surplus live rays to the next chip.

    rays: pytree of (N, ...) arrays; live: (N,) bool.
    Returns (rays2, live2, meta) where rays2 leaves are (N + block, ...):
    the local lanes (donated ones dead-marked) plus the received block.
    """
    N = live.shape[0]
    assert 0 < block <= N

    # live-first packing (stable: preserves Morton order within each class)
    perm = jnp.argsort(~live, stable=True)
    packed = jax.tree.map(lambda x: jnp.take(x, perm, axis=0), rays)
    count = jnp.sum(live.astype(jnp.int32))

    counts = jax.lax.all_gather(count, axis_name)          # (n_dev,)
    target = -(-jnp.sum(counts) // n_dev)                  # ceil mean
    surplus = jnp.maximum(count - target, 0)
    nxt = jax.lax.axis_index(axis_name) + 1
    deficit_next = jnp.maximum(
        target - jax.lax.dynamic_index_in_dim(counts, nxt % n_dev, 0,
                                              keepdims=False), 0)
    s = jnp.minimum(jnp.minimum(surplus, deficit_next), block)

    # donated slots = the LAST s live lanes of the packed order
    idx = count - s + jnp.arange(block, dtype=jnp.int32)   # (B,)
    valid = jnp.arange(block, dtype=jnp.int32) < s
    idx = jnp.clip(idx, 0, N - 1)
    donated = jax.tree.map(lambda x: jnp.take(x, idx, axis=0), packed)
    donated_src = jnp.take(perm, idx)

    recv = _shift((donated, valid), axis_name, +1, n_dev)
    recv_rays, recv_valid = recv

    # dead-mark donated lanes locally so nothing is traced twice
    packed_pos = jnp.arange(N, dtype=jnp.int32)
    still_live = (packed_pos < (count - s))
    live_packed = jnp.take(live, perm) & still_live
    live2 = jnp.concatenate([live_packed, recv_valid])

    rays2 = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), packed, recv_rays)
    meta = DonationMeta(perm=perm, donated_src=donated_src,
                        donated_valid=valid, recv_valid=recv_valid)
    return rays2, live2, meta


def ring_restore(results: Any, meta: DonationMeta, axis_name: str,
                 n_dev: int) -> Any:
    """Merge (N + block, ...) results back to origin-lane order (N, ...).

    The trailing block rides the reverse permute home and overwrites the
    donated lanes; local lanes are un-packed through meta.perm.
    """
    def split(x):
        return x[:-meta.donated_valid.shape[0]], x[-meta.donated_valid.shape[0]:]

    local = jax.tree.map(lambda x: split(x)[0], results)
    remote = jax.tree.map(lambda x: split(x)[1], results)
    back = _shift(remote, axis_name, -1, n_dev)

    inv = jnp.argsort(meta.perm)

    def merge(loc, rem):
        unpacked = jnp.take(loc, inv, axis=0)
        # scatter donated results into their origin lanes
        src = jnp.where(meta.donated_valid, meta.donated_src,
                        jnp.int32(unpacked.shape[0]))  # OOB drop for invalid
        return unpacked.at[src].set(rem, mode="drop")

    return jax.tree.map(merge, local, back)
