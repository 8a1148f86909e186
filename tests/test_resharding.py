"""Cross-chip ray re-sharding (ppermute ring donation) on the virtual
8-device CPU mesh: results must be identical with and without donation,
and donation must strictly reduce the live-ray imbalance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from physically_based_ray_tracer_tpu.parallel.mesh import make_mesh
from physically_based_ray_tracer_tpu.parallel.resharding import (ring_donate,
                                                                 ring_restore)

NDEV = 8
N_LOCAL = 64     # rays per chip
BLOCK = 16


def _mk_state(seed=0):
    """Global (NDEV*N_LOCAL,) ray 'payloads' + a skewed live mask: chip 0
    fully live, chip NDEV-1 nearly dead — the bounce-depth skew shape."""
    rng = np.random.default_rng(seed)
    n = NDEV * N_LOCAL
    payload = rng.normal(size=(n, 3)).astype(np.float32)
    live = np.zeros((n,), bool)
    for c in range(NDEV):
        k = int(N_LOCAL * (1.0 - c / NDEV))   # chip c: decreasing liveness
        sel = rng.permutation(N_LOCAL)[:k]
        live[c * N_LOCAL + sel] = True
    return jnp.asarray(payload), jnp.asarray(live)


def _trace_stub(rays, live):
    """Stand-in for the traversal: any per-lane pure function."""
    r = jnp.sum(rays * rays, axis=1) + 0.5
    return jnp.where(live, r, 0.0)


def test_donation_roundtrip_identity():
    payload, live = _mk_state()
    mesh = make_mesh(NDEV)

    def local(payload, live):
        rays2, live2, meta = ring_donate(payload, live, "tiles", NDEV, BLOCK)
        res2 = _trace_stub(rays2, live2)
        return ring_restore(res2, meta, "tiles", NDEV)

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("tiles"), P("tiles")),
                          out_specs=P("tiles"), check_vma=False))
    got = np.asarray(f(payload, live))
    want = np.asarray(_trace_stub(payload, live))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_donation_reduces_imbalance():
    payload, live = _mk_state(seed=4)
    mesh = make_mesh(NDEV)

    def counts(payload, live):
        rays2, live2, meta = ring_donate(payload, live, "tiles", NDEV, BLOCK)
        return jnp.sum(live2.astype(jnp.int32))[None]

    f = jax.jit(shard_map(counts, mesh=mesh, in_specs=(P("tiles"), P("tiles")),
                          out_specs=P("tiles"), check_vma=False))
    after = np.asarray(f(payload, live))
    before = np.asarray(
        live.reshape(NDEV, N_LOCAL).sum(axis=1)).astype(np.int64)
    # total live work conserved
    assert after.sum() == before.sum()
    # the ring neighbour of the most-loaded chip picked up work
    assert int(after.max()) <= int(before.max())
    assert int(after.std() * 100) < int(before.std() * 100)


def test_donation_respects_block_cap():
    payload, live = _mk_state(seed=9)
    mesh = make_mesh(NDEV)

    def moved(payload, live):
        _, _, meta = ring_donate(payload, live, "tiles", NDEV, BLOCK)
        return jnp.sum(meta.donated_valid.astype(jnp.int32))[None]

    f = jax.jit(shard_map(moved, mesh=mesh, in_specs=(P("tiles"), P("tiles")),
                          out_specs=P("tiles"), check_vma=False))
    m = np.asarray(f(payload, live))
    assert (m <= BLOCK).all()


def test_two_rounds_compose():
    """A second donation round (applied to the first round's local lanes)
    keeps the round-trip exact — rounds compose like ring-attention steps."""
    payload, live = _mk_state(seed=2)
    mesh = make_mesh(NDEV)

    def local(payload, live):
        r2, l2, m1 = ring_donate(payload, live, "tiles", NDEV, BLOCK)
        r3, l3, m2 = ring_donate(r2, l2, "tiles", NDEV, BLOCK)
        res = _trace_stub(r3, l3)
        res = ring_restore(res, m2, "tiles", NDEV)
        return ring_restore(res, m1, "tiles", NDEV)

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("tiles"), P("tiles")),
                          out_specs=P("tiles"), check_vma=False))
    got = np.asarray(f(payload, live))
    want = np.asarray(_trace_stub(payload, live))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_resharded_frame_matches_unresharded():
    """The REAL bounce loop under shard_map with per-bounce ring donation
    (sharded_frame(..., reshard_block=N)) must produce the same image as
    the plain sharded frame — per-lane results are pure functions of
    (ray, pixel_id), so rebalancing cannot change them."""
    import jax

    from physically_based_ray_tracer_tpu.parallel.shard import sharded_frame
    from physically_based_ray_tracer_tpu.render.film import FilmState
    from tests.scenes import TINY, sphere_scene

    scene, cam = sphere_scene()
    # skewed camera: aim up so a band of chips sees only sky -> real
    # live-lane imbalance for the donation pass to chew on
    from physically_based_ray_tracer_tpu.scene.camera import Camera
    cam = Camera.make(pos=(0, 1, 4), target=(0, 3.5, -2))
    mesh = make_mesh(NDEV)
    n_pix = TINY.n_pixels
    ids = jnp.arange(n_pix, dtype=jnp.int32)
    film = FilmState.zeros(n_pix)
    key = jax.random.key(0)

    base = sharded_frame(mesh, TINY)(scene, cam, film, key, 0, ids)[1]
    resh = sharded_frame(mesh, TINY, reshard_block=64)(
        scene, cam, film, key, 0, ids)[1]
    np.testing.assert_allclose(np.asarray(resh), np.asarray(base),
                               atol=2e-6, rtol=1e-5)
