"""Card-only tests: the CUDA traversal kernel on the GPU.

Run on the card with ``PBRT_TEST_GPU=1 python -m pytest -m gpu tests/``
(chip_smoke.py runs them in its own process). Elsewhere they skip: the
``gpu`` fixture looks for the card when a test starts, never at import."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the NVIDIA card (PBRT_TEST_GPU=1 pytest -m gpu)")
    from physically_based_ray_tracer_tpu.ops import cuda_ffi
    cuda_ffi.ensure_registered()
    return jax.devices()[0]


def _compare_kernel_plain(dbvh, o, d, tmax):
    import chip_smoke
    from physically_based_ray_tracer_tpu.ops import traverse_dense as td

    comps = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    args = (dbvh.nodes16, dbvh.groups, dbvh.inst16, *comps, tmax)
    kw = dict(stack_depth=64, max_steps=td.max_steps(dbvh))
    kc = jax.jit(lambda *a: td.ffi_trace(*a, closest=True, **kw))(*args)
    pc = jax.jit(lambda *a: td.plain_trace(*a, closest=True, **kw))(*args)
    closest = chip_smoke.compare_closest(td.hit_from_raw(dbvh, *kc[:5]),
                                         td.hit_from_raw(dbvh, *pc[:5]))
    half = jnp.where(pc[3] >= 0, pc[0] * 0.999, 20.0)
    args = args[:-1] + (half,)
    ka = jax.jit(lambda *a: td.ffi_trace(*a, closest=False, **kw))(*args)
    pa = jax.jit(lambda *a: td.plain_trace(*a, closest=False, **kw))(*args)
    occ = chip_smoke.compare_any(ka[0], pa[0])
    assert not np.asarray(kc[5]).any() and not np.asarray(ka[1]).any()
    return closest, occ


@pytest.mark.parametrize("layout", ["single_level", "two_level"])
def test_kernel_matches_plain_traversal(gpu, layout):
    from tests.test_traverse_dense import _rays, _tlas_scene
    from physically_based_ray_tracer_tpu.bvh.dense import build_dense
    from physically_based_ray_tracer_tpu.scene.procedural import make_sphere

    if layout == "two_level":
        dbvh, _ = _tlas_scene()
    else:
        tri = make_sphere(radius=1.0, lat=24, lon=32)[0].reshape(-1, 3, 3)
        dbvh, _ = build_dense(tri.astype(np.float32), leaf_target=16)
    o, d = _rays(50_000, seed=2)
    tmax = jnp.full((o.shape[0],), 1e30, jnp.float32)
    closest, occ = _compare_kernel_plain(dbvh, o, d, tmax)
    assert closest["ok"], closest
    assert occ["ok"], occ


def test_cornell_golden_on_card(gpu):
    """The Cornell golden config rendered on the card against the CPU's
    golden, at the goldens' own bounds except for a few pixels. The scene is
    symmetric about the camera axis, so some primary rays hit a wall-corner
    edge exactly, where the card's ray (its own sqrt and division rounding)
    and the CPU's (XLA fuses products into FMAs there) can pick the other
    triangle of the edge at the same t; at one sample that path then lights
    its pixel from another wall. Measured on an H100: 4 such pixels, and
    every other pixel within one PNG step of the CPU golden."""
    from tests.test_golden_configs import CORNELL_GOLDEN, _check, _render_cornell

    img = _render_cornell()
    assert img.mean() > 0.01
    _check(img, CORNELL_GOLDEN, outliers=16)
