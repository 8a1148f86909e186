"""Multi-process bring-up: distribute_init over two real OS processes.

Validates the multi-host story (SURVEY.md §2.5: the reference has none) in
simulation: two CPU processes join one JAX distributed system, form a
global 2-device mesh, and agree on a psum — the collective path gradient
reduction uses in diff/inverse.py. These processes stay on the CPU backend
(one JAX process per card is the rule on a GPU machine); the mesh and
collective code is the same for any backend.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import importlib.util
import os
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
# distribute_init must run before anything touches the XLA backend, so load
# parallel/mesh.py standalone (the package __init__ pulls in modules that
# build jnp constants at import time) — the same ordering a real multi-host
# launcher uses.
repo = os.environ["PBRT_REPO"]
spec = importlib.util.spec_from_file_location(
    "mesh_solo", os.path.join(repo, "physically_based_ray_tracer_tpu",
                              "parallel", "mesh.py"))
mesh_solo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mesh_solo)
distribute_init, make_mesh = mesh_solo.distribute_init, mesh_solo.make_mesh
distribute_init(coordinator=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2, jax.devices()

import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

mesh = make_mesh(2)
def local(x):
    return jax.lax.psum(jnp.sum(x), "tiles")[None]
f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("tiles"),),
                      out_specs=P("tiles"), check_vma=False))
x = jnp.arange(8, dtype=jnp.float32)
xs = jax.make_array_from_process_local_data(
    jax.NamedSharding(mesh, P("tiles")), np.arange(8, dtype=np.float32)[pid*4:(pid+1)*4], (8,))
out = f(xs)
# each shard holds the global psum; read this process's addressable shard
total = float(np.asarray(out.addressable_shards[0].data)[0])
assert total == 28.0, total
print("OK", pid, total)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_psum():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)   # single device per process
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["PBRT_REPO"] = repo
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "OK" in out, out


_FRAME_WORKER = r"""
import importlib.util
import os
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
repo = os.environ["PBRT_REPO"]
spec = importlib.util.spec_from_file_location(
    "mesh_solo", os.path.join(repo, "physically_based_ray_tracer_tpu",
                              "parallel", "mesh.py"))
mesh_solo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mesh_solo)
mesh_solo.distribute_init(coordinator=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2

import jax.numpy as jnp
import numpy as np
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "tests"))
from physically_based_ray_tracer_tpu.utils.compile_cache import (
    enable_compile_cache)
enable_compile_cache()
from scenes import sphere_scene, TINY
from physically_based_ray_tracer_tpu.parallel.shard import sharded_frame
from physically_based_ray_tracer_tpu.render.film import FilmState
from jax.sharding import NamedSharding, PartitionSpec as P

scene, cam = sphere_scene()
cfg = TINY
mesh = mesh_solo.make_mesh(2)
step = sharded_frame(mesh, cfg)
n_pix = cfg.n_pixels
half = n_pix // 2
sh = NamedSharding(mesh, P("tiles"))
ids = jax.make_array_from_process_local_data(
    sh, np.arange(n_pix, dtype=np.int32)[pid * half:(pid + 1) * half], (n_pix,))
film = FilmState(
    accum=jax.make_array_from_process_local_data(
        sh, np.zeros((half, 3), np.float32), (n_pix, 3)),
    spp=jax.make_array_from_process_local_data(
        sh, np.zeros((half,), np.float32), (n_pix,)),
    dist=jax.make_array_from_process_local_data(
        sh, np.zeros((half,), np.float32), (n_pix,)))
film2, avg = step(scene, cam, film, jax.random.key(0), 0, ids)
local = np.asarray(avg.addressable_shards[0].data)
np.save(os.path.join(outdir, f"avg_{pid}.npy"), local)
print("OK", pid, local.shape)
"""


def test_two_process_frame_render(tmp_path):
    """The other half of the multi-host story: two OS
    processes render one sharded frame; the stitched image must equal the
    single-process render (global-pixel-id RNG => sharding-invariant)."""
    import numpy as np

    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["PBRT_REPO"] = repo
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FRAME_WORKER, coord, str(pid), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "OK" in out, out

    stitched = np.concatenate([np.load(tmp_path / "avg_0.npy"),
                               np.load(tmp_path / "avg_1.npy")])

    # single-process reference render of the same frame
    import functools

    import jax
    import jax.numpy as jnp

    from physically_based_ray_tracer_tpu.render.film import FilmState
    from physically_based_ray_tracer_tpu.render.renderer import frame_fn
    from tests.scenes import TINY, sphere_scene

    scene, cam = sphere_scene()
    film = FilmState.zeros(TINY.n_pixels)
    ids = jnp.arange(TINY.n_pixels, dtype=jnp.int32)
    _, avg = jax.jit(functools.partial(frame_fn, cfg=TINY))(
        scene, cam, film, jax.random.key(0), 0, ids)
    np.testing.assert_allclose(stitched, np.asarray(avg), atol=1e-6)


_TRAIN_WORKER = r"""
import importlib.util
import os
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
repo = os.environ["PBRT_REPO"]
spec = importlib.util.spec_from_file_location(
    "mesh_solo", os.path.join(repo, "physically_based_ray_tracer_tpu",
                              "parallel", "mesh.py"))
mesh_solo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mesh_solo)
mesh_solo.distribute_init(coordinator=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2

import jax.numpy as jnp
import numpy as np
import optax
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "tests"))
from physically_based_ray_tracer_tpu.utils.compile_cache import (
    enable_compile_cache)
enable_compile_cache()
from scenes import sphere_scene, TINY
from physically_based_ray_tracer_tpu.diff.inverse import make_sharded_train_step
from jax.sharding import NamedSharding, PartitionSpec as P

scene, cam = sphere_scene()
cfg = TINY
mesh = mesh_solo.make_mesh(2)
n_pix = cfg.n_pixels
half = n_pix // 2
sh = NamedSharding(mesh, P("tiles"))
ids = jax.make_array_from_process_local_data(
    sh, np.arange(n_pix, dtype=np.int32)[pid * half:(pid + 1) * half], (n_pix,))
target = jax.make_array_from_process_local_data(
    sh, np.zeros((half, 3), np.float32), (n_pix, 3))
params = {"base_color": scene.mat_base, "roughness": scene.mat_rough,
          "point_color": scene.lights.point_color}
optimizer = optax.adam(1e-2)
opt_state = optimizer.init(params)
train = make_sharded_train_step(mesh, scene, cam, cfg, optimizer)
loss = None
for step in range(2):
    params, opt_state, loss = train(params, opt_state, jax.random.key(0),
                                    step, ids, target)
l = float(np.asarray(loss.addressable_data(0))) if hasattr(loss, "addressable_data") \
    else float(np.asarray(loss))
print("LOSS", pid, l, flush=True)
assert np.isfinite(l), l
print("OK", pid, l)
"""


def test_two_process_inverse_training():
    """BASELINE config 5: the inverse-rendering train step (forward render +
    backward + pmean gradient all-reduce) over a mesh spanning two real OS
    processes — the multi-host pod path in miniature."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["PBRT_REPO"] = repo
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TRAIN_WORKER, coord, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    losses = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "OK" in out, out
        loss_lines = [l for l in out.splitlines() if l.startswith("LOSS ")]
        assert loss_lines, out
        losses.append(float(loss_lines[-1].split()[2]))
    # pmean makes the loss identical on both processes
    assert abs(losses[0] - losses[1]) < 1e-6, losses
