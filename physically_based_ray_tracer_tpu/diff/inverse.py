"""Inverse rendering: recover scene parameters from target images.

BASELINE config #5: "recover material albedo/roughness + light params from
target images via pixel gradients on multi-host pod". The train step is a
pure jitted function; the sharded variant runs under ``shard_map`` with
pixels sharded over the ``tiles`` axis and gradients ``pmean``-reduced over
the mesh — the all-reduce-overlapped-with-backward design of SURVEY.md §5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from physically_based_ray_tracer_tpu.config import RenderConfig
from physically_based_ray_tracer_tpu.diff.grad import apply_params, render_color
from physically_based_ray_tracer_tpu.render.film import FilmState


def make_train_step(scene, cam, cfg: RenderConfig, optimizer,
                    axis_name: str | None = None):
    """Returns step(params, opt_state, key, sample, pixel_ids, target) ->
    (params', opt_state', loss)."""

    def step(params, opt_state, key, sample, pixel_ids, target):
        def loss_fn(p):
            s, c = apply_params(scene, cam, p)
            color = render_color(s, c, cfg, key, sample, pixel_ids)
            return jnp.mean((color - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        if axis_name is not None:
            loss = jax.lax.pmean(loss, axis_name)
            grads = jax.lax.pmean(grads, axis_name)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_sharded_train_step(mesh: Mesh, scene, cam, cfg: RenderConfig,
                            optimizer, axis: str = "tiles"):
    """Full multi-chip training step: pixels + target sharded, params/opt
    state replicated, gradient pmean over the mesh axis."""
    step = make_train_step(scene, cam, cfg, optimizer, axis_name=axis)
    tiles = P(axis)
    repl = P()
    mapped = shard_map(
        step, mesh=mesh,
        in_specs=(repl, repl, repl, repl, tiles, tiles),
        out_specs=(repl, repl, repl), check_vma=False)
    return jax.jit(mapped)


def fit(scene, cam, cfg: RenderConfig, params0: dict, target, pixel_ids,
        steps: int = 100, lr: float = 5e-2, seed: int = 0, verbose: bool = False,
        vary_sample: bool = True):
    """Adam-optimize ``params0`` to match ``target`` (B, 3) radiance.

    ``vary_sample=False`` fixes the RNG streams to sample 0 every step —
    useful when the target was rendered at sample 0 and the residual should
    go to zero exactly (deterministic regression tests); the default draws
    fresh sample decisions per step (standard stochastic optimization).
    """
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params0)
    step = jax.jit(make_train_step(scene, cam, cfg, optimizer))
    params = params0
    key = jax.random.key(seed)
    losses = []
    for i in range(steps):
        s = i if vary_sample else 0
        params, opt_state, loss = step(params, opt_state, key, s, pixel_ids, target)
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return params, losses
