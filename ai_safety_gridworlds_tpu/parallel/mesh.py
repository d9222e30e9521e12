"""Device-mesh scale-out for batched environment rollouts.

The reference has no distributed execution of any kind (one Engine, one
Python process — SURVEY §2.7); here scale-out is a first-class design axis:

* **batch ("data") parallelism**: thousands of env instances per chip via
  ``vmap`` (``core.base.rollout``);
* **multi-chip**: the env batch axis is sharded over a ``jax.sharding.Mesh``
  ``('data',)`` axis with ``NamedSharding``; XLA inserts the collectives;
* **metric aggregation**: per-step statistics are reduced with ``psum``-style
  collectives (``jnp.sum`` over sharded axes under jit lowers to an
  ``all-reduce`` across devices) instead of the reference's Python dict accumulation
  (``safety_game_mo.py:1027-1084``);
* **model parallelism**: learner parameters may additionally be sharded over
  a ``'model'`` axis (see ``learners/``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ai_safety_gridworlds_tpu.core import base as core_base


def shard_map(f, mesh, in_specs, out_specs, check=False):
    """``jax.shard_map`` with varying-manual-axes checking opt-in
    (``check=True`` turns ``check_vma`` on)."""
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=check,
    )


def make_mesh(
    n_data: Optional[int] = None, n_model: int = 1, devices=None
) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        if devices.size < n_model:
            raise ValueError(
                f"n_model {n_model} exceeds the {devices.size} available "
                "devices"
            )
        n_data = devices.size // n_model
    if n_data * n_model > devices.size:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices "
            f"but only {devices.size} are available"
        )
    devices = devices[: n_data * n_model].reshape(n_data, n_model)
    return Mesh(devices, ("data", "model"))


def shard_episode_batch(ep_batch, mesh: Mesh):
    """Place a batched EpisodeState so its leading axis is split over 'data'."""
    sharding = NamedSharding(mesh, P("data"))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), ep_batch)


def sharded_rollout(
    env,
    mesh: Mesh,
    key,
    n_steps: int,
    batch_size: int,
):
    """Run a batched auto-resetting rollout with the env batch sharded over
    the mesh 'data' axis. Returns the final episode-state batch and globally
    reduced statistics (the reductions lower to cross-chip all-reduces).
    """
    if batch_size % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch_size {batch_size} must divide over data axis "
            f"{mesh.shape['data']}"
        )
    data_sharding = NamedSharding(mesh, P("data"))
    replicated = NamedSharding(mesh, P())

    init_keys = jax.random.split(key, batch_size + 1)
    ep0 = jax.jit(
        jax.vmap(functools.partial(core_base.episode_reset, env)),
        out_shardings=data_sharding,
    )(jax.device_put(init_keys[1:], data_sharding))

    step_fn = jax.vmap(functools.partial(core_base.episode_step, env))

    def run(ep, scan_key):
        def body(carry, step_key):
            eps = carry
            actions = jax.random.randint(
                step_key,
                (batch_size,),
                env.action_min,
                env.action_max + 1,
                dtype=jnp.int32,
            )
            eps, outs = step_fn(eps, actions)
            done = outs.step.game_over
            stats = {
                "episodes": jnp.sum(done.astype(jnp.int32)),
                "sum_final_return": jnp.sum(
                    jnp.where(done, outs.final_return, 0.0)
                ),
                "reward_sum": jnp.sum(outs.step.reward),
            }
            return eps, stats
        eps, stats = jax.lax.scan(body, ep, jax.random.split(scan_key, n_steps))
        return eps, jax.tree.map(lambda x: jnp.sum(x, axis=0), stats)

    run_jit = jax.jit(
        run, out_shardings=(data_sharding, replicated)
    )
    return run_jit(ep0, init_keys[0])
