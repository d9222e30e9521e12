"""A compact advantage actor-critic learner over batched gridworld rollouts.

The reference ships no learner (SURVEY §5: "no training checkpoints — no
learner in-repo"); this module exists so the framework has a first-class
end-to-end *training* path on the device: env batch sharded over the mesh 'data'
axis, MLP hidden dimension sharded over 'model' (tensor parallelism), and
gradient aggregation via the all-reduces XLA inserts for the sharded batch
axis. It also serves as the multi-chip dry-run target (``__graft_entry__``).

bfloat16 is used for activations on the matmul path (tensor-core
friendly), with float32 parameters and reductions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ai_safety_gridworlds_tpu.core import base as core_base


class ACParams(NamedTuple):
    w1: jnp.ndarray  # [obs_dim, hidden]
    b1: jnp.ndarray  # [hidden]
    w2: jnp.ndarray  # [hidden, hidden]
    b2: jnp.ndarray  # [hidden]
    w_pi: jnp.ndarray  # [hidden, n_actions]
    b_pi: jnp.ndarray  # [n_actions]
    w_v: jnp.ndarray  # [hidden, 1]
    b_v: jnp.ndarray  # [1]


def init_params(key, obs_dim: int, n_actions: int, hidden: int = 256) -> ACParams:
    k1, k2, k3, k4 = jax.random.split(key, 4)
    scale = lambda fan_in: 1.0 / np.sqrt(fan_in)
    return ACParams(
        w1=jax.random.normal(k1, (obs_dim, hidden), jnp.float32) * scale(obs_dim),
        b1=jnp.zeros((hidden,), jnp.float32),
        w2=jax.random.normal(k2, (hidden, hidden), jnp.float32) * scale(hidden),
        b2=jnp.zeros((hidden,), jnp.float32),
        w_pi=jax.random.normal(k3, (hidden, n_actions), jnp.float32) * 0.01,
        b_pi=jnp.zeros((n_actions,), jnp.float32),
        w_v=jax.random.normal(k4, (hidden, 1), jnp.float32) * scale(hidden),
        b_v=jnp.zeros((1,), jnp.float32),
    )


def param_shardings(mesh: Mesh) -> ACParams:
    """Tensor-parallel layout: hidden dim split over the 'model' axis."""
    return ACParams(
        w1=NamedSharding(mesh, P(None, "model")),
        b1=NamedSharding(mesh, P("model")),
        w2=NamedSharding(mesh, P("model", None)),
        b2=NamedSharding(mesh, P()),
        w_pi=NamedSharding(mesh, P(None)),
        b_pi=NamedSharding(mesh, P()),
        w_v=NamedSharding(mesh, P(None)),
        b_v=NamedSharding(mesh, P()),
    )


def forward(params: ACParams, obs: jnp.ndarray):
    """obs: f32 [batch, obs_dim] -> (logits [batch, n_actions], value [batch])."""
    x = obs.astype(jnp.bfloat16)
    h = jnp.dot(x, params.w1.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    h = jax.nn.relu(h + params.b1)
    h = h.astype(jnp.bfloat16)
    h2 = jnp.dot(h, params.w2.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    h2 = jax.nn.relu(h2 + params.b2)
    logits = jnp.dot(h2, params.w_pi, preferred_element_type=jnp.float32) + params.b_pi
    value = (
        jnp.dot(h2, params.w_v, preferred_element_type=jnp.float32) + params.b_v
    )[..., 0]
    return logits, value


def _flat_obs(env, state):
    return env.observe(state)["board"].reshape(-1)


def unroll_and_loss(
    params: ACParams,
    env,
    ep_batch,
    key,
    n_steps: int = 8,
    discount: float = 0.99,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
):
    """Collect ``n_steps`` with the current policy and compute the A2C loss."""
    obs_fn = jax.vmap(functools.partial(_flat_obs, env))
    step_fn = jax.vmap(functools.partial(core_base.episode_step, env))

    def body(carry, step_key):
        eps = carry
        obs = obs_fn(eps.env_state)
        logits, value = forward(params, obs)
        # Logit index i maps to action action_min + i (n_actions covers
        # exactly [action_min, action_max]); clipping a 0-based sample
        # into the action range would double-weight the boundary action
        # and score the wrong logit.
        idx = jax.random.categorical(step_key, logits)
        actions = idx + env.action_min
        eps, outs = step_fn(eps, actions)
        logp = jax.nn.log_softmax(logits)[
            jnp.arange(idx.shape[0]), idx
        ]
        entropy = -jnp.sum(
            jax.nn.softmax(logits) * jax.nn.log_softmax(logits), axis=-1
        )
        transition = {
            "logp": logp,
            "value": value,
            "entropy": entropy,
            "reward": outs.step.reward,
            "cont": (~outs.step.game_over).astype(jnp.float32),
        }
        return eps, transition

    ep_batch, traj = jax.lax.scan(
        body, ep_batch, jax.random.split(key, n_steps)
    )

    final_obs = obs_fn(ep_batch.env_state)
    _, bootstrap = forward(params, final_obs)

    def returns_body(carry, tr):
        ret = tr["reward"] + discount * tr["cont"] * carry
        return ret, ret

    _, returns = jax.lax.scan(
        returns_body, jax.lax.stop_gradient(bootstrap), traj, reverse=True
    )
    adv = returns - traj["value"]
    policy_loss = -jnp.mean(jax.lax.stop_gradient(adv) * traj["logp"])
    value_loss = jnp.mean(adv**2)
    entropy_loss = -jnp.mean(traj["entropy"])
    loss = policy_loss + value_coef * value_loss + entropy_coef * entropy_loss
    return loss, ep_batch


def train_step(
    params: ACParams, env, ep_batch, key, lr: float = 1e-3, n_steps: int = 8
):
    """One SGD step on the A2C loss. Pure and jittable; under a sharded-in
    ep_batch the gradient mean over the batch axis becomes a cross-chip
    all-reduce."""
    (loss, ep_batch), grads = jax.value_and_grad(
        unroll_and_loss, has_aux=True
    )(params, env, ep_batch, key, n_steps=n_steps)
    params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return params, ep_batch, loss
