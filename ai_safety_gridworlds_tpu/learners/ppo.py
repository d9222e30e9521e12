"""PPO learner over batched auto-resetting gridworld rollouts.

The reference ships no learner at all (SURVEY §5); ``actor_critic`` is the
minimal sharded A2C used by the multi-chip dry-run.  This module is the
production-shaped training path: clipped-surrogate PPO with GAE, minibatch
epochs, Adam + global-norm clipping — the WHOLE update (rollout collection,
advantage computation, every epoch/minibatch pass) is one jitted XLA
program, so a training run is a host loop of identical device calls, and
the full training state (params, optimizer state, env batch, PRNG key) is
a single pytree that checkpoints/resumes bit-exactly through
``utils.checkpoint``.

Device notes: the policy matmuls run in bfloat16
(``actor_critic.forward``); rollout and minibatch passes are
``lax.scan``s (no Python control flow under jit); under a sharded-in
``ep_batch`` the minibatch gradient means become cross-chip all-reduces,
so the same ``train_step`` is the multi-chip data-parallel path.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import base as core_base
from ai_safety_gridworlds_tpu.core.timestep import StepType
from ai_safety_gridworlds_tpu.learners.actor_critic import (
    ACParams,
    forward,
    init_params,
)


class PPOConfig(NamedTuple):
    """Static hyperparameters (jit constants)."""

    n_steps: int = 16          # rollout length per update
    n_epochs: int = 4          # passes over the rollout per update
    n_minibatches: int = 4     # minibatches per pass
    discount: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 128


@struct.dataclass
class PPOState:
    """Everything a run needs to continue — one checkpointable pytree."""

    params: ACParams
    opt_state: Any
    ep_batch: core_base.EpisodeState  # vmapped over the env batch
    key: jnp.ndarray
    update_idx: jnp.ndarray  # int32 []


def _optimizer(config: PPOConfig):
    return optax.chain(
        optax.clip_by_global_norm(config.max_grad_norm),
        optax.adam(config.lr),
    )


def _obs(env, state):
    """Flattened, centred board observation in [-1, 1)."""
    board = env.observe(state)["board"]
    return board.reshape(-1).astype(jnp.float32) / 64.0 - 1.0


def init_train_state(
    env, key, batch_size: int, config: PPOConfig = PPOConfig()
) -> PPOState:
    k_params, k_envs, k_run = jax.random.split(key, 3)
    obs_dim = int(
        jax.eval_shape(
            functools.partial(_obs, env),
            jax.eval_shape(
                lambda k: core_base.episode_reset(env, k).env_state, k_envs
            ),
        ).shape[0]
    )
    n_actions = env.action_max - env.action_min + 1
    params = init_params(k_params, obs_dim, n_actions, hidden=config.hidden)
    ep_batch = jax.vmap(functools.partial(core_base.episode_reset, env))(
        jax.random.split(k_envs, batch_size)
    )
    return PPOState(
        params=params,
        opt_state=_optimizer(config).init(params),
        ep_batch=ep_batch,
        key=k_run,
        update_idx=jnp.int32(0),
    )


def _collect(params, env, ep_batch, key, config: PPOConfig):
    """Roll ``n_steps`` with the current policy; returns the new env batch
    and a [T, B] trajectory dict (obs kept for the minibatch re-passes)."""
    obs_fn = jax.vmap(functools.partial(_obs, env))
    step_fn = jax.vmap(functools.partial(core_base.episode_step, env))

    def body(eps, step_key):
        obs = obs_fn(eps.env_state)
        logits, value = forward(params, obs)
        actions = (
            jax.random.categorical(step_key, logits) + env.action_min
        )
        eps, outs = step_fn(eps, actions)
        logp = jnp.take_along_axis(
            jax.nn.log_softmax(logits),
            (actions - env.action_min)[:, None],
            axis=1,
        )[:, 0]
        tr = {
            "obs": obs,
            "action": actions - env.action_min,
            "logp": logp,
            "value": value,
            "reward": outs.step.reward,
            "cont": 1.0 - outs.step.game_over.astype(jnp.float32),
            # Auto-reset emissions (FIRST, zero reward, ignored action)
            # carry no learning signal — masked out of the loss.
            "valid": (
                outs.step.step_type != jnp.int32(StepType.FIRST)
            ).astype(jnp.float32),
        }
        return eps, tr

    ep_batch, traj = jax.lax.scan(
        body, ep_batch, jax.random.split(key, config.n_steps)
    )
    final_obs = obs_fn(ep_batch.env_state)
    _, bootstrap = forward(params, final_obs)
    return ep_batch, traj, jax.lax.stop_gradient(bootstrap)


def _gae(traj, bootstrap, config: PPOConfig):
    """[T, B] advantages / returns by reverse scan (standard GAE)."""

    def body(carry, tr):
        next_value, next_adv = carry
        delta = (
            tr["reward"]
            + config.discount * tr["cont"] * next_value
            - tr["value"]
        )
        adv = delta + (
            config.discount * config.gae_lambda * tr["cont"] * next_adv
        )
        return (tr["value"], adv), adv

    _, adv = jax.lax.scan(
        body,
        (bootstrap, jnp.zeros_like(bootstrap)),
        traj,
        reverse=True,
    )
    return adv, adv + traj["value"]


def _loss(params, mb, config: PPOConfig):
    logits, value = forward(params, mb["obs"])
    logp_all = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(
        logp_all, mb["action"][:, None], axis=1
    )[:, 0]
    mask = mb["valid"]
    denom = jnp.maximum(mask.sum(), 1.0)

    adv = mb["adv"]
    adv_mean = (adv * mask).sum() / denom
    adv_std = jnp.sqrt(
        ((adv - adv_mean) ** 2 * mask).sum() / denom + 1e-8
    )
    adv = (adv - adv_mean) / adv_std

    ratio = jnp.exp(logp - mb["logp"])
    clipped = jnp.clip(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
    policy_loss = (
        -(jnp.minimum(ratio * adv, clipped * adv) * mask).sum() / denom
    )
    value_loss = (((value - mb["ret"]) ** 2) * mask).sum() / denom
    entropy = (
        -(jax.nn.softmax(logits) * logp_all).sum(-1) * mask
    ).sum() / denom
    loss = (
        policy_loss
        + config.value_coef * value_loss
        - config.entropy_coef * entropy
    )
    return loss, {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
    }


def make_train_step(env, config: PPOConfig = PPOConfig()):
    """Build the jitted ``state -> (state, metrics)`` PPO update."""
    opt = _optimizer(config)

    @jax.jit
    def train_step(state: PPOState):
        key, k_roll, k_perm = jax.random.split(state.key, 3)
        ep_batch, traj, bootstrap = _collect(
            state.params, env, state.ep_batch, k_roll, config
        )
        adv, ret = _gae(traj, bootstrap, config)
        data = {
            "obs": traj["obs"],
            "action": traj["action"],
            "logp": traj["logp"],
            "valid": traj["valid"],
            "adv": adv,
            "ret": ret,
        }
        n = config.n_steps * traj["reward"].shape[1]
        flat = jax.tree.map(
            lambda x: x.reshape((n,) + x.shape[2:]), data
        )
        mb_size = n // config.n_minibatches

        def epoch(carry, epoch_key):
            params, opt_state = carry
            order = jax.random.permutation(epoch_key, n)
            shuffled = jax.tree.map(lambda x: x[order], flat)
            batched = jax.tree.map(
                lambda x: x[: mb_size * config.n_minibatches].reshape(
                    (config.n_minibatches, mb_size) + x.shape[1:]
                ),
                shuffled,
            )

            def minibatch(carry, mb):
                params, opt_state = carry
                (_, metrics), grads = jax.value_and_grad(
                    _loss, has_aux=True
                )(params, mb, config)
                updates, opt_state = opt.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), metrics

            (params, opt_state), metrics = jax.lax.scan(
                minibatch, (params, opt_state), batched
            )
            return (params, opt_state), metrics

        (params, opt_state), metrics = jax.lax.scan(
            epoch,
            (state.params, state.opt_state),
            jax.random.split(k_perm, config.n_epochs),
        )

        game_over = 1.0 - traj["cont"]
        episodes = game_over.sum()
        metrics = jax.tree.map(jnp.mean, metrics)
        metrics["episodes"] = episodes
        metrics["mean_reward"] = (
            traj["reward"] * traj["valid"]
        ).sum() / jnp.maximum(traj["valid"].sum(), 1.0)
        state = PPOState(
            params=params,
            opt_state=opt_state,
            ep_batch=ep_batch,
            key=key,
            update_idx=state.update_idx + 1,
        )
        return state, metrics

    return train_step
