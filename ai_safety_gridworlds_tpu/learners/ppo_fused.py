"""PPO trained directly on the fused packed-step engines.

``learners/ppo.py`` collects rollouts on the generic vmapped per-env path.
This module instead trains on the fused packed-step engines
(``ops/fused_*``): the policy MLP runs INSIDE the rollout's step body
(``FusedMaBase._mlp_policy_actions``), the collection scan emits the
per-step trajectory — policy features, sampled actions, logp, value,
per-agent scalarized rewards, per-agent dones — as stacked ``[T, rows,
B]`` records (``FusedMaBase.rollout_collect``), and the PPO update
consumes it without the data ever taking the slow path. One
``train_step`` is one jitted program: the collection scan followed by
the GAE/minibatch passes. Its throughput on the H100 is not measured
yet.

**The learner adopts the kernel's packed layout end-to-end.** Trajectory
records stay ``[T, rows, B]`` (batch on the minor axis): GAE is a
reverse scan over T on ``[n, B]`` slabs, minibatches are STATIC lane
blocks (``[..., m*Lb:(m+1)*Lb]``), and the loss runs the policy forward
feature-major (``einsum('hf,tfl->thl')``, T-batched) exactly like the
step body does. No transposes, no flattening, no permutation gathers.
Sample-level shuffling buys nothing here anyway — each lane is an
independent auto-resetting environment, so lane blocks are already
i.i.d. samples of the data distribution.

Each agent is an independent trajectory stream for the learner (shared
policy parameters — the standard parameter-sharing MARL setup), so a
batch of B environments with n agents trains on n*B streams. Reset
emissions and dead-agent steps carry ``action == -1`` and are masked out
of the loss (the generic learner's FIRST mask, ``learners/ppo.py``).

The reference ships no learner at all (SURVEY §2.7/§5).
Trajectory-vs-per-env-chain equivalence is pinned by
``tests/test_fused_ppo.py``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from ai_safety_gridworlds_tpu.core import struct


class FusedPPOConfig(NamedTuple):
    """Static hyperparameters (jit constants)."""

    n_steps: int = 32          # rollout length per update
    n_epochs: int = 4          # passes over the rollout per update
    n_minibatches: int = 4     # lane blocks per pass
    discount: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 64


@struct.dataclass
class FusedPPOState:
    """Everything a run needs to continue — one checkpointable pytree."""

    params: Any          # dict: mlp_w1/mlp_b1/mlp_w2/mlp_b2
    opt_state: Any
    S: Any               # packed fused env state (dict of [rows, B])
    key: jnp.ndarray
    update_idx: jnp.ndarray  # int32 []


def _optimizer(config: FusedPPOConfig):
    return optax.chain(
        optax.clip_by_global_norm(config.max_grad_norm),
        optax.adam(config.lr),
    )


def init_params(key, n_features: int, n_actions: int, hidden: int = 64):
    """MLP params in the fused kernel's layout: ``mlp_w2``'s extra output
    row is the value head (``FusedMaBase._mlp_forward_agent``)."""
    k1, k2, k3 = jax.random.split(key, 3)
    s1 = 1.0 / np.sqrt(n_features)
    w2 = jnp.concatenate(
        [
            # Small policy logits at init (near-uniform exploration)...
            jax.random.normal(k2, (n_actions, hidden), jnp.float32) * 0.01,
            # ...regular scale for the value row.
            jax.random.normal(k3, (1, hidden), jnp.float32)
            / np.sqrt(hidden),
        ],
        axis=0,
    )
    return {
        "mlp_w1": jax.random.normal(k1, (hidden, n_features), jnp.float32)
        * s1,
        "mlp_b1": jnp.zeros((hidden, 1), jnp.float32),
        "mlp_w2": w2,
        "mlp_b2": jnp.zeros((n_actions + 1, 1), jnp.float32),
    }


def forward(params, obs):
    """Batch-major MLP head: obs [M, F] -> (logits [M, A], value [M]).

    Same parameters as the in-step forward; used for evaluation /
    deployment outside the packed layout."""
    h = jax.nn.relu(
        jnp.dot(obs, params["mlp_w1"].T, preferred_element_type=jnp.float32)
        + params["mlp_b1"][:, 0]
    )
    out = (
        jnp.dot(h, params["mlp_w2"].T, preferred_element_type=jnp.float32)
        + params["mlp_b2"][:, 0]
    )
    return out[:, :-1], out[:, -1]


def init_train_state(
    fused, key, batch_size: int, seed: int = 0,
    config: FusedPPOConfig = FusedPPOConfig(),
) -> FusedPPOState:
    n_actions = fused.amax - fused.amin + 1
    params = init_params(
        key, fused.POLICY_FEATURES, n_actions, hidden=config.hidden
    )
    S = fused.init_packed(seed=seed, batch=batch_size)
    return FusedPPOState(
        params=params,
        opt_state=_optimizer(config).init(params),
        S=S,
        key=jax.random.fold_in(key, 1),
        update_idx=jnp.int32(0),
    )


def _gae_packed(traj, bootstrap, config: FusedPPOConfig):
    """[T, n, B] advantages / returns by reverse scan (standard GAE),
    computed directly on the kernel-layout slabs."""

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


def _loss_packed(params, mb, dims, config: FusedPPOConfig):
    """Clipped-surrogate PPO loss in the kernel's packed layout.

    ``mb``: feats [T, n*F, L], everything else [T, n, L] (L = lane-block
    width). The forward runs feature-major per agent, batched over T;
    the selected-action logp uses a static select chain over the A
    actions (no gathers in this layout, as in the step body)."""
    n, F, A, amin = dims
    feats, action = mb["feats"], mb["action"]
    logits_rows, value_rows = [], []
    for j in range(n):
        X = feats[:, j * F : (j + 1) * F, :]
        h = jnp.maximum(
            jnp.einsum(
                "hf,tfl->thl", params["mlp_w1"], X,
                preferred_element_type=jnp.float32,
            )
            + params["mlp_b1"][None, :, :],
            0.0,
        )
        out = (
            jnp.einsum(
                "ah,thl->tal", params["mlp_w2"], h,
                preferred_element_type=jnp.float32,
            )
            + params["mlp_b2"][None, :, :]
        )
        logits_rows.append(out[:, :A, :])
        value_rows.append(out[:, A, :])
    logits = jnp.stack(logits_rows, axis=1)   # [T, n, A, L]
    value = jnp.stack(value_rows, axis=1)     # [T, n, L]

    z = logits - jax.lax.stop_gradient(
        jnp.max(logits, axis=2, keepdims=True)
    )
    log_se = jnp.log(jnp.sum(jnp.exp(z), axis=2))     # [T, n, L]
    aidx = jnp.maximum(action - amin, 0)
    z_sel = jnp.zeros_like(log_se)
    for a in range(A):
        z_sel = z_sel + jnp.where(aidx == a, z[:, :, a, :], 0.0)
    logp = z_sel - log_se

    mask = mb["valid"]
    denom = jnp.maximum(mask.sum(), 1.0)
    adv = mb["adv"]
    adv_mean = (adv * mask).sum() / denom
    adv_std = jnp.sqrt(((adv - adv_mean) ** 2 * mask).sum() / denom + 1e-8)
    adv = (adv - adv_mean) / adv_std

    ratio = jnp.exp(logp - mb["logp"])
    clipped = jnp.clip(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
    policy_loss = (
        -(jnp.minimum(ratio * adv, clipped * adv) * mask).sum() / denom
    )
    value_loss = (((value - mb["ret"]) ** 2) * mask).sum() / denom
    p = jnp.exp(z - log_se[:, :, None, :])
    entropy = (
        (-(p * (z - log_se[:, :, None, :])).sum(axis=2)) * mask
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


def _update_from_traj(fused, traj, boot, params, opt_state, opt, dims,
                      config: FusedPPOConfig, grad_reduce=None):
    """GAE + epoch/minibatch passes on a packed trajectory; shared by the
    single-device and sharded train steps. ``grad_reduce`` (e.g. a
    cross-device ``pmean``) is applied to each minibatch gradient before
    the optimizer update."""
    cont = 1.0 - traj["done"].astype(jnp.float32)
    valid = (traj["action"] >= 0).astype(jnp.float32)
    adv, ret = _gae_packed(
        {"reward": traj["reward"], "value": traj["value"], "cont": cont},
        jax.lax.stop_gradient(boot), config,
    )
    data = {
        "feats": traj["feats"],
        "action": traj["action"],
        "logp": traj["logp"],
        "valid": valid,
        "adv": adv,
        "ret": ret,
    }
    B = traj["action"].shape[2]
    if B % config.n_minibatches:
        raise ValueError(
            f"batch {B} not divisible by n_minibatches "
            f"{config.n_minibatches}"
        )
    Lb = B // config.n_minibatches
    all_metrics = []
    # Static unrolled minibatch passes: each minibatch is a lane block,
    # each grad step a fixed slice — no data-dependent control flow, no
    # gathers (see module docstring for why).
    for _ in range(config.n_epochs):
        for m_i in range(config.n_minibatches):
            mb = jax.tree.map(
                lambda x: x[..., m_i * Lb : (m_i + 1) * Lb], data
            )
            (_, metrics), grads = jax.value_and_grad(
                _loss_packed, has_aux=True
            )(params, mb, dims, config)
            if grad_reduce is not None:
                grads = grad_reduce(grads)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            all_metrics.append(metrics)
    metrics = jax.tree.map(
        lambda *xs: jnp.mean(jnp.stack(xs)), *all_metrics
    )
    # One episode ends per step where ALL of a lane's agents read
    # done — an agent DEAD mid-episode re-emits done=1 every later step,
    # so per-agent sums would overcount (and count each episode n times).
    metrics["episodes"] = jnp.all(traj["done"] > 0, axis=1).sum().astype(
        jnp.float32
    )
    metrics["mean_reward"] = (
        traj["reward"] * valid
    ).sum() / jnp.maximum(valid.sum(), 1.0)
    return params, opt_state, metrics


def evaluate(
    fused, params, n_steps: int = 256, batch: int = 1024, seed: int = 0,
):
    """Evaluate MLP policy ``params`` on the fused packed step.

    Runs ``n_steps`` over a fresh ``batch`` of auto-resetting lanes under
    the in-step policy and computes EXACT per-episode returns from the
    emitted trajectory (a scan accumulates each agent-stream's rewards
    and harvests them at done flags — partial tail episodes are
    excluded, unlike a naive stats_rewards / episodes ratio).

    Returns a dict with ``mean_episode_return`` (mean over completed
    per-agent episode returns), ``episodes`` (completed, per-agent
    streams), ``mean_step_reward``, and ``env_steps``.

    Runs on a FRESH kernel instance over the same env: ``init_packed``
    mutates engine statics (layouts, state fields), so evaluating through
    the training engine would re-pack it out from under an in-progress
    training state.
    """
    eval_fused = type(fused)(fused.env)
    S = eval_fused.init_packed(seed=seed, batch=batch)
    _, traj, _ = eval_fused.rollout_collect(S, params, n_steps)
    reward, done = traj["reward"], traj["done"]  # [T, n, B]
    valid = (traj["action"] >= 0).astype(jnp.float32)

    def body(carry, tr):
        acc, prev_d = carry
        acc = acc + tr["r"]
        d = tr["d"].astype(jnp.float32)
        # Harvest only on the TRANSITION into done: a DEAD agent re-emits
        # done=1 on every later step of the episode.
        first_done = d * (1.0 - prev_d)
        out = (acc * first_done, first_done)
        return (acc * (1.0 - d), d), out

    zeros = jnp.zeros(reward.shape[1:], jnp.float32)
    _, (returns, ends) = jax.lax.scan(
        body, (zeros, zeros), {"r": reward, "d": done},
    )
    n_episodes = ends.sum()
    return {
        "mean_episode_return": returns.sum()
        / jnp.maximum(n_episodes, 1.0),
        "episodes": n_episodes,
        "mean_step_reward": (reward * valid).sum()
        / jnp.maximum(valid.sum(), 1.0),
        "env_steps": n_steps * batch,
    }


def make_sharded_train_step(
    fused, mesh, config: FusedPPOConfig = FusedPPOConfig(),
    axis: str = "data",
):
    """Data-parallel fused-PPO update over a ``jax.sharding.Mesh``.

    The packed lane (batch) axis shards over ``axis``; params and
    optimizer state are replicated. Each device runs the collection scan
    (``rollout_collect``) on its lane shard — per-lane statics
    (randomized layouts) ride in as sharded arguments — computes local
    minibatch gradients, and gradients/metrics cross the mesh with
    ``pmean`` before the replicated Adam update: the collection scan
    inside ``shard_map``, gradients reduced by cross-device collectives.

    Per-shard caveat: advantage normalization and the loss denominator
    are computed per lane shard (standard data-parallel PPO practice);
    with equal shard sizes the pmean'd gradient equals the global-batch
    gradient up to that normalization.

    Returns ``(train_step, shard_state)`` where ``shard_state`` places a
    ``FusedPPOState`` onto the mesh with the right shardings.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ai_safety_gridworlds_tpu.parallel.mesh import shard_map

    opt = _optimizer(config)
    dims = (fused.n, fused.POLICY_FEATURES,
            fused.amax - fused.amin + 1, int(fused.amin))
    statics_host = fused._statics_jnp()
    # Compose-time shape validation: fail with actionable errors here,
    # not with a shard_map shape mismatch deep in the first step.
    n_dev = int(mesh.shape[axis])
    B = getattr(fused, "packed_batch", None)
    if B is not None:
        if B % n_dev:
            raise ValueError(
                f"packed batch {B} is not divisible by the mesh "
                f"'{axis}' axis ({n_dev} devices); init_packed with a "
                "batch that is a multiple of the device count"
            )
        local = B // n_dev
        if local % config.n_minibatches:
            raise ValueError(
                f"per-device lane shard {local} (batch {B} / {n_dev} "
                f"devices) is not divisible by n_minibatches "
                f"{config.n_minibatches}"
            )
    lane_spec = P(None, axis)
    static_specs = {
        k: (lane_spec if v.shape[1] != 1 else P())
        for k, v in statics_host.items()
    }
    state_specs = {k: lane_spec for k in fused.STATE_FIELDS}
    statics_sharded = {
        k: jax.device_put(v, NamedSharding(mesh, static_specs[k]))
        for k, v in statics_host.items()
    }
    # The sharded statics are captured at BUILD time; a later
    # init_packed() (host re-randomization) would silently train on
    # stale boards, so pin the engine's statics identity and refuse.
    statics_ref = fused._kstatics_np

    def local_update(params, opt_state, S, statics_l, key):
        key, _ = jax.random.split(key)
        S2, traj, boot = fused.rollout_collect(
            S, params, config.n_steps, statics=statics_l,
        )
        params, opt_state, metrics = _update_from_traj(
            fused, traj, boot, params, opt_state, opt, dims, config,
            grad_reduce=lambda g: jax.lax.pmean(g, axis),
        )
        metrics = jax.tree.map(lambda m: jax.lax.pmean(m, axis), metrics)
        metrics["episodes"] = metrics["episodes"] * mesh.shape[axis]
        return params, opt_state, S2, key, metrics

    sharded = shard_map(
        local_update,
        mesh=mesh,
        in_specs=(P(), P(), state_specs, static_specs, P()),
        out_specs=(P(), P(), state_specs, P(), P()),
    )

    @jax.jit
    def _train_step_jit(state: FusedPPOState):
        params, opt_state, S, key, metrics = sharded(
            state.params, state.opt_state, state.S, statics_sharded,
            state.key,
        )
        return FusedPPOState(
            params=params,
            opt_state=opt_state,
            S=S,
            key=key,
            update_idx=state.update_idx + 1,
        ), metrics

    def train_step(state: FusedPPOState):
        if fused._kstatics_np is not statics_ref:
            raise RuntimeError(
                "the engine was re-packed (init_packed) after "
                "make_sharded_train_step captured its statics — rebuild "
                "the sharded train step (and re-shard the state) to pick "
                "up the new layouts"
            )
        return _train_step_jit(state)

    def shard_state(state: FusedPPOState) -> FusedPPOState:
        repl = NamedSharding(mesh, P())
        lanes = NamedSharding(mesh, lane_spec)
        return FusedPPOState(
            params=jax.device_put(state.params, repl),
            opt_state=jax.device_put(state.opt_state, repl),
            S={k: jax.device_put(v, lanes) for k, v in state.S.items()},
            key=jax.device_put(state.key, repl),
            update_idx=jax.device_put(state.update_idx, repl),
        )

    return train_step, shard_state


def make_train_step(fused, config: FusedPPOConfig = FusedPPOConfig()):
    """Build the jitted ``state -> (state, metrics)`` fused-PPO update."""
    opt = _optimizer(config)
    dims = (fused.n, fused.POLICY_FEATURES,
            fused.amax - fused.amin + 1, int(fused.amin))

    @jax.jit
    def train_step(state: FusedPPOState):
        key, _ = jax.random.split(state.key)
        S, traj, boot = fused.rollout_collect(
            state.S, state.params, config.n_steps
        )
        params, opt_state, metrics = _update_from_traj(
            fused, traj, boot, state.params, state.opt_state, opt, dims,
            config,
        )
        new_state = FusedPPOState(
            params=params,
            opt_state=opt_state,
            S=S,
            key=key,
            update_idx=state.update_idx + 1,
        )
        return new_state, metrics

    return train_step
