"""Multi-agent (MO+MA) safety environment layer.

Re-implements the semantics of the reference MA stack
(``environments/shared/rl/pycolab_interface_ma.py:160-440``,
``safety_game_ma.py:134-1159``, ``safety_game_moma.py:151-2150``) on the
functional core:

* **sequential randomized sub-stepping**: one env step = a permutation of the
  acting agents drawn from the env RNG; each agent's sub-step runs a FULL
  engine sweep (the acting agent's sprite update plus every drape update),
  advancing the frame counter by one per sub-step and consuming per-sub-step
  drape randomness (``pycolab_interface_ma.py:176-239``);
* **per-agent termination**: ``terminate_episode(..., agent)`` records a
  per-agent reason; the episode ends when every agent has one, or when
  ``frame >= max_iterations`` kills all (``safety_game_ma.py:986-1005``,
  ``pycolab_interface_ma.py:424-430``);
* **per-agent step types** MID→LAST→DEAD (``environment_ma.py:62-76``);
* **per-agent vector rewards** aggregated across sub-steps
  (``pycolab_interface_ma.py:420``) as an ``[n_agents, n_dims]`` array.

The functional base models the SUB-STEP as the unit: subclasses implement
``engine_substep(state, agent_idx, action, options, slot)``; the base
assembles the randomized sequential loop (unrolled over the small static
agent count, with each sub-step gated on the acting agent's aliveness).
"""

from __future__ import annotations

from typing import Any, Optional  # noqa: F401 (Any used in annotations)

import jax
import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_tpu.mo.safety_game_mo import MoSafetyGridworld


@struct.dataclass
class MaEngineStep:
    """What one full MA step (all sub-steps) communicated to the engine."""

    rewards: jnp.ndarray  # f32 [n_agents, n_dims] aggregated over sub-steps
    termination_reasons: jnp.ndarray  # int32 [n_agents]; NONE if alive
    discount: jnp.ndarray  # f32 []


@struct.dataclass
class MaStepOut:
    step_types: jnp.ndarray  # int32 [n_agents]
    rewards: jnp.ndarray  # f32 [n_agents, n_dims]
    discount: jnp.ndarray  # f32 []
    game_over: jnp.ndarray  # bool [] — episode ended for everyone
    termination_reasons: jnp.ndarray  # int32 [n_agents]


class MaSafetyGridworld(MoSafetyGridworld):
    """Functional base for multi-agent multi-objective envs.

    Subclass contract:
      * ``n_agents`` / ``agent_chars`` attributes;
      * ``State`` carries at least ``t``, ``key``, ``pos`` (int32 [n, 2]),
        ``termination_reasons`` (int32 [n], NONE while alive), and
        ``step_types`` (int32 [n]);
      * ``engine_substep(state, agent_idx, action, options, slot) ->
        (state, rewards_delta [n, dims])`` — one ``Engine.play({agent: act})``:
        the acting agent's update plus all drape updates. Termination is
        recorded by updating ``state.termination_reasons``. The frame counter
        ``state.t`` is advanced by the caller.
    """

    n_agents: int = 2
    agent_chars: str = "12"
    randomize_agent_actions_order: bool = True

    def engine_substep(self, state, agent_idx, action, options, slot):
        raise NotImplementedError

    def agent_reward_keys(self) -> dict:
        """Per-agent enabled reward dimension keys
        (``ma_reward.get_enabled_agent_rewards_keys``, ``ma_reward.py:123``).
        The kernel works in the UNION space (``self.reward_space``); agents
        with heterogeneous reward sets (e.g. firemaker workers vs supervisor)
        set ``enabled_ma_rewards``; the wrapper slices union rows down to
        each agent's keys."""
        enabled_ma = getattr(self, "enabled_ma_rewards", None)
        if enabled_ma is not None:
            from ai_safety_gridworlds_tpu.mo.mo_reward import mo_reward

            return {
                a: mo_reward.get_enabled_reward_dimension_keys(rewards)
                for a, rewards in enabled_ma.items()
            }
        return {
            c: list(self.reward_space.keys)
            for c in self.agent_chars[: self.n_agents]
        }

    def zero_rewards(self):
        return jnp.zeros((self.n_agents, self.reward_space.n_dims), jnp.float32)

    def apply_substep(self, state, agent_idx, action, options, slot):
        """Run one gated sub-step: advances the frame and applies the acting
        agent's engine sweep iff ``action >= 0``. Returns (state, rewards)."""
        action = jnp.asarray(action, jnp.int32)
        acting = action >= 0
        frame_t = state.t + 1
        new_state, delta = self.engine_substep(
            state.replace(t=frame_t), agent_idx, action, options, slot
        )
        state = jax.tree.map(
            lambda new, old: jnp.where(acting, new, old), new_state, state
        )
        return state, jnp.where(acting, delta, 0.0)

    def finalize_step(self, state, rewards):
        """Post-sub-step bookkeeping: truncation, per-agent step types,
        termination reasons, discount."""
        truncated = state.t >= self.max_iterations
        reasons = state.termination_reasons
        game_over_per_agent = truncated | (reasons != TerminationReason.NONE)

        prev_types = state.step_types
        step_types = jnp.where(
            game_over_per_agent,
            jnp.where(
                (prev_types == StepType.MID) | (prev_types == StepType.FIRST),
                jnp.int32(StepType.LAST),
                jnp.int32(StepType.DEAD),
            ),
            jnp.int32(StepType.MID),
        )
        state = state.replace(step_types=step_types)

        all_over = jnp.all(game_over_per_agent)
        reasons_out = jnp.where(
            reasons != TerminationReason.NONE,
            reasons,
            jnp.where(
                truncated,
                jnp.int32(TerminationReason.MAX_STEPS),
                jnp.int32(TerminationReason.NONE),
            ),
        )
        discount = jnp.where(
            jnp.all(reasons != TerminationReason.NONE),
            jnp.float32(0.0),
            jnp.float32(1.0),
        )
        out = MaStepOut(
            step_types=step_types,
            rewards=rewards,
            discount=discount,
            game_over=all_over,
            termination_reasons=reasons_out,
        )
        return state, out

    # ---------------------------------------------------------------- step

    def step(self, state, actions, options=None):
        """One full MA step.

        Args:
          state: env state.
          actions: int32 [n_agents] — per-agent "step" action; −1 marks an
            agent that is not acting this step (dead agents are excluded from
            the actions dict in the reference, so no sub-step runs for them).
          options: optional dict; may carry ``agent_order`` (int32 [n_agents]
            permutation drawn on the host from the env Generator for parity)
            plus env-specific per-sub-step randomness.

        Returns:
          (state, MaStepOut)
        """
        actions = jnp.asarray(actions, jnp.int32)
        n = self.n_agents

        if options is not None and "agent_order" in options:
            order = jnp.asarray(options["agent_order"], jnp.int32)
        elif self.randomize_agent_actions_order and n > 1:
            key, sub = jax.random.split(state.key)
            order = jax.random.permutation(sub, n).astype(jnp.int32)
            state = state.replace(key=key)
        else:
            order = jnp.arange(n, dtype=jnp.int32)

        rewards = self.zero_rewards()
        # Unroll over sub-step slots (n is small and static). Each slot runs
        # the sub-step for agent order[slot] iff that agent is acting.
        for slot in range(n):
            agent_idx = order[slot]
            state, delta = self.apply_substep(
                state, agent_idx, actions[agent_idx], options, slot
            )
            rewards = rewards + delta

        return self.finalize_step(state, rewards)

    # ------------------------------------------------------------- helpers

    def host_agent_order(self, np_random, acting_agents) -> np.ndarray:
        """Shuffle the acting agents exactly as the reference does
        (``pycolab_interface_ma.py:176-180``: ``Generator.shuffle`` of the
        actions dict items). Returns int32 [n_agents]: the first
        ``len(acting_agents)`` entries are the shuffled acting agent indices,
        the rest are the non-acting agents (which the step loop skips)."""
        items = list(acting_agents)
        if self.randomize_agent_actions_order and len(items) > 1:
            np_random.shuffle(items)
        rest = [i for i in range(self.n_agents) if i not in set(items)]
        return np.asarray(items + rest, dtype=np.int32)


def agent_perspective(
    board: np.ndarray,
    position,
    observation_direction: int,
    what_lies_outside,
    observation_radius=None,
    observation_direction_mode: int = 0,
) -> np.ndarray:
    """Host-side agent-centric crop + pad + rotate of a board or layer.

    Faithful port of the reference ``get_agent_perspective``
    (``safety_game_moma.py:1996-2101``): crop by per-direction visibility,
    pad outside the board with ``what_lies_outside``, then rotate k×90° so
    the agent's observation direction faces up (only when the direction mode
    is not fixed). ``observation_radius`` may be None (whole board,
    agent-centric), a scalar, a 4-list indexed by Directions, or −1 (global
    view, no transform).
    """
    from ai_safety_gridworlds_tpu.core.actions import Directions

    h, w = board.shape[:2]
    row, col = int(position[0]), int(position[1])

    if observation_radius is None:
        if observation_direction_mode == 0:
            left = right = w - 1
            top = bottom = h - 1
        else:
            m = max(h, w)
            left = right = top = bottom = m - 1
    elif np.isscalar(observation_radius):
        if observation_radius == -1:
            return board
        left = right = top = bottom = int(observation_radius)
    else:
        r = observation_radius
        if observation_direction_mode == 0:
            left, right = r[Directions.LEFT], r[Directions.RIGHT]
            top, bottom = r[Directions.UP], r[Directions.DOWN]
        else:
            d = observation_direction
            if d == Directions.UP:
                left, right = r[Directions.LEFT], r[Directions.RIGHT]
                top, bottom = r[Directions.UP], r[Directions.DOWN]
            elif d == Directions.DOWN:
                left, right = r[Directions.RIGHT], r[Directions.LEFT]
                top, bottom = r[Directions.DOWN], r[Directions.UP]
            elif d == Directions.LEFT:
                left, right = r[Directions.UP], r[Directions.DOWN]
                top, bottom = r[Directions.RIGHT], r[Directions.LEFT]
            elif d == Directions.RIGHT:
                left, right = r[Directions.DOWN], r[Directions.UP]
                top, bottom = r[Directions.LEFT], r[Directions.RIGHT]
            else:
                raise ValueError("Invalid observation_direction")

    out = board[
        max(0, row - top) : row + bottom + 1,
        max(0, col - left) : col + right + 1,
    ]
    fill = what_lies_outside
    if row - top < 0:
        pad = np.full((top - row,) + out.shape[1:], fill, board.dtype)
        out = np.concatenate([pad, out], axis=0)
    if row + bottom + 1 > h:
        pad = np.full(
            (row + bottom + 1 - h,) + out.shape[1:], fill, board.dtype
        )
        out = np.concatenate([out, pad], axis=0)
    if col - left < 0:
        pad = np.full(
            (out.shape[0], left - col) + out.shape[2:], fill, board.dtype
        )
        out = np.concatenate([pad, out], axis=1)
    if col + right + 1 > w:
        pad = np.full(
            (out.shape[0], col + right + 1 - w) + out.shape[2:],
            fill,
            board.dtype,
        )
        out = np.concatenate([out, pad], axis=1)

    if observation_direction_mode != 0:
        d = observation_direction
        if d == Directions.DOWN:
            out = np.rot90(out, k=2)
        elif d == Directions.LEFT:
            out = np.rot90(out, k=-1)
        elif d == Directions.RIGHT:
            out = np.rot90(out, k=1)
    return out


# ---------------------------------------------------------------------------
# Batched multi-agent rollout machinery: the MA analogue of
# ``core.base.episode_reset/episode_step/rollout`` — vmap over env
# instances, ``lax.scan`` over time, auto-reset via ``lax.cond``
# (the reference steps one Engine per process, ``pycolab_interface_ma.py``).


@struct.dataclass
class MaEpisodeState:
    """Carries one MA environment instance through an auto-resetting rollout."""

    env_state: Any
    episode_returns: jnp.ndarray  # f32 [n_agents, n_dims]


@struct.dataclass
class MaEpisodeOut:
    step: MaStepOut
    # Valid only where ``step.game_over``: final per-agent returns of the
    # episode that just ended.
    final_returns: jnp.ndarray


def ma_episode_reset(env: MaSafetyGridworld, key) -> MaEpisodeState:
    key, opt_key = jax.random.split(key)
    options = env.sample_reset_options(opt_key)
    return MaEpisodeState(
        env_state=env.initial_state(key, options),
        episode_returns=env.zero_rewards(),
    )


def ma_episode_step(env: MaSafetyGridworld, ep: MaEpisodeState, actions):
    """Auto-resetting MA step: when the previous step ended the episode for
    every agent, reset instead of stepping (FIRST timestep, zero rewards)."""
    n = env.n_agents

    def do_reset(ep):
        key, subkey = jax.random.split(ep.env_state.key)
        new = ma_episode_reset(env, subkey)
        new = new.replace(
            env_state=new.env_state.replace(key=key)
        )
        out = MaStepOut(
            step_types=jnp.full((n,), int(StepType.FIRST), jnp.int32),
            rewards=env.zero_rewards(),
            discount=jnp.float32(1.0),
            game_over=jnp.asarray(False),
            termination_reasons=jnp.full(
                (n,), int(TerminationReason.NONE), jnp.int32
            ),
        )
        return new, MaEpisodeOut(step=out, final_returns=env.zero_rewards())

    def do_step(ep):
        # Dead agents are excluded from the actions dict upstream
        # (``pycolab_interface_ma.py:183``): no sub-step runs for them, so
        # drapes must not advance on their slots either.
        alive = (
            ep.env_state.termination_reasons == TerminationReason.NONE
        )
        gated = jnp.where(alive, jnp.asarray(actions, jnp.int32), -1)
        env_state, out = env.step(ep.env_state, gated)
        returns = ep.episode_returns + out.rewards
        new = MaEpisodeState(env_state=env_state, episode_returns=returns)
        return new, MaEpisodeOut(
            step=out,
            final_returns=jnp.where(out.game_over, returns, 0.0),
        )

    was_over = jnp.all(
        (ep.env_state.step_types == StepType.LAST)
        | (ep.env_state.step_types == StepType.DEAD)
    )
    return jax.lax.cond(was_over, do_reset, do_step, ep)


def ma_rollout(
    env: MaSafetyGridworld,
    key,
    n_steps: int,
    batch_size: int,
    policy=None,
):
    """Batched auto-resetting MA rollout (vmap envs x scan steps).

    ``policy(key, ep_batch) -> int32 [batch, n_agents]`` actions; default
    uniform random over the env's action range for every agent.

    Returns (final episode-state batch, stats dict with finished-episode
    counts and summed final per-agent returns).
    """
    n = env.n_agents
    if policy is None:

        def policy(k, eps):
            return jax.random.randint(
                k,
                (batch_size, n),
                env.action_min,
                env.action_max + 1,
                dtype=jnp.int32,
            )

    init_keys = jax.random.split(key, batch_size + 1)
    ep0 = jax.vmap(lambda k: ma_episode_reset(env, k))(init_keys[1:])
    step_fn = jax.vmap(lambda ep, a: ma_episode_step(env, ep, a))

    def body(carry, step_key):
        eps = carry
        actions = policy(step_key, eps)
        eps, outs = step_fn(eps, actions)
        done = outs.step.game_over
        stats = {
            "episodes": jnp.sum(done.astype(jnp.int32)),
            "sum_final_returns": jnp.sum(outs.final_returns, axis=0),
        }
        return eps, stats

    step_keys = jax.random.split(init_keys[0], n_steps)
    eps, per_step = jax.lax.scan(body, ep0, step_keys)
    stats = jax.tree.map(lambda x: jnp.sum(x, axis=0), per_step)
    return eps, stats
