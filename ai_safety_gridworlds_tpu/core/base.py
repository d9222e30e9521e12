"""The functional safety-gridworld game protocol and episode machinery.

This module replaces three reference layers at once with one pure-functional
state machine:

* the pycolab ``Engine`` game loop (``pycolab/engine.py:583-761``),
* the pycolab→RL adapter (``rl/pycolab_interface.py:133-303``: FIRST/MID/LAST
  transitions, ``max_iterations`` truncation, auto-reset on step-after-LAST),
* the ``SafetyEnvironment`` bookkeeping (``safety_game.py:265-304``: episode
  return, hidden reward, termination reason, performance).

The OO entity zoo (Sprites/Drapes/Plot) becomes: a per-family ``State`` pytree
plus a pure ``engine_step(state, action) -> (state, EngineStep)``.  The Plot's
three directive kinds map to explicit ``EngineStep`` fields (reward,
termination+discount) and a static render order (z-order).  Everything here is
shape-static and jit/vmap/scan-compatible; batching over thousands of
environment instances is ``jax.vmap``, rollouts are ``jax.lax.scan``, and
multi-host scale-out shards the batch axis over a device mesh
(see ``parallel/mesh.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core.timestep import StepType, TerminationReason


@struct.dataclass
class EngineStep:
    """What one game iteration communicated to the engine.

    The functional analogue of the Plot directives collected by
    ``Engine._apply_and_clear_plot`` (``pycolab/engine.py:761``) plus the
    safety-suite's hidden-reward side channel (``safety_game.py:598-606``).
    """

    reward: Any  # f32 [] (scalar suite) or f32 [n_dims] (MO suite)
    hidden_reward: jnp.ndarray  # f32 [] delta for this step
    hidden_written: jnp.ndarray  # bool [] any add_hidden_reward call this step
    terminated: jnp.ndarray  # bool [] terminate_episode directive issued
    termination_reason: jnp.ndarray  # int32 [] (TerminationReason), NONE if not
    discount: jnp.ndarray  # f32 [] discount if terminated (default 0.0)
    actual_action: jnp.ndarray  # int32 [] action after policy wrappers

    @classmethod
    def make(
        cls,
        reward,
        *,
        hidden_reward=0.0,
        hidden_written=None,
        terminated=False,
        termination_reason=int(TerminationReason.NONE),
        discount=0.0,
        actual_action=-1,
    ) -> "EngineStep":
        if hidden_written is None:
            # Default heuristic: a nonzero delta implies a write. Envs where
            # writes can cancel to zero pass the flag explicitly.
            hidden_written = jnp.asarray(hidden_reward, jnp.float32) != 0.0
        return cls(
            reward=jnp.asarray(reward, jnp.float32),
            hidden_reward=jnp.asarray(hidden_reward, jnp.float32),
            hidden_written=jnp.asarray(hidden_written, bool),
            terminated=jnp.asarray(terminated, bool),
            termination_reason=jnp.asarray(termination_reason, jnp.int32),
            discount=jnp.asarray(discount, jnp.float32),
            actual_action=jnp.asarray(actual_action, jnp.int32),
        )


@struct.dataclass
class StepOut:
    """Result of one environment step, before observation rendering."""

    step_type: jnp.ndarray  # int32 []
    reward: Any  # f32 [] or [n_dims]
    discount: jnp.ndarray  # f32 []
    game_over: jnp.ndarray  # bool [] — this step emitted LAST
    termination_reason: jnp.ndarray  # int32 []
    hidden_reward: jnp.ndarray  # f32 [] delta
    hidden_written: jnp.ndarray  # bool []
    actual_action: jnp.ndarray  # int32 []


class SafetyGridworld:
    """Base class for the functional safety gridworld families.

    Subclasses define:
      * ``initial_state(key) -> State`` — state at frame 0 (the reference's
        ``its_showtime`` point). ``State`` must be a ``core.struct``
        dataclass with at least ``t`` (int32 frame counter) and ``key``
        (PRNG key) fields.
      * ``engine_step(state, action) -> (State, EngineStep)`` — the physics of
        one ``Engine.play`` call, following the env's update schedule.
      * ``observe(state) -> dict`` — the distilled observation
        (``board``/``RGB`` etc.).

    Class attributes configure the RL shell:
      * ``max_iterations`` — truncation bound (``pycolab_interface.py:302``).
      * ``action_min``/``action_max`` — inclusive discrete action id range.
      * ``default_reward`` — substituted when the game gives no reward.
    """

    max_iterations: int = 100
    action_min: int = 1
    action_max: int = 4
    default_reward: float = 0.0

    # --- subclass API -------------------------------------------------------

    def initial_state(self, key, options=None):
        """State at frame 0. ``options`` carries per-episode randomization
        (e.g. level choice, supervisor presence) drawn either on host from
        numpy's global RNG for bit-exact reference parity
        (:meth:`host_reset_options`) or on device (:meth:`sample_reset_options`).
        """
        raise NotImplementedError

    def host_reset_options(self) -> dict:
        """Draw per-episode randomization exactly as the reference does
        (global ``np.random`` at game build, e.g.
        ``absent_supervisor.py:103-105``). Called by the stateful wrapper on
        every reset, including the construction-time probe episode, so the
        numpy stream position matches the reference's."""
        return {}

    def sample_reset_options(self, key) -> dict:
        """Device-side equivalent of :meth:`host_reset_options` for batched
        rollouts (same distribution, JAX PRNG instead of numpy)."""
        return {}

    def carry_state_across_reset(self, old_state, new_state):
        """Transfer cross-episode state (e.g. friend_foe's bandit policy
        estimates, ``friend_foe.py:156-165``) from the ended episode's state
        into the fresh one during batched auto-reset."""
        del old_state
        return new_state

    def engine_step(self, state, action, options=None):
        """Physics of one ``Engine.play``. ``options`` may carry pre-drawn
        per-step randomness for bit-exact parity with the reference's global
        numpy draws (see :meth:`host_step_options`); when ``None`` the env
        draws from ``state.key`` on device instead."""
        raise NotImplementedError

    def host_step_options(self, state, action) -> dict:
        """Draw this step's randomness exactly as the reference would from the
        global numpy RNG (e.g. per-watered-tomato dry draws,
        ``tomato_watering.py:168-171``). Called by the stateful wrapper before
        every step with the pending action (some reference draws depend on the
        post-move position); default: no per-step randomness."""
        return {}

    def observe(self, state) -> dict:
        raise NotImplementedError

    # --- performance metric -------------------------------------------------

    def episode_performance(self, episode_return, hidden_return):
        """Per-episode safety performance.

        The default mirrors ``SafetyEnvironment._calculate_episode_performance``
        (episode return, ``safety_game.py:246-255``); hidden-reward envs
        override to return ``hidden_return`` (e.g. ``boat_race.py:210-211``).
        """
        return episode_return

    # --- the RL shell -------------------------------------------------------

    def step(self, state, action, options=None):
        """One full environment step: frame count, physics, termination logic.

        Equivalent to ``Engine.play`` + ``Environment._update_for_game_step``
        (``pycolab_interface.py:292-303``).
        """
        action = jnp.asarray(action, jnp.int32)
        state = state.replace(t=state.t + 1)
        state, es = self.engine_step(state, action, options)

        truncated = state.t >= self.max_iterations
        game_over = es.terminated | truncated
        # A directive reason wins over MAX_STEPS (the reference only fills in
        # MAX_STEPS when no reason was recorded, safety_game.py:296-297).
        reason = jnp.where(
            es.terminated,
            es.termination_reason,
            jnp.where(
                truncated,
                jnp.int32(TerminationReason.MAX_STEPS),
                jnp.int32(TerminationReason.NONE),
            ),
        )
        discount = jnp.where(es.terminated, es.discount, jnp.float32(1.0))
        step_type = jnp.where(
            game_over, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
        )
        out = StepOut(
            step_type=step_type,
            reward=es.reward,
            discount=discount,
            game_over=game_over,
            termination_reason=reason,
            hidden_reward=es.hidden_reward,
            hidden_written=es.hidden_written,
            actual_action=es.actual_action,
        )
        return state, out

    # --- reward structure ---------------------------------------------------

    def zero_reward(self):
        """A zero of the env's reward type (scalar here; vector in MO base)."""
        return jnp.float32(0.0)


@struct.dataclass
class EpisodeState:
    """Carries one environment instance through an auto-resetting rollout."""

    env_state: Any
    last_step_type: jnp.ndarray  # int32 [] step type of last emitted timestep
    episode_return: Any  # f32 [] or [n_dims]
    hidden_return: jnp.ndarray  # f32 []


@struct.dataclass
class EpisodeOut:
    """Per-step rollout output: the StepOut fields plus episode accounting."""

    step: StepOut
    # Valid only where ``step.game_over``: final returns of the episode that
    # just ended (including this step's reward), for performance aggregation.
    final_return: Any
    final_hidden: jnp.ndarray


def episode_reset(env: SafetyGridworld, key) -> EpisodeState:
    """Start a fresh episode (the FIRST timestep's state)."""
    key, opt_key = jax.random.split(key)
    options = env.sample_reset_options(opt_key)
    env_state = env.initial_state(key, options)
    return EpisodeState(
        env_state=env_state,
        last_step_type=jnp.int32(StepType.FIRST),
        episode_return=env.zero_reward(),
        hidden_return=jnp.float32(0.0),
    )


def episode_step(env: SafetyGridworld, ep: EpisodeState, action) -> tuple:
    """Auto-resetting step: replicates step-after-LAST → reset
    (``pycolab_interface.py:165-168``) as a ``lax.cond``.

    The reset branch emits a FIRST timestep with zero reward (the stateful
    wrapper maps it back to reward ``None`` as the reference does).
    """

    def do_reset(ep: EpisodeState):
        key, subkey = jax.random.split(ep.env_state.key)
        new = episode_reset(env, subkey)
        # Keep advancing the key chain across episodes; preserve any
        # cross-episode state the env declares.
        new_env_state = env.carry_state_across_reset(
            ep.env_state, new.env_state.replace(key=key)
        )
        new = new.replace(env_state=new_env_state)
        out = EpisodeOut(
            step=StepOut(
                step_type=jnp.int32(StepType.FIRST),
                reward=env.zero_reward(),
                discount=jnp.float32(1.0),
                game_over=jnp.asarray(False),
                termination_reason=jnp.int32(TerminationReason.NONE),
                hidden_reward=jnp.float32(0.0),
                hidden_written=jnp.asarray(False),
                actual_action=jnp.int32(-1),
            ),
            final_return=env.zero_reward(),
            final_hidden=jnp.float32(0.0),
        )
        return new, out

    def do_step(ep: EpisodeState):
        env_state, out = env.step(ep.env_state, action)
        episode_return = ep.episode_return + out.reward
        hidden_return = ep.hidden_return + out.hidden_reward
        new = EpisodeState(
            env_state=env_state,
            last_step_type=out.step_type,
            episode_return=episode_return,
            hidden_return=hidden_return,
        )
        return new, EpisodeOut(
            step=out,
            final_return=episode_return,
            final_hidden=hidden_return,
        )

    need_reset = ep.last_step_type == StepType.LAST
    return jax.lax.cond(need_reset, do_reset, do_step, ep)


def random_policy(env: SafetyGridworld) -> Callable:
    """Uniform-random policy over the env's discrete action range."""

    def policy(key, ep: EpisodeState):
        return jax.random.randint(
            key, (), env.action_min, env.action_max + 1, dtype=jnp.int32
        )

    return policy


def rollout(
    env: SafetyGridworld,
    key,
    n_steps: int,
    batch_size: int,
    policy: Optional[Callable] = None,
    collect: bool = False,
):
    """Batched auto-resetting rollout: vmap over envs, scan over time.

    Args:
      env: the environment family.
      key: PRNG key.
      n_steps: steps per environment instance.
      batch_size: number of env instances stepped in lockstep.
      policy: ``policy(key, ep_state_batch) -> int32 [batch]`` actions; default
        uniform random.
      collect: if True, stack per-step ``EpisodeOut``s (costly); otherwise only
        aggregate statistics are returned.

    Returns:
      (final_ep_state_batch, stats_dict[, outs if collect])
    """
    if policy is None:
        base_policy = random_policy(env)
        policy = lambda k, eps: jax.vmap(
            lambda kk: base_policy(kk, None)
        )(jax.random.split(k, batch_size))

    init_keys = jax.random.split(key, batch_size + 1)
    ep0 = jax.vmap(lambda k: episode_reset(env, k))(init_keys[1:])
    step_fn = jax.vmap(functools.partial(episode_step, env))

    def scan_body(carry, step_key):
        eps = carry
        actions = policy(step_key, eps)
        eps, outs = step_fn(eps, actions)
        done = outs.step.game_over
        # final_return is [batch] for scalar envs and [batch, n_dims] for
        # MO envs — broadcast the lane mask over trailing reward dims.
        dmask = done.reshape(
            done.shape + (1,) * (outs.final_return.ndim - done.ndim)
        )
        stats = {
            "episodes": jnp.sum(done.astype(jnp.int32)),
            "sum_final_return": jnp.sum(
                jnp.where(dmask, outs.final_return, 0.0)
            ),
            "sum_final_hidden": jnp.sum(
                jnp.where(done, outs.final_hidden, 0.0)
            ),
        }
        if collect:
            return eps, (stats, outs)
        return eps, stats

    step_keys = jax.random.split(init_keys[0], n_steps)
    eps, scanned = jax.lax.scan(scan_body, ep0, step_keys)
    if collect:
        per_step_stats, outs = scanned
        stats = jax.tree.map(lambda x: jnp.sum(x, axis=0), per_step_stats)
        return eps, stats, outs
    stats = jax.tree.map(lambda x: jnp.sum(x, axis=0), scanned)
    return eps, stats
