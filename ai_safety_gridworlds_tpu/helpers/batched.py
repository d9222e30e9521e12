"""One-call batched rollouts that auto-select the fused packed step.

The reference exposes environments through a name registry
(``ai_safety_gridworlds/helpers/factory.py:185-273``); this module extends
that ergonomics to the batched compute path: ``batched_rollout(name)``
(or the reusable :class:`BatchedEnv`) resolves the registered functional
env, asks :func:`ai_safety_gridworlds_tpu.ops.make_fused` for its fused
packed-step driver, and only falls back to the generic
``vmap``-over-``lax.scan`` path when no fused step covers the
configuration.

The fused step runs the whole RL shell (action draws, sub-steps,
finalize, auto-reset) on a packed ``[rows, B]`` state as one jitted
``lax.scan``; the generic path vmaps the per-env step chain. Their
relative speed on the H100 is not measured yet. A user adding a *new*
env gets the generic path until they add a fused step
(``docs/KERNELS.md``).
"""

from __future__ import annotations

import jax
import numpy as np


class BatchedEnv:
    """A batch of auto-resetting environments behind the fastest available
    rollout driver.

    ``kernel`` reports which path was selected: ``"fused"`` (the packed
    step driver from ``ops/fused_*.py``) or ``"generic_vmap"``
    (``core.base.rollout`` / ``ma.safety_game_ma.ma_rollout``).

    Stepping a random policy for ``n_steps`` and reading aggregate
    statistics is one call: ``BatchedEnv("boat_race", 4096).rollout(256)``.
    """

    def __init__(
        self,
        name: str,
        batch_size: int = 1024,
        *,
        seed: int = 0,
        backend: str = "auto",
        **env_kwargs,
    ):
        if backend not in ("auto", "fused", "generic"):
            raise ValueError(
                f"backend must be auto|fused|generic, got {backend!r}"
            )
        from ai_safety_gridworlds_tpu import ops
        from ai_safety_gridworlds_tpu.helpers import factory

        self.name = name
        self.batch_size = batch_size
        self.seed = seed
        self.env = factory.get_raw_env(name, **env_kwargs)
        self._fused = None
        if backend != "generic":
            self._fused = ops.make_fused(self.env)
        if backend == "fused" and self._fused is None:
            raise NotImplementedError(
                f"{name!r} has no fused kernel for this configuration"
            )
        if self._fused is not None:
            try:
                self._S = self._fused.init_packed(
                    seed=seed, batch=batch_size
                )
            except Exception:
                # A kernel exists for the env but rejects this particular
                # configuration at packing time (e.g. a savanna top-up
                # deficit exceeding the free cells, which the per-env
                # device path CAN run via overlay curtains). On "auto",
                # fall back loudly like make_fused does; on explicit
                # "fused", surface the error.
                if backend == "fused":
                    raise
                import logging

                logging.getLogger(__name__).warning(
                    "fused kernel for %r rejected this configuration at "
                    "init_packed; falling back to the generic path",
                    name, exc_info=True,
                )
                self._fused = None
        if self._fused is not None:
            self._eps0 = 0
            self._rew0 = np.zeros_like(
                np.asarray(self._S["stats_rewards"]).sum(axis=-1)
            )
        else:
            self._key = jax.random.PRNGKey(seed)
        self._is_ma = hasattr(self.env, "n_agents")

    @property
    def kernel(self) -> str:
        return "fused" if self._fused is not None else "generic_vmap"

    @property
    def state(self):
        """The packed kernel state (fused path) — power-user surface for
        feeding ``ops`` drivers or ``learners.ppo_fused`` directly."""
        if self._fused is None:
            raise AttributeError(
                "generic path keeps no persistent packed state"
            )
        return self._S

    @property
    def fused(self):
        """The fused kernel driver, or None on the generic path."""
        return self._fused

    def rollout(self, n_steps: int) -> dict:
        """Advance every lane ``n_steps`` env steps under a uniform-random
        policy and return PER-CALL aggregate statistics:

        ``episodes`` (episodes finished during this call), ``sum_rewards``
        (fused path: per-dim/per-agent OBSERVED-reward sums over all lanes
        this call; generic path: sums of FINISHED-episode final returns —
        the two backends report different reward aggregates), ``steps``
        (``n_steps * batch_size``), and ``kernel``.
        """
        if self._fused is not None:
            self._S = self._fused.rollout(self._S, n_steps)
            # The kernel's stats_* accumulate since init; report deltas
            # so repeated calls do not double-count.
            eps = int(np.asarray(self._S["stats_episodes"]).sum())
            rew = np.asarray(self._S["stats_rewards"]).sum(axis=-1)
            stats = {
                "episodes": eps - self._eps0,
                "sum_rewards": rew - self._rew0,
            }
            self._eps0, self._rew0 = eps, rew
        elif self._is_ma:
            from ai_safety_gridworlds_tpu.ma.safety_game_ma import ma_rollout

            self._key, sub = jax.random.split(self._key)
            _, raw = ma_rollout(
                self.env, sub, n_steps=n_steps, batch_size=self.batch_size
            )
            stats = {
                "episodes": int(raw["episodes"]),
                "sum_rewards": np.asarray(raw["sum_final_returns"]),
            }
        else:
            from ai_safety_gridworlds_tpu.core import base as core_base

            self._key, sub = jax.random.split(self._key)
            _, raw = core_base.rollout(
                self.env, sub, n_steps=n_steps, batch_size=self.batch_size
            )
            stats = {
                "episodes": int(raw["episodes"]),
                "sum_rewards": np.asarray(raw["sum_final_return"]),
            }
        stats["steps"] = n_steps * self.batch_size
        stats["kernel"] = self.kernel
        return stats


def batched_rollout(
    name: str,
    batch_size: int = 1024,
    n_steps: int = 256,
    *,
    seed: int = 0,
    backend: str = "auto",
    **env_kwargs,
) -> dict:
    """One-call batched rollout for a registered env name, auto-selecting
    the fused packed step when one covers the configuration."""
    return BatchedEnv(
        name, batch_size, seed=seed, backend=backend, **env_kwargs
    ).rollout(n_steps)
