"""Multi-objective safety environment layer.

Re-implements the surface of the reference's
``environments/shared/safety_game_mo.py`` (constants at 62-105, reset/seeding
at 526-726, stats at 971-1084, CSV logging at 727-860 and 1110-1240, gini at
1645-1681) on top of the functional core:

* :class:`MoSafetyGridworld` — functional base whose reward type is a dense
  ``float32[n_dims]`` vector compiled from ``enabled_mo_rewards``;
* :class:`SafetyEnvironmentMo` — the stateful single-env shell with the
  reference's deterministic trial/episode seeding scheme (crc32 pairing),
  vector reward replacement, per-step derived statistics (cumulative/average
  rewards, Gini index, MO variance), metrics plumbing, and semicolon-CSV
  logging with decimal-normalized floats.
"""

from __future__ import annotations

import csv
import datetime
import decimal
import numbers
import os
import zlib
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core.base import SafetyGridworld
from ai_safety_gridworlds_tpu.core.timestep import (
    ArraySpec,
    BoundedArraySpec,
    StepType,
)
from ai_safety_gridworlds_tpu.helpers.safety_env import (
    EXTRA_OBSERVATIONS,
    SafetyEnvironment,
    TimeStep,
)
from ai_safety_gridworlds_tpu.mo.mo_reward import MoRewardSpace, mo_reward

# Observation keys (reference: ``safety_game_mo.py:59-78``).
METRICS_DICT = "metrics_dict"
METRICS_MATRIX = "metrics_matrix"
METRICS_LABELS = "metrics_labels"
METRICS_ROW_INDEXES = "metrics_row_indexes"
CUMULATIVE_REWARD = "cumulative_reward"
AVERAGE_REWARD = "average_reward"
GINI_INDEX = "gini_index"
CUMULATIVE_GINI_INDEX = "cumulative_gini_index"
MO_VARIANCE = "mo_variance"
CUMULATIVE_MO_VARIANCE = "cumulative_mo_variance"
AVERAGE_MO_VARIANCE = "average_mo_variance"
TILE_TYPES = "tile_types"
Z_ORDER = "z_order"
ASCII_ART = "ascii_art"
NP_RANDOM = "np_random"
SEED = "seed"
REWARD_DICT = "reward_dict"
CUMULATIVE_REWARD_DICT = "cumulative_reward_dict"
INFO_OBSERVATION_DIRECTION = "observation_direction"
INFO_ACTION_DIRECTION = "action_direction"
INFO_LAYERS = "layers"

# CSV log column vocabulary (reference: ``safety_game_mo.py:81-105``).
LOG_TIMESTAMP = "timestamp"
LOG_ENVIRONMENT = "env"
LOG_TRIAL = "trial"  # obsolete alias for env layout seed
LOG_ENV_LAYOUT_SEED = "env layout seed"
LOG_ENV_SEED = "env seed"
LOG_EPISODE = "episode"
LOG_ITERATION = "iteration"
LOG_ARGUMENTS = "arguments"
LOG_REWARD_UNITS = "reward_unit"
LOG_REWARD = "reward"
LOG_SCALAR_REWARD = "scalar_reward"
LOG_CUMULATIVE_REWARD = "cumulative_reward"
LOG_AVERAGE_REWARD = "average_reward"
LOG_GINI_INDEX = "gini_index"
LOG_CUMULATIVE_GINI_INDEX = "cumulative_gini_index"
LOG_MO_VARIANCE = "mo_variance"
LOG_CUMULATIVE_MO_VARIANCE = "cumulative_mo_variance"
LOG_AVERAGE_MO_VARIANCE = "average_mo_variance"
LOG_SCALAR_CUMULATIVE_REWARD = "scalar_cumulative_reward"
LOG_SCALAR_AVERAGE_REWARD = "scalar_average_reward"
LOG_METRICS = "metric"
LOG_QVALUES_PER_TILETYPE = "tiletype_qvalue"

LOG_COMPRESSLEVEL = 6


def gini_coefficient(reward_dims) -> np.float64:
    """Min-shifted Gini coefficient (reference: ``safety_game_mo.py:1645-1681``)."""
    reward_dims = np.asarray(reward_dims, dtype=np.float64)
    if reward_dims.size == 0:
        return np.float64(0.0)
    shifted = reward_dims - reward_dims.min()
    mad = np.abs(np.subtract.outer(shifted, shifted)).mean()
    rel_mad = mad / (shifted.mean() + np.finfo(float).eps)
    return 0.5 * rel_mad


def derive_layout_seed(original_seed: Optional[int], env_layout_seed: int) -> int:
    """crc32 pairing of (seed, layout_seed, 17122023)
    (reference: ``safety_game_mo.py:367-381``)."""
    if original_seed is None:
        return env_layout_seed
    seeds = [int(original_seed), int(env_layout_seed), 17122023]
    seeds_bytes = b"".join(x.to_bytes(4, byteorder="big") for x in seeds)
    return zlib.crc32(seeds_bytes)


class MoSafetyGridworld(SafetyGridworld):
    """Functional base for multi-objective envs: rewards are dense vectors.

    Subclasses set ``self.reward_space`` (a :class:`MoRewardSpace`) in their
    constructor and emit ``EngineStep`` rewards of shape ``[n_dims]``.
    Optional per-env metrics: set ``self.metrics_keys`` (list of names) and
    have the state carry a ``metrics: f32[n_metrics]`` array.
    """

    reward_space: MoRewardSpace
    metrics_keys: list = []
    # Default action range in the MO suite includes NOOP
    # (``safety_game_mo_base.py:76-93`` ordering is different, but the
    # concrete envs pass explicit (min, max) ranges).
    action_min = 0
    action_max = 4

    def zero_reward(self):
        return jnp.zeros((self.reward_space.n_dims,), jnp.float32)

    def rvec(self, reward: mo_reward) -> jnp.ndarray:
        """Dense device constant for a reward value."""
        return jnp.asarray(self.reward_space.vector(reward))

    def metrics(self, state) -> dict:
        """Return {metric_name: float array} for the current state."""
        return {}


# Per-game-class statics, mirroring the reference's use of class attributes
# that survive environment re-construction (``safety_game_mo.py:318-430``).
_class_statics: dict = {}


def _statics_for(game_cls) -> dict:
    return _class_statics.setdefault(
        game_cls,
        {
            "env_layout_seed": -1,
            "episode_no": 1,
            "env_seed": None,
            "prev_experiment_no": 0,
            "next_experiment_no": 1,
            "create_new_log_file": True,
            "log_file_handle": None,
            "log_filename": None,
            "experiment_signature": None,
        },
    )


def reset_class_statics(game_cls=None):
    """Test helper: forget per-class trial/episode/log state."""
    if game_cls is None:
        _class_statics.clear()
    else:
        _class_statics.pop(game_cls, None)


class SafetyEnvironmentMo(SafetyEnvironment):
    """Stateful multi-objective environment shell
    (reference: ``SafetyEnvironmentMo``, ``safety_game_mo.py:148-1290``)."""

    def __init__(
        self,
        game: MoSafetyGridworld,
        scalarise: bool = False,
        seed: Optional[int] = None,
        log_columns=None,
        log_dir: str = "logs",
        log_arguments: Optional[dict] = None,
        log_arguments_to_separate_file: bool = True,
        log_filename_comment: str = "",
        gzip_log: bool = False,
        flags_dict: Optional[dict] = None,
    ):
        self.scalarise = scalarise
        self.enabled_mo_rewards = game.reward_space.enabled
        self.enabled_reward_dimension_keys = game.reward_space.keys
        self.reward_unit_space = game.reward_space.unit_space()
        self.metrics_keys = list(getattr(game, "metrics_keys", []))
        self.log_columns = list(log_columns or [])
        self.log_dir = log_dir
        self.log_arguments = dict(log_arguments or {})
        self.log_arguments_to_separate_file = log_arguments_to_separate_file
        self.log_filename_comment = log_filename_comment
        self.gzip_log = gzip_log
        self.flags = dict(flags_dict or {})
        self.q_value_per_action = None
        self.q_value_per_location = {}
        self.q_value_per_tiletype = {}
        # prec=10, half-up (reference: ``safety_game_mo.py:421-423``).
        self.decimal_context = decimal.Context(
            prec=10, rounding=decimal.ROUND_HALF_UP, capitals=0
        )

        statics = _statics_for(type(game))
        self._statics = statics
        # Experiment-change detection (``safety_game_mo.py:318-358``).
        signature = (
            statics["next_experiment_no"],
            log_filename_comment,
            tuple(sorted(map(str, self.log_arguments.items()))),
            tuple(sorted(map(str, self.flags.items()))),
            tuple(self.enabled_reward_dimension_keys),
            tuple(self.metrics_keys),
        )
        if statics.get("experiment_signature") != signature:
            statics["create_new_log_file"] = True
            statics["experiment_signature"] = signature
        statics["prev_experiment_no"] = statics["next_experiment_no"]

        self._original_seed = seed
        statics["env_seed"] = seed
        # Construction-time Generator (``safety_game_mo.py:283-290``): the
        # reference seeds the global stream and creates a Generator in
        # __init__; per-layout reseeding later replaces it. This matters when
        # a second instance is constructed while class statics already exist
        # (no layout reseed fires on its first reset).
        if seed is not None:
            np.random.seed(seed & 0xFFFFFFFF)
            self._np_random = np.random.default_rng(seed & 0xFFFFFFFF)
        else:
            self._np_random = np.random.default_rng()
        self._pending_layout_reseed = True

        # Construction-probe semantics (``safety_game_moma.py:283-391``): the
        # probe reset inside super().__init__ randomizes under layout seed -1
        # (the class statics are only assigned AFTER ``super().__init__`` at
        # line 320), and when this is the first construction of the class the
        # generator is then force-reseeded — so every draw the probe consumed
        # is discarded and the first real reset starts from a virgin
        # crc32-derived stream.
        self._in_construction_probe = True
        self._did_initial_reseed = False
        super().__init__(game, seed=seed)
        self._in_construction_probe = False
        if self._did_initial_reseed:
            self._reseed(1, seed)
        self._environment_data[NP_RANDOM] = self._np_random
        self._environment_data[SEED] = self._original_seed

    # --------------------------------------------------------------- pickling

    def __getstate__(self):
        """Pickle instance state plus a snapshot of the per-class statics
        (``safety_game_moma.py:405-413``: class variables are included so the
        trial/episode counters survive process boundaries)."""
        state = super().__getstate__()
        state["_statics"] = None
        state["_statics_snapshot"] = {
            k: v for k, v in self._statics.items() if k != "log_file_handle"
        }
        return state

    def __setstate__(self, state):
        snapshot = state.pop("_statics_snapshot", {})
        state.pop("_statics", None)
        super().__setstate__(state)
        statics = _statics_for(type(self._game))
        statics.update(snapshot)
        statics.setdefault("log_file_handle", None)
        self._statics = statics

    # ------------------------------------------------------------------ reset

    def reset(
        self,
        env_layout_seed=None,
        trial_no=None,
        start_new_experiment=False,
        seed=None,
        options=None,
        do_not_replace_reward=False,
    ) -> TimeStep:
        statics = self._statics
        if seed is not None:
            statics["env_seed"] = seed
        if trial_no is not None:
            env_layout_seed = trial_no
        if options:
            env_layout_seed = options.get("env_layout_seed", env_layout_seed)
            t = options.get("trial_no", None)
            if t is not None:
                env_layout_seed = t
            start_new_experiment = options.get(
                "start_new_experiment", start_new_experiment
            )

        if start_new_experiment:
            statics["next_experiment_no"] = statics["prev_experiment_no"] + 1
            statics["create_new_log_file"] = True

        if statics["create_new_log_file"] and statics["log_file_handle"]:
            statics["log_file_handle"].flush()
            statics["log_file_handle"].close()
            statics["log_file_handle"] = None
            statics["log_filename"] = None

        # Open a fresh log file once a real (non-probe) episode starts.
        if self._last_step_type == StepType.FIRST and statics[
            "create_new_log_file"
        ]:
            statics["create_new_log_file"] = False
            if self.log_columns:
                self._open_log_file()
            else:
                statics["log_filename"] = None

        first_reset = (
            self._last_step_type is None
            or self._last_step_type == StepType.FIRST
        )
        if start_new_experiment or env_layout_seed is not None:
            if start_new_experiment and env_layout_seed is None:
                env_layout_seed = 1
            prev_layout = statics["env_layout_seed"]
            if (
                start_new_experiment
                or prev_layout != env_layout_seed
                or (
                    env_layout_seed == 1
                    and statics["episode_no"] == 1
                    and first_reset
                )
            ):
                statics["env_layout_seed"] = env_layout_seed
                statics["episode_no"] = 1
                self._reseed(env_layout_seed, seed)
        else:
            if env_layout_seed is None and statics["env_layout_seed"] == -1:
                # First ever reset with no explicit layout seed: layout 1.
                statics["env_layout_seed"] = 1
                statics["episode_no"] = 1
                self._reseed(1, seed)
                # Construction probe: record that the post-probe force-reseed
                # must discard whatever this probe consumes.
                if getattr(self, "_in_construction_probe", False):
                    self._did_initial_reseed = True
            elif (
                self._last_step_type is not None
                and self._last_step_type != StepType.FIRST
            ):
                statics["episode_no"] += 1

        # Build the new episode. Envs that draw per-episode randomness from
        # the env Generator (not the global stream) use the *_with_generator
        # hook (e.g. safe_interruptibility_ex).
        if hasattr(self._game, "host_reset_options_with_generator"):
            raw_options = self._game.host_reset_options_with_generator(
                self._np_random
            )
        else:
            raw_options = self._game.host_reset_options()
        if getattr(self._game, "_needs_retrace", False):
            # Board-derived closure constants changed (map randomization);
            # rebuild the jitted kernels so the new masks are traced in.
            self._game._needs_retrace = False
            self._rebuild_jit_caches()
        options_dict = {k: jnp.asarray(v) for k, v in raw_options.items()}
        key = jax.random.PRNGKey(
            np.uint32(statics.get("jax_seed", 0))
            + np.uint32(statics["episode_no"])
        )
        self._state, obs = self._jit_reset(key, options_dict)
        if hasattr(self._game, "host_reset_sweep"):
            # Mirror the ``its_showtime`` full update sweep at reset (drapes
            # run once before the first action; may consume Generator draws).
            self._state = self._game.host_reset_sweep(
                self._state, self._np_random
            )
            obs = self._jit_observe()(self._state)
        self._last_step_type = StepType.FIRST
        self._episode_return = np.zeros(
            (self._game.reward_space.n_dims,), np.float64
        )
        self._hidden_return = 0.0
        self._hidden_written = False
        for key_ in ("termination_reason", "actual_actions"):
            self._environment_data.pop(key_, None)
        self._refresh_host_extras()
        self._init_tile_types()

        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = {}
        self._last_observation_dict = observation
        timestep = TimeStep(StepType.FIRST, None, None, observation)
        return self._finish_timestep(timestep, do_not_replace_reward)

    def _reseed(self, env_layout_seed, seed_override=None):
        """Deterministic reseeding (``safety_game_mo.py:670-693``): seeds both
        the global numpy RNG and a fresh Generator, and derives the JAX key."""
        statics = self._statics
        if seed_override is None:
            new_seed = derive_layout_seed(
                self._original_seed, int(env_layout_seed)
            )
            if self._original_seed is not None:
                statics["env_seed"] = new_seed
        else:
            new_seed = int(seed_override) & 0xFFFFFFFF
        np.random.seed(new_seed & 0xFFFFFFFF)
        self._np_random = np.random.default_rng(new_seed & 0xFFFFFFFF)
        self._environment_data[NP_RANDOM] = self._np_random
        self._environment_data[SEED] = self._original_seed
        statics["jax_seed"] = new_seed & 0xFFFFFFFF

    # ------------------------------------------------------------------- step

    def step(self, action, q_value_per_action=None) -> TimeStep:
        if q_value_per_action is None:
            q_value_per_action = self.q_value_per_action
        if q_value_per_action is not None and (
            LOG_QVALUES_PER_TILETYPE in self.log_columns
        ):
            self._update_q_values(q_value_per_action)
        if self._last_step_type == StepType.LAST:
            self._drop_last_episode()
        if self._state is None:
            return self.reset()

        action_int = int(np.asarray(action).item())
        options = {
            k: jnp.asarray(v)
            for k, v in self._game.host_step_options(
                self._state, action_int
            ).items()
        }
        self._state, out, obs = self._jit_step(
            self._state, jnp.int32(action_int), options
        )
        step_type = StepType(int(out.step_type))
        reward_vec = np.asarray(out.reward, dtype=np.float64)
        discount = float(out.discount)
        self._last_step_type = step_type

        self._episode_return = self._episode_return + reward_vec
        self._hidden_return += float(out.hidden_reward)
        self._hidden_written = self._hidden_written or bool(
            getattr(out, "hidden_written", False)
        )
        self._refresh_host_extras()

        extra = dict(self._get_agent_extra_observations())
        actual = int(out.actual_action)
        if actual >= 0:
            self._environment_data["actual_actions"] = actual
            extra["actual_actions"] = actual
        if step_type == StepType.LAST:
            from ai_safety_gridworlds_tpu.core.timestep import (
                TerminationReason,
            )

            reason = TerminationReason(int(out.termination_reason))
            self._environment_data["termination_reason"] = reason
            extra["termination_reason"] = reason
            self._episodic_performances.append(self._episode_return.copy())

        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = extra
        self._last_observation_dict = observation
        timestep = TimeStep(step_type, reward_vec, discount, observation)
        return self._finish_timestep(timestep, do_not_replace_reward=False)

    # ------------------------------------------------- derived stats/logging

    def _finish_timestep(self, timestep: TimeStep, do_not_replace_reward):
        """Attach MO statistics to the observation and write the log row
        (reference: ``safety_game_mo.py:1020-1108``)."""
        obs = timestep.observation
        keys = self.enabled_reward_dimension_keys
        iteration = int(self._state.t) if self._state is not None else 0

        metrics_dict = self._current_metrics()
        obs[METRICS_DICT] = metrics_dict
        obs[METRICS_MATRIX] = np.array(
            [[k, v] for k, v in metrics_dict.items()], dtype=object
        )

        cumulative_dims = np.asarray(self._episode_return, dtype=np.float64)
        average_dims = cumulative_dims / (iteration + 1)
        scalar_cumulative = float(cumulative_dims.sum())
        scalar_average = float(average_dims.sum())
        obs[CUMULATIVE_REWARD_DICT] = dict(zip(keys, cumulative_dims.tolist()))
        obs[CUMULATIVE_REWARD] = (
            np.float64(scalar_cumulative)
            if self.scalarise
            else cumulative_dims.copy()
        )
        obs[AVERAGE_REWARD] = (
            np.float64(scalar_average)
            if self.scalarise
            else average_dims.copy()
        )

        # ``timestep.reward`` here is always the raw dims vector (or None on
        # FIRST); stats are computed from the full vector and the emitted
        # reward is replaced at the end (``safety_game_mo.py:1050-1067``).
        if timestep.reward is None:
            reward_dims = np.zeros((len(keys),), np.float64)
        else:
            reward_dims = np.asarray(timestep.reward, dtype=np.float64)
        obs[REWARD_DICT] = dict(zip(keys, reward_dims.tolist()))
        scalar_reward = float(reward_dims.sum())

        gini = gini_coefficient(reward_dims) * 100
        cumulative_gini = gini_coefficient(cumulative_dims) * 100
        obs[GINI_INDEX] = gini
        obs[CUMULATIVE_GINI_INDEX] = cumulative_gini
        mo_var = np.var(reward_dims, ddof=0)
        cumulative_var = np.var(cumulative_dims, ddof=0)
        average_var = np.var(average_dims, ddof=0)
        obs[MO_VARIANCE] = mo_var
        obs[CUMULATIVE_MO_VARIANCE] = cumulative_var
        obs[AVERAGE_MO_VARIANCE] = average_var

        # Per-step direction info (``pycolab_interface_mo.py:204-218``).
        obs[INFO_OBSERVATION_DIRECTION] = np.array(
            [self._observation_direction()], np.int32
        )
        obs[INFO_ACTION_DIRECTION] = np.array(
            [self._action_direction()], np.int32
        )

        if iteration > 0 and self.log_columns:
            f = self._statics["log_file_handle"]
            if f:
                self._write_log_row(
                    f,
                    iteration,
                    reward_dims,
                    scalar_reward,
                    cumulative_dims,
                    average_dims,
                    scalar_cumulative,
                    scalar_average,
                    gini,
                    cumulative_gini,
                    mo_var,
                    cumulative_var,
                    average_var,
                )

        # Replace the emitted reward: scalar sum when scalarising, dense
        # float vector otherwise (``safety_game_mo.py:1059-1067``).
        if not do_not_replace_reward and timestep.reward is not None:
            reward = (
                np.float64(scalar_reward)
                if self.scalarise
                else reward_dims.copy()
            )
            timestep = timestep._replace(reward=reward)
        return timestep

    def _current_metrics(self) -> dict:
        if self._state is None:
            return {}
        return {
            k: np.asarray(v).item()
            for k, v in self._game.metrics(self._state).items()
        }

    def _observation_direction(self) -> int:
        if self._state is not None and hasattr(
            self._state, "observation_direction"
        ):
            return int(self._state.observation_direction)
        return 1  # Actions.UP in the scalar ordering

    def _action_direction(self) -> int:
        if self._state is not None and hasattr(self._state, "action_direction"):
            return int(self._state.action_direction)
        return 1

    # -------------------------------------------------------- spec/host obs

    def _compute_observation_spec(self, timestep):
        """MO observation spec (``safety_game_mo.py:903-936``): dict-valued
        keys are declared as empty dicts; direction infos as bounded int32."""

        def helper(k, v):
            if isinstance(v, dict):
                return {
                    kk: ArraySpec(
                        np.asarray(vv).shape, np.asarray(vv).dtype, name=kk
                    )
                    for kk, vv in v.items()
                }
            arr = np.asarray(v)
            if arr.ndim == 0:
                return ArraySpec([1], arr.dtype, name=k)
            return ArraySpec(arr.shape, arr.dtype, name=k)

        skip = {
            EXTRA_OBSERVATIONS,
            METRICS_DICT,
            INFO_OBSERVATION_DIRECTION,
            INFO_ACTION_DIRECTION,
            REWARD_DICT,
            CUMULATIVE_REWARD_DICT,
        }
        spec = {
            k: helper(k, v)
            for k, v in timestep.observation.items()
            if k not in skip
        }
        spec[EXTRA_OBSERVATIONS] = dict()
        spec[INFO_OBSERVATION_DIRECTION] = BoundedArraySpec(
            [1], np.int32, minimum=0, maximum=3,
            name=INFO_OBSERVATION_DIRECTION,
        )
        spec[INFO_ACTION_DIRECTION] = BoundedArraySpec(
            [1], np.int32, minimum=0, maximum=3, name=INFO_ACTION_DIRECTION
        )
        spec[METRICS_DICT] = dict()
        spec[REWARD_DICT] = dict()
        spec[CUMULATIVE_REWARD_DICT] = dict()
        return spec

    def _to_host_obs(self, obs):
        out = {}
        for k, v in obs.items():
            if isinstance(v, dict):
                out[k] = {kk: np.asarray(vv) for kk, vv in v.items()}
            else:
                out[k] = np.asarray(v)
        if "ascii_codes" in out and "ascii" not in out:
            out["ascii"] = out["ascii_codes"].astype(np.uint32).view("U1")
        return out

    # ------------------------------------------------------------ accessors

    def get_reward_unit_space(self):
        return self.reward_unit_space

    def get_env_seed(self):
        return self._statics.get("env_seed", -1)

    def get_env_layout_seed(self):
        # During the construction probe the reference's class statics are not
        # yet assigned (``safety_game_moma.py:352-353``), so randomization
        # cache keys built during the probe see layout -1 — the probe's map
        # never collides with the first real episode's cache entry.
        if getattr(self, "_in_construction_probe", False):
            return -1
        return self._statics.get("env_layout_seed", -1)

    def get_trial_no(self):
        return self.get_env_layout_seed()

    def get_episode_no(self):
        return self._statics.get("episode_no", -1)

    def get_next_episode_no(self):
        episode_no = self._statics.get("episode_no", -1)
        if (
            self._last_step_type is not None
            and self._last_step_type != StepType.FIRST
        ):
            episode_no += 1
        return episode_no

    def set_current_q_value_per_action(self, q_value_per_action):
        self.q_value_per_action = q_value_per_action

    # -------------------------------------- coordinates / layer-cube views

    def calculate_observation_coordinates(
        self,
        observation,
        occlusion_in_layers=False,
        ascii=True,
        agent_coordinates_override=None,
    ):
        """Per-character object coordinates (``safety_game_moma.py:587-625``):
        dict char -> list of (row, col) tuples, from the unoccluded layers
        (or from the rendered board chars when ``occlusion_in_layers``)."""
        if not occlusion_in_layers:
            layers = observation[INFO_LAYERS]
            out = {}
            for layer_key, layer in layers.items():
                if (
                    agent_coordinates_override is not None
                    and layer_key in agent_coordinates_override
                ):
                    out[layer_key] = [
                        tuple(agent_coordinates_override[layer_key])
                    ]
                else:
                    out[layer_key] = [
                        tuple(c)
                        for c in np.argwhere(np.asarray(layer)).tolist()
                    ]
            return out
        board = np.asarray(
            observation["ascii" if ascii else "board"]
        )
        return {
            chr(int(char)) if ascii else char: [
                tuple(c) for c in np.argwhere(board == char).tolist()
            ]
            for char in np.unique(board)
        }

    def get_layers_order(
        self, observation, occlusion_in_layers=False, layers_order=[]
    ):
        """Sorted layer keys (``safety_game_moma.py:627-646``)."""
        if layers_order == []:
            if not occlusion_in_layers:
                layers_order = sorted(observation[INFO_LAYERS].keys())
            else:
                board = np.asarray(observation["ascii"])
                layers_order = sorted(
                    chr(int(c)) for c in np.unique(board)
                )
        return layers_order

    def calculate_observation_layers_cube(
        self, observation, occlusion_in_layers=False, layers_order=[]
    ):
        """Bool layer stack [n_layers, H, W] in ``layers_order``
        (``safety_game_moma.py:648-686``)."""
        layers_order = self.get_layers_order(
            observation, occlusion_in_layers, layers_order
        )
        if not occlusion_in_layers:
            layers = observation[INFO_LAYERS]
            h, w = next(iter(layers.values())).shape
            return np.stack(
                [
                    np.asarray(
                        layers.get(k, np.zeros((h, w), bool)), dtype=bool
                    )
                    for k in layers_order
                ]
            )
        board = np.asarray(observation["ascii_codes"])
        return np.stack(
            [board == ord(k) for k in layers_order]
        )

    # --------------------------------------------- Q-value-per-tile logging

    def _movement_deltas(self):
        from ai_safety_gridworlds_tpu.core.actions import ACTION_DELTAS_MO

        return np.asarray(ACTION_DELTAS_MO)

    def _simulate_destination(self, action: int, board: np.ndarray):
        """Destination tile if the agent took ``action`` from its current
        position (mirror of ``AgentSafetySpriteMo.simulate_update``,
        ``safety_game_mo.py:1340-1576``): move one cell unless the target's
        rendered char is impassable; NOOP/QUIT and turns stay in place."""
        pos = np.asarray(self._state.pos).reshape(-1)[:2]
        deltas = self._movement_deltas()
        if action < 0 or action >= len(deltas):
            return (int(pos[0]), int(pos[1]))
        dr, dc = deltas[action]
        if dr == 0 and dc == 0:
            return (int(pos[0]), int(pos[1]))
        h, w = board.shape
        tr = min(max(int(pos[0]) + int(dr), 0), h - 1)
        tc = min(max(int(pos[1]) + int(dc), 0), w - 1)
        impassable = set(getattr(self._game, "impassable_chars", "#"))
        if chr(board[tr, tc]) in impassable:
            return (int(pos[0]), int(pos[1]))
        return (tr, tc)

    def _update_q_values(self, q_value_per_action):
        """Mean Q per destination location and per tile type over the action
        set (``safety_game_mo.py:810-857``). Values persist across steps —
        unreachable tile types keep their last estimate."""
        if self._state is None:
            return
        board = np.asarray(self.char_board())
        minimum = int(self._game.action_min)
        per_location: dict = {}
        per_tiletype: dict = {}
        for action_index, q_value in enumerate(q_value_per_action):
            action = minimum + action_index
            loc = self._simulate_destination(action, board)
            tile_type = chr(board[loc])
            per_location.setdefault(loc, []).append(q_value)
            per_tiletype.setdefault(tile_type, []).append(q_value)
        self.q_value_per_location.update(
            {k: np.mean(v, axis=0) for k, v in per_location.items()}
        )
        self.q_value_per_tiletype.update(
            {k: np.mean(v, axis=0) for k, v in per_tiletype.items()}
        )

    def _init_tile_types(self):
        """Passable tile-type chars for Q-value logging
        (``safety_game_mo.py:1326-1336``): board chars minus impassable and
        the agent's own char, plus the gap char."""
        board = np.asarray(self.char_board())
        chars = {chr(int(c)) for c in np.unique(board)}
        impassable = set(getattr(self._game, "impassable_chars", "#"))
        agent_chars = set(
            getattr(
                self._game,
                "agent_chars",
                getattr(self._game, "agent_char", "A"),
            )
        )
        self._environment_data[TILE_TYPES] = sorted(
            (chars - impassable - agent_chars) | {" "}
        )

    def _get_hidden_reward(self, default_reward=0):
        """Cumulative hidden reward for the running episode, or
        ``default_reward`` if no entity has written one (the plot's
        HIDDEN_REWARD key is created lazily, ``safety_game.py:598-606``)."""
        if not getattr(self, "_hidden_written", False):
            return default_reward
        return self._hidden_return

    # Performance: vector-valued (``safety_game_mo.py:938-968``).

    def get_overall_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        mean = np.mean(
            np.stack(self._episodic_performances), axis=0
        )
        if self.scalarise:
            return np.float64(mean.sum())
        return np.asarray(mean, dtype=np.float64)

    def get_last_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        last = np.asarray(self._episodic_performances[-1], dtype=np.float64)
        if self.scalarise:
            return np.float64(last.sum())
        return last

    # ----------------------------------------------------------- CSV logging

    def _open_log_file(self):
        statics = self._statics
        if self.log_dir and not os.path.exists(self.log_dir):
            os.makedirs(self.log_dir)
        classname = (
            type(self._game).__module__ + "." + type(self._game).__qualname__
        )
        timestamp_str = datetime.datetime.strftime(
            datetime.datetime.now(), "%Y.%m.%d-%H.%M.%S"
        )
        comment = self.log_filename_comment
        log_filename = (
            classname
            + ("-" if comment else "")
            + comment
            + "-"
            + timestamp_str
            + ".csv"
        )
        statics["log_filename"] = log_filename

        if self.log_arguments_to_separate_file:
            arguments_filename = (
                classname
                + ("-" if comment else "")
                + comment
                + "-arguments-"
                + timestamp_str
                + ".txt"
            )
            with open(
                os.path.join(self.log_dir, arguments_filename),
                mode="wt",
                encoding="utf-8",
            ) as f:
                print("{", file=f)
                for k, v in self.log_arguments.items():
                    print(f"\t'{k}': {v},", file=f)
                print("\t'FLAGS': {", file=f)
                for k, v in self.flags.items():
                    print(f"\t\t'{k}': {v},", file=f)
                print("\t},", file=f)
                print("\t'reward_dimensions': {", file=f)
                unit_space = self.reward_unit_space
                if isinstance(unit_space, dict):
                    # MoMa: per-agent unit spaces.
                    for agent, space in unit_space.items():
                        print(f"\t\t'{agent}': {space},", file=f)
                elif unit_space:
                    for i, k in enumerate(self.enabled_reward_dimension_keys):
                        print(
                            f"\t\t'{k}': [{unit_space[0][i]}, "
                            f"{unit_space[1][i]}],",
                            file=f,
                        )
                print("\t},", file=f)
                print("\t'metrics_keys': [", file=f)
                for k in self.metrics_keys:
                    print(f"\t\t'{k}',", file=f)
                print("\t],", file=f)
                print("}", file=f)

        if self.gzip_log:
            import gzip

            f = gzip.open(
                os.path.join(self.log_dir, log_filename + ".gz"),
                mode="wt",
                newline="",
                encoding="utf-8",
                compresslevel=LOG_COMPRESSLEVEL,
            )
        else:
            f = open(
                os.path.join(self.log_dir, log_filename),
                mode="wt",
                buffering=1024 * 1024,
                newline="",
                encoding="utf-8",
            )
        self._write_log_header(f)
        statics["log_file_handle"] = f

    def _write_log_header(self, f):
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL, delimiter=";")
        keys = self.enabled_reward_dimension_keys
        data = []
        for col in self.log_columns:
            if col == LOG_REWARD:
                data += [LOG_REWARD + "_" + k for k in keys]
            elif col == LOG_CUMULATIVE_REWARD:
                data += [LOG_CUMULATIVE_REWARD + "_" + k for k in keys]
            elif col == LOG_AVERAGE_REWARD:
                data += [LOG_AVERAGE_REWARD + "_" + k for k in keys]
            elif col == LOG_METRICS:
                data += [LOG_METRICS + "_" + k for k in self.metrics_keys]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                data += [
                    LOG_QVALUES_PER_TILETYPE + "_" + t.strip() + "_" + k
                    for t in tile_types
                    for k in keys
                ]
            else:
                data.append(col)
        writer.writerow(data)
        f.flush()

    def _write_log_row(
        self,
        f,
        iteration,
        reward_dims,
        scalar_reward,
        cumulative_dims,
        average_dims,
        scalar_cumulative,
        scalar_average,
        gini,
        cumulative_gini,
        mo_var,
        cumulative_var,
        average_var,
    ):
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL, delimiter=";")
        data = []
        for col in self.log_columns:
            if col == LOG_TIMESTAMP:
                data.append(
                    datetime.datetime.strftime(
                        datetime.datetime.now(), "%Y.%m.%d-%H.%M.%S"
                    )
                )
            elif col == LOG_ENVIRONMENT:
                data.append(
                    type(self._game).__module__
                    + "."
                    + type(self._game).__qualname__
                )
            elif col == LOG_ENV_SEED:
                data.append(self.get_env_seed())
            elif col in (LOG_ENV_LAYOUT_SEED, LOG_TRIAL):
                data.append(self.get_env_layout_seed())
            elif col == LOG_EPISODE:
                data.append(self.get_episode_no())
            elif col == LOG_ITERATION:
                data.append(iteration)
            elif col == LOG_ARGUMENTS:
                data.append(str(self.log_arguments))
            elif col == LOG_REWARD:
                data += [self.format_float(v) for v in reward_dims]
            elif col == LOG_SCALAR_REWARD:
                data.append(self.format_float(scalar_reward))
            elif col == LOG_CUMULATIVE_REWARD:
                data += [self.format_float(v) for v in cumulative_dims]
            elif col == LOG_AVERAGE_REWARD:
                data += [self.format_float(v) for v in average_dims]
            elif col == LOG_SCALAR_CUMULATIVE_REWARD:
                data.append(self.format_float(scalar_cumulative))
            elif col == LOG_SCALAR_AVERAGE_REWARD:
                data.append(self.format_float(scalar_average))
            elif col == LOG_GINI_INDEX:
                data.append(self.format_float(gini))
            elif col == LOG_CUMULATIVE_GINI_INDEX:
                data.append(self.format_float(cumulative_gini))
            elif col == LOG_MO_VARIANCE:
                data.append(self.format_float(mo_var))
            elif col == LOG_CUMULATIVE_MO_VARIANCE:
                data.append(self.format_float(cumulative_var))
            elif col == LOG_AVERAGE_MO_VARIANCE:
                data.append(self.format_float(average_var))
            elif col == LOG_METRICS:
                metrics = self._current_metrics()
                data += [
                    self.format_float(metrics.get(k, None))
                    for k in self.metrics_keys
                ]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                for t in tile_types:
                    q = self.q_value_per_tiletype.get(
                        t, np.zeros([len(reward_dims)])
                    )
                    data += [self.format_float(v) for v in q]
        writer.writerow(data)
        f.flush()

    def format_float(self, value):
        """Decimal normalization (``safety_game_mo.py:1218-1227``)."""
        if isinstance(value, numbers.Number):
            d = self.decimal_context.create_decimal_from_float(float(value))
            integral = d.to_integral()
            return integral if d == integral else d.normalize()
        return str(value)

    def close(self):
        f = self._statics.get("log_file_handle")
        if f:
            f.flush()
            f.close()
            self._statics["log_file_handle"] = None
