"""Stateful multi-objective multi-agent environment shell.

Mirrors the reference ``SafetyEnvironmentMoMa``
(``safety_game_moma.py:151-2100``) + ``EnvironmentMa``
(``pycolab_interface_ma.py:44-440``): dict-keyed per-agent step types,
rewards, cumulative statistics, per-agent termination bookkeeping (DEAD
states), randomized sequential sub-stepping driven by the env Generator, and
agent-centric perspective observations.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core.timestep import (
    BoundedArraySpec,
    StepType,
    TerminationReason,
)
from ai_safety_gridworlds_tpu.helpers.safety_env import (
    EXTRA_OBSERVATIONS,
    TimeStep,
)
from ai_safety_gridworlds_tpu.ma.safety_game_ma import (
    MaSafetyGridworld,
    agent_perspective,
)
from ai_safety_gridworlds_tpu.mo.safety_game_mo import (
    CUMULATIVE_REWARD,
    AVERAGE_REWARD,
    CUMULATIVE_REWARD_DICT,
    GINI_INDEX,
    CUMULATIVE_GINI_INDEX,
    INFO_ACTION_DIRECTION,
    INFO_LAYERS,
    INFO_OBSERVATION_DIRECTION,
    LOG_QVALUES_PER_TILETYPE,
    METRICS_DICT,
    METRICS_MATRIX,
    MO_VARIANCE,
    CUMULATIVE_MO_VARIANCE,
    AVERAGE_MO_VARIANCE,
    REWARD_DICT,
    SafetyEnvironmentMo,
    gini_coefficient,
)


class SafetyEnvironmentMoMa(SafetyEnvironmentMo):
    """Multi-agent shell over a :class:`MaSafetyGridworld`."""

    def __init__(self, game: MaSafetyGridworld, **kwargs):
        # Opt-in byte-compatible CSV mode: reproduce the upstream MoMa
        # writer's quirky layout (``safety_game_moma.py:901-981,1382-1487``)
        # where dict-valued columns emit agent-NAME cells / dict reprs
        # instead of flattened per-dimension values (PARITY.md "MoMa
        # per-agent CSV columns"). Off by default: the flattened layout is
        # the cleaner one.
        self.reference_csv_format = bool(
            kwargs.pop("reference_csv_format", False)
        )
        self._agent_names = [c for c in game.agent_chars[: game.n_agents]]
        self._episode_returns = np.zeros(
            (game.n_agents, game.reward_space.n_dims), np.float64
        )
        self._episode_float_touched = np.zeros(
            (game.n_agents, game.reward_space.n_dims), bool
        )
        # Observable agent attributes (continuous modalities like firemaker's
        # expression dims); opt-in via set_observable_attribute_categories.
        self._observable_attribute_categories: list = list(
            getattr(game, "observable_attribute_categories", [])
        )
        self._observable_attribute_value_mapping: dict = {}
        self._observable_attributes: dict = {}
        # Per-agent reward dimension keys + index maps into the kernel's
        # union reward space (``safety_game_moma.py:273-280``); needed before
        # the probe reset in super().__init__.
        self.enabled_agents_reward_dimensions = game.agent_reward_keys()
        union_index = {k: i for i, k in enumerate(game.reward_space.keys)}
        self._agent_reward_index = {
            a: np.asarray(
                [union_index[k] for k in keys], dtype=np.int64
            )
            for a, keys in self.enabled_agents_reward_dimensions.items()
        }
        super().__init__(game, **kwargs)
        enabled_ma = getattr(game, "enabled_ma_rewards", None)
        if enabled_ma is not None:
            from ai_safety_gridworlds_tpu.mo.mo_reward import mo_reward

            self.reward_unit_space = {
                a: [
                    np.array(
                        [float(x) for x in space[0]]
                    ),
                    np.array([float(x) for x in space[1]]),
                ]
                for a, space in (
                    (a, mo_reward.get_enabled_reward_unit_space(rewards))
                    for a, rewards in enabled_ma.items()
                )
            }
        else:
            unit = game.reward_space.unit_space()
            self.reward_unit_space = {
                a: [
                    np.array([float(x) for x in unit[0]]),
                    np.array([float(x) for x in unit[1]]),
                ]
                for a in self._agent_names
            }

    def _agent_reward_vector(self, union_row: np.ndarray, agent: str):
        return union_row[self._agent_reward_index[agent]]

    # ------------------------------------------------------------- helpers

    @property
    def agent_names(self):
        return list(self._agent_names)

    def _agent_index(self, agent) -> int:
        return self._agent_names.index(agent)

    def _normalize_actions(self, agents_actions) -> dict:
        """Numeric actions become {"step": a} (``safety_game_ma.py:412-422``).
        Direction modalities (``action_direction``/``observation_direction``,
        ``pycolab_interface_ma.py:192-207``) are kept as action entries;
        continuous attribute modalities (e.g. firemaker's ``expression_*``
        dims, ``firemaker_ex_ma.py:830-839``) are captured into the agents'
        observable attributes. Unknown modalities raise, mirroring the
        reference action-size check (``pycolab_interface_ma.py:202-207``)."""
        continuous = getattr(self._game, "continuous_action_ranges", {})
        out = {}
        for agent, action in agents_actions.items():
            if isinstance(action, dict):
                if "step" not in action:
                    raise RuntimeError(
                        "Multi-modal actions must contain a 'step' entry"
                    )
                for key, value in action.items():
                    if key in ("step", "action_direction",
                               "observation_direction"):
                        continue
                    if key not in continuous:
                        raise RuntimeError(
                            f"Unknown action modality {key!r}"
                        )
                    if key in self._observable_attribute_categories:
                        self._observable_attributes.setdefault(key, {})[
                            agent
                        ] = float(value)
                out[agent] = action
            else:
                out[agent] = {"step": int(np.asarray(action).item())}
        return out

    def _direction_overrides(self, agents_actions) -> dict:
        """Per-agent direction-modality override arrays (−1 = absent): the
        ``action_direction``/``observation_direction`` action-dict entries
        steer the facing update instead of the ``step`` entry
        (``safety_game_ma.py:652-653,715-716``)."""
        n = self._game.n_agents
        ado = np.full((n,), -1, np.int32)
        odo = np.full((n,), -1, np.int32)
        for agent, action in agents_actions.items():
            i = self._agent_index(agent)
            if "action_direction" in action:
                ado[i] = int(np.asarray(action["action_direction"]).item())
            if "observation_direction" in action:
                odo[i] = int(
                    np.asarray(action["observation_direction"]).item()
                )
        return {
            "action_direction_override": ado,
            "observation_direction_override": odo,
        }

    # ----------------------------------------- observable agent attributes

    def set_observable_attribute_categories(
        self,
        observable_attribute_categories=[],
        observable_attribute_value_mapping=None,
    ):
        """Enable observable agent-attribute channels
        (``safety_game_ma.py:236-239`` / ``observation_distiller_ex.py:99-144``):
        each category becomes a float board with every visible agent's
        attribute value painted at its position, plus per-agent sparse
        layers."""
        self._observable_attribute_categories = list(
            observable_attribute_categories
        )
        self._observable_attribute_value_mapping = dict(
            observable_attribute_value_mapping or {}
        )

    def _attach_observable_attributes(self, obs):
        if not self._observable_attribute_categories:
            return
        board_shape = np.asarray(obs["board"]).shape
        positions = np.asarray(self._state.pos)
        boards = {}
        layers = {}
        for attr in self._observable_attribute_categories:
            board = np.zeros(board_shape, np.float32)
            layers[attr] = {}
            values = self._observable_attributes.get(attr, {})
            for i, a in enumerate(self._agent_names):
                if a not in values:
                    continue
                value = values[a]
                mapping = self._observable_attribute_value_mapping.get(attr)
                if mapping is not None:
                    value = mapping.get(value, value)
                pos = tuple(positions[i])
                board[pos] = value
                layer = np.zeros(board_shape, np.float32)
                layer[pos] = value
                layers[attr][a] = layer
            boards[attr] = board
        obs["agent_attribute_board"] = boards
        obs["agent_attribute_layers"] = layers

    # ----------------------------------------------------------------- api

    def action_spec(self):
        """Multi-modal MA action spec (``pycolab_interface_ma.py:298-380``):
        a (3,) discrete spec for the ``step`` / ``action_direction`` /
        ``observation_direction`` modalities, plus a float32 spec for any
        continuous modalities (e.g. expression dims) as a
        ``[discrete, continuous]`` list."""
        game = self._game
        # direction_set = DEFAULT_ACTION_SET + [NOOP] upstream
        # (``island_navigation_ex_ma.py:947``): ids 0..4.
        dir_lo, dir_hi = getattr(game, "direction_action_range", (0, 4))
        discrete = BoundedArraySpec(
            shape=(3,),
            dtype="int32",
            minimum=[game.action_min, dir_lo, dir_lo],
            maximum=[game.action_max, dir_hi, dir_hi],
            name="discrete",
        )
        continuous = getattr(game, "continuous_action_ranges", None)
        if continuous:
            discrete = [
                discrete,
                BoundedArraySpec(
                    shape=(len(continuous),),
                    dtype="float32",
                    minimum=[lo for lo, _ in continuous.values()],
                    maximum=[hi for _, hi in continuous.values()],
                    name="continuous",
                ),
            ]
        return discrete

    def reset(self, *args, **kwargs) -> TimeStep:
        timestep = super().reset(*args, **kwargs)
        n = self._game.n_agents
        self._episode_returns = np.zeros(
            (n, self._game.reward_space.n_dims), np.float64
        )
        self._episode_float_touched = np.zeros(
            (n, self._game.reward_space.n_dims), bool
        )
        # Per-agent step types as a dict (``pycolab_interface_ma.py:161-171``).
        step_types = {a: StepType.FIRST for a in self._agent_names}
        return timestep._replace(step_type=step_types)

    def step(self, agents_actions, q_value_per_action=None) -> TimeStep:
        if self._state is None:
            # No live episode (construction probe dropped it): start one,
            # like the scalar/MO shells and the reference
            # (``pycolab_interface_ma.py``: ``if self._current_game is
            # None: return self.reset(...)``).
            return self.reset()
        if q_value_per_action is None:
            q_value_per_action = self.q_value_per_action
        if q_value_per_action is not None and (
            LOG_QVALUES_PER_TILETYPE in self.log_columns
        ):
            self._update_q_values_ma(agents_actions, q_value_per_action)
        agents_actions = self._normalize_actions(agents_actions)

        state = self._state
        prev_types = np.asarray(state.step_types)
        acting = [self._agent_index(a) for a in agents_actions]

        # Dead/LAST agents: commands rejected unless the episode can restart.
        # The restart condition reproduces the reference expression verbatim,
        # including its agent/agent2 mixing (``pycolab_interface_ma.py:211-218``:
        # ``all(state[agent].dead() or state[agent2].last() ...)``).
        for agent in agents_actions:
            i = self._agent_index(agent)
            if prev_types[i] in (int(StepType.LAST), int(StepType.DEAD)):
                if all(
                    prev_types[i] == int(StepType.DEAD)
                    or prev_types[j] == int(StepType.LAST)
                    for j in range(len(prev_types))
                ):
                    return self.reset()
                raise ValueError(f"Agent {agent} is done")

        # Host-drawn agent order, consuming the env Generator exactly like
        # the reference shuffle.
        order = self._game.host_agent_order(self._np_random, acting)
        actions_arr = np.full((self._game.n_agents,), -1, np.int32)
        for agent, action in agents_actions.items():
            actions_arr[self._agent_index(agent)] = action["step"]
        dir_overrides = self._direction_overrides(agents_actions)

        if hasattr(self._game, "host_substep"):
            # Full host-mirror sub-stepping (e.g. aintelope_savanna): the
            # parity path executes the numpy mirror, consuming the env
            # Generator exactly like the reference; the device kernel is the
            # batched device path.
            rewards = np.zeros(
                (self._game.n_agents, self._game.reward_space.n_dims),
                np.float32,
            )
            for slot in range(self._game.n_agents):
                agent_idx = int(order[slot])
                action = int(actions_arr[agent_idx])
                if action < 0:
                    continue
                state, delta = self._game.host_substep(
                    state, agent_idx, action, self._np_random,
                    overrides=dir_overrides,
                )
                rewards = rewards + np.asarray(delta, np.float32)
            if not hasattr(self, "_jit_finalize"):
                self._jit_finalize = jax.jit(self._game.finalize_step)
            self._state, out = self._jit_finalize(
                state, jnp.asarray(rewards)
            )
            obs = self._jit_observe()(self._state)
        elif hasattr(self._game, "host_substep_options"):
            # Sub-step-granular host randomness (e.g. firemaker's fire
            # spread): loop the slots on host, drawing each sub-step's
            # randomness from the env Generator against the live state.
            if not hasattr(self, "_jit_substep"):
                self._jit_substep = jax.jit(
                    self._game.apply_substep, static_argnames=("slot",)
                )
                self._jit_finalize = jax.jit(self._game.finalize_step)
            rewards = np.zeros(
                (self._game.n_agents, self._game.reward_space.n_dims),
                np.float32,
            )
            for slot in range(self._game.n_agents):
                agent_idx = int(order[slot])
                action = int(actions_arr[agent_idx])
                sub_options = {
                    k: jnp.asarray(v)
                    for k, v in self._game.host_substep_options(
                        state, agent_idx, action, self._np_random,
                        overrides=dir_overrides,
                    ).items()
                }
                sub_options.update(
                    {k: jnp.asarray(v) for k, v in dir_overrides.items()}
                )
                state, delta = self._jit_substep(
                    state,
                    jnp.int32(agent_idx),
                    jnp.int32(action),
                    sub_options,
                    slot,
                )
                rewards = rewards + np.asarray(delta)
            self._state, out = self._jit_finalize(
                state, jnp.asarray(rewards)
            )
            obs = self._jit_observe()(self._state)
        else:
            options = {
                "agent_order": jnp.asarray(order),
            }
            options.update(
                {k: jnp.asarray(v) for k, v in dir_overrides.items()}
            )
            options.update(
                {
                    k: jnp.asarray(v)
                    for k, v in self._game.host_step_options(
                        state, actions_arr
                    ).items()
                }
            )
            self._state, out, obs = self._jit_step(
                state, jnp.asarray(actions_arr), options
            )

        step_types = {
            a: StepType(int(out.step_types[i]))
            for i, a in enumerate(self._agent_names)
        }
        rewards_arr = np.asarray(out.rewards, np.float64)
        self._episode_returns = self._episode_returns + rewards_arr
        # Fractional provenance (per dim, per episode): once a dim's
        # accumulation goes non-integer, the upstream writer's running
        # Python sum is a float forever — even if later contributions
        # cancel it back to exactly 0 ("0.0", not "0"). Value-based: a
        # non-integer per-step sum is exactly the event that flips the
        # upstream number to float type (``safety_game_mo.py:1218-1227``).
        self._episode_float_touched = self._episode_float_touched | (
            np.mod(rewards_arr, 1.0) != 0.0
        )
        self._refresh_host_extras()

        reward = {
            a: (
                np.float64(rewards_arr[i].sum())
                if self.scalarise
                else self._agent_reward_vector(rewards_arr[i], a)
            )
            for i, a in enumerate(self._agent_names)
        }
        discount = float(out.discount)

        # Termination bookkeeping.
        reasons = np.asarray(out.termination_reasons)
        term_dict = {
            a: (
                TerminationReason(int(reasons[i]))
                if reasons[i] != int(TerminationReason.NONE)
                else None
            )
            for i, a in enumerate(self._agent_names)
        }
        self._environment_data["termination_reason"] = term_dict

        self._last_step_type = (
            StepType.LAST
            if bool(out.game_over)
            else StepType.MID
        )
        if bool(out.game_over):
            self._episodic_performances.append(self._episode_returns.copy())

        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = {
            "termination_reason": term_dict,
        }
        self._attach_ma_stats(observation, step_rewards=rewards_arr)
        self._attach_observable_attributes(observation)
        self._last_observation_dict = observation
        if self.log_columns and int(np.asarray(self._state.t)) > 0:
            f = self._statics.get("log_file_handle")
            if f:
                self._write_ma_log_row(
                    f, rewards_arr, observation, step_types
                )
        return TimeStep(step_types, reward, discount, observation)

    # --------------------------------------------------------- CSV logging

    def _agent_log_columns(self, prefix):
        return [
            prefix + "_" + a + "_" + k
            for a in self._agent_names
            for k in self.enabled_agents_reward_dimensions[a]
        ]

    def _reference_runtime_float_dims(self):
        """Per agent: which reward dims receive FLOAT-typed contributions
        at runtime upstream, making any fired (nonzero) value a Python
        float in the dict-repr cells. Two static sources: a non-int
        constant value (e.g. a fractional flag override), and — under
        ``use_satiation_proportional_reward`` — the four satiation score
        constants, whose upstream contributions are ``score * satiation``
        products with satiation always a float (absl ``DEFINE_float``
        rates; ``island_navigation_ex_ma.py:344,595-596,805``)."""
        cached = getattr(self, "_ref_float_dims_cache", None)
        if cached is not None:
            return cached
        game = self._game
        cfg = getattr(game, "cfg", {}) or {}
        prop_dims = set()
        if cfg.get("use_satiation_proportional_reward", False):
            for const in (
                # savanna naming / island_ex naming
                "DRINK_DEFICIENCY_SCORE", "FOOD_DEFICIENCY_SCORE",
                "DRINK_OVERSATIATION_SCORE", "FOOD_OVERSATIATION_SCORE",
                "DRINK_DEFICIENCY_REWARD", "FOOD_DEFICIENCY_REWARD",
                "DRINK_OVERSATIATION_REWARD", "FOOD_OVERSATIATION_REWARD",
            ):
                mo = cfg.get(const)
                if mo is not None and hasattr(
                    mo, "_reward_dimensions_dict"
                ):
                    prop_dims |= set(mo._reward_dimensions_dict)
        enabled_ma = getattr(game, "enabled_ma_rewards", None)
        out = {}
        for a, keys in self.enabled_agents_reward_dimensions.items():
            fl = {k: k in prop_dims for k in keys}
            for mo in (enabled_ma or {}).get(a, []):
                for k, v in mo._reward_dimensions_dict.items():
                    if k in fl and not isinstance(v, int):
                        fl[k] = True
            out[a] = [fl[k] for k in keys]
        self._ref_float_dims_cache = out
        return out

    @staticmethod
    def _reference_py_number(v, float_typed=False, float_touched=False):
        """float64 cell -> the Python number upstream would hold. The
        upstream writer accumulates plain Python numbers, so a dim is a
        float exactly when a float contribution has joined its sum;
        observable as: the value is currently non-integer, OR the dim is
        statically float-typed (``_reference_runtime_float_dims``) and
        fired (nonzero — upstream proportional contributions are strictly
        nonzero), OR the per-episode fractional-provenance bit
        ``float_touched`` is set (the running sum went non-integer at
        some earlier step — it stays a Python float even when later
        contributions cancel it back to exactly 0: "0.0", not "0";
        ``safety_game_mo.py:1218-1227``). Residual ambiguity (PARITY.md):
        integral-valued float contributions to a dim with otherwise
        int-typed constants are indistinguishable from int contributions
        by value; no shipped env produces them."""
        f = float(v)
        if float_touched or not f.is_integer():
            return f
        if float_typed and f != 0:
            return f
        return int(f)

    def _reference_metrics_keys(self):
        """Metric columns as the upstream writer would freeze them at
        construction (``safety_game_moma.py:327``): the game's
        reference-init order filtered by the enabled metric set."""
        order = getattr(self._game, "reference_init_metrics_order", None)
        if order is None:
            return self.metrics_keys
        enabled = set(self.metrics_keys)
        return [k for k in order if k in enabled]

    def _write_log_header(self, f):
        """Per-agent CSV header (``safety_game_moma.py:901-981``). Deviation
        from upstream: dict-valued columns are flattened to explicit
        ``<column>_<agent>[_<dim>]`` columns (the upstream writer emits
        Python dict reprs for these cells)."""
        import csv as _csv

        from ai_safety_gridworlds_tpu.mo.safety_game_mo import (
            LOG_AVERAGE_MO_VARIANCE,
            LOG_AVERAGE_REWARD,
            LOG_CUMULATIVE_GINI_INDEX,
            LOG_CUMULATIVE_MO_VARIANCE,
            LOG_CUMULATIVE_REWARD,
            LOG_GINI_INDEX,
            LOG_METRICS,
            LOG_MO_VARIANCE,
            LOG_REWARD,
            LOG_SCALAR_AVERAGE_REWARD,
            LOG_SCALAR_CUMULATIVE_REWARD,
            LOG_SCALAR_REWARD,
            TILE_TYPES,
        )

        writer = _csv.writer(f, quoting=_csv.QUOTE_MINIMAL, delimiter=";")
        ref_mode = self.reference_csv_format
        data = []
        for col in self.log_columns:
            if col in (
                LOG_REWARD, LOG_CUMULATIVE_REWARD, LOG_AVERAGE_REWARD
            ) and ref_mode:
                # Upstream iterates the agent-keyed dict: one column per
                # AGENT (``safety_game_moma.py:935-945``).
                data += [col + "_" + a for a in self._agent_names]
            elif col == LOG_REWARD:
                data += self._agent_log_columns(LOG_REWARD)
            elif col == LOG_CUMULATIVE_REWARD:
                data += self._agent_log_columns(LOG_CUMULATIVE_REWARD)
            elif col == LOG_AVERAGE_REWARD:
                data += self._agent_log_columns(LOG_AVERAGE_REWARD)
            elif col in (
                LOG_SCALAR_REWARD,
                LOG_SCALAR_CUMULATIVE_REWARD,
                LOG_SCALAR_AVERAGE_REWARD,
                LOG_GINI_INDEX,
                LOG_CUMULATIVE_GINI_INDEX,
                LOG_MO_VARIANCE,
                LOG_CUMULATIVE_MO_VARIANCE,
                LOG_AVERAGE_MO_VARIANCE,
            ):
                if ref_mode:  # single dict-repr cell upstream
                    data.append(col)
                else:
                    data += [col + "_" + a for a in self._agent_names]
            elif col == LOG_METRICS:
                keys = (
                    self._reference_metrics_keys()
                    if ref_mode
                    else self.metrics_keys
                )
                data += [LOG_METRICS + "_" + k for k in keys]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                if ref_mode:
                    # Upstream iterates TWO agent-keyed dicts here: its
                    # TILE_TYPES is {agent: [tiles]} and dim_key iterates
                    # enabled_agents_reward_dimensions — so the header is
                    # agent x agent (``safety_game_moma.py:973-979``).
                    data += [
                        LOG_QVALUES_PER_TILETYPE
                        + "_" + a1.strip() + "_" + a2
                        for a1 in self._agent_names
                        for a2 in self._agent_names
                    ]
                else:
                    data += [
                        LOG_QVALUES_PER_TILETYPE
                        + "_" + a + "_" + t.strip() + "_" + k
                        for a in self._agent_names
                        for t in tile_types
                        for k in self.enabled_agents_reward_dimensions[a]
                    ]
            else:
                data.append(col)
        writer.writerow(data)
        f.flush()

    def _write_ma_log_row(self, f, rewards_arr, observation,
                          step_types=None):
        import csv as _csv
        import datetime as _dt

        from ai_safety_gridworlds_tpu.mo.safety_game_mo import (
            AVERAGE_MO_VARIANCE,
            AVERAGE_REWARD,
            CUMULATIVE_GINI_INDEX,
            CUMULATIVE_MO_VARIANCE,
            CUMULATIVE_REWARD,
            GINI_INDEX,
            LOG_ARGUMENTS,
            LOG_AVERAGE_MO_VARIANCE,
            LOG_AVERAGE_REWARD,
            LOG_CUMULATIVE_GINI_INDEX,
            LOG_CUMULATIVE_MO_VARIANCE,
            LOG_CUMULATIVE_REWARD,
            LOG_ENV_LAYOUT_SEED,
            LOG_ENV_SEED,
            LOG_ENVIRONMENT,
            LOG_EPISODE,
            LOG_GINI_INDEX,
            LOG_ITERATION,
            LOG_METRICS,
            LOG_MO_VARIANCE,
            LOG_REWARD,
            LOG_SCALAR_AVERAGE_REWARD,
            LOG_SCALAR_CUMULATIVE_REWARD,
            LOG_SCALAR_REWARD,
            LOG_TIMESTAMP,
            LOG_TRIAL,
            MO_VARIANCE,
            TILE_TYPES,
        )

        iteration = int(np.asarray(self._state.t))
        per_agent_reward = {
            a: self._agent_reward_vector(rewards_arr[i], a)
            for i, a in enumerate(self._agent_names)
        }
        ref_mode = self.reference_csv_format
        if ref_mode:
            # Upstream value semantics (``safety_game_moma.py:1287-1355``):
            # per-step dicts SKIP dead agents; cumulative/average dicts
            # keep every agent; dims are plain-Python float lists.
            dead = int(StepType.DEAD)
            alive = [
                a for a in self._agent_names
                if step_types is None or int(step_types[a]) != dead
            ]
            conv = self._reference_py_number
            float_dims = self._reference_runtime_float_dims()
            reward_dims_f = {
                a: [
                    conv(v, float_typed=ft)
                    for v, ft in zip(per_agent_reward[a], float_dims[a])
                ]
                for a in alive
            }
            cum_dims = {
                a: [
                    conv(v, float_typed=ft, float_touched=bool(tc))
                    for v, ft, tc in zip(
                        self._agent_reward_vector(
                            self._episode_returns[i], a
                        ),
                        float_dims[a],
                        self._agent_reward_vector(
                            self._episode_float_touched[i], a
                        ),
                    )
                ]
                for i, a in enumerate(self._agent_names)
            }
            avg_dims = {
                a: [x / (iteration + 1) for x in dims]
                for a, dims in cum_dims.items()
            }
        writer = _csv.writer(f, quoting=_csv.QUOTE_MINIMAL, delimiter=";")
        data = []
        for col in self.log_columns:
            if col == LOG_TIMESTAMP:
                data.append(
                    _dt.datetime.strftime(
                        _dt.datetime.now(), "%Y.%m.%d-%H.%M.%S"
                    )
                )
            elif col == LOG_ENVIRONMENT:
                data.append(
                    type(self._game).__module__
                    + "." + type(self._game).__qualname__
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
                if ref_mode:
                    # Upstream iterates the dict: agent-NAME cells
                    # (``safety_game_moma.py:1422-1426``).
                    data += [
                        self.format_float(dim_value)
                        for dim_value in reward_dims_f
                    ]
                else:
                    for a in self._agent_names:
                        data += [
                            self.format_float(v)
                            for v in per_agent_reward[a]
                        ]
            elif col == LOG_CUMULATIVE_REWARD:
                if ref_mode:
                    data += [
                        self.format_float(dim_value)
                        for dim_value in cum_dims
                    ]
                else:
                    cum = observation.get(CUMULATIVE_REWARD, {})
                    for a in self._agent_names:
                        data += [
                            self.format_float(v)
                            for v in np.atleast_1d(cum.get(a, []))
                        ]
            elif col == LOG_AVERAGE_REWARD:
                if ref_mode:
                    data += [
                        self.format_float(dim_value)
                        for dim_value in avg_dims
                    ]
                else:
                    avg = observation.get(AVERAGE_REWARD, {})
                    for a in self._agent_names:
                        data += [
                            self.format_float(v)
                            for v in np.atleast_1d(avg.get(a, []))
                        ]
            elif col == LOG_SCALAR_REWARD:
                if ref_mode:
                    data.append(self.format_float(
                        {a: sum(reward_dims_f[a]) for a in alive}
                    ))
                else:
                    data += [
                        self.format_float(per_agent_reward[a].sum())
                        for a in self._agent_names
                    ]
            elif col == LOG_SCALAR_CUMULATIVE_REWARD:
                if ref_mode:
                    data.append(self.format_float(
                        {a: sum(d) for a, d in cum_dims.items()}
                    ))
                else:
                    cum = observation.get(CUMULATIVE_REWARD, {})
                    data += [
                        self.format_float(np.sum(cum.get(a, 0.0)))
                        for a in self._agent_names
                    ]
            elif col == LOG_SCALAR_AVERAGE_REWARD:
                if ref_mode:
                    data.append(self.format_float(
                        {a: sum(d) for a, d in avg_dims.items()}
                    ))
                else:
                    avg = observation.get(AVERAGE_REWARD, {})
                    data += [
                        self.format_float(np.sum(avg.get(a, 0.0)))
                        for a in self._agent_names
                    ]
            elif col in (
                LOG_GINI_INDEX,
                LOG_CUMULATIVE_GINI_INDEX,
                LOG_MO_VARIANCE,
                LOG_CUMULATIVE_MO_VARIANCE,
                LOG_AVERAGE_MO_VARIANCE,
            ):
                if ref_mode:
                    # One str(dict) cell per column, dead agents skipped
                    # (``safety_game_moma.py:1330-1356,1444-1460``).
                    src = {
                        LOG_GINI_INDEX: {
                            a: gini_coefficient(reward_dims_f[a]) * 100
                            for a in alive
                        },
                        LOG_CUMULATIVE_GINI_INDEX: {
                            a: gini_coefficient(cum_dims[a]) * 100
                            for a in alive
                        },
                        LOG_MO_VARIANCE: {
                            a: np.var(reward_dims_f[a], ddof=0)
                            for a in alive
                        },
                        LOG_CUMULATIVE_MO_VARIANCE: {
                            a: np.var(cum_dims[a], ddof=0) for a in alive
                        },
                        LOG_AVERAGE_MO_VARIANCE: {
                            a: np.var(avg_dims[a], ddof=0) for a in alive
                        },
                    }[col]
                    data.append(self.format_float(src))
                else:
                    obs_key = {
                        LOG_GINI_INDEX: GINI_INDEX,
                        LOG_CUMULATIVE_GINI_INDEX: CUMULATIVE_GINI_INDEX,
                        LOG_MO_VARIANCE: MO_VARIANCE,
                        LOG_CUMULATIVE_MO_VARIANCE: CUMULATIVE_MO_VARIANCE,
                        LOG_AVERAGE_MO_VARIANCE: AVERAGE_MO_VARIANCE,
                    }[col]
                    values = observation.get(obs_key, {})
                    data += [
                        self.format_float(values.get(a, 0.0))
                        for a in self._agent_names
                    ]
            elif col == LOG_METRICS:
                metrics = self._current_metrics()
                keys = (
                    self._reference_metrics_keys()
                    if ref_mode
                    else self.metrics_keys
                )
                data += [
                    self.format_float(metrics.get(k, None))
                    for k in keys
                ]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                if ref_mode:
                    # Upstream iterates its agent-keyed TILE_TYPES dict:
                    # with q-values supplied the lookup HITS the agent's
                    # {tile: vec} store and the cells become TILE-CHAR
                    # strings; without, it yields len(alive) zeros per
                    # agent (``safety_game_moma.py:1473-1484``).
                    for a in self._agent_names:
                        q = self.q_value_per_tiletype.get(
                            a, np.zeros([len(reward_dims_f)])
                        )
                        data += [self.format_float(v) for v in q]
                else:
                    for a in self._agent_names:
                        n_dims = len(
                            self.enabled_agents_reward_dimensions[a]
                        )
                        agent_q = self.q_value_per_tiletype.get(a, {})
                        for t in tile_types:
                            q = agent_q.get(t, np.zeros([n_dims]))
                            data += [self.format_float(v) for v in q]
        writer.writerow(data)
        f.flush()

    def calculate_agents_observation_coordinates(
        self,
        observation,
        agent_observations,
        occlusion_in_layers=False,
        ascii=True,
        observe_from_agent_coordinates=None,
        observe_from_agent_directions=None,
    ):
        """Per-agent relative object coordinates
        (``safety_game_moma.py:528-584``): for each agent, every layer's
        coordinates in the agent's perspective, offset so the agent sits at
        (0, 0). NB the reference emits (x, y) tuple order here."""
        result = {}
        for agent_chr, agent_observation in agent_observations.items():
            layers = agent_observation.get(INFO_LAYERS, {})
            agent_coords = (
                np.argwhere(np.asarray(layers[agent_chr]))
                if agent_chr in layers
                else None
            )
            layer_coords = self.calculate_observation_coordinates(
                {**agent_observation, INFO_LAYERS: layers},
                occlusion_in_layers=occlusion_in_layers,
                ascii=ascii,
            )
            if agent_coords is not None and len(agent_coords) > 0:
                ay, ax = int(agent_coords[0][0]), int(agent_coords[0][1])
                result[agent_chr] = {
                    key: [(x - ax, y - ay) for (y, x) in coords]
                    for key, coords in layer_coords.items()
                }
            else:
                result[agent_chr] = []
        return result

    # ------------------------------------------- Q-value-per-tile logging

    def _update_q_values_ma(self, agents_actions, q_value_per_action):
        """Per-agent destination-tile Q aggregation
        (``safety_game_moma.py:984-1047``)."""
        if self._state is None:
            return
        board = np.asarray(self.char_board())
        minimum = int(self._game.action_min)
        deltas = self._movement_deltas()
        positions = np.asarray(self._state.pos)
        h, w = board.shape
        impassable = set(
            getattr(self._game, "impassable_chars", "#")
        ) | set(self._agent_names)
        for a in agents_actions:
            if a not in q_value_per_action:
                continue
            idx = self._agent_names.index(a)
            per_location: dict = {}
            per_tiletype: dict = {}
            for action_index, q_value in enumerate(q_value_per_action[a]):
                action = minimum + action_index
                loc = (int(positions[idx][0]), int(positions[idx][1]))
                if 0 <= action < len(deltas):
                    dr, dc = deltas[action]
                    tr = min(max(loc[0] + int(dr), 0), h - 1)
                    tc = min(max(loc[1] + int(dc), 0), w - 1)
                    if chr(board[tr, tc]) not in impassable:
                        loc = (tr, tc)
                tile_type = chr(board[loc])
                per_location.setdefault(loc, []).append(q_value)
                per_tiletype.setdefault(tile_type, []).append(q_value)
            self.q_value_per_location.setdefault(a, {}).update(
                {k: np.mean(v, axis=0) for k, v in per_location.items()}
            )
            self.q_value_per_tiletype.setdefault(a, {}).update(
                {k: np.mean(v, axis=0) for k, v in per_tiletype.items()}
            )

    # ------------------------------------------------------------- stats

    def _attach_ma_stats(self, obs, step_rewards=None):
        """Per-agent statistics on the observation.

        ``step_rewards`` is the [n_agents, n_dims] per-STEP reward array
        (zeros at reset): per-step gini/variance/reward_dict come from it
        (``safety_game_moma.py:1289,1330-1352``); DEAD agents are skipped
        in the per-step stat dicts, exactly like the reference loop."""
        keys = self.enabled_reward_dimension_keys
        iteration = int(self._state.t)
        metrics_dict = self._current_metrics()
        obs[METRICS_DICT] = metrics_dict
        obs[METRICS_MATRIX] = np.array(
            [[k, v] for k, v in metrics_dict.items()], dtype=object
        )
        types = np.asarray(self._state.step_types)
        cumulative = {}
        average = {}
        gini = {}
        cum_gini = {}
        variance = {}
        cum_var = {}
        avg_var = {}
        reward_dicts = {}
        cum_dicts = {}
        for i, a in enumerate(self._agent_names):
            dims = self._agent_reward_vector(self._episode_returns[i], a)
            avg = dims / (iteration + 1)
            cumulative[a] = (
                np.float64(dims.sum()) if self.scalarise else dims.copy()
            )
            average[a] = (
                np.float64(avg.sum()) if self.scalarise else avg.copy()
            )
            step_dims = self._agent_reward_vector(
                step_rewards[i] if step_rewards is not None
                else np.zeros_like(self._episode_returns[i]),
                a,
            )
            reward_dicts[a] = dict(
                zip(
                    self.enabled_agents_reward_dimensions[a],
                    step_dims.tolist(),
                )
            )
            cum_dicts[a] = dict(
                zip(self.enabled_agents_reward_dimensions[a], dims.tolist())
            )
            if int(types[i]) == int(StepType.DEAD):
                # The reference's per-step stat loop skips dead agents
                # (their keys are absent for the step).
                continue
            gini[a] = gini_coefficient(step_dims) * 100
            cum_gini[a] = gini_coefficient(dims) * 100
            variance[a] = np.var(step_dims, ddof=0)
            cum_var[a] = np.var(dims, ddof=0)
            avg_var[a] = np.var(avg, ddof=0)
        obs[CUMULATIVE_REWARD] = cumulative
        obs[AVERAGE_REWARD] = average
        obs[GINI_INDEX] = gini
        obs[CUMULATIVE_GINI_INDEX] = cum_gini
        obs[MO_VARIANCE] = variance
        obs[CUMULATIVE_MO_VARIANCE] = cum_var
        obs[AVERAGE_MO_VARIANCE] = avg_var
        obs[CUMULATIVE_REWARD_DICT] = cum_dicts
        obs[REWARD_DICT] = reward_dicts
        # Per-agent directions.
        if hasattr(self._state, "observation_direction"):
            obs[INFO_OBSERVATION_DIRECTION] = {
                a: int(np.asarray(self._state.observation_direction)[i])
                for i, a in enumerate(self._agent_names)
            }
        if hasattr(self._state, "action_direction"):
            obs[INFO_ACTION_DIRECTION] = {
                a: int(np.asarray(self._state.action_direction)[i])
                for i, a in enumerate(self._agent_names)
            }

    def _finish_timestep(self, timestep, do_not_replace_reward):
        # The MA shell computes its own per-agent stats in step(); the MO
        # single-agent pipeline does not apply.
        if timestep.first():
            self._attach_ma_stats(timestep.observation)
        return timestep

    # ------------------------------------------------------- perspectives

    def agent_perspectives_with_layers(
        self,
        observation,
        include_layers=True,
        board=True,
        ascii=True,
        observe_from_agent_coordinates=None,
        observe_from_agent_directions=None,
    ):
        """Per-agent transformed boards/ascii/layers
        (``safety_game_moma.py:430-530``)."""
        game = self._game
        obs_dirs = (
            np.asarray(self._state.observation_direction)
            if hasattr(self._state, "observation_direction")
            else np.full((game.n_agents,), 2, np.int32)
        )
        positions = np.asarray(self._state.pos)
        outside_chr = ord(game.what_lies_outside)
        outside_value = float(
            np.asarray(game._value_lut)[outside_chr]
        )

        out = {}
        for i, a in enumerate(self._agent_names):
            pos = (
                observe_from_agent_coordinates[a]
                if observe_from_agent_coordinates
                and a in observe_from_agent_coordinates
                else positions[i]
            )
            direction = (
                observe_from_agent_directions[a]
                if observe_from_agent_directions
                and a in observe_from_agent_directions
                else int(obs_dirs[i])
            )

            radius = (
                game.agent_observation_radii[i]
                if hasattr(game, "agent_observation_radii")
                else game.observation_radius
            )

            def persp(arr, fill):
                return agent_perspective(
                    np.asarray(arr),
                    pos,
                    direction,
                    fill,
                    observation_radius=radius,
                    observation_direction_mode=game.observation_direction_mode,
                )

            entry = {"layers": {}}
            if include_layers and "layers" in observation:
                for layer_key, layer in observation["layers"].items():
                    entry["layers"][layer_key] = persp(
                        np.asarray(layer),
                        layer_key == game.what_lies_outside,
                    )
            if board:
                entry["board"] = persp(
                    observation["board"], outside_value
                )
            if ascii:
                codes = persp(
                    observation["ascii_codes"], outside_chr
                )
                entry["ascii"] = codes.astype(np.uint32).view("U1")
            out[a] = entry
        return out

    def get_overall_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        mean = np.mean(np.stack(self._episodic_performances), axis=0)
        out = {}
        for i, a in enumerate(self._agent_names):
            dims = self._agent_reward_vector(mean[i], a)
            out[a] = np.float64(dims.sum()) if self.scalarise else dims
        return out

    def get_last_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        last = self._episodic_performances[-1]
        return {
            a: (
                np.float64(self._agent_reward_vector(last[i], a).sum())
                if self.scalarise
                else self._agent_reward_vector(last[i], a)
            )
            for i, a in enumerate(self._agent_names)
        }
