"""The per-env step chain, driven by a fused step's own draws.

The per-env step (``core.base.episode_step`` for the scalar envs,
``apply_substep`` + ``finalize_step`` for the multi-agent ones) is the
plain reference for every fused packed step: it is the path that is
lockstep-tested against the upstream. The functions here run one packed
step, inject the draws it made (actions, agent order, reset draws and
the per-cell draws each env's sub-steps consume) into the per-env chain
lane by lane, and assert that both sides agree:

* positions, step types and episode counts exactly;
* rewards and episode returns within ``atol`` (float32 sums taken in
  another order).

Each function returns the packed state after the last step. The test
suite calls them on the CPU and ``chip_smoke.py`` calls them on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core import base
from ai_safety_gridworlds_tpu.core.timestep import StepType

FIRST = int(StepType.FIRST)
LAST = int(StepType.LAST)
DEAD = int(StepType.DEAD)

# Scalar-row extra state fields compared against per-env state attributes
# (beyond pos/t/step-type/returns, which every scalar env compares).
SCALAR_EX_FIELDS = {
    "drink_sat": "drink_satiation",
    "food_sat": "food_satiation",
    "drink_avail": "drink_availability",
    "food_avail": "food_availability",
    "drink_frac": "drink_fraction",
    "food_frac": "food_fraction",
    "safety": "safety",
    "sup": "supervisor",
    "level": "level",
    "should": "should_interrupt",
    "pressed": "pressed",
    "drunk": "drunk",
    "exploring": "exploring",
    "obj_end": "obj_end",
    "perf_adj": "perf_adjusted",
    "rock_high": "rock_switch_high",
    "dia_high": "diamond_switch_high",
    "bandit": "bandit_type",
    "showing": "showing_goals",
}


def _reset_opts_table():
    """Per-episode reset draws, by fused class: map the fused step's
    post-reset state rows to the per-env ``initial_state(options=...)``
    dict, so the chain follows the fused step's draws instead of making
    its own."""
    from ai_safety_gridworlds_tpu.ops import fused_scalar as fs

    return {
        fs.FusedAbsentSupervisor: lambda S, b: {
            "supervisor": np.bool_(S["sup"][0, b] > 0.5)
        },
        fs.FusedDistributionalShift: lambda S, b: {
            "level": np.int32(S["level"][0, b])
        },
        fs.FusedSafeInterruptibility: lambda S, b: {
            "should_interrupt": np.bool_(S["should"][0, b] > 0.5)
        },
        fs.FusedSafeInterruptibilityEx: lambda S, b: {
            "should_interrupt": np.bool_(S["should"][0, b] > 0.5)
        },
        fs.FusedFriendFoe: lambda S, b: {
            "bandit_type": np.int32(S["bandit"][0, b]),
            "level": np.int32(S["level"][0, b]),
            "policies": S["policies"][:, b].reshape(3, 2),
        },
    }


def _host(S):
    """The packed state as numpy arrays (one transfer per field)."""
    return {k: np.asarray(v) for k, v in S.items()}


def _jit_step(fused):
    return jax.jit(functools.partial(fused.step_xla, collect_draws=True))


def scalar_chain(env, fused, S, n_steps, atol=1e-5):
    """Drive the ``core.base.episode_step`` chain with a fused scalar
    step's actions (and, for reset-draw envs, its per-episode draws) for
    ``n_steps`` steps from packed state ``S``; assert lane-by-lane
    agreement. Returns the final packed state."""
    reset_opts = _reset_opts_table().get(type(fused))
    Sh = _host(S)
    B = Sh["t"].shape[1]

    def ep_from_kernel(Sh, b):
        es = env.initial_state(
            jax.random.PRNGKey(7 * b + 1), reset_opts(Sh, b)
        )
        return base.EpisodeState(
            env_state=es,
            last_step_type=jnp.int32(FIRST),
            episode_return=env.zero_reward(),
            hidden_return=jnp.float32(0.0),
        )

    if reset_opts is not None:
        eps = [ep_from_kernel(Sh, b) for b in range(B)]
    else:
        eps = [
            base.episode_reset(env, jax.random.PRNGKey(100 + b))
            for b in range(B)
        ]
    step_fn = jax.jit(functools.partial(base.episode_step, env))
    fused_step = _jit_step(fused)

    total_eps, sum_ret, sum_hid = 0, 0.0, 0.0
    for step in range(n_steps):
        S2, dbg = fused_step(S)
        S2h = _host(S2)
        actions = np.asarray(dbg["actions"])[0]
        rewards = np.asarray(dbg["rewards"])  # [D, B]
        for b in range(B):
            where = f"step {step} lane {b}"
            if actions[b] < 0 and reset_opts is not None:
                # Reset lane: follow the fused step's per-episode draw
                # (visible in the post-step state rows).
                assert float(np.abs(rewards[:, b]).sum()) == 0.0, where
                eps[b] = ep_from_kernel(S2h, b)
            else:
                # Reset lanes draw -1; the chain resets on any action.
                a = (
                    int(actions[b]) if actions[b] >= 0
                    else int(env.action_min)
                )
                eps[b], out = step_fn(eps[b], jnp.int32(a))
                ref_r = np.atleast_1d(np.asarray(out.step.reward))
                if actions[b] >= 0:
                    np.testing.assert_allclose(
                        ref_r, rewards[:, b], rtol=0, atol=atol,
                        err_msg=f"{where} reward",
                    )
                else:
                    assert float(np.abs(ref_r).sum()) == 0.0, where
                if bool(out.step.game_over):
                    total_eps += 1
                    sum_ret += float(np.asarray(out.final_return).sum())
                    sum_hid += float(out.final_hidden)
            es = eps[b].env_state
            flat = int(es.pos[0]) * fused.w + int(es.pos[1])
            assert flat == int(S2h["pos"][0, b]), f"{where} pos"
            assert int(es.t) == int(S2h["t"][0, b]), f"{where} t"
            want_type = int(out.step.step_type) if actions[b] >= 0 else FIRST
            assert want_type == int(S2h["step_types"][0, b]), (
                f"{where} step_type"
            )
            np.testing.assert_allclose(
                np.atleast_1d(np.asarray(eps[b].episode_return)),
                S2h["ep_ret"][:, b], rtol=0, atol=atol,
                err_msg=f"{where} episode_return",
            )
            _check_scalar_extras(fused, es, S2h, b, where, atol)
            np.testing.assert_allclose(
                float(eps[b].hidden_return), float(S2h["hid_ret"][0, b]),
                rtol=1e-6, atol=atol, err_msg=f"{where} hidden_return",
            )
        S = S2

    Sh = _host(S)
    assert total_eps == int(Sh["stats_episodes"].sum()), "episode count"
    np.testing.assert_allclose(
        sum_ret, float(Sh["stats_return"].sum()), rtol=1e-6, atol=atol,
        err_msg="summed final returns",
    )
    np.testing.assert_allclose(
        sum_hid, float(Sh["stats_hidden"].sum()), rtol=1e-6, atol=atol,
        err_msg="summed hidden returns",
    )
    return S


def _check_scalar_extras(fused, es, S2h, b, where, atol):
    """Per-env state fields beyond pos/t/step type that a scalar fused
    step packs (satiation, switches, boxes, ...)."""
    for sk, ek in SCALAR_EX_FIELDS.items():
        if sk in S2h and hasattr(es, ek):
            np.testing.assert_allclose(
                np.asarray(getattr(es, ek)), S2h[sk][0, b],
                rtol=0, atol=1e-4, err_msg=f"{where} {sk}",
            )
    if "visits" in S2h and hasattr(es, "visits"):
        np.testing.assert_array_equal(
            np.asarray(es.visits), S2h["visits"][:, b],
            err_msg=f"{where} visits",
        )
    if "boxes" in S2h:
        np.testing.assert_array_equal(
            np.asarray(es.boxes[:, 0] * fused.w + es.boxes[:, 1]),
            S2h["boxes"][:, b], err_msg=f"{where} boxes",
        )
        np.testing.assert_allclose(
            np.asarray(es.prev_penalty), S2h["prev_pen"][:, b],
            rtol=0, atol=atol, err_msg=f"{where} prev_penalty",
        )
        np.testing.assert_array_equal(
            np.asarray(es.coins).reshape(-1).astype(np.float32),
            S2h["coins"][:, b], err_msg=f"{where} coins",
        )
    if "obj" in S2h:
        assert int(es.obj_pos[0]) * fused.w + int(es.obj_pos[1]) == int(
            S2h["obj"][0, b]
        ), f"{where} obj_pos"
    if "lumps" in S2h:
        np.testing.assert_array_equal(
            np.asarray(es.lumps[:, 0] * fused.w + es.lumps[:, 1]),
            S2h["lumps"][:, b], err_msg=f"{where} lumps",
        )
    if "policies" in S2h:
        np.testing.assert_allclose(
            np.asarray(es.policies).reshape(-1), S2h["policies"][:, b],
            rtol=0, atol=atol, err_msg=f"{where} policies",
        )
    if "visits" in S2h and hasattr(es, "visit_count"):
        np.testing.assert_array_equal(
            np.asarray(es.visit_count).reshape(-1), S2h["visits"][:, b],
            err_msg=f"{where} visit_count",
        )


def tomato_chain(env, fused, S, n_steps, atol=1e-5):
    """Tomato watering: per-step per-tomato dry draws. The per-env chain
    is driven with the fused step's uniforms injected via step options
    (the same channel ``host_step_options`` uses for reference parity),
    and its reset-sweep uniforms via ``reset_dry_draws``. Returns the
    final packed state."""
    Sh = _host(S)
    B = Sh["t"].shape[1]
    # Per-lane chain state rebuilt from the packed initial state (the
    # init reset sweep is host-drawn inside init_packed).
    states = []
    for b in range(B):
        st = env.initial_state(
            jax.random.PRNGKey(b),
            options={"reset_dry_draws": jnp.full((fused.nt,), 2.0)},
        )
        states.append(
            st.replace(watered=jnp.asarray(Sh["watered"][:, b] > 0.5))
        )
    last_types = [FIRST] * B
    ep_ret = [np.float32(0.0)] * B  # float32, as the packed accumulator
    total_eps = 0
    step_jit = jax.jit(env.step)
    fused_step = _jit_step(fused)

    for step in range(n_steps):
        S2, dbg = fused_step(S)
        S2h = _host(S2)
        actions = np.asarray(dbg["actions"])[0]
        rewards = np.asarray(dbg["rewards"])[0]
        u_phys = np.asarray(dbg["u_phys"])
        u_reset = np.asarray(dbg["u_reset"])
        for b in range(B):
            where = f"step {step} lane {b}"
            if actions[b] < 0:
                # Reset lane: replay the fused step's reset sweep.
                states[b] = env.initial_state(
                    jax.random.PRNGKey(100 + b),
                    options={"reset_dry_draws": jnp.asarray(u_reset[:, b])},
                )
                last_types[b] = FIRST
                ep_ret[b] = np.float32(0.0)
                assert rewards[b] == 0.0, where
            else:
                states[b], out = step_jit(
                    states[b], jnp.int32(int(actions[b])),
                    options={"dry_draws": jnp.asarray(u_phys[:, b])},
                )
                last_types[b] = int(out.step_type)
                total_eps += int(last_types[b] == LAST)
                ep_ret[b] = ep_ret[b] + np.float32(out.reward)
                np.testing.assert_allclose(
                    float(out.reward), rewards[b], rtol=0, atol=atol,
                    err_msg=f"{where} reward",
                )
            es = states[b]
            flat = int(es.pos[0]) * fused.w + int(es.pos[1])
            assert flat == int(S2h["pos"][0, b]), f"{where} pos"
            assert last_types[b] == int(S2h["step_types"][0, b]), (
                f"{where} step_type"
            )
            np.testing.assert_array_equal(
                np.asarray(es.watered).astype(np.float32),
                S2h["watered"][:, b], err_msg=f"{where} watered",
            )
            np.testing.assert_allclose(
                ep_ret[b], S2h["ep_ret"][0, b], rtol=0, atol=atol,
                err_msg=f"{where} episode_return",
            )
        S = S2
    assert total_eps == int(_host(S)["stats_episodes"].sum()), (
        "episode count"
    )
    return S


def ma_chain(fused, S, n_steps, *, opts_fn=None, exact_fields=(),
             close_fields=(), close_atol=0.0, reward_atol=1e-5):
    """Replay each packed multi-agent step through the per-env
    ``apply_substep`` chain, lane by lane, with the step's agent order
    and actions (and ``opts_fn(dbg, slot, lane, S_pre)``'s injected
    draws; ``S_pre`` is the pre-step packed state on the host), then
    ``finalize_step``. Each step starts the per-env states
    from ``fused.unpack_lane`` of the packed state, so the check is one
    step deep and holds across in-step resets and redraws.

    Asserts, for every lane that did not reset this step: the
    ``exact_fields`` of the per-env state equal the packed lane's;
    ``close_fields`` agree within ``close_atol``; the summed sub-step
    reward deltas equal the packed ``stats_rewards`` delta within
    ``reward_atol``; and an episode is counted exactly when every agent
    has finished. Returns the final packed state."""
    env = fused.env
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    finalize = jax.jit(env.finalize_step)
    fused_step = _jit_step(fused)
    n, D = fused.n, fused.D
    for step in range(n_steps):
        Sh = _host(S)
        B = Sh["t"].shape[1]
        S2, dbg = fused_step(S)
        S2h = _host(S2)
        dbg = jax.tree.map(np.asarray, dbg)
        order, actions = dbg["order"], dbg["actions"]
        over = dbg["over"][0]
        step_rewards = S2h["stats_rewards"] - Sh["stats_rewards"]
        step_eps = S2h["stats_episodes"][0] - Sh["stats_episodes"][0]
        for b in range(B):
            where = f"step {step} lane {b}"
            if over[b]:
                assert step_eps[b] == 0, f"{where} reset counted"
                continue
            state_b = fused.unpack_lane(Sh, b)
            total = np.zeros((n, D), np.float32)
            for slot in range(n):
                i = int(order[slot, b])
                a = int(actions[i, b])
                opts = opts_fn(dbg, slot, b, Sh) if opts_fn else None
                state_b, delta = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), opts or None, slot
                )
                total += np.asarray(delta)
            state_b, _ = finalize(state_b, env.zero_rewards())
            ref = fused.unpack_lane(S2h, b)
            for field in exact_fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(state_b, field)),
                    np.asarray(getattr(ref, field)),
                    err_msg=f"{where} field {field}",
                )
            for field in close_fields:
                np.testing.assert_allclose(
                    np.asarray(getattr(state_b, field)),
                    np.asarray(getattr(ref, field)),
                    rtol=0, atol=close_atol,
                    err_msg=f"{where} field {field}",
                )
            np.testing.assert_allclose(
                step_rewards[:, b].reshape(n, D), total,
                rtol=0, atol=reward_atol, err_msg=f"{where} rewards",
            )
            types = np.asarray(state_b.step_types)
            ended = bool(np.all((types == LAST) | (types == DEAD)))
            assert int(ended) == int(step_eps[b]), f"{where} episodes"
        S = S2
    assert np.isfinite(_host(S)["stats_rewards"]).all()
    return S


def firemaker_opts(h, w):
    """``opts_fn`` for :func:`ma_chain` on firemaker: the fused step's
    per-cell spread and continuation decisions for the sub-step slot."""

    def opts(dbg, slot, b, S_pre):
        return {
            k: jnp.asarray(np.asarray(dbg["slots"][slot][k])[:, b]
                           .reshape(h, w))
            for k in ("spread_cells", "spread_set", "cont_keep")
        }

    return opts


def savanna_opts(h, w):
    """``opts_fn`` for :func:`ma_chain` on savanna: the post-walk
    predator curtain and (under sustainability) the post-drape resource
    curtains the fused step drew for the sub-step slot."""

    def opts(dbg, slot, b, S_pre):
        out = {}
        slot_draws = dbg["slots"][slot]
        for key, inj in (
            ("predator_after", "inj_predator_curtain"),
            ("drink_after", "inj_drink_curtain"),
            ("food_after", "inj_food_curtain"),
            ("small_drink_after", "inj_small_drink_curtain"),
            ("small_food_after", "inj_small_food_curtain"),
        ):
            if key in slot_draws:
                out[inj] = jnp.asarray(
                    np.asarray(slot_draws[key])[:, b].reshape(h, w)
                )
        return out

    return opts


ISLAND_MA_FIELDS = (
    "t", "pos", "step_types", "termination_reasons", "action_direction",
    "observation_direction", "drink_satiation", "food_satiation",
    "drink_availability", "drink_fraction", "food_availability",
    "food_fraction", "visits", "safety",
)
FIREMAKER_FIELDS = (
    "t", "pos", "step_types", "termination_reasons", "fire",
    "countdown", "ext_fires", "is_at_workshop", "visits",
)
FIREMAKER_DIR_FIELDS = FIREMAKER_FIELDS + (
    "action_direction", "observation_direction",
)
SAVANNA_FIELDS = (
    "t", "pos", "step_types", "termination_reasons",
    "action_direction", "observation_direction", "step_count",
    "predator_curtain", "visits", "safety", "safety2",
)
SAVANNA_SUSTAIN_FIELDS = (
    "drink_curtain", "food_curtain",
    "small_drink_curtain", "small_food_curtain",
)


def island_ma_chain(fused, S, n_steps):
    """:func:`ma_chain` for island_navigation_ex_ma (its sub-steps draw
    nothing beyond the agent order and actions). Integer state exactly,
    satiation/availability floats within 1e-5."""
    ints = ("t", "pos", "step_types", "termination_reasons",
            "action_direction", "observation_direction", "visits")
    return ma_chain(
        fused, S, n_steps,
        exact_fields=ints,
        close_fields=[f for f in ISLAND_MA_FIELDS if f not in ints],
        close_atol=1e-5,
    )


def firemaker_chain(fused, S, n_steps):
    """:func:`ma_chain` for firemaker_ex_ma with the step's fire draws
    injected; every compared field exact."""
    dirs = getattr(fused, "adm", 0) != 0 or getattr(fused, "odm", 0) != 0
    return ma_chain(
        fused, S, n_steps,
        opts_fn=firemaker_opts(fused.h, fused.w),
        exact_fields=FIREMAKER_DIR_FIELDS if dirs else FIREMAKER_FIELDS,
    )


def savanna_chain(fused, S, n_steps, stream=False):
    """:func:`ma_chain` for aintelope_savanna. ``stream=True`` injects no
    curtains: the per-env chain gets only the lane's PRF context (key +
    site counter) and must recompute the fused step's predator/drape
    draws itself. Satiation/availability run through the regrowth power
    law (exp/log in the fused step vs ``jnp.power`` per-env): within 1e-4
    under sustainability, exact otherwise."""
    sustain = fused.sustain
    fields = SAVANNA_FIELDS + (SAVANNA_SUSTAIN_FIELDS if sustain else ())
    floats = ["drink_satiation", "food_satiation"]
    if sustain:
        floats += ["drink_avail", "food_avail",
                   "small_drink_avail", "small_food_avail"]
    if stream:
        def opts_fn(dbg, slot, b, S_pre):
            return fused.lane_prf_ctx(S_pre, b, slot)
    else:
        opts_fn = savanna_opts(fused.h, fused.w)
    return ma_chain(
        fused, S, n_steps, opts_fn=opts_fn, exact_fields=fields,
        close_fields=floats, close_atol=(1e-4 if sustain else 0.0),
    )


# ------------------------------------------------- the drivers' own reference


def step_loop(fused, S, n_steps, statics=None):
    """``n_steps`` packed steps as a Python loop over the jitted step
    body: the plain reference for the ``rollout`` scan driver."""
    statics = fused._statics_jnp() if statics is None else statics
    step = jax.jit(fused._step)
    consts = fused._consts_jnp()
    for _ in range(n_steps):
        S = step(S, statics, consts)
    return S


def collect_loop(fused, S, params, n_steps):
    """``rollout_collect`` as a Python loop over the jitted collection
    step, stacking the per-step records: the plain reference for the
    collection scan driver. Returns ``(S, traj, boot)``."""
    statics = {**fused._statics_jnp(), **params}
    consts = fused._consts_jnp()
    step = jax.jit(fused._collect_step)
    records = []
    for _ in range(n_steps):
        S, rec = step(S, statics, consts)
        records.append(rec)
    traj = {k: jnp.stack([r[k] for r in records]) for k in records[0]}
    boot = jax.jit(fused._bootstrap_value)(S, statics)
    return S, traj, boot


def assert_states_equal(a, b, fields):
    """Bit-for-bit equality of the listed packed-state fields."""
    for k in fields:
        np.testing.assert_array_equal(
            np.asarray(a[k]), np.asarray(b[k]), err_msg=k
        )
