"""Fused firemaker kernel: equivalence, bit-identity, and auto-reset.

Three layers of validation:

1. **Semantic equivalence** — one fused packed step, with its internal
   draws (agent order, actions, fire spread/continuation fields) captured
   and injected into the per-env ``apply_substep`` chain (the path that is
   lockstep-tested against the reference). States and rewards must match
   exactly for every batch lane.
2. **Driver bit-identity** — the jitted ``lax.scan`` rollout and a
   Python loop over the jitted packed step produce identical packed
   states and stats on the same device.
3. **Auto-reset bookkeeping** — episodes terminate at ``max_iterations``
   and restart with FIRST step types, counted in the stats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_safety_gridworlds_tpu.core.timestep import StepType
from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa
from ai_safety_gridworlds_tpu.ops import reference_chain
from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker


def test_fused_step_matches_per_env_substeps():
    """A few steps in so fire exists; each step's draws replay through the
    per-env engine sub-steps (roll-form stencil; the matrix form is
    covered below)."""
    fused = FusedFiremaker(FiremakerExMa(), matrix_stencil=False)
    S = fused.init_packed(seed=3, batch=16)
    S = reference_chain.firemaker_chain(fused, S, 12)
    assert np.isfinite(np.asarray(S["stats_rewards"])).all()


@pytest.mark.parametrize("amount_agents", [2, 3])
def test_fused_rewards_match_per_env_substep_deltas(amount_agents):
    """Per-step per-lane reward deltas of the fused kernel equal the
    per-env sub-step chain's summed deltas — on both the default 2-agent
    (1 worker + supervisor) and the 3-agent (2 workers + supervisor)
    configs. Mirrors ``test_fused_island_ma.py``; reference semantics:
    ``/root/reference/ai_safety_gridworlds/environments/firemaker_ex_ma.py:772-801``.
    """
    env = FiremakerExMa(amount_agents=amount_agents)
    fused = FusedFiremaker(env)
    B = 8
    S = fused.init_packed(seed=11 + amount_agents, batch=B)
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    h, w, n, D = fused.h, fused.w, fused.n, fused.D
    for step in range(10):
        per_env = [fused.unpack_lane(S, b) for b in range(B)]
        prev_stats = np.asarray(S["stats_rewards"])
        S2, dbg = fused.step_xla(S, collect_draws=True)
        fused_step_rewards = np.asarray(S2["stats_rewards"]) - prev_stats
        order = np.asarray(dbg["order"])
        actions = np.asarray(dbg["actions"])
        over = np.asarray(dbg["over"])[0]
        for b in range(B):
            if over[b]:
                continue
            state_b = per_env[b]
            total = np.zeros((n, D), np.float32)
            for slot in range(n):
                i = int(order[slot, b])
                a = int(actions[i, b])
                opts = {
                    k: jnp.asarray(
                        np.asarray(dbg["slots"][slot][k])[:, b].reshape(h, w)
                    )
                    for k in ("spread_cells", "spread_set", "cont_keep")
                }
                state_b, delta = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), opts, slot
                )
                total += np.asarray(delta)
            np.testing.assert_allclose(
                fused_step_rewards[:, b].reshape(n, D), total,
                rtol=0, atol=1e-5,
                err_msg=f"step {step} lane {b} (amount_agents={amount_agents})",
            )
        S = S2


def test_fused_step_types_vs_per_env_finalize():
    """Step types / reasons follow finalize semantics incl. truncation."""
    env = FiremakerExMa(max_iterations=6)
    fused = FusedFiremaker(env)
    S = fused.init_packed(seed=1, batch=8)
    saw_last = False
    for _ in range(6):
        S = fused.step_xla(S)
        types = np.asarray(S["step_types"])
        saw_last = saw_last or (types == int(StepType.LAST)).all()
    assert saw_last


def test_xla_pallas_bit_identity():
    fused = FusedFiremaker(FiremakerExMa(), matrix_stencil=False)
    S0 = fused.init_packed(seed=7, batch=64)
    Sx = fused.rollout(dict(S0), 40)
    Sl = reference_chain.step_loop(fused, dict(S0), 40)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    # Something actually happened.
    assert np.asarray(Sx["t"]).max() > 0
    assert np.abs(np.asarray(Sx["stats_rewards"])).sum() > 0


def test_auto_reset_counts_episodes():
    env = FiremakerExMa(max_iterations=9)
    fused = FusedFiremaker(env)
    B = 32
    S = fused.init_packed(seed=5, batch=B)
    # 9 frames / 2 agents = episode ends at step ceil(9/2)=5 (t>=9), reset
    # emitted the following step. 40 steps => ~7 episodes per lane.
    S = fused.rollout(S, 40)
    eps = np.asarray(S["stats_episodes"])
    assert (eps >= 5).all() and (eps <= 9).all(), eps
    t = np.asarray(S["t"])
    assert (t <= 9 + 1).all()


@pytest.mark.parametrize("adm,odm", [(1, 0), (1, 1), (2, 2)])
def test_fused_direction_modes_match_per_env(adm, odm):
    """Relative action/observation direction modes: the fused kernel's
    facings, moves, and step outputs stay in lockstep with the per-env
    chain (which is itself lockstep-tested against the reference)."""
    env = FiremakerExMa(
        action_direction_mode=adm, observation_direction_mode=odm
    )
    fused = FusedFiremaker(env)
    B = 8
    S = fused.init_packed(seed=17 + adm * 3 + odm, batch=B)
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    h, w, n = fused.h, fused.w, fused.n
    for step in range(10):
        per_env = [fused.unpack_lane(S, b) for b in range(B)]
        S2, dbg = fused.step_xla(S, collect_draws=True)
        order = np.asarray(dbg["order"])
        actions = np.asarray(dbg["actions"])
        over = np.asarray(dbg["over"])[0]
        for b in range(B):
            if over[b]:
                continue
            state_b = per_env[b]
            for slot in range(n):
                i = int(order[slot, b])
                a = int(actions[i, b])
                opts = {
                    k: jnp.asarray(
                        np.asarray(dbg["slots"][slot][k])[:, b].reshape(h, w)
                    )
                    for k in ("spread_cells", "spread_set", "cont_keep")
                }
                state_b, _ = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), opts, slot
                )
            state_b, _ = jax.jit(env.finalize_step)(
                state_b, env.zero_rewards()
            )
            ref_state = fused.unpack_lane(S2, b)
            for field in (
                "t", "pos", "step_types", "termination_reasons", "fire",
                "action_direction", "observation_direction",
                "countdown", "ext_fires", "is_at_workshop", "visits",
            ):
                np.testing.assert_array_equal(
                    np.asarray(getattr(state_b, field)),
                    np.asarray(getattr(ref_state, field)),
                    err_msg=f"step {step} lane {b} field {field} "
                            f"(adm={adm} odm={odm})",
                )
        S = S2


def test_fused_direction_modes_bit_identity_and_fallback_gone():
    from ai_safety_gridworlds_tpu import ops as ops_pkg

    env = FiremakerExMa(
        action_direction_mode=2, observation_direction_mode=2
    )
    fused = ops_pkg.make_fused(env)
    assert isinstance(fused, FusedFiremaker)
    S0 = fused.init_packed(seed=23, batch=64)
    Sx = fused.rollout(dict(S0), 20)
    Sl = reference_chain.step_loop(fused, dict(S0), 20)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    # Turn actions actually changed some facings.
    assert (np.asarray(Sx["act_dir"]) != 0).any()
    # The invalid mode combination still raises (matches the per-env path).
    with pytest.raises(NotImplementedError):
        FusedFiremaker(
            FiremakerExMa(
                action_direction_mode=0, observation_direction_mode=2
            )
        )


def test_fused_direction_mode_rewards_match_per_env():
    """Reward deltas under turning mode 2 (turn actions pay movement
    reward like any non-NOOP action — reference quirk) match the per-env
    chain exactly."""
    env = FiremakerExMa(
        action_direction_mode=2, observation_direction_mode=2
    )
    fused = FusedFiremaker(env)
    B = 6
    S = fused.init_packed(seed=29, batch=B)
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    h, w, n, D = fused.h, fused.w, fused.n, fused.D
    for step in range(8):
        per_env = [fused.unpack_lane(S, b) for b in range(B)]
        prev_stats = np.asarray(S["stats_rewards"])
        S2, dbg = fused.step_xla(S, collect_draws=True)
        fused_step_rewards = np.asarray(S2["stats_rewards"]) - prev_stats
        order = np.asarray(dbg["order"])
        actions = np.asarray(dbg["actions"])
        over = np.asarray(dbg["over"])[0]
        for b in range(B):
            if over[b]:
                continue
            state_b = per_env[b]
            total = np.zeros((n, D), np.float32)
            for slot in range(n):
                i = int(order[slot, b])
                a = int(actions[i, b])
                opts = {
                    k: jnp.asarray(
                        np.asarray(dbg["slots"][slot][k])[:, b].reshape(h, w)
                    )
                    for k in ("spread_cells", "spread_set", "cont_keep")
                }
                state_b, delta = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), opts, slot
                )
                total += np.asarray(delta)
            np.testing.assert_allclose(
                fused_step_rewards[:, b].reshape(n, D), total,
                rtol=0, atol=1e-5, err_msg=f"step {step} lane {b}",
            )
        S = S2


# ------------------------------------------------------ matrix-form stencil


def test_mxu_stencil_cum_accuracy():
    """The banded log-survival matrix form of the spread probability is
    within 1e-5 absolute of the separable product form on random source
    boards (it is mathematically exact for 0/1 sources — only f32
    rounding differs), and exactly 0 wherever no neighbor burns."""
    env = FiremakerExMa()
    poly = FusedFiremaker(env, matrix_stencil=False)
    mxu = FusedFiremaker(env, matrix_stencil=True)
    consts = {k: jnp.asarray(v) for k, v in mxu.consts.items()}
    rng = np.random.default_rng(0)
    for density in (0.02, 0.1, 0.5, 1.0):
        src = (rng.random((poly.HW, 64)) < density).astype(np.float32)
        src_f = jnp.asarray(src)
        cum_poly = np.asarray(poly._spread_cum(src_f, consts))
        cum_mxu = np.asarray(mxu._spread_cum(src_f, consts))
        np.testing.assert_allclose(
            cum_mxu, cum_poly, rtol=0, atol=1e-5,
            err_msg=f"density {density}",
        )
        # Zero-neighbor cells are exactly 0 in BOTH forms (the in-kernel
        # ``cum > 0`` spread-cell mask must not light up spuriously).
        no_nbr = cum_poly == 0.0
        assert (cum_mxu[no_nbr] == 0.0).all()
        assert (cum_mxu[~no_nbr] > 0.0).all()


def test_mxu_stencil_chain_equivalence():
    """Full-step semantics with the matrix stencil: the fused step's state
    stays lockstep with the per-env chain under injected draws (the
    spread DECISIONS are injected, so this checks everything around the
    stencil composes identically)."""
    fused = FusedFiremaker(FiremakerExMa(), matrix_stencil=True)
    S = fused.init_packed(seed=3, batch=8)
    reference_chain.firemaker_chain(fused, S, 8)


def test_mxu_stencil_xla_pallas_bit_identity():
    fused = FusedFiremaker(FiremakerExMa(), matrix_stencil=True)
    S0 = fused.init_packed(seed=7, batch=64)
    Sx = fused.rollout(dict(S0), 30)
    Sl = reference_chain.step_loop(fused, dict(S0), 30)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.abs(np.asarray(Sx["stats_rewards"])).sum() > 0


def test_stencil_check_of_chip_smoke():
    """chip_smoke's stencil gate (matrix vs roll form at HIGHEST) holds
    at a small width on the CPU."""
    import chip_smoke

    assert chip_smoke.stencil_max_error(lanes=64) <= chip_smoke.STENCIL_ATOL
