"""Fused island_navigation_ex_ma kernel: equivalence, bit-identity, reset.

Mirrors ``tests/test_fused_savanna.py``:

1. **Semantic equivalence** — one fused packed step, with its internal
   draws (agent order, actions; the sub-steps consume no other
   randomness) injected into the per-env ``apply_substep`` chain (the
   path that is lockstep-tested against the reference). States and
   rewards must match exactly for every batch lane — on the default
   config AND a rich config (sustainability regrowth, homeostasis,
   thirst death, proportional rewards).
2. **Driver bit-identity** — the jitted ``lax.scan`` rollout vs a Python
   loop over the jitted packed step.
3. **Auto-reset bookkeeping** — truncation, FIRST restart, episode counts.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core.timestep import StepType
from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.ops import reference_chain
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa

RICH_KW = dict(
    level=3,
    amount_agents=2,
    sustainability_challenge=True,
    thirst_hunger_death=True,
    penalise_oversatiation=True,
    use_satiation_proportional_reward=True,
)

def _run_equivalence(env, seed, steps, B=8):
    fused = FusedIslandMa(env)
    S = fused.init_packed(seed=seed, batch=B)
    return reference_chain.island_ma_chain(fused, S, steps)


def test_fused_step_matches_per_env_default_config():
    _run_equivalence(IslandNavigationExMa(), seed=3, steps=12)


def test_fused_step_matches_per_env_rich_config():
    _run_equivalence(IslandNavigationExMa(**RICH_KW), seed=5, steps=12)


def test_fused_rewards_match_per_env_substep_deltas():
    env = IslandNavigationExMa(**RICH_KW)
    fused = FusedIslandMa(env)
    B = 4
    S = fused.init_packed(seed=11, batch=B)
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    n, D = fused.n, fused.D
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
                state_b, delta = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), None, slot
                )
                total += np.asarray(delta)
            np.testing.assert_allclose(
                fused_step_rewards[:, b].reshape(n, D), total,
                rtol=0, atol=1e-5, err_msg=f"step {step} lane {b}",
            )
        S = S2


def test_xla_pallas_bit_identity():
    env = IslandNavigationExMa(**RICH_KW)
    fused = FusedIslandMa(env)
    S0 = fused.init_packed(seed=7, batch=64)
    n_steps = 30
    Sx = fused.rollout(dict(S0), n_steps)
    Sl = reference_chain.step_loop(fused, dict(S0), n_steps)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.asarray(Sx["t"]).max() > 0
    assert np.abs(np.asarray(Sx["stats_rewards"])).sum() > 0


def test_auto_reset_counts_episodes():
    env = IslandNavigationExMa(max_iterations=8)
    fused = FusedIslandMa(env)
    B = 32
    S = fused.init_packed(seed=5, batch=B)
    S = fused.rollout(S, 40)
    eps = np.asarray(S["stats_episodes"])
    # 8 sub-step frames / 2 agents = episodes of >=4 steps (+1 reset step);
    # water deaths can end some episodes sooner.
    assert (eps >= 1).all() and (eps <= 9).all(), eps
    types = np.asarray(S["step_types"])
    assert set(np.unique(types)) <= {
        int(StepType.FIRST), int(StepType.MID), int(StepType.LAST),
        int(StepType.DEAD),
    }


def test_per_lane_maps_differ_with_randomization():
    env = IslandNavigationExMa(map_randomization_frequency=2)
    fused = FusedIslandMa(env)
    fused.init_packed(seed=1, batch=16)
    boards = fused._boards_np
    assert boards.shape[1] == 16
    assert np.unique(boards.T, axis=0).shape[0] > 1
    # Agent start cells + wall edges preserved per the randomizer contract.
    for lane in (0, 7):
        b = fused.board_for_lane(lane)
        assert (b[0, :] == fused.board_for_lane(0)[0, :]).all()


def test_layout_pool_cycles_per_episode():
    """K pooled layouts cycled by the in-step reset (``ep_idx % K``),
    scan driver and step loop bit-identical (mirrors the savanna pool
    tests)."""
    env = IslandNavigationExMa(
        map_randomization_frequency=3, max_iterations=6
    )
    fused = FusedIslandMa(env)
    K = 3
    S0 = fused.init_packed(seed=31, batch=32, layout_pool=K)
    pools = fused._kstatics_np
    assert not np.array_equal(pools["sboard"], pools["sboard_p1"])
    Sx = fused.rollout(dict(S0), 30)
    Sl = reference_chain.step_loop(fused, dict(S0), 30)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.asarray(Sx["ep_idx"]).max() >= K
    # After a reset into layout k, dead lanes restart from THAT layout's
    # pos0 (then each agent takes one sub-step, moving at most 1 cell).
    S2 = fused.step_xla(Sx)
    over = np.all(
        np.isin(np.asarray(Sx["step_types"]), (2, 3)), axis=0
    )
    assert over.any(), "need at least one resetting lane"
    w = fused.w
    pos2 = np.asarray(S2["pos"])
    ep2 = np.asarray(S2["ep_idx"])[0]
    pools_pos0 = [pools["pos0"]] + [
        pools[f"pos0_p{k}"] for k in range(1, K)
    ]

    def manh(flat_a, flat_b):
        return abs(flat_a // w - flat_b // w) + abs(
            flat_a % w - flat_b % w
        )

    discriminated = False
    for b in np.nonzero(over)[0]:
        sel = pools_pos0[ep2[b] % K][:, b]
        for j in range(fused.n):
            assert manh(pos2[j, b], sel[j]) <= 1, (
                f"lane {b} agent {j} not at its layout's start"
            )
        for k in range(K):
            if k == ep2[b] % K:
                continue
            other = pools_pos0[k][:, b]
            if any(
                manh(other[j], sel[j]) > 2 for j in range(fused.n)
            ):
                discriminated = True
    assert discriminated, "layouts too similar to discriminate"


def test_fused_gap_and_non_rewards_match_per_env():
    """Nonzero GAP/NON_DRINK/NON_FOOD rewards (rolf-style overrides) stay
    equivalent between the fused kernel and the per-env chain."""
    from ai_safety_gridworlds_tpu.mo.mo_reward import mo_reward

    env = IslandNavigationExMa(
        level=9,
        amount_agents=2,
        NON_DRINK_REWARD=mo_reward({"DRINK_REWARD": -0.09}),
        NON_FOOD_REWARD=mo_reward({"FOOD_REWARD": -0.05}),
        GAP_REWARD=mo_reward(
            {"FOOD_REWARD": -0.001, "DRINK_REWARD": -0.002}
        ),
    )
    fused = FusedIslandMa(env)
    B = 6
    S = fused.init_packed(seed=41, batch=B)
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    n, D = fused.n, fused.D
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
                state_b, delta = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), None, slot
                )
                total += np.asarray(delta)
            np.testing.assert_allclose(
                fused_step_rewards[:, b].reshape(n, D), total,
                rtol=0, atol=1e-5, err_msg=f"step {step} lane {b}",
            )
        S = S2
    # The overrides actually produced nonzero penalties somewhere.
    assert np.asarray(S["stats_rewards"]).min() < 0
