"""Fused scalar kernels (boat_race, island_navigation): equivalence.

Mirrors the MA kernel suites (``tests/test_fused_island_ma.py``):

1. **Semantic equivalence** — the fused packed step's drawn actions are
   injected into the per-env ``core.base.episode_step`` chain (the path
   that is lockstep-tested against the reference), and per-lane state,
   rewards, step types, and episode accounting must match exactly.
2. **Driver bit-identity** — the jitted ``lax.scan`` rollout vs a Python
   loop over the jitted packed step.
3. **Auto-reset bookkeeping** — truncation, FIRST restart, episode
   counts and final-return sums vs ``core.base.rollout`` semantics.
4. **Fused PPO composes** — ``learners.ppo_fused.make_train_step`` runs
   on a scalar kernel (the in-kernel MLP policy + collection path).
"""

import os

import jax
import numpy as np
import pytest

from ai_safety_gridworlds_tpu.core.timestep import StepType
from ai_safety_gridworlds_tpu.envs.boat_race import BoatRace
from ai_safety_gridworlds_tpu.envs.boat_race_ex import BoatRaceEx
from ai_safety_gridworlds_tpu.envs.island_navigation import IslandNavigation
from ai_safety_gridworlds_tpu.envs.island_navigation_ex import (
    IslandNavigationEx,
)
from ai_safety_gridworlds_tpu.envs.side_effects_sokoban import (
    SideEffectsSokoban,
)
from ai_safety_gridworlds_tpu.envs.absent_supervisor import AbsentSupervisor
from ai_safety_gridworlds_tpu.envs.distributional_shift import (
    DistributionalShift,
)
from ai_safety_gridworlds_tpu.envs.safe_interruptibility import (
    SafeInterruptibility,
)
from ai_safety_gridworlds_tpu.envs.whisky_gold import WhiskyGold
from ai_safety_gridworlds_tpu.envs.tomato_watering import (
    TomatoCRMDP, TomatoWatering,
)
from ai_safety_gridworlds_tpu.envs.conveyor_belt import ConveyorBelt
from ai_safety_gridworlds_tpu.envs.conveyor_belt_ex import ConveyorBeltEx
from ai_safety_gridworlds_tpu.envs.safe_interruptibility_ex import (
    SafeInterruptibilityEx,
)
from ai_safety_gridworlds_tpu.envs.friend_foe import FriendFoe
from ai_safety_gridworlds_tpu.envs.rocks_diamonds import RocksDiamonds
from ai_safety_gridworlds_tpu.ops import reference_chain
from ai_safety_gridworlds_tpu.ops.fused_scalar import (
    FusedAbsentSupervisor, FusedBoatRace, FusedBoatRaceEx,
    FusedConveyorBelt, FusedConveyorBeltEx, FusedDistributionalShift,
    FusedFriendFoe, FusedIslandNav, FusedIslandNavEx,
    FusedRocksDiamonds, FusedSafeInterruptibility,
    FusedSafeInterruptibilityEx, FusedSokoban, FusedTomatoWatering,
    FusedWhiskyGold,
)

FIRST = int(StepType.FIRST)
MID = int(StepType.MID)
LAST = int(StepType.LAST)

CASES = [
    (BoatRace, FusedBoatRace, {}),
    (BoatRace, FusedBoatRace, {"max_iterations": 7}),
    (IslandNavigation, FusedIslandNav, {}),
    (IslandNavigation, FusedIslandNav, {"max_iterations": 9}),
    # MO variants: reward vectors + visit-count repetition penalty.
    (BoatRaceEx, FusedBoatRaceEx, {}),
    (BoatRaceEx, FusedBoatRaceEx, {"max_iterations": 11}),
    (BoatRaceEx, FusedBoatRaceEx, {"level": 3, "noops": False}),
    (BoatRaceEx, FusedBoatRaceEx,
     {"level": 0, "iterations_penalty": False,
      "repetition_penalty": False}),
    # Extended island: default (level 9, sustainability) and the full
    # flag matrix the bench's island_navigation_ex_full config uses.
    (IslandNavigationEx, FusedIslandNavEx, {}),
    (IslandNavigationEx, FusedIslandNavEx, {"max_iterations": 13}),
    (IslandNavigationEx, FusedIslandNavEx,
     {"level": 3, "sustainability_challenge": True,
      "thirst_hunger_death": True, "penalise_oversatiation": True,
      "use_satiation_proportional_reward": True}),
    (IslandNavigationEx, FusedIslandNavEx,
     {"level": 4, "sustainability_challenge": False}),
    (IslandNavigationEx, FusedIslandNavEx,
     {"level": 5, "noops": False, "penalise_oversatiation": False}),
    # Sokoban: push rules, penalty refunds, coins; 1-3 boxes.
    (SideEffectsSokoban, FusedSokoban, {}),
    (SideEffectsSokoban, FusedSokoban, {"level": 1, "noops": True}),
    (SideEffectsSokoban, FusedSokoban, {"level": 2}),
    (SideEffectsSokoban, FusedSokoban, {"level": 3}),
    # Per-episode reset draws (supervisor / lava layout / interruption).
    (AbsentSupervisor, FusedAbsentSupervisor, {}),
    (AbsentSupervisor, FusedAbsentSupervisor, {"supervisor": True}),
    (DistributionalShift, FusedDistributionalShift, {}),
    (DistributionalShift, FusedDistributionalShift, {"is_testing": True}),
    (SafeInterruptibility, FusedSafeInterruptibility, {}),
    (SafeInterruptibility, FusedSafeInterruptibility,
     {"level": 0, "interruption_probability": 1.0}),
    (SafeInterruptibility, FusedSafeInterruptibility,
     {"level": 2, "noops": True, "interruption_probability": 0.0}),
    # Whisky gold (agent mode: the exploration hijack is human-only).
    (WhiskyGold, FusedWhiskyGold, {}),
    # Conveyor belt: all 4 variants (belt advance, end event, pushes).
    (ConveyorBelt, FusedConveyorBelt, {"variant": "vase"}),
    (ConveyorBelt, FusedConveyorBelt, {"variant": "sushi"}),
    (ConveyorBelt, FusedConveyorBelt, {"variant": "sushi_goal",
                                       "noops": True}),
    (ConveyorBelt, FusedConveyorBelt, {"variant": "sushi_goal2"}),
    # Rocks and diamonds: switch toggles + signed goal-area rewards.
    (RocksDiamonds, FusedRocksDiamonds, {}),
    (RocksDiamonds, FusedRocksDiamonds, {"level": 1}),
    # MO extended variants (dual-dispatch / doubled-reward quirks).
    (ConveyorBeltEx, FusedConveyorBeltEx, {"variant": "vase"}),
    (ConveyorBeltEx, FusedConveyorBeltEx,
     {"variant": "sushi_goal", "noops": True}),
    (SafeInterruptibilityEx, FusedSafeInterruptibilityEx, {}),
    (SafeInterruptibilityEx, FusedSafeInterruptibilityEx,
     {"level": 2, "interruption_probability": 1.0}),
    # Friend/foe: bandit reset draws + cross-episode policy carry.
    (FriendFoe, FusedFriendFoe, {}),
    (FriendFoe, FusedFriendFoe, {"bandit_type": "friend"}),
    (FriendFoe, FusedFriendFoe, {"bandit_type": "adversary",
                                 "extra_step": True}),
]


def _ids(case):
    env_cls, _, kw = case
    return env_cls.__name__ + (
        "_" + "_".join(f"{k}{v}" for k, v in kw.items()) if kw else ""
    )


# Fuzz knobs (same convention as tests/test_fuzz_lockstep.py): scale the
# chain-equivalence sweep beyond CI's single seed with
#   FUSED_FUZZ_SEEDS=8 FUSED_FUZZ_STEPS=200 pytest tests/test_fused_scalar.py
_FUZZ_SEEDS = int(os.environ.get("FUSED_FUZZ_SEEDS", "1"))
_FUZZ_STEPS = int(os.environ.get("FUSED_FUZZ_STEPS", "0"))


@pytest.mark.parametrize("fuzz_seed", range(_FUZZ_SEEDS))
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fused_step_matches_per_env_chain(case, fuzz_seed):
    """Per-lane reference chain driven by the fused step's own actions
    (and, for reset-draw envs, its own per-episode draws)."""
    env_cls, fused_cls, kw = case
    env = env_cls(**kw)
    fused = fused_cls(env)
    S = fused.init_packed(seed=11 + 1000 * fuzz_seed, batch=6)
    reference_chain.scalar_chain(env, fused, S, _FUZZ_STEPS or 25)


@pytest.mark.parametrize("case", CASES[::2], ids=lambda c: c[0].__name__)
def test_fused_xla_pallas_bit_identical(case):
    """The jitted scan driver equals a Python loop over the jitted step."""
    env_cls, fused_cls, kw = case
    env = env_cls(**kw)
    fused = fused_cls(env)
    S0 = fused.init_packed(seed=3, batch=64)
    Sx = fused.rollout(dict(S0), n_steps=40)
    Sl = reference_chain.step_loop(fused, dict(S0), 40)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    # Everything actually ran: boat_race truncates at 100 (no episodes in
    # 40 steps), island terminates fast — just require progress.
    assert int(np.asarray(Sx["t"]).sum()) > 0


def test_fused_autoreset_truncation_counts():
    env = BoatRace(max_iterations=5)
    fused = FusedBoatRace(env)
    B = 64
    S = fused.init_packed(seed=0, batch=B)
    # 18 steps at max_iterations=5: each lane runs 5+1(reset)=6-step
    # cycles -> exactly 3 completed episodes per lane.
    S = fused.rollout(S, n_steps=18)
    np.testing.assert_array_equal(np.asarray(S["stats_episodes"]), 3)
    # Every completed boat_race episode yields <= -5 + 3*k observed.
    assert np.isfinite(np.asarray(S["stats_return"])).all()
    types = np.asarray(S["step_types"])
    assert set(np.unique(types)) <= {FIRST, MID, LAST}


def test_fused_ppo_composes_on_scalar_kernel():
    from ai_safety_gridworlds_tpu.learners import ppo_fused

    env = IslandNavigation()
    fused = FusedIslandNav(env)
    config = ppo_fused.FusedPPOConfig(
        n_steps=8, n_epochs=1, n_minibatches=2, hidden=8
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), config=config, batch_size=128, seed=0
    )
    train = ppo_fused.make_train_step(fused, config=config)
    state, metrics = train(state)
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), k
    state, _ = train(state)
    assert int(state.update_idx) == 2


@pytest.mark.parametrize("crmdp", [False, True], ids=["watering", "crmdp"])
def test_fused_tomato_matches_per_env_with_injected_draws(crmdp):
    """Tomato watering: per-step per-tomato dry draws. The per-env chain
    is driven with the KERNEL's uniforms injected via step options (the
    same channel ``host_step_options`` uses for reference parity), and
    the kernel's reset-sweep uniforms via ``reset_dry_draws``."""
    env = (TomatoCRMDP if crmdp else TomatoWatering)()
    fused = FusedTomatoWatering(env)
    S = fused.init_packed(seed=4, batch=5)
    reference_chain.tomato_chain(env, fused, S, 30)


def test_fused_tomato_xla_pallas_bit_identical():
    fused = FusedTomatoWatering(TomatoWatering())
    S0 = fused.init_packed(seed=6, batch=64)
    Sx = fused.rollout(dict(S0), n_steps=50)
    Sl = reference_chain.step_loop(fused, dict(S0), 50)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)


def test_fused_whisky_human_mode_falls_back():
    from ai_safety_gridworlds_tpu import ops

    assert ops.make_fused(WhiskyGold(human_player=True)) is None
    assert isinstance(ops.make_fused(WhiskyGold()), FusedWhiskyGold)


ALL_FUSED = [
    (BoatRace, FusedBoatRace),
    (IslandNavigation, FusedIslandNav),
    (BoatRaceEx, FusedBoatRaceEx),
    (IslandNavigationEx, FusedIslandNavEx),
    (SideEffectsSokoban, FusedSokoban),
    (AbsentSupervisor, FusedAbsentSupervisor),
    (DistributionalShift, FusedDistributionalShift),
    (SafeInterruptibility, FusedSafeInterruptibility),
    (WhiskyGold, FusedWhiskyGold),
    (TomatoWatering, FusedTomatoWatering),
    (ConveyorBelt, FusedConveyorBelt),
    (RocksDiamonds, FusedRocksDiamonds),
    (FriendFoe, FusedFriendFoe),
    (ConveyorBeltEx, FusedConveyorBeltEx),
    (SafeInterruptibilityEx, FusedSafeInterruptibilityEx),
]


@pytest.mark.parametrize(
    "env_cls,fused_cls", ALL_FUSED, ids=lambda c: getattr(c, "__name__", "")
)
def test_fused_ppo_collection_composes_on_every_kernel(env_cls, fused_cls):
    """Every fused scalar kernel implements the full contract: in-kernel
    MLP policy, trajectory collection, and one PPO update produce finite
    metrics (tiny CPU-sized shapes)."""
    from ai_safety_gridworlds_tpu.learners import ppo_fused

    fused = fused_cls(env_cls())
    config = ppo_fused.FusedPPOConfig(
        n_steps=4, n_epochs=1, n_minibatches=2, hidden=8
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(1), config=config, batch_size=32, seed=0
    )
    train = ppo_fused.make_train_step(fused, config=config)
    state, metrics = train(state)
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), (fused_cls.__name__, k)
