"""Auto-routing batched rollouts (``helpers/batched.py``): for every
registered safety env, one call picks the fused packed step when the
configuration has one, and the generic vmapped path otherwise — registry
ergonomics per ``ai_safety_gridworlds/helpers/factory.py:185-273``."""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.helpers import factory
from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv, batched_rollout

# All 19 safety env families (12 originals + 4 extended MO + 3 MA).
FUSED_NAMES = [
    "boat_race",
    "island_navigation",
    "side_effects_sokoban",
    "absent_supervisor",
    "distributional_shift",
    "safe_interruptibility",
    "whisky_gold",
    "tomato_watering",
    "tomato_crmdp",
    "conveyor_belt",
    "rocks_diamonds",
    "friend_foe",
    "boat_race_ex",
    "island_navigation_ex",
    "conveyor_belt_ex",
    "safe_interruptibility_ex",
    "island_navigation_ex_ma",
    "firemaker_ex_ma",
    "aintelope_savanna",
]


@pytest.mark.parametrize("name", FUSED_NAMES)
def test_every_safety_env_routes_to_fused(name):
    env = BatchedEnv(name, batch_size=4, seed=1)
    assert env.kernel == "fused", name
    stats = env.rollout(3)
    assert stats["kernel"] == "fused"
    assert stats["steps"] == 12
    assert np.isfinite(stats["sum_rewards"]).all()
    # Packed state advanced.
    assert int(np.asarray(env.state["t"]).sum()) > 0


def test_conveyor_variant_routes_to_fused():
    stats = batched_rollout("conveyor_belt_sushi", batch_size=4, n_steps=3)
    assert stats["kernel"] == "fused"


def test_experiment_preset_routes_to_fused():
    # Experiment presets are IslandNavigationEx configs -> FusedIslandNavEx.
    name = factory.env_names()
    preset = next(n for n in name if n.startswith("food_drink"))
    env = BatchedEnv(preset, batch_size=4)
    assert env.kernel == "fused"
    env.rollout(2)


def test_unsupported_config_falls_back_to_generic():
    # human_player whisky_gold has no fused kernel (fused_scalar.py:1441).
    env = BatchedEnv("whisky_gold", batch_size=4, human_player=True)
    assert env.kernel == "generic_vmap"
    stats = env.rollout(3)
    assert stats["kernel"] == "generic_vmap"
    assert stats["steps"] == 12
    with pytest.raises(AttributeError):
        env.state
    with pytest.raises(NotImplementedError):
        BatchedEnv("whisky_gold", batch_size=4, human_player=True,
                   backend="fused")


def test_generic_backend_forced():
    env = BatchedEnv("boat_race", batch_size=4, backend="generic")
    assert env.kernel == "generic_vmap"
    stats = env.rollout(3)
    assert stats["episodes"] >= 0


def test_fused_and_generic_agree_on_reward_scale():
    # Same env, both paths, uniform policy: mean per-step reward should be
    # in the same ballpark (loose distributional sanity, not bit parity —
    # the two paths draw from different PRNG streams).
    a = batched_rollout("boat_race", batch_size=64, n_steps=50, seed=3)
    b = batched_rollout(
        "boat_race", batch_size=64, n_steps=50, seed=3, backend="generic"
    )
    ra = float(np.sum(a["sum_rewards"])) / a["steps"]
    rb = float(np.sum(b["sum_rewards"])) / b["steps"]
    assert abs(ra - rb) < 1.0, (ra, rb)


def test_get_raw_env_matches_kernel_dispatch():
    env = factory.get_raw_env("firemaker_ex_ma")
    assert env.name == "firemaker_ex_ma"
    from ai_safety_gridworlds_tpu import ops

    fused = ops.make_fused(env)
    assert fused is not None and fused.env is env


def test_repeated_rollouts_report_per_call_stats():
    """The fused kernel's stats_* accumulate since init; BatchedEnv must
    report per-call DELTAS so back-to-back calls don't double-count."""
    env = BatchedEnv("boat_race", batch_size=128, seed=5)
    assert env.kernel == "fused"
    a = env.rollout(120)
    b = env.rollout(120)
    assert a["episodes"] > 0
    # Same-length follow-up call: similar (not cumulative ~2x) episodes.
    assert b["episodes"] < a["episodes"] * 1.5
    ra = float(np.sum(a["sum_rewards"]))
    rb = float(np.sum(b["sum_rewards"]))
    assert abs(rb) < abs(ra) * 1.5 + 1.0


def test_auto_backend_falls_back_when_init_packed_rejects_config():
    """A kernel can exist for the env yet reject the configuration at
    packing time (savanna top-up deficit beyond the free cells); on
    backend='auto' that must fall back to the generic path, not crash —
    while backend='fused' surfaces the error."""
    env = BatchedEnv(
        "aintelope_savanna", batch_size=8, amount_food_patches=200,
    )
    assert env.kernel == "generic_vmap"
    stats = env.rollout(4)
    assert stats["steps"] == 32
    with pytest.raises(ValueError, match="top up"):
        BatchedEnv(
            "aintelope_savanna", batch_size=8, backend="fused",
            amount_food_patches=200,
        )
