"""Multi-chip composition beyond the happy path.

The driver validates ``dryrun_multichip(8)``; real pods come in other
sizes and users mis-size batches. These tests run the FULL dry run (env
rollout + actor-critic update + fused rollout in shard_map +
sharded fused-PPO step) at n in {2, 4} on the virtual CPU mesh, and pin
the actionable-error guards for every non-divisible combination.
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
import __graft_entry__  # noqa: E402
from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (  # noqa: E402
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.learners import ppo_fused  # noqa: E402
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa  # noqa: E402
from ai_safety_gridworlds_tpu.parallel import mesh as pmesh  # noqa: E402


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_smaller_meshes(n):
    __graft_entry__.dryrun_multichip(n)


def test_make_mesh_refuses_oversized():
    avail = len(jax.devices())
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_mesh(n_data=avail + 1, n_model=1)
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_mesh(n_data=avail, n_model=2)


def test_sharded_rollout_refuses_nondivisible_batch():
    from ai_safety_gridworlds_tpu.envs.island_navigation import (
        IslandNavigation,
    )

    mesh = pmesh.make_mesh(n_data=4, n_model=1)
    with pytest.raises(ValueError, match="divide"):
        pmesh.sharded_rollout(
            IslandNavigation(), mesh, jax.random.PRNGKey(0),
            n_steps=2, batch_size=6,
        )


def test_sharded_ppo_refuses_nondivisible_combinations():
    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=4))
    config = ppo_fused.FusedPPOConfig(
        n_steps=4, n_epochs=1, n_minibatches=2, hidden=8
    )
    mesh = pmesh.make_mesh(n_data=4, n_model=1)

    # batch 6 not divisible by 4 devices
    fused.init_packed(seed=1, batch=6)
    with pytest.raises(ValueError, match="not divisible by the mesh"):
        ppo_fused.make_sharded_train_step(fused, mesh, config=config)

    # batch 8 / 4 devices = 2 lanes/device; 4 minibatches cannot split 2
    fused.init_packed(seed=1, batch=8)
    with pytest.raises(ValueError, match="n_minibatches"):
        ppo_fused.make_sharded_train_step(
            fused, mesh,
            config=ppo_fused.FusedPPOConfig(
                n_steps=4, n_epochs=1, n_minibatches=4, hidden=8
            ),
        )


def test_pallas_rollout_refuses_nondivisible_tile():
    """The rollout has no lane tile any more: a lane count that no
    power-of-two tile divides (12) runs, equal to the step loop."""
    from ai_safety_gridworlds_tpu.ops import reference_chain

    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=4))
    S = fused.init_packed(seed=2, batch=12)
    out = fused.rollout(dict(S), 6)
    ref = reference_chain.step_loop(fused, dict(S), 6)
    reference_chain.assert_states_equal(out, ref, fused.STATE_FIELDS)


def test_sharded_ppo_uneven_but_valid_composition_runs():
    """A non-power-of-two split that IS valid must run: 12 lanes over 2
    devices (6/device), 3 minibatches."""
    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=4))
    config = ppo_fused.FusedPPOConfig(
        n_steps=4, n_epochs=1, n_minibatches=3, hidden=8
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=12, config=config
    )
    mesh = pmesh.make_mesh(n_data=2, n_model=1)
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config=config
    )
    state = shard_state(state)
    state, metrics = train_step(state)
    assert int(state.update_idx) == 1
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), k
