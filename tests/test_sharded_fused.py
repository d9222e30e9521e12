"""Multi-device composition tests: the fused rollouts under shard_map.

These validate the composition that runs on real multi-GPU hardware —
fused rollouts with the lane (batch) axis sharded over a
``jax.sharding.Mesh`` — on the 8-virtual-device CPU mesh (conftest forces
``--xla_force_host_platform_device_count=8``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ai_safety_gridworlds_tpu.parallel.mesh import make_mesh, shard_map

N_DEV = 8


def _mesh():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(n_data=N_DEV, n_model=1)


def _lane_split(fused, S, mesh, statics=None):
    lane = NamedSharding(mesh, P(None, "data"))
    S_sharded = {k: jax.device_put(v, lane) for k, v in S.items()}
    statics_host = fused._statics_jnp() if statics is None else statics
    specs = {
        k: (P(None, "data") if v.shape[1] != 1 else P())
        for k, v in statics_host.items()
    }
    statics_sharded = {
        k: jax.device_put(v, NamedSharding(mesh, specs[k]))
        for k, v in statics_host.items()
    }
    return S_sharded, statics_sharded, specs


@pytest.mark.parametrize("kernel", ["island", "savanna"])
def test_sharded_pallas_rollout_bit_identical(kernel):
    """The fused rollout under shard_map (each device running the scan on
    its lane shard) is bit-identical to the single-device rollout —
    lanes are independent, so sharding must not change anything."""
    if kernel == "island":
        from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
            IslandNavigationExMa,
        )
        from ai_safety_gridworlds_tpu.ops.fused_island_ma import (
            FusedIslandMa,
        )

        fused = FusedIslandMa(IslandNavigationExMa(max_iterations=6))
    else:
        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
            AIntelopeSavanna,
        )
        from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna

        fused = FusedSavanna(AIntelopeSavanna(max_iterations=6))

    mesh = _mesh()
    B = 4 * N_DEV
    S = fused.init_packed(seed=3, batch=B)
    ref = fused.rollout(dict(S), 5)

    S_sh, statics_sh, specs = _lane_split(fused, S, mesh)
    state_specs = {k: P(None, "data") for k in S}

    def body(S_local, statics_local):
        out = fused.rollout(S_local, 5, statics=statics_local)
        reward_sum = jax.lax.psum(
            jnp.sum(S_local["stats_rewards"]), "data"
        )
        return out, reward_sum

    out, _ = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(state_specs, specs),
            out_specs=(state_specs, P()),
        )
    )(S_sh, statics_sh)

    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(out[k]), np.asarray(ref[k]), err_msg=k
        )


def test_sharded_fused_ppo_train_step():
    """One data-parallel fused-PPO update on the 8-device mesh: the
    collection scan runs per-device inside shard_map, gradients pmean
    across the mesh, params stay replicated and finite, and the update
    matches the single-device train step's direction (same trajectory:
    identical lanes, pmean of equal shards == global mean up to per-shard
    advantage normalization)."""
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_tpu.learners import ppo_fused
    from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa

    mesh = _mesh()
    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=6))
    config = ppo_fused.FusedPPOConfig(
        n_steps=6, n_epochs=1, n_minibatches=2, hidden=16
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=4 * N_DEV, config=config
    )
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config=config
    )
    state = shard_state(state)
    state2, metrics = train_step(state)
    jax.block_until_ready(metrics)

    assert int(state2.update_idx) == 1
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), k
    # Params were updated and are replicated across all 8 devices.
    w1 = state2.params["mlp_w1"]
    assert not np.array_equal(np.asarray(w1), np.asarray(state.params["mlp_w1"]))
    assert w1.sharding.is_fully_replicated
    # Every lane shard advanced its env clock.
    assert int(jnp.sum(state2.S["t"])) > 0


def test_sharded_ppo_checkpoint_roundtrip(tmp_path):
    """The SHARDED fused-PPO train state checkpoints and restores with
    its shardings intact (orbax handles jax.Array shardings natively),
    and training resumes bit-exactly."""
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_tpu.learners import ppo_fused
    from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_tpu.utils.checkpoint import CheckpointManager

    mesh = _mesh()
    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=6))
    config = ppo_fused.FusedPPOConfig(
        n_steps=4, n_epochs=1, n_minibatches=2, hidden=8
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(3), batch_size=2 * N_DEV, config=config
    )
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config=config
    )
    state = shard_state(state)
    state, _ = train_step(state)

    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        mgr.save(1, state)
        restored = mgr.restore(1, state)

    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Same sharding layout on the restored state.
    assert restored.S["t"].sharding == state.S["t"].sharding

    s1, m1 = train_step(state)
    s2, m2 = train_step(restored)
    np.testing.assert_array_equal(
        np.asarray(s1.params["mlp_w1"]), np.asarray(s2.params["mlp_w1"])
    )
