"""Fused-kernel trajectory emission + PPO: equivalence and training.

The fused collection path (``FusedMaBase.rollout_collect``) runs the policy
MLP inside the packed step and emits per-step records. These tests pin it
three ways:

1. **Driver bit-identity** — the jitted collection scan vs a Python loop
   over the jitted collection step produce the same trajectory, final
   state, and bootstrap values.
2. **Per-env chain replay** — the emitted actions, rewards, and dones
   match the per-env ``apply_substep`` chain (itself lockstep-tested
   against the reference) when the kernel's draws are injected, and the
   emitted logp/value match the step-wise kernel emission.
3. **Training** — the jitted fused-PPO ``train_step`` runs end to end,
   produces finite metrics, and moves the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_safety_gridworlds_tpu.core.timestep import StepType
from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.learners import ppo_fused
from ai_safety_gridworlds_tpu.ops import reference_chain
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa

LAST = int(StepType.LAST)
DEAD = int(StepType.DEAD)


def _make(hidden=16, seed=0):
    env = IslandNavigationExMa()
    fused = FusedIslandMa(env)
    n_actions = fused.amax - fused.amin + 1
    params = ppo_fused.init_params(
        jax.random.PRNGKey(seed), fused.POLICY_FEATURES, n_actions,
        hidden=hidden,
    )
    return env, fused, params


def test_collect_xla_pallas_bit_identity():
    _, fused, params = _make()
    B = 64
    S0 = fused.init_packed(seed=7, batch=B)
    T = 10
    Sx, tx, bx = fused.rollout_collect(dict(S0), params, T)
    Sp, tp, bp = reference_chain.collect_loop(fused, dict(S0), params, T)
    for k in fused.STATE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(Sx[k]), np.asarray(Sp[k]), err_msg=k
        )
    for k in tx:
        np.testing.assert_array_equal(
            np.asarray(tx[k]), np.asarray(tp[k]), err_msg=f"traj {k}"
        )
    np.testing.assert_array_equal(np.asarray(bx), np.asarray(bp))
    # The policy actually acted: rewards accrued, actions in range.
    acts = np.asarray(tx["action"])
    assert ((acts >= fused.amin) | (acts == -1)).all()
    assert (acts <= fused.amax).all()
    assert np.abs(np.asarray(tx["reward"])).sum() > 0


def test_emitted_trajectory_matches_per_env_chain():
    env, fused, params = _make()
    B, T = 4, 8
    n, D = fused.n, fused.D
    S0 = fused.init_packed(seed=11, batch=B)
    _, traj, boot = fused.rollout_collect(dict(S0), params, T)
    traj = {k: np.asarray(v) for k, v in traj.items()}

    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    finalize_fn = jax.jit(env.finalize_step)
    S = dict(S0)
    for k in range(T):
        per_env = [fused.unpack_lane(S, b) for b in range(B)]
        S2, dbg = fused.step_xla(S, collect_draws=True, params=params)
        # Step-wise kernel emission == streamed trajectory record.
        np.testing.assert_array_equal(
            np.asarray(dbg["actions"]), traj["action"][k], err_msg=f"s{k}"
        )
        np.testing.assert_allclose(
            np.asarray(dbg["pol"]["logp"]), traj["logp"][k], atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(dbg["pol"]["value"]), traj["value"][k], atol=1e-5
        )
        order = np.asarray(dbg["order"])
        actions = np.asarray(dbg["actions"])
        over = np.asarray(dbg["over"])[0]
        for b in range(B):
            if over[b]:
                assert (actions[:, b] == -1).all()
                assert traj["reward"][k][:, b].sum() == 0.0
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
            state_b, _ = finalize_fn(state_b, env.zero_rewards())
            # Scalarized per-agent rewards match the per-env chain.
            np.testing.assert_allclose(
                traj["reward"][k][:, b], total.sum(axis=1), atol=1e-4,
                err_msg=f"step {k} lane {b} reward",
            )
            # Per-agent dones match the per-env finalize.
            types_b = np.asarray(state_b.step_types)
            done_ref = ((types_b == LAST) | (types_b == DEAD)).astype(
                np.int32
            )
            np.testing.assert_array_equal(
                traj["done"][k][:, b], done_ref,
                err_msg=f"step {k} lane {b} done",
            )
        S = S2

    # Bootstrap value == learner-side forward on the final features.
    feats = fused.feats_of(S)
    for j in range(n):
        X = np.concatenate(
            [np.asarray(r) for r in feats[j]], axis=0
        ).T  # [B, F]
        _, v = ppo_fused.forward(params, jnp.asarray(X))
        np.testing.assert_allclose(
            np.asarray(boot)[j], np.asarray(v), atol=1e-4
        )


def test_valid_masks_reset_and_dead_steps():
    env = IslandNavigationExMa(max_iterations=6)
    fused = FusedIslandMa(env)
    n_actions = fused.amax - fused.amin + 1
    params = ppo_fused.init_params(
        jax.random.PRNGKey(3), fused.POLICY_FEATURES, n_actions, hidden=8
    )
    S0 = fused.init_packed(seed=5, batch=16)
    _, traj, _ = fused.rollout_collect(dict(S0), params, 20)
    acts = np.asarray(traj["action"])
    dones = np.asarray(traj["done"])
    # Episodes of 3 full steps (6 sub-step frames / 2 agents) force resets
    # within 20 steps: reset emissions carry the -1 sentinel.
    assert (acts == -1).any()
    assert dones.any()
    # A step after an all-done step is a reset emission (-1 everywhere).
    all_done = dones.all(axis=1)  # [T, B]
    t_idx, b_idx = np.nonzero(all_done[:-1])
    assert t_idx.size > 0
    assert (acts[t_idx + 1, :, b_idx] == -1).all()


def test_ppo_train_step_runs_and_updates():
    _, fused, _ = _make(hidden=16)
    config = ppo_fused.FusedPPOConfig(
        n_steps=8, n_epochs=2, n_minibatches=2, hidden=16
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=32, seed=1, config=config
    )
    train_step = ppo_fused.make_train_step(fused, config)
    p0 = jax.tree.map(np.asarray, state.params)
    state, metrics = train_step(state)
    state, metrics = train_step(state)
    assert int(state.update_idx) == 2
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), k
    moved = jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
        p0, state.params,
    )
    assert max(jax.tree.leaves(moved)) > 0.0


def test_ppo_train_step_pallas_backend():
    """The train step's collection equals the collection-step loop, and
    the update runs once with finite metrics."""
    _, fused, _ = _make(hidden=8)
    config = ppo_fused.FusedPPOConfig(
        n_steps=4, n_epochs=1, n_minibatches=2, hidden=8
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(1), batch_size=16, seed=2, config=config
    )
    _, traj_loop, _ = reference_chain.collect_loop(
        fused, dict(state.S), state.params, config.n_steps
    )
    train_step = ppo_fused.make_train_step(fused, config)
    state2, metrics = train_step(state)
    assert int(state2.update_idx) == 1
    assert np.isfinite(np.asarray(metrics["mean_reward"]))
    # The update's episode count is the loop trajectory's.
    done = np.asarray(traj_loop["done"]) > 0
    assert float(metrics["episodes"]) == float(done.all(axis=1).sum())


@pytest.mark.parametrize("kernel", ["savanna", "firemaker"])
def test_ppo_train_step_other_kernels(kernel):
    """The fused-PPO update runs (and learns finite updates) on the other
    two kernels' collection paths too, and their collection scans equal
    the collection-step loop."""
    if kernel == "savanna":
        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
            AIntelopeSavanna,
        )
        from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna

        fused = FusedSavanna(AIntelopeSavanna(max_iterations=6))
    else:
        from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import (
            FiremakerExMa,
        )
        from ai_safety_gridworlds_tpu.ops.fused_firemaker import (
            FusedFiremaker,
        )

        fused = FusedFiremaker(FiremakerExMa(max_iterations=6))

    config = ppo_fused.FusedPPOConfig(
        n_steps=5, n_epochs=1, n_minibatches=2, hidden=16
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(2), batch_size=16, config=config
    )
    S, traj_x, boot_x = fused.rollout_collect(
        dict(state.S), state.params, 5
    )
    _, traj_p, boot_p = reference_chain.collect_loop(
        fused, dict(state.S), state.params, 5
    )
    for k in traj_x:
        # Ints exact; the MLP float fields may differ by ~1 ULP between
        # the scan-body and standalone-step matmul fusions.
        np.testing.assert_allclose(
            np.asarray(traj_x[k]), np.asarray(traj_p[k]),
            rtol=0, atol=1e-6, err_msg=k,
        )
    np.testing.assert_allclose(
        np.asarray(boot_x), np.asarray(boot_p), rtol=0, atol=1e-6
    )

    train_step = ppo_fused.make_train_step(fused, config=config)
    state2, metrics = train_step(state)
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), k
    assert not np.array_equal(
        np.asarray(state2.params["mlp_w1"]),
        np.asarray(state.params["mlp_w1"]),
    )


def test_evaluate_exact_episode_returns():
    """evaluate() matches a host-side replay of the emitted trajectory:
    per-agent episode returns harvested at done TRANSITIONS only (DEAD
    agents re-emit done), partial tail episodes excluded."""
    env = IslandNavigationExMa(max_iterations=5)
    fused = FusedIslandMa(env)
    params = ppo_fused.init_params(
        jax.random.PRNGKey(1), fused.POLICY_FEATURES,
        fused.amax - fused.amin + 1, hidden=8,
    )
    out = ppo_fused.evaluate(fused, params, n_steps=24, batch=8, seed=4)
    # Host-side oracle from the same trajectory.
    S = fused.init_packed(seed=4, batch=8)
    _, traj, _ = fused.rollout_collect(S, params, 24)
    reward = np.asarray(traj["reward"])
    done = np.asarray(traj["done"]) > 0
    T, n, B = reward.shape
    rets, count = [], 0
    for j in range(n):
        for b in range(B):
            acc, prev = 0.0, False
            for t in range(T):
                acc += reward[t, j, b]
                if done[t, j, b] and not prev:
                    rets.append(acc)
                    count += 1
                if done[t, j, b]:
                    acc = 0.0
                prev = done[t, j, b]
    assert int(out["episodes"]) == count and count > 0
    np.testing.assert_allclose(
        float(out["mean_episode_return"]),
        float(np.mean(rets)), rtol=1e-5,
    )


def test_ppo_train_step_savanna_sustainability():
    """Fused-PPO collection composes with the in-kernel sustainability
    drape phase: the collection scan matches the collection-step loop and
    one train step produces finite updates."""
    from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna

    fused = FusedSavanna(
        AIntelopeSavanna(max_iterations=6, sustainability_challenge=True)
    )
    config = ppo_fused.FusedPPOConfig(
        n_steps=5, n_epochs=1, n_minibatches=2, hidden=16
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(2), batch_size=16, config=config
    )
    S, traj_x, boot_x = fused.rollout_collect(
        dict(state.S), state.params, 5
    )
    _, traj_p, _ = reference_chain.collect_loop(
        fused, dict(state.S), state.params, 5
    )
    for k in traj_x:
        np.testing.assert_allclose(
            np.asarray(traj_x[k]), np.asarray(traj_p[k]),
            rtol=0, atol=1e-6, err_msg=k,
        )
    train = ppo_fused.make_train_step(fused, config=config)
    state2, metrics = train(state)
    leaves = jax.tree_util.tree_leaves(state2.params)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), k
