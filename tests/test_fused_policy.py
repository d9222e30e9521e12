"""In-kernel linear policies for the fused MA kernels.

``FusedMaBase.set_policies`` installs per-lane linear policies (argmax of
W @ feat + b, eps-greedy exploration reusing the action-site uniform) so
one fused rollout evaluates thousands of policy candidates — the
population-evaluation building block (``docs/KERNELS.md``).
"""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.envs.aintelope_savanna import AIntelopeSavanna
from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa
from ai_safety_gridworlds_tpu.ops import reference_chain
from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa
from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna


def _fused(B=32, seed=0):
    f = FusedIslandMa(IslandNavigationExMa())
    return f, f.init_packed(seed=seed, batch=B)


def test_greedy_policy_controls_actions():
    f, S = _fused()
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    W = np.zeros((A, F), np.float32)
    b = np.zeros((A,), np.float32)
    b[0] = 100.0  # NOOP dominates every state
    f.set_policies(W, b, eps=0.0)
    _, dbg = f.step_xla(S, collect_draws=True)
    acts = np.asarray(dbg["actions"])
    assert (acts == 0).all()


def test_per_lane_policies_differ():
    f, S = _fused(B=64)
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    rng = np.random.default_rng(0)
    W = rng.normal(size=(64, A, F)).astype(np.float32) * 3
    b = rng.normal(size=(64, A)).astype(np.float32)
    f.set_policies(W, b, eps=0.0)
    _, dbg = f.step_xla(S, collect_draws=True)
    acts = np.asarray(dbg["actions"])
    assert len(np.unique(acts[0])) > 1


def test_eps_one_recovers_uniform_draw():
    f, S = _fused(B=64)
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    rng = np.random.default_rng(1)
    f.set_policies(
        rng.normal(size=(A, F)).astype(np.float32),
        rng.normal(size=(A,)).astype(np.float32),
        eps=1.0,
    )
    _, dbg_pol = f.step_xla(S, collect_draws=True)
    f.set_policies(None, None)
    _, dbg_uni = f.step_xla(S, collect_draws=True)
    np.testing.assert_array_equal(
        np.asarray(dbg_pol["actions"]), np.asarray(dbg_uni["actions"])
    )


def test_policy_rollout_xla_pallas_bit_identity():
    f, S = _fused(B=64)
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    rng = np.random.default_rng(2)
    f.set_policies(
        rng.normal(size=(64, A, F)).astype(np.float32),
        rng.normal(size=(64, A)).astype(np.float32),
        eps=0.1,
    )
    Sx = f.rollout(dict(S), 15)
    Sl = reference_chain.step_loop(f, dict(S), 15)
    reference_chain.assert_states_equal(Sx, Sl, f.STATE_FIELDS)


def test_policy_equivalence_with_per_env_chain():
    """Policy-chosen actions still replay exactly through apply_substep."""
    import jax
    import jax.numpy as jnp

    env = IslandNavigationExMa()
    f = FusedIslandMa(env)
    B = 8
    S = f.init_packed(seed=3, batch=B)
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    rng = np.random.default_rng(3)
    f.set_policies(
        rng.normal(size=(B, A, F)).astype(np.float32),
        rng.normal(size=(B, A)).astype(np.float32),
        eps=0.2,
    )
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    for step in range(6):
        per_env = [f.unpack_lane(S, bl) for bl in range(B)]
        S2, dbg = f.step_xla(S, collect_draws=True)
        order = np.asarray(dbg["order"])
        actions = np.asarray(dbg["actions"])
        over = np.asarray(dbg["over"])[0]
        for bl in range(B):
            if over[bl]:
                continue
            state_b = per_env[bl]
            for slot in range(f.n):
                i = int(order[slot, bl])
                a = int(actions[i, bl])
                state_b, _ = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), None, slot
                )
            state_b, _ = jax.jit(env.finalize_step)(
                state_b, env.zero_rewards()
            )
            ref = f.unpack_lane(S2, bl)
            np.testing.assert_array_equal(
                np.asarray(state_b.pos), np.asarray(ref.pos),
                err_msg=f"step {step} lane {bl}",
            )
        S = S2


def test_savanna_policy_controls_actions():
    f = FusedSavanna(AIntelopeSavanna())
    S = f.init_packed(seed=1, batch=16)
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    W = np.zeros((A, F), np.float32)
    b = np.zeros((A,), np.float32)
    b[2] = 100.0  # always RIGHT
    f.set_policies(W, b, eps=0.0)
    _, dbg = f.step_xla(S, collect_draws=True)
    acts = np.asarray(dbg["actions"])
    assert (acts == 2).all()
    f.set_policies(None, None)
    _, dbg2 = f.step_xla(S, collect_draws=True)
    assert len(np.unique(np.asarray(dbg2["actions"]))) > 1


def test_firemaker_policy_controls_actions():
    f = FusedFiremaker(FiremakerExMa())
    S = f.init_packed(seed=2, batch=16)
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    W = np.zeros((A, F), np.float32)
    b = np.zeros((A,), np.float32)
    b[1] = 100.0  # always action id amin+1
    f.set_policies(W, b, eps=0.0)
    _, dbg = f.step_xla(S, collect_draws=True)
    acts = np.asarray(dbg["actions"])
    assert (acts == f.amin + 1).all()


def test_bad_policy_shapes_raise():
    f = FusedFiremaker(FiremakerExMa())
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    with pytest.raises(ValueError):
        f.set_policies(np.zeros((A, F + 1)), np.zeros((A,)))
    with pytest.raises(ValueError):
        f.set_policies(np.zeros((A, F)), np.zeros((A - 1,)))
    with pytest.raises(ValueError):
        f.set_policies(
            np.zeros((4, A, F)), np.zeros((8, A))
        )  # lane dims disagree


def test_policy_batch_mismatch_raises():
    f = FusedFiremaker(FiremakerExMa())
    A, F = f.amax - f.amin + 1, f.POLICY_FEATURES
    f.set_policies(np.zeros((8, A, F)), np.zeros((8, A)))
    S = f.init_packed(seed=0, batch=16)
    with pytest.raises(ValueError):
        f.rollout(S, 2)


def test_policy_search_example_improves(capsys):
    """The ES example runs end-to-end at tiny scale and its elite mean
    beats the population mean (selection pressure works)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "policy_search_example",
        os.path.join(
            os.path.dirname(__file__), "..", "examples",
            "policy_search_example.py",
        ),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(pop=32, steps=32, iters=2, seed=7)
    out = capsys.readouterr().out
    assert "iter 1" in out and "env-steps across" in out
