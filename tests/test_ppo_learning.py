"""Learning-quality gates for the PPO learners.

The mechanics suites (``test_fused_ppo.py``) pin driver bit-identity and
trajectory equivalence but nothing there asserts the learners *learn* or
that the advantage/surrogate math is *correct*. These tests close both
holes:

1. **Convergence smokes** — fused PPO on island_navigation_ex_ma and the
   generic learner on island_navigation must improve mean evaluated
   return over the initial policy by a pinned margin within a fixed,
   CPU-sized budget (fixed seeds; jitted CPU execution is deterministic).
   A sign error anywhere in the advantage pipeline turns improvement into
   regression and fails these.
2. **NumPy differentials** — GAE (both layouts) and the full
   clipped-surrogate loss (both layouts) recomputed by a straightforward
   , loop-based NumPy implementation on a RECORDED trajectory must match
   the jitted implementations. An off-by-one in the bootstrap chain or a
   mis-masked normalization fails these.

The reference ships no learner (SURVEY §5); the oracle here is the PPO
math itself (Schulman et al. 2017, eqs. 7/11-12; GAE per Schulman et al.
2015, eq. 16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core import base as core_base
from ai_safety_gridworlds_tpu.envs.island_navigation import IslandNavigation
from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.learners import ppo, ppo_fused
from ai_safety_gridworlds_tpu.learners.actor_critic import forward
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa


# ---------------------------------------------------------------------------
# NumPy oracles: straightforward loop implementations of GAE and the PPO
# clipped-surrogate objective, no jax.
# ---------------------------------------------------------------------------


def np_gae(reward, value, cont, bootstrap, discount, lam):
    """reward/value/cont: [T, ...]; returns (adv, ret) via the textbook
    reverse recurrence: delta_t = r_t + g*c_t*V_{t+1} - V_t;
    A_t = delta_t + g*lam*c_t*A_{t+1}."""
    T = reward.shape[0]
    adv = np.zeros_like(reward)
    next_value, next_adv = bootstrap, np.zeros_like(bootstrap)
    for t in range(T - 1, -1, -1):
        delta = reward[t] + discount * cont[t] * next_value - value[t]
        adv[t] = delta + discount * lam * cont[t] * next_adv
        next_value, next_adv = value[t], adv[t]
    return adv, adv + value


def np_mlp_forward(params, X):
    """X [M, F] -> (logits [M, A], value [M]) with the shared MLP layout
    (mlp_w2's last row is the value head)."""
    w1 = np.asarray(params["mlp_w1"], np.float64)
    b1 = np.asarray(params["mlp_b1"], np.float64)[:, 0]
    w2 = np.asarray(params["mlp_w2"], np.float64)
    b2 = np.asarray(params["mlp_b2"], np.float64)[:, 0]
    h = np.maximum(X @ w1.T + b1, 0.0)
    out = h @ w2.T + b2
    return out[:, :-1], out[:, -1]


def np_ppo_loss(logits, value, action_idx, old_logp, valid, adv, ret, cfg):
    """Flat-sample clipped-surrogate PPO loss (Schulman 2017 eq. 7 +
    masked-mean advantage normalization, squared-error value loss,
    entropy bonus), all in float64 loops-and-broadcasts NumPy."""
    z = logits - logits.max(axis=1, keepdims=True)
    lse = np.log(np.exp(z).sum(axis=1))
    logp_all = z - lse[:, None]
    logp = logp_all[np.arange(len(action_idx)), action_idx]
    m = valid
    denom = max(m.sum(), 1.0)
    am = (adv * m).sum() / denom
    astd = np.sqrt((((adv - am) ** 2) * m).sum() / denom + 1e-8)
    advn = (adv - am) / astd
    ratio = np.exp(logp - old_logp)
    clipped = np.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
    pol = -(np.minimum(ratio * advn, clipped * advn) * m).sum() / denom
    vl = (((value - ret) ** 2) * m).sum() / denom
    p = np.exp(logp_all)
    ent = ((-(p * logp_all).sum(axis=1)) * m).sum() / denom
    return {
        "loss": pol + cfg.value_coef * vl - cfg.entropy_coef * ent,
        "policy_loss": pol,
        "value_loss": vl,
        "entropy": ent,
    }


# ---------------------------------------------------------------------------
# Differentials on recorded trajectories
# ---------------------------------------------------------------------------


def _record_fused(T=12, B=16, seed=3, hidden=16):
    env = IslandNavigationExMa()
    fused = FusedIslandMa(env)
    params = ppo_fused.init_params(
        jax.random.PRNGKey(seed), fused.POLICY_FEATURES,
        fused.amax - fused.amin + 1, hidden=hidden,
    )
    S0 = fused.init_packed(seed=seed + 1, batch=B)
    _, traj, boot = fused.rollout_collect(S0, params, T)
    return fused, params, {k: np.asarray(v) for k, v in traj.items()}, (
        np.asarray(boot)
    )


def test_gae_packed_matches_numpy_on_recorded_trajectory():
    _, _, traj, boot = _record_fused()
    config = ppo_fused.FusedPPOConfig(discount=0.97, gae_lambda=0.9)
    cont = 1.0 - traj["done"].astype(np.float32)
    adv_j, ret_j = ppo_fused._gae_packed(
        {
            "reward": jnp.asarray(traj["reward"]),
            "value": jnp.asarray(traj["value"]),
            "cont": jnp.asarray(cont),
        },
        jnp.asarray(boot),
        config,
    )
    adv_n, ret_n = np_gae(
        traj["reward"].astype(np.float64),
        traj["value"].astype(np.float64),
        cont.astype(np.float64),
        boot.astype(np.float64),
        config.discount,
        config.gae_lambda,
    )
    np.testing.assert_allclose(np.asarray(adv_j), adv_n, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ret_j), ret_n, atol=1e-4)
    # The trajectory must actually exercise the interesting paths:
    # episode boundaries (cont=0) and nonzero rewards.
    assert (cont == 0.0).any() and np.abs(traj["reward"]).sum() > 0


def test_loss_packed_matches_numpy_on_recorded_trajectory():
    fused, params, traj, boot = _record_fused()
    config = ppo_fused.FusedPPOConfig()
    n, F = fused.n, fused.POLICY_FEATURES
    A, amin = fused.amax - fused.amin + 1, int(fused.amin)

    cont = 1.0 - traj["done"].astype(np.float32)
    adv, ret = np_gae(
        traj["reward"], traj["value"], cont, boot,
        config.discount, config.gae_lambda,
    )
    valid = (traj["action"] >= 0).astype(np.float32)
    mb = {
        "feats": jnp.asarray(traj["feats"]),
        "action": jnp.asarray(traj["action"]),
        "logp": jnp.asarray(traj["logp"]),
        "valid": jnp.asarray(valid),
        "adv": jnp.asarray(adv.astype(np.float32)),
        "ret": jnp.asarray(ret.astype(np.float32)),
    }
    loss_j, metrics_j = jax.jit(
        functools.partial(ppo_fused._loss_packed, dims=(n, F, A, amin),
                          config=config)
    )(params, mb)

    # NumPy oracle: flatten [T, n, B] -> [M] samples, forward each agent's
    # features through the NumPy MLP, recompute everything.
    T, _, B = traj["action"].shape
    feats = traj["feats"]  # [T, n*F, B]
    X = np.concatenate(
        [
            feats[:, j * F : (j + 1) * F, :].transpose(0, 2, 1).reshape(
                T * B, F
            )
            for j in range(n)
        ],
        axis=0,
    )  # [n*T*B, F] in (j, t, b) order
    logits, value = np_mlp_forward(params, X.astype(np.float64))

    def flat(x):  # [T, n, B] -> same (j, t, b) order
        return np.concatenate(
            [x[:, j, :].reshape(T * B) for j in range(n)], axis=0
        )

    action_idx = np.maximum(flat(traj["action"]) - amin, 0)
    out_n = np_ppo_loss(
        logits, value, action_idx, flat(traj["logp"]).astype(np.float64),
        flat(valid).astype(np.float64), flat(adv), flat(ret), config,
    )
    assert np.isfinite(float(loss_j))
    np.testing.assert_allclose(
        float(loss_j), out_n["loss"], rtol=1e-5, atol=2e-4
    )
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(
            float(metrics_j[k]), out_n[k], rtol=1e-5, atol=2e-4, err_msg=k
        )
    # Masked samples exist (reset emissions) — the oracle and the packed
    # loss must agree on EXCLUDING them, not just on the happy path.
    assert (valid == 0).any()


def _record_generic(T=16, B=8, seed=2):
    env = IslandNavigation()
    config = ppo.PPOConfig(n_steps=T, hidden=32)
    state = ppo.init_train_state(
        env, jax.random.PRNGKey(seed), batch_size=B, config=config
    )
    ep_batch, traj, boot = jax.jit(
        functools.partial(ppo._collect, env=env, config=config),
        static_argnames=(),
    )(state.params, ep_batch=state.ep_batch, key=jax.random.PRNGKey(7))
    traj = {k: np.asarray(v) for k, v in traj.items()}
    return env, config, state.params, traj, np.asarray(boot)


def test_gae_and_loss_generic_match_numpy():
    env, config, params, traj, boot = _record_generic()
    adv_j, ret_j = ppo._gae(
        {k: jnp.asarray(traj[k]) for k in ("reward", "value", "cont")},
        jnp.asarray(boot), config,
    )
    adv_n, ret_n = np_gae(
        traj["reward"].astype(np.float64),
        traj["value"].astype(np.float64),
        traj["cont"].astype(np.float64),
        boot.astype(np.float64),
        config.discount, config.gae_lambda,
    )
    np.testing.assert_allclose(np.asarray(adv_j), adv_n, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ret_j), ret_n, atol=1e-4)
    assert (traj["cont"] == 0.0).any()  # episode boundaries exercised

    T, B = traj["reward"].shape
    mb = {
        "obs": jnp.asarray(traj["obs"].reshape(T * B, -1)),
        "action": jnp.asarray(traj["action"].reshape(T * B)),
        "logp": jnp.asarray(traj["logp"].reshape(T * B)),
        "valid": jnp.asarray(traj["valid"].reshape(T * B)),
        "adv": jnp.asarray(adv_n.astype(np.float32).reshape(T * B)),
        "ret": jnp.asarray(ret_n.astype(np.float32).reshape(T * B)),
    }
    loss_j, metrics_j = jax.jit(
        functools.partial(ppo._loss, config=config)
    )(params, mb)

    # The generic learner's MLP (actor_critic.forward) runs its matmuls
    # in bfloat16 on the MXU; recompute the forward through the jax
    # function itself but CHECK the loss composition in float64 NumPy, so
    # the differential isolates the PPO math from the quantized matmul.
    logits_j, value_j = forward(params, mb["obs"])
    out_n = np_ppo_loss(
        np.asarray(logits_j, np.float64),
        np.asarray(value_j, np.float64),
        traj["action"].reshape(T * B),
        traj["logp"].astype(np.float64).reshape(T * B),
        traj["valid"].astype(np.float64).reshape(T * B),
        adv_n.reshape(T * B), ret_n.reshape(T * B), config,
    )
    np.testing.assert_allclose(
        float(loss_j), out_n["loss"], rtol=1e-5, atol=2e-4
    )
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(
            float(metrics_j[k]), out_n[k], rtol=1e-5, atol=2e-4, err_msg=k
        )
    assert (traj["valid"] == 0).any()


# ---------------------------------------------------------------------------
# Convergence smokes
# ---------------------------------------------------------------------------


def test_fused_ppo_learns_island_ma():
    """40 CPU-sized fused-PPO updates on island_navigation_ex_ma must lift
    mean evaluated episode return far above the random-init policy
    (measured: -45 -> +15; gate at +30 improvement). Fixed seeds."""
    env = IslandNavigationExMa()
    fused = FusedIslandMa(env)
    config = ppo_fused.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=64, seed=3, config=config
    )
    train = ppo_fused.make_train_step(fused, config)
    ev0 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    for _ in range(40):
        state, metrics = train(state)
    assert np.isfinite(float(metrics["mean_reward"]))
    ev1 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    r0 = float(ev0["mean_episode_return"])
    r1 = float(ev1["mean_episode_return"])
    assert int(ev0["episodes"]) > 50 and int(ev1["episodes"]) > 50
    assert r1 - r0 > 30.0, (r0, r1)
    assert r1 > -10.0, r1


def test_fused_ppo_learns_firemaker():
    """200 CPU-sized fused-PPO updates on firemaker_ex_ma (the r4/r5
    bench headline env) must lift mean evaluated episode return far above
    the random-init policy (measured: -28.0 -> +37.6; gate at +40
    improvement and a positive final policy). Episodes bounded at 50
    steps so the 128-step evaluation finishes >2 per lane — firemaker
    episodes otherwise only end at max_iterations. Reward structure per
    ``firemaker_ex_ma.py:772-801`` (workshop work vs fire/trespassing
    penalties)."""
    from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker

    fused = FusedFiremaker(FiremakerExMa(max_iterations=50))
    config = ppo_fused.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=64, seed=3, config=config
    )
    train = ppo_fused.make_train_step(fused, config)
    ev0 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    for _ in range(200):
        state, metrics = train(state)
    assert np.isfinite(float(metrics["mean_reward"]))
    ev1 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    r0 = float(ev0["mean_episode_return"])
    r1 = float(ev1["mean_episode_return"])
    assert int(ev0["episodes"]) > 100 and int(ev1["episodes"]) > 100
    assert r1 - r0 > 40.0, (r0, r1)
    assert r1 > 0.0, r1


def test_fused_ppo_learns_savanna():
    """60 CPU-sized fused-PPO updates on aintelope_savanna must lift mean
    evaluated episode return (measured: -32.6 -> -2.4; gate at +15
    improvement) — the policy learns foraging/predator avoidance per the
    "score" reward flags (``aintelope_savanna.py:481-497``)."""
    from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna

    fused = FusedSavanna(AIntelopeSavanna(max_iterations=50))
    config = ppo_fused.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=64, seed=3, config=config
    )
    train = ppo_fused.make_train_step(fused, config)
    ev0 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    for _ in range(60):
        state, metrics = train(state)
    assert np.isfinite(float(metrics["mean_reward"]))
    ev1 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    r0 = float(ev0["mean_episode_return"])
    r1 = float(ev1["mean_episode_return"])
    assert int(ev0["episodes"]) > 50 and int(ev1["episodes"]) > 50
    assert r1 - r0 > 15.0, (r0, r1)
    assert r1 > -15.0, r1


def test_generic_ppo_learns_island_navigation():
    """40 generic-learner updates on scalar island_navigation must lift
    sampled-policy mean episode return (measured: -2.9 -> +39; gate at
    +20 improvement and an absolutely-positive final policy)."""
    env = IslandNavigation()

    def evaluate(params, n_steps=64, batch=64, seed=5):
        obs_fn = jax.vmap(functools.partial(ppo._obs, env))
        step_fn = jax.vmap(functools.partial(core_base.episode_step, env))
        eps = jax.vmap(functools.partial(core_base.episode_reset, env))(
            jax.random.split(jax.random.PRNGKey(seed), batch)
        )

        def body(carry, key):
            eps, acc = carry
            logits, _ = forward(params, obs_fn(eps.env_state))
            actions = jax.random.categorical(key, logits) + env.action_min
            eps, outs = step_fn(eps, actions)
            done = outs.step.game_over.astype(jnp.float32)
            acc = acc + outs.step.reward
            out = (acc * done, done)
            return (eps, acc * (1.0 - done)), out

        (_, _), (rets, dones) = jax.lax.scan(
            body,
            (eps, jnp.zeros(batch)),
            jax.random.split(jax.random.PRNGKey(seed + 1), n_steps),
        )
        n = dones.sum()
        return float(rets.sum() / jnp.maximum(n, 1.0)), int(n)

    config = ppo.PPOConfig(n_steps=32, hidden=64, lr=7e-4)
    state = ppo.init_train_state(
        env, jax.random.PRNGKey(0), batch_size=64, config=config
    )
    train = ppo.make_train_step(env, config)
    r0, n0 = evaluate(state.params)
    for _ in range(40):
        state, metrics = train(state)
    assert np.isfinite(float(metrics["mean_reward"]))
    r1, n1 = evaluate(state.params)
    assert n0 > 50 and n1 > 50
    assert r1 - r0 > 20.0, (r0, r1)
    assert r1 > 10.0, r1


def test_fused_ppo_learns_island_navigation_scalar_kernel():
    """Same gate on a fused SCALAR kernel (``ops/fused_scalar.py``): 40
    CPU-sized fused-PPO updates on island_navigation must lift mean
    evaluated episode return far above the random-init policy (measured:
    +0.02 -> +27.7; gate at +15 improvement). Guards the scalar kernels'
    POLICY_FEATURES / collection path end-to-end."""
    from ai_safety_gridworlds_tpu.ops.fused_scalar import FusedIslandNav

    env = IslandNavigation()
    fused = FusedIslandNav(env)
    config = ppo_fused.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=64, seed=3, config=config
    )
    train = ppo_fused.make_train_step(fused, config)
    ev0 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    for _ in range(40):
        state, metrics = train(state)
    assert np.isfinite(float(metrics["mean_reward"]))
    ev1 = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=64, seed=9
    )
    r0 = float(ev0["mean_episode_return"])
    r1 = float(ev1["mean_episode_return"])
    assert int(ev0["episodes"]) > 50 and int(ev1["episodes"]) > 50
    assert r1 - r0 > 15.0, (r0, r1)
    assert r1 > 10.0, r1
