"""Smoke run of the main path on a GPU.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-gpus   # the data-parallel path on four GPUs

Drives the system the way its users do — ``BatchedEnv`` →
``ops.make_fused`` → ``learners.ppo_fused`` — at the batch sizes they
run (thousands of auto-resetting lanes), and checks what comes out
against the plain reference, the per-env step chain, on the same device:

1. device: a GPU, its name and power limit;
2. every fused env: ``BatchedEnv(name, 4096).rollout(64)`` takes the
   fused route and returns finite statistics;
3. full size: four envs at 65,536 lanes for 256 steps (wall time and
   peak device memory);
4. reference: the per-env chain driven by the fused step's own draws,
   8 lanes x 50 steps, on five envs; the fire-spread stencil's matrix
   form against its roll form; the collection path's logp/value against
   the batch-major policy forward at full float32 precision;
5. training: three fused-PPO updates on four envs at 4,096 lanes;
6. the generic vmapped path on two envs.

``--four-gpus`` runs only the data-parallel path across four GPUs and
what it is compared with. Any failure ends the run with a non-zero exit
code. The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The phases are plain functions of a batch size, so the test suite runs
them small on the CPU; only :func:`main` insists on a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REFERENCE_ENVS = (
    "boat_race", "tomato_watering", "island_navigation_ex_ma",
    "aintelope_savanna", "firemaker_ex_ma",
)
FULL_SIZE_ENVS = (
    "aintelope_savanna", "island_navigation_ex_ma", "firemaker_ex_ma",
    "boat_race",
)
TRAIN_ENVS = (
    "island_navigation_ex_ma", "firemaker_ex_ma", "aintelope_savanna",
    "boat_race",
)
GENERIC_ENVS = ("boat_race", "firemaker_ex_ma")

# The stencil's matrix form against its roll form, absolute on ``cum``.
STENCIL_ATOL = 1e-5
# In-step policy forward (default precision: TF32 on the GPU's tensor
# cores, 10 mantissa bits, ~5e-4 relative per input) against the
# batch-major forward at full float32: with 6 features, 64 hidden units
# and O(1) weights that is ~1e-3 on logits and value.
POLICY_ATOL = 1e-2
# Sharded against unsharded policy outputs of the same collection.
COLLECT_ATOL = 1e-5


def log(msg):
    print(msg, flush=True)


def _block(tree):
    jax.block_until_ready(tree)
    return tree


def _fused_for(name, **kw):
    from ai_safety_gridworlds_tpu import ops
    from ai_safety_gridworlds_tpu.helpers import factory

    fused = ops.make_fused(factory.get_raw_env(name, **kw))
    assert fused is not None, f"{name} has no fused step"
    return fused


def _assert_finite(tree, what):
    for leaf in jax.tree.leaves(tree):
        assert np.isfinite(np.asarray(leaf)).all(), f"{what} not finite"


# ------------------------------------------------------------- phases


def phase_device():
    """The device JAX runs on, the card's name and power limit."""
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}: platform={dev.platform} "
        f"kind={dev.device_kind} count={len(jax.devices())}")


def phase_every_env(batch=4096, n_steps=64, names=None):
    """``BatchedEnv(name, batch).rollout(n_steps)`` for every env with a
    fused step: fused route taken, statistics finite."""
    from ai_safety_gridworlds_tpu import ops
    from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv

    for name in names or ops.FUSED_ENV_NAMES:
        t0 = time.perf_counter()
        env = BatchedEnv(name, batch)
        assert env.kernel == "fused", f"{name}: route {env.kernel}"
        stats = env.rollout(n_steps)  # compile + run
        t1 = time.perf_counter()
        stats = env.rollout(n_steps)
        t2 = time.perf_counter()
        assert stats["kernel"] == "fused"
        assert np.isfinite(stats["sum_rewards"]).all(), name
        assert stats["episodes"] >= 0, name
        log(f"fused {name:26s} batch {batch} x {n_steps} steps: "
            f"first call {t1 - t0:.2f} s, second {t2 - t1:.3f} s, "
            f"{stats['episodes']} episodes")


def phase_full_size(batch=65536, n_steps=256, names=FULL_SIZE_ENVS):
    """The four flagship envs at full batch: wall time of ``n_steps``
    steps after warm-up, and peak device memory."""
    from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv

    for name in names:
        env = BatchedEnv(name, batch)
        assert env.kernel == "fused", name
        env.rollout(n_steps)  # compile + warm-up
        t0 = time.perf_counter()
        stats = env.rollout(n_steps)  # ends in a host fetch of the stats
        wall = time.perf_counter() - t0
        assert np.isfinite(stats["sum_rewards"]).all(), name
        mem = jax.devices()[0].memory_stats() or {}
        log(f"full size {name:26s} batch {batch} x {n_steps} steps: "
            f"wall {wall:.3f} s, peak_bytes_in_use "
            f"{mem.get('peak_bytes_in_use', 'n/a')}")


def phase_reference(lanes=8, n_steps=50, stencil_lanes=4096,
                    policy_batch=4096, names=REFERENCE_ENVS):
    """The fused steps against the per-env reference chain, the stencil
    forms against each other, and the collection path's policy outputs
    against the batch-major forward."""
    for name in names:
        reference_chain_check(name, lanes, n_steps)
    err = stencil_max_error(stencil_lanes)
    log(f"stencil: matrix vs roll form max |d cum| {err:.3e} "
        f"(gate {STENCIL_ATOL:g})")
    logp_err, value_err = policy_max_error(policy_batch)
    log(f"collection: |d logp| {logp_err:.3e}, |d value| {value_err:.3e} "
        f"vs float32 forward (gate {POLICY_ATOL:g}: the in-step forward "
        "runs at default precision, TF32 on the GPU)")


def reference_chain_check(name, lanes=8, n_steps=50):
    """One env's fused step against the per-env chain driven by the fused
    step's own draws (``ops.reference_chain``)."""
    from ai_safety_gridworlds_tpu.ops import reference_chain as rc

    t0 = time.perf_counter()
    fused = _fused_for(name)
    S = fused.init_packed(seed=3, batch=lanes)
    if name == "boat_race":
        rc.scalar_chain(fused.env, fused, S, n_steps)
    elif name == "tomato_watering":
        rc.tomato_chain(fused.env, fused, S, n_steps)
    elif name == "island_navigation_ex_ma":
        rc.island_ma_chain(fused, S, n_steps)
    elif name == "aintelope_savanna":
        assert fused.exact_reset, "savanna default must redraw"
        rc.savanna_chain(fused, S, n_steps)
    elif name == "firemaker_ex_ma":
        rc.firemaker_chain(fused, S, n_steps)
    else:
        raise ValueError(f"no reference chain for {name}")
    log(f"reference chain {name:26s} {lanes} lanes x {n_steps} steps: "
        f"match ({time.perf_counter() - t0:.1f} s)")


def stencil_max_error(lanes=4096, seed=0):
    """Max |cum| difference of the matrix-form stencil against the roll
    form (computed at ``Precision.HIGHEST``) over random source boards;
    asserts the gate and that cells with no burning neighbour are exactly
    0 in both."""
    from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker

    env = FiremakerExMa()
    roll = FusedFiremaker(env, matrix_stencil=False)
    matrix = FusedFiremaker(env, matrix_stencil=True)
    consts = {k: jnp.asarray(v) for k, v in matrix.consts.items()}
    roll_cum = jax.jit(lambda s: roll._spread_cum(s, consts))
    matrix_cum = jax.jit(lambda s: matrix._spread_cum(s, consts))
    rng = np.random.default_rng(seed)
    worst = 0.0
    for density in (0.02, 0.1, 0.5, 1.0):
        src = jnp.asarray(
            (rng.random((roll.HW, lanes)) < density).astype(np.float32)
        )
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(roll_cum(src))
        got = np.asarray(matrix_cum(src))
        worst = max(worst, float(np.abs(got - ref).max()))
        no_nbr = ref == 0.0
        assert (got[no_nbr] == 0.0).all(), "spurious spread cells"
        assert (got[~no_nbr] > 0.0).all(), "lost spread cells"
    assert worst <= STENCIL_ATOL, f"stencil error {worst} > {STENCIL_ATOL}"
    return worst


def policy_max_error(batch=4096, n_steps=16, seed=0):
    """Collection-path ``logp``/``value`` (in-step policy forward) against
    ``ppo_fused.forward`` at ``Precision.HIGHEST`` on the emitted features
    and actions; asserts ``POLICY_ATOL`` and returns both max errors."""
    from ai_safety_gridworlds_tpu.learners import ppo_fused

    fused = _fused_for("island_navigation_ex_ma")
    n, F = fused.n, fused.POLICY_FEATURES
    A, amin = fused.amax - fused.amin + 1, int(fused.amin)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = ppo_fused.init_params(k1, F, A, hidden=64)
    # O(1) logits, so the sampled actions and their logp are not all
    # near-uniform.
    params["mlp_w2"] = jax.random.normal(k2, params["mlp_w2"].shape) * 0.3
    S = fused.init_packed(seed=seed, batch=batch)
    _, traj, _ = jax.jit(
        lambda S, p: fused.rollout_collect(S, p, n_steps)
    )(S, params)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    logp_err = value_err = 0.0
    with jax.default_matmul_precision("highest"):
        for j in range(n):
            obs = traj["feats"][:, j * F:(j + 1) * F, :]     # [T, F, B]
            obs = obs.transpose(0, 2, 1).reshape(-1, F)
            logits, value = ppo_fused.forward(params, jnp.asarray(obs))
            logp_all = np.asarray(jax.nn.log_softmax(logits, axis=-1))
            action = traj["action"][:, j, :].reshape(-1)
            valid = action >= 0
            logp = logp_all[np.arange(action.size),
                            np.maximum(action - amin, 0)]
            logp_err = max(logp_err, float(np.abs(
                logp - traj["logp"][:, j, :].reshape(-1))[valid].max()))
            value_err = max(value_err, float(np.abs(
                np.asarray(value) - traj["value"][:, j, :].reshape(-1)
            )[valid].max()))
    assert logp_err <= POLICY_ATOL, f"logp error {logp_err}"
    assert value_err <= POLICY_ATOL, f"value error {value_err}"
    return logp_err, value_err


def phase_training(batch=4096, n_updates=3, names=TRAIN_ENVS,
                   config=None):
    """``n_updates`` fused-PPO updates per env: finite metrics and the
    update counter advanced."""
    from ai_safety_gridworlds_tpu.learners import ppo_fused

    config = config or ppo_fused.FusedPPOConfig(
        n_steps=64, n_epochs=2, n_minibatches=4
    )
    for name in names:
        fused = _fused_for(name)
        state = ppo_fused.init_train_state(
            fused, jax.random.PRNGKey(0), batch_size=batch, config=config
        )
        train_step = ppo_fused.make_train_step(fused, config)
        t0 = time.perf_counter()
        for _ in range(n_updates):
            state, metrics = train_step(state)
            _assert_finite(metrics, f"{name} metrics")
        assert int(state.update_idx) == n_updates, name
        log(f"train {name:26s} batch {batch}: {n_updates} updates in "
            f"{time.perf_counter() - t0:.2f} s (compile included), "
            f"mean_reward {float(metrics['mean_reward']):+.4f}")


def phase_generic(batch=1024, n_steps=64, names=GENERIC_ENVS):
    """The generic vmapped path: ``BatchedEnv(backend="generic")``."""
    from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv

    for name in names:
        env = BatchedEnv(name, batch, backend="generic")
        assert env.kernel == "generic_vmap", name
        t0 = time.perf_counter()
        stats = env.rollout(n_steps)
        assert np.isfinite(stats["sum_rewards"]).all(), name
        log(f"generic {name:26s} batch {batch} x {n_steps} steps: "
            f"{time.perf_counter() - t0:.2f} s (compile included)")


def phase_four_gpus(batch_per_device=4096, n_devices=4, n_steps=64,
                    n_updates=3):
    """The data-parallel path over ``n_devices`` devices, each part
    compared with its unsharded run."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ai_safety_gridworlds_tpu.learners import ppo_fused
    from ai_safety_gridworlds_tpu.parallel.mesh import shard_map

    devices = jax.devices()
    assert len(devices) >= n_devices, f"need {n_devices} devices"
    mesh = Mesh(np.asarray(devices[:n_devices]), ("data",))
    lanes = NamedSharding(mesh, P(None, "data"))
    batch = batch_per_device * n_devices

    # Firemaker's fused rollout under shard_map, bit for bit.
    fused = _fused_for("firemaker_ex_ma")
    S = fused.init_packed(seed=0, batch=batch)
    statics = fused._statics_jnp()
    state_specs = {k: P(None, "data") for k in S}
    static_specs = {
        k: (P(None, "data") if v.shape[1] != 1 else P())
        for k, v in statics.items()
    }
    sharded_rollout = jax.jit(shard_map(
        lambda S_l, st_l: fused.rollout(S_l, n_steps, statics=st_l),
        mesh=mesh, in_specs=(state_specs, static_specs),
        out_specs=state_specs,
    ))
    S_sh = {k: jax.device_put(v, lanes) for k, v in S.items()}
    statics_sh = {
        k: jax.device_put(v, NamedSharding(mesh, static_specs[k]))
        for k, v in statics.items()
    }
    out = _block(sharded_rollout(S_sh, statics_sh))
    ref = _block(fused.rollout(dict(S), n_steps))
    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(out[k]), np.asarray(ref[k]), err_msg=k
        )
    assert {s.device for s in out["t"].addressable_shards} == set(
        devices[:n_devices]
    ), "state shards not on distinct devices"
    log(f"four gpus: sharded firemaker rollout {batch} lanes x {n_steps} "
        "steps bit-identical to unsharded")

    # Data-parallel fused PPO on island_ma.
    fused = _fused_for("island_navigation_ex_ma")
    config = ppo_fused.FusedPPOConfig(n_steps=n_steps, n_epochs=2,
                                      n_minibatches=4)
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=batch, config=config
    )
    # The first update's collection, sharded and unsharded.
    S0, params0 = dict(state.S), state.params
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config=config
    )
    state = shard_state(state)
    shard_devs = {s.device for s in state.S["t"].addressable_shards}
    assert len(shard_devs) == n_devices, "state shards not distinct"
    t0 = time.perf_counter()
    for _ in range(n_updates):
        state, metrics = train_step(state)
        _assert_finite(metrics, "sharded ppo metrics")
    assert int(state.update_idx) == n_updates
    log(f"four gpus: sharded fused PPO {batch} lanes: {n_updates} updates "
        f"in {time.perf_counter() - t0:.2f} s (compile included)")

    statics = fused._statics_jnp()
    static_specs = {
        k: (P(None, "data") if v.shape[1] != 1 else P())
        for k, v in statics.items()
    }
    state_specs = {k: P(None, "data") for k in S0}
    traj_spec = P(None, None, "data")
    collect = jax.jit(shard_map(
        lambda S_l, st_l, p: fused.rollout_collect(
            S_l, p, n_steps, statics=st_l
        ),
        mesh=mesh, in_specs=(state_specs, static_specs, P()),
        out_specs=(state_specs, traj_spec, P(None, "data")),
    ))
    _, traj_sh, boot_sh = collect(
        {k: jax.device_put(v, lanes) for k, v in S0.items()},
        {k: jax.device_put(v, NamedSharding(mesh, static_specs[k]))
         for k, v in statics.items()},
        params0,
    )
    _, traj, boot = fused.rollout_collect(S0, params0, n_steps)
    # Features, actions, rewards and dones exactly; the policy outputs
    # within COLLECT_ATOL (per-shard matrix products have other shapes,
    # so the compiler may sum in another order).
    for k in ("feats", "action", "reward", "done"):
        np.testing.assert_array_equal(
            np.asarray(traj_sh[k]), np.asarray(traj[k]), err_msg=k
        )
    for name, got, want in (("logp", traj_sh["logp"], traj["logp"]),
                            ("value", traj_sh["value"], traj["value"]),
                            ("boot", boot_sh, boot)):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=0, atol=COLLECT_ATOL,
            err_msg=name,
        )
    log(f"four gpus: sharded rollout_collect trajectory {batch} lanes x "
        f"{n_steps} steps equal to unsharded (logp/value/boot within "
        f"{COLLECT_ATOL:g})")


# ------------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-gpus", action="store_true",
        help="run only the data-parallel path across four GPUs",
    )
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from ai_safety_gridworlds_tpu.utils import compile_cache

    compile_cache.enable()
    t0 = time.perf_counter()
    phase_device()
    if args.four_gpus:
        phase_four_gpus()
    else:
        phases = (phase_every_env, phase_full_size, phase_reference,
                  phase_training, phase_generic)
        for phase in phases:
            t = time.perf_counter()
            phase()
            log(f"-- {phase.__name__} done in "
                f"{time.perf_counter() - t:.1f} s")
    log(f"total {time.perf_counter() - t0:.1f} s")
    count = 4 if args.four_gpus else len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
