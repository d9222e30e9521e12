"""Throughput benchmark over the contract config set (BASELINE.md).

Prints ONE JSON line per benchmark config:

  boat_race, boat_race_ex, island_navigation, island_navigation_ex
  (default + full challenge-flag matrix) on the generic scan path and on
  their fused packed steps, the three multi-agent flagships
  firemaker_ex_ma, aintelope_savanna, island_navigation_ex_ma (fused
  packed steps), one non-default MA config (firemaker
  action_direction_mode=1), the generic vmapped MA path, the fused-PPO
  training configs, and the data-parallel configs over every visible GPU

then a final headline line carrying the firemaker number, with every
config's result embedded under "configs".

Run it on a GPU: ``python bench.py``. It exits non-zero when JAX finds no
GPU, and any config that fails fails the run. Every line names the device
it ran on.

Rigor: every config reports {value: median, min, max, n_reps} over
individually-timed repetitions, each rep calibrated to a minimum wall
time (pipelined chunks, one sync per rep), and every timed region ends
with a host fetch of a result that depends on the whole rep.

Each config steps BATCH auto-resetting environments in lockstep with a
uniform-random policy, including the value-mapped board observation per
step for the scalar/MO envs on the generic path (the same per-step work
surface the reference exposes through ``SafetyEnvironment.step`` +
distiller). The fused configs run the packed step bodies
(``ops/fused_*.py``) as one jitted ``lax.scan`` per chunk.

vs_baseline divides by the reference's single-stream CPU steps/s (the
reference publishes no numbers, BASELINE.md):

  boat_race 4846, island_navigation 6232, boat_race_ex 1746,
  island_navigation_ex 1376, firemaker_ex_ma 607, aintelope_savanna 1251,
  island_navigation_ex_ma 964.
"""

import json
import statistics
import sys
import time

import jax
import numpy as np

from ai_safety_gridworlds_tpu.utils import compile_cache

BATCH = 4096
N_REPS = 5
MIN_REP_WALL_S = 0.4
REFERENCE_STEPS_PER_SEC = {
    "boat_race": 4.846e3,
    "boat_race_fused": 4.846e3,
    "island_navigation": 6.232e3,
    "island_navigation_fused": 6.232e3,
    "boat_race_ex": 1.746e3,
    "boat_race_ex_fused": 1.746e3,
    "island_navigation_ex": 1.376e3,
    "island_navigation_ex_fused": 1.376e3,
    "island_navigation_ex_full": 1.376e3,
    "island_navigation_ex_full_fused": 1.376e3,
    "firemaker_ex_ma": 607.0,
    "firemaker_ex_ma_dirmode1": 607.0,
    "firemaker_ex_ma_generic": 607.0,
    "aintelope_savanna": 1.251e3,
    "aintelope_savanna_sustain": 1.251e3,
    "island_navigation_ex_ma": 964.0,
    # Sharded (shard_map over every visible GPU) configs.
    "firemaker_ex_ma_sharded": 607.0,
    "ppo_island_ma_train_sharded": 964.0,
    # Training configs: vs the same env's reference single-stream step
    # rate (the reference ships no learner at all).
    "ppo_island_ma_train": 964.0,
    "ppo_firemaker_train": 607.0,
    "ppo_savanna_train": 1.251e3,
    "ppo_boat_race_train": 4.846e3,
}


def _spread(rates):
    rates = sorted(rates)
    return {
        "value": round(statistics.median(rates), 1),
        "min": round(rates[0], 1),
        "max": round(rates[-1], 1),
        "n_reps": len(rates),
    }


def bench_scalar(env, n_steps=4096, n_reps=N_REPS):
    from ai_safety_gridworlds_tpu.utils import profiling

    out = profiling.measure_steps_per_second(
        env,
        batch_size=BATCH,
        n_steps=n_steps,
        n_reps=n_reps,
        include_observation=True,
        min_rep_wall_s=MIN_REP_WALL_S,
    )
    return _spread(out["rep_steps_per_sec"])


def bench_fused(fused, n_steps=256, n_reps=N_REPS, batch=None):
    # Timed regions end with a host fetch (np.asarray) of the final
    # state, which depends on every queued chunk.
    batch = BATCH if batch is None else batch
    S = fused.init_packed(seed=0, batch=batch)
    S = fused.rollout(S, n_steps)  # compile + warm-up
    np.asarray(S["t"])

    t0 = time.perf_counter()
    S = fused.rollout(S, n_steps)  # calibrate chunks per rep
    np.asarray(S["t"])
    chunk_wall = max(time.perf_counter() - t0, 1e-9)
    chunks = max(1, int(MIN_REP_WALL_S / chunk_wall) + 1)

    rates = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        for _ in range(chunks):
            S = fused.rollout(S, n_steps)
        np.asarray(S["t"])
        rates.append(chunks * n_steps * batch / (time.perf_counter() - t0))
    return _spread(rates)


def bench_generic_ma(game, batch=1024, n_steps=128, n_reps=3):
    """Generic vmapped MA path — what non-fused configs actually get."""
    from ai_safety_gridworlds_tpu.ma.safety_game_ma import ma_rollout

    run = jax.jit(
        lambda key: ma_rollout(
            game, key, n_steps=n_steps, batch_size=batch
        )
    )
    _, stats = run(jax.random.PRNGKey(0))
    np.asarray(stats["episodes"])  # host fetch: drains the queue
    rates = []
    for i in range(n_reps):
        t0 = time.perf_counter()
        _, stats = run(jax.random.PRNGKey(i + 1))
        np.asarray(stats["episodes"])
        rates.append(batch * n_steps / (time.perf_counter() - t0))
    return _spread(rates)


def emit(name, spread, extra=None, batch=BATCH):
    line = {
        "metric": f"env_steps_per_sec_{name}_b{batch}",
        "value": spread["value"],
        "unit": "steps/s",
        "vs_baseline": round(
            spread["value"] / REFERENCE_STEPS_PER_SEC[name], 2
        ),
        "min": spread["min"],
        "max": spread["max"],
        "n_reps": spread["n_reps"],
        **_DEVICE,
    }
    if extra:
        line.update(extra)
    print(json.dumps(line), flush=True)
    return line


# Filled in by main() from jax.devices(): every line names its device.
_DEVICE = {}


def run_all():
    """Run every config in order, one JSON line each; returns the lines."""
    from ai_safety_gridworlds_tpu.envs.boat_race import BoatRace
    from ai_safety_gridworlds_tpu.envs.boat_race_ex import BoatRaceEx
    from ai_safety_gridworlds_tpu.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex import (
        IslandNavigationEx,
    )
    from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker
    from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna
    from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa

    lines = []

    def emit_line(name, spread, extra=None, batch=BATCH):
        lines.append(emit(name, spread, extra=extra, batch=batch))

    emit_line(
        "firemaker_ex_ma",
        bench_fused(FusedFiremaker(FiremakerExMa())),
        extra={"kernel": "fused"},
    )

    # The data-parallel composition over every visible GPU, gated on
    # bit-identity with the unsharded rollout.
    spread, extra = bench_sharded_rollout()
    emit_line(
        "firemaker_ex_ma_sharded", spread,
        extra={"kernel": "fused+shard_map", **extra},
    )
    spread, extra = bench_sharded_ppo()
    emit_line(
        "ppo_island_ma_train_sharded", spread,
        extra={"kernel": "fused+ppo+shard_map", **extra},
    )

    for name, mk in (
        ("boat_race", lambda: BoatRace()),
        ("island_navigation", lambda: IslandNavigation()),
        ("boat_race_ex", lambda: BoatRaceEx()),
        ("island_navigation_ex", lambda: IslandNavigationEx()),
        # Representative full flag matrix: every challenge subsystem on.
        (
            "island_navigation_ex_full",
            lambda: IslandNavigationEx(
                level=3,
                sustainability_challenge=True,
                thirst_hunger_death=True,
                penalise_oversatiation=True,
                use_satiation_proportional_reward=True,
            ),
        ),
    ):
        emit_line(name, bench_scalar(mk()))

    # Fused scalar packed steps: the whole RL shell per step, like the MA
    # flagships.
    from ai_safety_gridworlds_tpu.ops.fused_scalar import (
        FusedBoatRace, FusedBoatRaceEx, FusedIslandNav, FusedIslandNavEx,
    )

    full_flags = dict(
        level=3,
        sustainability_challenge=True,
        thirst_hunger_death=True,
        penalise_oversatiation=True,
        use_satiation_proportional_reward=True,
    )
    for name, fused, n_steps in (
        ("boat_race_fused", FusedBoatRace(BoatRace()), 8192),
        ("island_navigation_fused",
         FusedIslandNav(IslandNavigation()), 8192),
        ("boat_race_ex_fused", FusedBoatRaceEx(BoatRaceEx()), 4096),
        ("island_navigation_ex_fused",
         FusedIslandNavEx(IslandNavigationEx()), 4096),
        ("island_navigation_ex_full_fused",
         FusedIslandNavEx(IslandNavigationEx(**full_flags)), 4096),
    ):
        emit_line(
            name, bench_fused(fused, n_steps=n_steps),
            extra={"kernel": "fused"},
        )

    emit_line(
        "aintelope_savanna",
        bench_fused(FusedSavanna(AIntelopeSavanna())),
        extra={"kernel": "fused"},
    )
    emit_line(
        "island_navigation_ex_ma",
        bench_fused(FusedIslandMa(IslandNavigationExMa())),
        extra={"kernel": "fused"},
    )
    # Sustainability challenge: dynamic resource curtains in the step.
    emit_line(
        "aintelope_savanna_sustain",
        bench_fused(
            FusedSavanna(AIntelopeSavanna(sustainability_challenge=True))
        ),
        extra={"kernel": "fused"},
    )

    # Non-default MA config: relative direction mode 1.
    from ai_safety_gridworlds_tpu import ops as ops_pkg

    dirmode_fused = ops_pkg.make_fused(FiremakerExMa(action_direction_mode=1))
    assert isinstance(dirmode_fused, FusedFiremaker)
    emit_line(
        "firemaker_ex_ma_dirmode1",
        bench_fused(dirmode_fused),
        extra={"kernel": "fused"},
    )

    # The generic vmapped path on the default firemaker config: keeps the
    # fused-vs-generic gap visible in every run.
    emit_line(
        "firemaker_ex_ma_generic",
        bench_generic_ma(FiremakerExMa()),
        extra={"kernel": "generic_vmap"},
        batch=1024,
    )

    # End-to-end TRAINING throughput: the packed-native fused-PPO update
    # (collection scan + GAE + minibatch epochs, one jitted program) in
    # env-steps/s including the optimizer.
    for name, game, kernel_cls in (
        ("ppo_island_ma_train", IslandNavigationExMa(), FusedIslandMa),
        ("ppo_firemaker_train", FiremakerExMa(), FusedFiremaker),
        ("ppo_savanna_train", AIntelopeSavanna(), FusedSavanna),
        ("ppo_boat_race_train", BoatRace(), FusedBoatRace),
    ):
        emit_line(
            name, bench_ppo_fused(game, kernel_cls),
            extra={"kernel": "fused+ppo"},
        )
    return lines


def bench_sharded_rollout(n_reps=N_REPS, n_steps=256):
    """The multi-device composition: firemaker's fused rollout inside
    ``shard_map`` over a mesh of every visible GPU, with per-shard
    metrics psum'd — asserting the sharded chunk is BIT-IDENTICAL to the
    unsharded rollout."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker
    from ai_safety_gridworlds_tpu.parallel.mesh import make_mesh, shard_map

    n_dev = len(jax.devices())
    mesh = make_mesh(n_data=n_dev, n_model=1)
    fused = FusedFiremaker(FiremakerExMa())
    B = BATCH
    S = fused.init_packed(seed=0, batch=B)
    statics = fused._statics_jnp()

    state_specs = {k: P(None, "data") for k in S}
    static_specs = {
        k: (P(None, "data") if v.shape[1] != 1 else P())
        for k, v in statics.items()
    }
    lane = NamedSharding(mesh, P(None, "data"))
    S_sh = {k: jax.device_put(v, lane) for k, v in S.items()}
    statics_sh = {
        k: jax.device_put(v, NamedSharding(mesh, static_specs[k]))
        for k, v in statics.items()
    }

    def body(S_local, statics_local):
        out = fused.rollout(S_local, n_steps, statics=statics_local)
        return out, jax.lax.psum(jnp.sum(out["stats_rewards"]), "data")

    run = jax.jit(
        shard_map(
            body, mesh=mesh,
            in_specs=(state_specs, static_specs),
            out_specs=(state_specs, P()),
        )
    )

    # Bit-identity gate: one sharded chunk == one unsharded chunk.
    ref = fused.rollout(dict(S), n_steps)
    out, rs = run(S_sh, statics_sh)
    np.asarray(rs)
    mismatched = [
        k for k in ref
        if not np.array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    ]
    if mismatched:
        raise AssertionError(
            f"sharded rollout diverged from unsharded: {mismatched}"
        )

    # Timed reps (pipelined chunks, one host-fetch sync per rep).
    S_sh = out
    t0 = time.perf_counter()
    S_sh, rs = run(S_sh, statics_sh)
    np.asarray(rs)
    chunk_wall = max(time.perf_counter() - t0, 1e-9)
    chunks = max(1, int(MIN_REP_WALL_S / chunk_wall) + 1)
    rates = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        for _ in range(chunks):
            S_sh, rs = run(S_sh, statics_sh)
        np.asarray(rs)
        rates.append(chunks * n_steps * B / (time.perf_counter() - t0))
    spread = _spread(rates)
    spread_extra = {"bit_identical": True, "mesh": f"{n_dev}x1"}
    return spread, spread_extra


def bench_sharded_ppo(n_reps=N_REPS):
    """One data-parallel fused-PPO update per rep under shard_map over
    every visible GPU (``learners/ppo_fused.make_sharded_train_step``)."""
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_tpu.learners import ppo_fused
    from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    mesh = make_mesh(n_data=n_dev, n_model=1)
    fused = FusedIslandMa(IslandNavigationExMa())
    config = ppo_fused.FusedPPOConfig(n_steps=64, n_epochs=2,
                                      n_minibatches=4)
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=BATCH, config=config
    )
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config=config
    )
    state = shard_state(state)
    state, metrics = train_step(state)  # compile + warm-up
    np.asarray(jax.tree.leaves(metrics)[0])
    for k, v in metrics.items():
        assert np.isfinite(np.asarray(v)).all(), f"sharded ppo metric {k}"

    steps_per_update = config.n_steps * BATCH
    t0 = time.perf_counter()
    state, metrics = train_step(state)
    np.asarray(jax.tree.leaves(metrics)[0])
    chunk_wall = max(time.perf_counter() - t0, 1e-9)
    chunks = max(1, int(MIN_REP_WALL_S / chunk_wall) + 1)
    rates = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        for _ in range(chunks):
            state, metrics = train_step(state)
        np.asarray(jax.tree.leaves(metrics)[0])
        rates.append(
            chunks * steps_per_update / (time.perf_counter() - t0)
        )
    return _spread(rates), {"mesh": f"{n_dev}x1"}


def bench_ppo_fused(game, kernel_cls, n_reps=N_REPS):
    from ai_safety_gridworlds_tpu.learners import ppo_fused

    fused = kernel_cls(game)
    config = ppo_fused.FusedPPOConfig(n_steps=64, n_epochs=2,
                                      n_minibatches=4)
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=BATCH, config=config
    )
    train_step = ppo_fused.make_train_step(fused, config=config)
    state, metrics = train_step(state)  # compile + warm-up
    np.asarray(jax.tree.leaves(metrics)[0])  # host fetch

    steps_per_update = config.n_steps * BATCH
    t0 = time.perf_counter()
    state, metrics = train_step(state)
    np.asarray(jax.tree.leaves(metrics)[0])
    chunk_wall = max(time.perf_counter() - t0, 1e-9)
    chunks = max(1, int(MIN_REP_WALL_S / chunk_wall) + 1)

    rates = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        for _ in range(chunks):
            state, metrics = train_step(state)
        np.asarray(jax.tree.leaves(metrics)[0])
        rates.append(
            chunks * steps_per_update / (time.perf_counter() - t0)
        )
    return _spread(rates)


def _results_map(lines):
    return {
        line["metric"].split("env_steps_per_sec_")[1].rsplit("_b", 1)[0]:
        line["value"]
        for line in lines
    }


def main():
    """Measure every config on the GPU, then print the headline line."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"bench.py measures on a GPU; JAX found {devices[0].platform}",
            file=sys.stderr,
        )
        sys.exit(1)
    compile_cache.enable()
    _DEVICE.update(
        platform=devices[0].platform,
        device_kind=devices[0].device_kind,
        device_count=len(devices),
    )
    lines = run_all()
    headline = next(
        line for line in lines
        if line["metric"].startswith("env_steps_per_sec_firemaker_ex_ma_b")
    )
    final = dict(headline)
    final["configs"] = _results_map(lines)
    print(json.dumps(final), flush=True)


if __name__ == "__main__":
    main()
