"""Batched example: 4096 parallel environments under jit+vmap+scan.

This is the capability the reference cannot offer: the functional core
(`SafetyGridworld.engine_step`) batches over thousands of environment
copies on one accelerator, and `rollout` runs whole episodes inside a
single compiled XLA program.
"""

import time

import jax
import jax.numpy as jnp

from ai_safety_gridworlds_tpu.core.base import rollout
from ai_safety_gridworlds_tpu.envs.boat_race import BoatRace
from ai_safety_gridworlds_tpu.utils import compile_cache


def main():
    game = BoatRace()
    batch, steps = 4096, 512

    run = jax.jit(
        lambda key: rollout(game, key, n_steps=steps, batch_size=batch)
    )
    key = jax.random.PRNGKey(0)
    out = run(key)  # compile
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    eps, stats = run(jax.random.PRNGKey(1))
    jax.block_until_ready(stats)
    dt = time.perf_counter() - t0
    print(f"{batch * steps / dt:,.0f} env steps/s "
          f"({batch} envs x {steps} steps in {dt*1e3:.1f} ms)")
    episodes = int(stats["episodes"])
    print("episodes finished:", episodes)
    print("mean final return:",
          float(stats["sum_final_return"]) / max(1, episodes))


def ma_example():
    """Multi-agent batched rollout (savanna, 2 agents)."""
    from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_tpu.ma.safety_game_ma import ma_rollout

    game = AIntelopeSavanna(amount_agents=2, level=13, max_iterations=100)
    batch, steps = 256, 128
    run = jax.jit(
        lambda key: ma_rollout(game, key, n_steps=steps, batch_size=batch)
    )
    eps, stats = run(jax.random.PRNGKey(0))
    jax.block_until_ready(stats)

    t0 = time.perf_counter()
    eps, stats = run(jax.random.PRNGKey(1))
    jax.block_until_ready(stats)
    dt = time.perf_counter() - t0
    print(f"MA savanna: {batch * steps / dt:,.0f} env steps/s, "
          f"{int(stats['episodes'])} episodes, per-agent final returns "
          f"{stats['sum_final_returns'].sum(axis=1)}")


def fused_example():
    """Fused packed MA rollout: the production path. The whole
    multi-agent step (action draws, agent order, all sub-steps, finalize,
    auto-reset) is one step body, run as one jitted scan per chunk."""
    from ai_safety_gridworlds_tpu import ops
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )

    fused = ops.make_fused(IslandNavigationExMa())
    batch, steps = 1024, 256
    S = fused.init_packed(seed=0, batch=batch)
    S = fused.rollout(S, steps)  # compile + warm-up
    jax.block_until_ready(S["t"])

    t0 = time.perf_counter()
    S = fused.rollout(S, steps)
    jax.block_until_ready(S["t"])
    dt = time.perf_counter() - t0
    print(f"fused island_navigation_ex_ma: {batch * steps / dt:,.0f} "
          f"env steps/s, {int(S['stats_episodes'].sum())} episodes")


def fused_scalar_example():
    """Fused scalar step: the same packed treatment for the scalar RL
    shell (ops/fused_scalar.py); its rate on the H100 is not measured
    yet."""
    import numpy as np

    from ai_safety_gridworlds_tpu import ops
    from ai_safety_gridworlds_tpu.envs.boat_race import BoatRace

    fused = ops.make_fused(BoatRace())
    batch, steps = 1024, 512
    S = fused.init_packed(seed=0, batch=batch)
    S = fused.rollout(S, steps)  # compile + warm-up
    np.asarray(S["t"])

    t0 = time.perf_counter()
    S = fused.rollout(S, steps)
    np.asarray(S["t"])  # host fetch: drains the queue
    dt = time.perf_counter() - t0
    eps = int(S["stats_episodes"].sum())
    mean_perf = float(S["stats_hidden"].sum()) / max(eps, 1)
    print(f"fused boat_race: {batch * steps / dt:,.0f} env steps/s, "
          f"{eps} episodes, mean performance {mean_perf:.2f}")


if __name__ == "__main__":
    compile_cache.enable()
    main()
    ma_example()
    fused_example()
    fused_scalar_example()
