"""Gradient-free policy search on the fused packed step.

Each batch lane of the fused island_navigation_ex_ma step carries its
OWN linear policy (``FusedMaBase.set_policies``), so one rollout scores
an entire population of candidates in parallel: thousands of policies
x hundreds of steps in one jitted scan. This example runs a simple iterated random search
( (mu, lambda) ES without gradients): sample a population around the
current mean, evaluate all lanes in one fused rollout, recombine the top
quantile, repeat.

The reference framework has no counterpart: population evaluation there
means thousands of sequential Python episodes.
"""

import time

import jax
import numpy as np

from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa
from ai_safety_gridworlds_tpu.utils import compile_cache


def main(pop=1024, steps=256, iters=5, sigma=1.0, elite_frac=0.1, seed=0):
    env = IslandNavigationExMa()
    fused = FusedIslandMa(env)
    A = fused.amax - fused.amin + 1
    F = fused.POLICY_FEATURES
    n, D = fused.n, fused.D
    rng = np.random.default_rng(seed)
    mean_w = np.zeros((A, F), np.float32)
    mean_b = np.zeros((A,), np.float32)
    n_elite = max(1, int(pop * elite_frac))

    # Scalarised per-lane fitness: summed reward vector over all agents.
    def evaluate(W, b):
        fused.set_policies(W, b, eps=0.05)
        S = fused.init_packed(seed=seed, batch=pop)
        S = fused.rollout(S, steps)
        jax.block_until_ready(S["t"])
        rewards = np.asarray(S["stats_rewards"])  # [n*D, pop]
        episodes = np.maximum(np.asarray(S["stats_episodes"])[0], 1)
        return rewards.sum(axis=0) / episodes  # mean return per episode

    t0 = time.perf_counter()
    baseline = evaluate(
        np.tile(mean_w, (pop, 1, 1)), np.tile(mean_b, (pop, 1))
    )
    print(f"random/zero policy mean return: {baseline.mean():9.2f}")

    for it in range(iters):
        W = mean_w + sigma * rng.normal(size=(pop, A, F)).astype(np.float32)
        b = mean_b + sigma * rng.normal(size=(pop, A)).astype(np.float32)
        fitness = evaluate(W, b)
        elite = np.argsort(fitness)[-n_elite:]
        mean_w = W[elite].mean(axis=0)
        mean_b = b[elite].mean(axis=0)
        sigma *= 0.9
        print(
            f"iter {it}: pop best {fitness.max():9.2f}  "
            f"elite mean {fitness[elite].mean():9.2f}  "
            f"pop mean {fitness.mean():9.2f}"
        )

    dt = time.perf_counter() - t0
    total = (iters + 1) * pop * steps
    print(
        f"{total:,} env-steps across {iters + 1} populations in "
        f"{dt:.1f}s ({total / dt / 1e6:.1f}M steps/s incl. recompiles)"
    )


if __name__ == "__main__":
    compile_cache.enable()
    main()
