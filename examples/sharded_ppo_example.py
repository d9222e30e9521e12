"""Data-parallel fused-PPO across a device mesh.

The multi-GPU training composition: each device runs the fused
collection scan (env physics + policy MLP + sampling + trajectory
emission in one step body) on its shard of the lane batch, local
minibatch gradients ``pmean`` across the mesh, and the replicated Adam
update applies everywhere (``learners.ppo_fused.make_sharded_train_step``).

On a machine without multiple accelerators, run with a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_ppo_example.py
"""

import argparse
import time

import jax

from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.learners import ppo_fused
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa
from ai_safety_gridworlds_tpu.parallel.mesh import make_mesh
from ai_safety_gridworlds_tpu.utils import compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=20)
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--n-steps", type=int, default=16)
    args = ap.parse_args()
    compile_cache.enable()

    devices = jax.devices()
    mesh = make_mesh(n_data=len(devices), n_model=1)
    batch = args.batch_per_device * len(devices)
    print(f"mesh: {mesh.shape} over {devices[0].platform}; "
          f"lane batch {batch} ({args.batch_per_device}/device)")

    fused = FusedIslandMa(IslandNavigationExMa())
    config = ppo_fused.FusedPPOConfig(
        n_steps=args.n_steps, n_minibatches=2, hidden=32
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=batch, config=config
    )
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config=config
    )
    state = shard_state(state)

    steps_per_update = args.n_steps * batch
    t0 = time.perf_counter()
    for i in range(args.updates):
        state, metrics = train_step(state)
        if (i + 1) % 5 == 0:
            jax.block_until_ready(metrics)
            rate = steps_per_update * 5 / (time.perf_counter() - t0)
            print(
                f"update {i + 1}: {rate:,.0f} env steps/s, "
                f"mean_reward {float(metrics['mean_reward']):+.3f}, "
                f"episodes {float(metrics['episodes']):.0f}"
            )
            t0 = time.perf_counter()
    assert state.params["mlp_w1"].sharding.is_fully_replicated


if __name__ == "__main__":
    main()
