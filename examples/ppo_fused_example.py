"""Train multi-agent PPO on island_navigation_ex_ma on the fused step.

The rollout collection runs INSIDE the fused packed step
(``FusedMaBase.rollout_collect``): the policy MLP, categorical sampling,
env physics, and trajectory emission all happen in one step body, run
as one jitted scan, instead of the generic vmapped path that
``examples/ppo_train_example.py`` uses. The PPO update
(``learners.ppo_fused``) consumes the emitted trajectory in the same
jitted program. Full run state checkpoints/resumes through orbax exactly
like the scalar PPO example.
"""

import argparse
import shutil
import time

import jax

from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_tpu.learners import ppo_fused
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa
from ai_safety_gridworlds_tpu.utils import compile_cache
from ai_safety_gridworlds_tpu.utils.checkpoint import CheckpointManager


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n-steps", type=int, default=32)
    ap.add_argument("--ckpt-dir", default="/tmp/ppo_fused_island_ma_ckpt")
    args = ap.parse_args()
    compile_cache.enable()

    env = IslandNavigationExMa()
    fused = FusedIslandMa(env)
    config = ppo_fused.FusedPPOConfig(
        n_steps=args.n_steps, lr=7e-4, entropy_coef=0.01, hidden=64
    )
    state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(0), batch_size=args.batch, seed=0,
        config=config,
    )
    train_step = ppo_fused.make_train_step(fused, config)

    steps_per_update = args.n_steps * args.batch  # full MA env steps
    mgr = CheckpointManager(
        args.ckpt_dir, max_to_keep=3, save_interval_steps=50
    )
    try:
        latest = mgr.latest_step()
        if latest is not None:
            try:
                state = mgr.restore(latest, state)
                print(f"resumed from update {latest}")
            except ValueError:
                # A checkpoint from an INCOMPATIBLE run config (e.g. a
                # different --batch) — start fresh instead of crashing.
                print(
                    f"checkpoint in {args.ckpt_dir} has incompatible "
                    "shapes (different run config?); starting fresh"
                )
                mgr.close()
                shutil.rmtree(args.ckpt_dir, ignore_errors=True)
                mgr = CheckpointManager(
                    args.ckpt_dir, max_to_keep=3, save_interval_steps=50
                )

        t_last, i_last = time.perf_counter(), int(state.update_idx)
        while int(state.update_idx) < args.updates:
            state, metrics = train_step(state)
            i = int(state.update_idx)
            mgr.save(i, state)
            if i % 10 == 0 or i == args.updates:
                jax.block_until_ready(metrics)
                now = time.perf_counter()
                rate = steps_per_update * (i - i_last) / (now - t_last)
                t_last, i_last = now, i
                print(
                    f"update {i:4d}  mean_reward/step "
                    f"{float(metrics['mean_reward']):+.4f}  entropy "
                    f"{float(metrics['entropy']):.3f}  episodes "
                    f"{int(metrics['episodes'])}  "
                    f"~{rate:,.0f} env-steps/s incl. update"
                )
    finally:
        mgr.close()

    # Held-out evaluation on the fused step: exact completed-episode
    # returns.
    ev = ppo_fused.evaluate(
        fused, state.params, n_steps=128, batch=args.batch, seed=999,
    )
    print(
        f"eval: mean episode return {float(ev['mean_episode_return']):+.2f} "
        f"over {int(ev['episodes'])} episodes"
    )


if __name__ == "__main__":
    main()
