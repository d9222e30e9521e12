"""Worker process for the 2-process multi-host CPU smoke test.

Run by ``tests/test_multihost.py`` (not collected by pytest):

    python tests/multihost_worker.py <port> <num_processes> <process_id> <out_dir>

Each process exposes 4 virtual CPU devices, joins a Gloo-backed jax
distributed group (a stand-in for a multi-host GPU process group), builds
the GLOBAL 8-device mesh, initializes only its own environment lanes,
runs a jitted sharded rollout whose metric reduction lowers to a
cross-process all-reduce, and writes its addressable lanes through the
host-sharded CSV sink.
"""

import functools
import os
import sys

# Keep the GLOBAL mesh at 8 devices regardless of host count (2 hosts x 4
# devices or 4 hosts x 2 devices): the per-device lane shard must stay
# compatible with the fused-PPO minibatch split.
_DEVICES_PER_PROC = max(1, 8 // int(sys.argv[2])) if len(sys.argv) > 2 else 4

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={_DEVICES_PER_PROC}"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    port, num_processes, process_id, out_dir = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )
    from ai_safety_gridworlds_tpu.core import base as core_base
    from ai_safety_gridworlds_tpu.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    assert jax.process_count() == num_processes
    assert jax.device_count() == _DEVICES_PER_PROC * num_processes

    mesh = multihost.make_global_mesh()
    env = IslandNavigation()

    global_batch = 16
    local = global_batch // num_processes
    # Each host initializes ONLY its own lanes, keyed by global lane index
    # so the assembled global batch is host-count-invariant.
    lane0 = process_id * local
    local_eps = jax.vmap(functools.partial(core_base.episode_reset, env))(
        jax.vmap(jax.random.PRNGKey)(jnp.arange(lane0, lane0 + local))
    )
    local_eps = jax.tree.map(np.asarray, local_eps)
    eps = multihost.global_batch_from_local(local_eps, mesh, axis="data")

    step_fn = jax.vmap(functools.partial(core_base.episode_step, env))

    @jax.jit
    def run(eps, key):
        def body(carry, step_key):
            eps = carry
            actions = jax.random.randint(
                step_key, (global_batch,), env.action_min,
                env.action_max + 1, dtype=jnp.int32,
            )
            eps, outs = step_fn(eps, actions)
            return eps, None

        eps, _ = jax.lax.scan(body, eps, jax.random.split(key, 20))
        # Sharded-axis reductions lower to cross-process all-reduces.
        global_return = jnp.sum(eps.episode_return)
        global_hidden = jnp.sum(eps.hidden_return)
        return eps, global_return, global_hidden

    eps, g_ret, g_hid = run(eps, jax.random.PRNGKey(123))
    jax.block_until_ready(g_ret)
    assert np.isfinite(float(g_ret)) and np.isfinite(float(g_hid))

    # --- fused rollout over the GLOBAL (cross-host) mesh -----------------
    # The production MA composition: the fused scan per device inside
    # shard_map, lanes split across hosts, stats psum'd across processes.
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_tpu.parallel.mesh import shard_map

    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=6))
    S = fused.init_packed(seed=5, batch=global_batch)  # same on all hosts
    statics = fused._statics_jnp()
    lane_sh = NamedSharding(mesh, P(None, "data"))
    repl_sh = NamedSharding(mesh, P())

    def _global(v, sharding):
        arr = np.asarray(v)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx, a=arr: a[idx]
        )

    S_sh = {k: _global(v, lane_sh) for k, v in S.items()}
    statics_sh = {k: _global(v, repl_sh) for k, v in statics.items()}

    def fused_body(S_local, statics_l):
        out = fused.rollout(S_local, 6, statics=statics_l)
        return out, jax.lax.psum(jnp.sum(out["stats_rewards"]), "data")

    out, fused_tot = jax.jit(
        shard_map(
            fused_body,
            mesh=mesh,
            in_specs=({k: P(None, "data") for k in S},
                      {k: P() for k in statics}),
            out_specs=({k: P(None, "data") for k in S}, P()),
        )
    )(S_sh, statics_sh)
    jax.block_until_ready(fused_tot)
    assert np.isfinite(float(fused_tot))
    assert int(jnp.max(out["t"].addressable_shards[0].data)) > 0

    # --- sharded fused-PPO train step over the GLOBAL mesh ---------------
    # Full production training composition across HOSTS: the collection
    # scan per device inside shard_map, pmean'd gradients, replicated
    # Adam update. init is seeded identically on every host, so the
    # replicated metrics must agree byte-for-byte.
    from ai_safety_gridworlds_tpu.learners import ppo_fused

    config = ppo_fused.FusedPPOConfig(
        n_steps=4, n_epochs=1, n_minibatches=2, hidden=8
    )
    ppo_state = ppo_fused.init_train_state(
        fused, jax.random.PRNGKey(7), batch_size=global_batch, config=config
    )
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config=config
    )
    ppo_state = shard_state(ppo_state)
    ppo_state, metrics = train_step(ppo_state)
    jax.block_until_ready(metrics)
    ppo_loss = float(np.asarray(metrics["policy_loss"]).ravel()[0])
    assert all(
        np.isfinite(np.asarray(v)).all() for v in metrics.values()
    )
    assert int(ppo_state.update_idx) == 1

    sink = multihost.ShardedCsvSink(
        out_dir, "rollout", ["episode_return", "hidden_return", "env_t"]
    )
    sink.write(
        20,
        {
            "episode_return": eps.episode_return,
            "hidden_return": eps.hidden_return,
            "env_t": eps.env_state.t,
        },
    )
    sink.close()
    # The replicated global reduction must agree across hosts byte-for-byte.
    with open(
        os.path.join(out_dir, f"global_host{process_id}.txt"), "w"
    ) as f:
        f.write(
            f"{float(g_ret)!r};{float(g_hid)!r};{float(fused_tot)!r};"
            f"{ppo_loss!r}\n"
        )
    print(f"worker {process_id} ok", flush=True)


if __name__ == "__main__":
    main()
