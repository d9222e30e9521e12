"""First-class step-rate measurement and profiler hooks.

The reference exposes no performance tooling at all (SURVEY §5: the closest
artifact is the curses UI's wall-clock episode timer, ``safety_ui.py:93-97``).
For a batched simulator, steps/s is a first-class metric: this module
provides a self-contained measurement harness (compile-excluded, device-
synchronized timing) and an optional ``jax.profiler`` trace context for
inspecting the compiled step in TensorBoard/XProf or Perfetto.

Timed regions end with a host fetch of a scalar that depends on the
whole rollout (``float(acc)``), which waits for every queued chunk.
Rates of these paths on the H100 are not measured yet.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp

from ai_safety_gridworlds_tpu.core import base as core_base


def measure_steps_per_second(
    env,
    batch_size: int = 4096,
    n_steps: int = 2048,
    n_reps: int = 3,
    include_observation: bool = True,
    key=None,
    min_rep_wall_s: float = 0.0,
) -> dict:
    """Measure aggregate env steps/s for a batched auto-resetting rollout.

    Compiles once (excluded from timing), then times ``n_reps`` repetitions
    individually (``block_until_ready`` per rep) so callers get a spread,
    not just an aggregate. Long measured intervals matter: short dispatches
    are dominated by per-call host->device latency — ``min_rep_wall_s``
    (when > 0) calibrates how many chained scan chunks make up one rep so
    each rep's wall time reaches at least that long; the chunks within a
    rep are dispatched without intermediate syncs (pipelined, like a real
    training loop).

    Returns a dict with ``steps_per_sec`` (median over reps),
    ``rep_steps_per_sec`` (per-rep list), ``min``/``max``, ``wall_time_s``,
    ``total_steps``, ``device`` and the measurement configuration.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    step_fn = jax.vmap(functools.partial(core_base.episode_step, env))
    obs_fn = (
        jax.vmap(lambda s: env.observe(s)["board"])
        if include_observation
        else None
    )

    def chunk(ep, chunk_key):
        def body(carry, step_key):
            eps, acc = carry
            actions = jax.random.randint(
                step_key,
                (batch_size,),
                env.action_min,
                env.action_max + 1,
                dtype=jnp.int32,
            )
            eps, outs = step_fn(eps, actions)
            acc = acc + jnp.sum(outs.step.reward)
            if obs_fn is not None:
                # Full-board reduction keeps the render from being DCE'd.
                acc = acc + jnp.sum(obs_fn(eps.env_state))
            return (eps, acc), None

        (ep, acc), _ = jax.lax.scan(
            body, (ep, jnp.float32(0.0)), jax.random.split(chunk_key, n_steps)
        )
        return ep, acc

    keys = jax.random.split(key, batch_size + 1)
    ep = jax.jit(
        jax.vmap(functools.partial(core_base.episode_reset, env))
    )(keys[1:])
    run = jax.jit(chunk)

    # Timed regions end with a host fetch of the scalar accumulator,
    # which depends on every queued chunk.
    ep, acc = run(ep, keys[0])  # compile + warm-up
    float(acc)

    chunks_per_rep = 1
    if min_rep_wall_s > 0:
        # Calibrate: one timed chunk decides how many pipelined chunks a
        # rep needs to outlast dispatch jitter.
        t0 = time.perf_counter()
        ep, acc = run(ep, jax.random.fold_in(keys[0], 10**6))
        float(acc)
        chunk_wall = max(time.perf_counter() - t0, 1e-9)
        chunks_per_rep = max(1, int(min_rep_wall_s / chunk_wall) + 1)

    rep_rates, wall_total = [], 0.0
    steps_per_rep = chunks_per_rep * n_steps * batch_size
    for i in range(n_reps):
        t0 = time.perf_counter()
        for j in range(chunks_per_rep):
            ep, acc = run(
                ep, jax.random.fold_in(keys[0], i * chunks_per_rep + j)
            )
        float(acc)
        wall = time.perf_counter() - t0
        wall_total += wall
        rep_rates.append(steps_per_rep / wall)

    sorted_rates = sorted(rep_rates)
    total = n_reps * steps_per_rep
    return {
        "steps_per_sec": sorted_rates[len(sorted_rates) // 2],
        "rep_steps_per_sec": rep_rates,
        "min": sorted_rates[0],
        "max": sorted_rates[-1],
        "wall_time_s": wall_total,
        "total_steps": total,
        "batch_size": batch_size,
        "n_steps": n_steps,
        "n_reps": n_reps,
        "chunks_per_rep": chunks_per_rep,
        "include_observation": include_observation,
        "device": str(jax.devices()[0]),
    }


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    """``jax.profiler`` trace context: wrap a measured region to capture an
    XLA execution trace viewable in TensorBoard / XProf."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def per_step_latency(env, n_steps: int = 100, key=None) -> dict:
    """Single-env dispatch-bound step latency (the interactive-shell cost a
    human or single-stream agent sees), in seconds per step."""
    if key is None:
        key = jax.random.PRNGKey(0)
    ep = core_base.episode_reset(env, key)
    step = jax.jit(functools.partial(core_base.episode_step, env))
    ep, out = step(ep, jnp.int32(env.action_min))  # compile
    jax.block_until_ready(out.step.reward)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ep, out = step(ep, jnp.int32(env.action_min))
    jax.block_until_ready(out.step.reward)
    wall = time.perf_counter() - t0
    return {"seconds_per_step": wall / n_steps, "steps": n_steps}
