"""Multi-process multi-host smoke test on a CPU Gloo backend.

Spawns real OS processes (tests/multihost_worker.py) joined into one
8-device global mesh via ``jax.distributed`` — the same entry points that
drive a multi-host GPU process group (``parallel/multihost.py``) — at 1,
2, and 4 processes. Verifies:

* the jitted sharded rollout (with cross-process all-reduce metric
  reduction) runs to completion on every process;
* all processes compute byte-identical replicated global metrics;
* the host-sharded CSV sinks jointly cover every global batch lane exactly
  once (each host writes its own contiguous lane block);
* the MERGED sinks and global metrics are host-count-invariant: the 2- and
  4-process runs reproduce the single-process result byte-for-byte (lanes
  are keyed by global index, so distribution must not change anything).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env():
    # The worker puts the repo on its own path and sets
    # JAX_PLATFORMS/XLA_FLAGS itself, so it starts from a clean copy.
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")
    }
    return env


def _run_group(tmp_path, n):
    """Run an n-process group; return (merged {lane: csv fields}, the
    replicated global-metrics line shared by every host)."""
    out_dir = tmp_path / f"n{n}"
    out_dir.mkdir()
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(n), str(i),
             str(out_dir)],
            env=_clean_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(n)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"multihost worker timed out (n={n})")
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i}/{n} failed:\n{out}"
        assert f"worker {i} ok" in out

    # Replicated global reductions agree byte-for-byte across hosts.
    globals_ = [
        open(out_dir / f"global_host{i}.txt").read() for i in range(n)
    ]
    assert len(set(globals_)) == 1

    # The per-host CSV sinks partition the global lane space exactly.
    lanes = {}
    for i in range(n):
        path = out_dir / f"rollout_host{i}.csv"
        rows = open(path).read().strip().splitlines()
        assert rows[0] == "step;lane;episode_return;hidden_return;env_t"
        for row in rows[1:]:
            fields = row.split(";")
            lane = int(fields[1])
            assert lane not in lanes, f"lane {lane} written twice"
            lanes[lane] = (i, fields)
    assert sorted(lanes) == list(range(16))
    # Each host wrote its own contiguous 16/n-lane block.
    local = 16 // n
    for k in range(16):
        assert lanes[k][0] == k // local, (k, lanes[k][0])
    return {k: v[1] for k, v in lanes.items()}, globals_[0]


def test_multi_process_mesh_merges_to_single_process(tmp_path):
    merged = {n: _run_group(tmp_path, n) for n in (1, 2, 4)}
    base_lanes, base_globals = merged[1]
    for n in (2, 4):
        lanes, globals_ = merged[n]
        # Global all-reduced metrics (rollout sums, fused psum total,
        # replicated PPO loss) reproduce the single-process run exactly.
        assert globals_ == base_globals, f"n={n} global metrics diverged"
        # Every per-lane CSV row merges to the single-process sink output.
        assert lanes == base_lanes, f"n={n} merged CSV diverged"
