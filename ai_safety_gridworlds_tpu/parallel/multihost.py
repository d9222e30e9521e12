"""Multi-host (multi-process) scale-out: DCN mesh + host-sharded sinks.

The reference has no distributed execution at all (SURVEY §2.7); this module
provides the pieces that take the single-host mesh programs in
``parallel/mesh.py`` across hosts:

* :func:`initialize` — ``jax.distributed`` bring-up (coordinator over DCN;
  Gloo collectives when smoke-testing on CPU processes).
* :func:`make_global_mesh` — a ('data', 'model') mesh over ALL processes'
  devices; under jit, reductions over sharded axes lower to
  cross-device all-reduces.
* :func:`global_array_from_local` — assemble a globally-sharded array from
  each host's local batch shard (the data-loading path: each host
  initializes only its own environment lanes).
* :class:`ShardedCsvSink` — the multi-host replacement for the reference's
  single-process CSV logging subsystem (``safety_game_mo.py:1110-1227``):
  every host writes ONLY the rows for the batch lanes whose shards are
  addressable locally, so the sink scales with hosts and no device array
  ever crosses hosts just to be logged. Rows use the same semicolon +
  decimal-normalized format as the per-env CSV logger
  (``mo/safety_game_mo.py``).

Smoke-tested with two real processes on a CPU Gloo backend by
``tests/test_multihost.py``; the same entry points drive multi-host GPU
process groups (coordinator = host 0, one process per host) unchanged.
"""

from __future__ import annotations

import decimal
import numbers
import os
from typing import Optional, Sequence

import jax
import numpy as np

from ai_safety_gridworlds_tpu.parallel.mesh import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Bring up the jax distributed runtime for a multi-host mesh.

    Pass the coordinator address, process count and process id
    explicitly (nothing infers them on a plain GPU host or in the
    2-process CPU smoke test). On a CPU platform this selects the Gloo
    collectives implementation so cross-process psum works.
    """
    # NOTE: must not touch the XLA backend (jax.devices()/default_backend())
    # before jax.distributed.initialize — inspect the config/env only.
    platforms = jax.config.jax_platforms or os.environ.get(
        "JAX_PLATFORMS", ""
    )
    if platforms.startswith("cpu"):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def make_global_mesh(n_model: int = 1) -> jax.sharding.Mesh:
    """A ('data', 'model') mesh over every device of every process.

    ``jax.devices()`` is the global view after :func:`initialize`; the
    single-host :func:`parallel.mesh.make_mesh` therefore already builds the
    right mesh — this wrapper just documents/asserts the multi-process
    contract (all hosts must call it with identical arguments).
    """
    return make_mesh(n_model=n_model)


def global_array_from_local(local, mesh, spec) -> jax.Array:
    """Assemble a global sharded array from this process's local shard data.

    ``local`` holds this host's slice of the global array (its rows of the
    batch axis); the result is a global array sharded by ``spec`` over
    ``mesh`` that jitted mesh programs consume directly.
    """
    sharding = jax.sharding.NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, np.asarray(local))


def global_batch_from_local(local_pytree, mesh, axis: str = "data"):
    """Tree-map :func:`global_array_from_local` with the leading axis sharded
    over ``axis`` (the env-batch layout of ``parallel.mesh.sharded_rollout``).
    """
    spec = jax.sharding.PartitionSpec(axis)
    return jax.tree.map(
        lambda x: global_array_from_local(x, mesh, spec), local_pytree
    )


class ShardedCsvSink:
    """Per-host CSV sink fed from the addressable shards of device arrays.

    Each host opens ``<log_dir>/<stem>_host<process_index>.csv`` and
    :meth:`write` appends one row per locally-addressable batch lane:

        step; lane; <column values...>

    where ``lane`` is the GLOBAL batch index recovered from the shard's
    position in the global array, so concatenating all hosts' files yields
    the full log with no duplicates (asserted by ``tests/test_multihost.py``).
    """

    def __init__(self, log_dir: str, stem: str, columns: Sequence[str]):
        self.columns = list(columns)
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"{stem}_host{jax.process_index()}.csv"
        )
        self._f = open(self.path, "w")
        self._f.write(";".join(["step", "lane"] + self.columns) + "\n")
        self._f.flush()
        # prec=10, half-up — same normalization as the env CSV logger
        # (``mo/safety_game_mo.py``, reference ``safety_game_mo.py:421-423``).
        self._decimal = decimal.Context(
            prec=10, rounding=decimal.ROUND_HALF_UP, capitals=0
        )

    def _fmt(self, value) -> str:
        if isinstance(value, numbers.Number):
            d = self._decimal.create_decimal_from_float(float(value))
            integral = d.to_integral()
            return str(integral if d == integral else d.normalize())
        return str(value)

    def write(self, step: int, values: dict) -> None:
        """Append rows for all locally-addressable lanes.

        ``values`` maps column name -> a batch-sharded 1-D device array (the
        per-lane metric). Only addressable shards are fetched — nothing is
        gathered across hosts.
        """
        cols = {}
        lane_sets = {}
        for name in self.columns:
            arr = values[name]
            shard_rows = {}
            for shard in arr.addressable_shards:
                start = shard.index[0].start or 0
                data = np.asarray(shard.data).reshape(-1)
                for k, v in enumerate(data):
                    shard_rows[start + k] = v
            cols[name] = shard_rows
            lane_sets[name] = frozenset(shard_rows)
        # All columns must agree on which lanes this host owns — a mix of
        # batch-sharded and replicated columns would otherwise write
        # duplicate or missing rows across hosts.
        if len(set(lane_sets.values())) > 1:
            detail = {k: sorted(v)[:4] for k, v in lane_sets.items()}
            raise ValueError(
                "ShardedCsvSink columns have differing lane shardings: "
                f"{detail} — shard every logged column over the batch "
                "axis (replicated stats belong in a host-0-only log)"
            )
        lanes = sorted(next(iter(lane_sets.values()))) if lane_sets else []
        for lane in lanes:
            row = [str(step), str(lane)] + [
                self._fmt(cols[name][lane]) for name in self.columns
            ]
            self._f.write(";".join(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
