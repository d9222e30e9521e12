"""Checkpoint / resume for training state and environment batches.

The reference has no training checkpoints (SURVEY §5: "no learner
in-repo"); its persistence surface is (a) env pickleability for process
cloning (``safety_game_mo.py:406-419``), (b) friend_foe's
``--environment_data_file`` bandit statistics, and (c) the deterministic
``(seed, env_layout_seed, episode_no)`` seed scheme that makes any trial
re-derivable.  In this rebuild every piece of run state — network
params, optimizer state, the auto-resetting ``EpisodeState`` batch, and
the PRNG key — is a JAX pytree, so checkpointing is a single orbax
save/restore and resume is bit-deterministic (asserted by
``tests/test_ppo_checkpoint.py``).

Multi-host: orbax natively persists sharded ``jax.Array``s (each host
writes its addressable shards), so the same two calls work unchanged on a
``parallel.multihost`` mesh.
"""

from __future__ import annotations

import os
from typing import Any

import jax


def _ocp():
    import orbax.checkpoint as ocp

    return ocp


def save_pytree(path: str, pytree: Any) -> None:
    """Write ``pytree`` (params / opt state / EpisodeState batch / keys)
    to ``path`` (created; must not already hold a checkpoint)."""
    ocp = _ocp()
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), pytree)


def _abstract_leaf(x):
    """Template leaf -> ShapeDtypeStruct, KEEPING a concrete jax.Array's
    sharding so multi-device states restore onto their original mesh
    placement instead of the default device."""
    if isinstance(x, jax.ShapeDtypeStruct):
        return x
    return jax.ShapeDtypeStruct(
        jax.numpy.shape(x),
        jax.numpy.result_type(x),
        sharding=getattr(x, "sharding", None),
    )


def restore_pytree(path: str, template: Any) -> Any:
    """Restore a pytree written by :func:`save_pytree`.

    ``template`` supplies structure/shape/dtype/sharding — pass either a
    matching concrete pytree or one of ``jax.eval_shape`` abstract leaves.
    """
    ocp = _ocp()
    template = jax.tree.map(_abstract_leaf, template)
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(path), template)


class CheckpointManager:
    """Stepped checkpoint directory with retention + resume.

    A thin wrapper over ``orbax.checkpoint.CheckpointManager`` that keeps
    the call sites free of orbax types::

        mgr = CheckpointManager(dir, max_to_keep=3, save_interval_steps=10)
        mgr.save(step, train_state)           # no-op off the interval
        step = mgr.latest_step()              # None if empty
        state = mgr.restore(step, template)   # bit-exact resume
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
    ):
        ocp = _ocp()
        self._mgr = ocp.CheckpointManager(
            os.path.abspath(directory),
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps,
                enable_async_checkpointing=False,  # deterministic tests
            ),
        )

    def save(self, step: int, pytree: Any) -> bool:
        ocp = _ocp()
        return self._mgr.save(
            step, args=ocp.args.StandardSave(pytree)
        )

    def latest_step(self):
        return self._mgr.latest_step()

    def restore(self, step: int, template: Any) -> Any:
        ocp = _ocp()
        template = jax.tree.map(_abstract_leaf, template)
        return self._mgr.restore(
            step, args=ocp.args.StandardRestore(template)
        )

    def close(self):
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
