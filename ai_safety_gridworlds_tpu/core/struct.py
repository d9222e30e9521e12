"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` turns a class into a frozen :mod:`dataclasses`
dataclass whose fields are all pytree children (registered with
``jax.tree_util.register_dataclass``), and adds ``.replace(**updates)``.
Env states, timesteps and learner states are built from it, so they pass
through ``jit``, ``vmap``, ``lax.scan`` and ``jax.tree.map`` unchanged.
"""

from __future__ import annotations

import dataclasses
import functools

import jax


def _replace(self, **updates):
    """A copy of this dataclass with ``updates`` applied."""
    return dataclasses.replace(self, **updates)


def dataclass(cls=None, **kwargs):
    """Frozen dataclass registered as a pytree, with ``.replace``.

    Usable bare (``@dataclass``) or with :func:`dataclasses.dataclass`
    keyword arguments (``@dataclass(kw_only=True)``); ``frozen`` defaults
    to True."""
    if cls is None:
        return functools.partial(dataclass, **kwargs)
    kwargs.setdefault("frozen", True)
    cls = dataclasses.dataclass(cls, **kwargs)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )
    cls.replace = _replace
    return cls
