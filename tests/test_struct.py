"""``core.struct.dataclass``: frozen dataclasses that are JAX pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_safety_gridworlds_tpu.core import struct


@struct.dataclass
class _State:
    pos: jnp.ndarray
    t: jnp.ndarray
    label: int = 3


def _state():
    return _State(pos=jnp.arange(4), t=jnp.int32(2))


def test_pytree_round_trip():
    s = _state()
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert len(leaves) == 3
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _State)
    np.testing.assert_array_equal(back.pos, s.pos)
    assert int(back.t) == 2 and back.label == 3
    doubled = jax.tree.map(lambda x: x * 2, s)
    np.testing.assert_array_equal(doubled.pos, 2 * np.arange(4))
    assert doubled.label == 6


def test_replace_returns_new_and_is_frozen():
    s = _state()
    s2 = s.replace(t=jnp.int32(5))
    assert int(s2.t) == 5 and int(s.t) == 2
    np.testing.assert_array_equal(s2.pos, s.pos)
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.t = jnp.int32(1)
    with pytest.raises(TypeError):
        s.replace(missing=1)


def test_jit_vmap_and_scan():
    s = _state()
    out = jax.jit(lambda s: s.replace(pos=s.pos + s.t))(s)
    assert isinstance(out, _State)
    np.testing.assert_array_equal(out.pos, np.arange(4) + 2)
    batched = jax.vmap(lambda p: _State(pos=p, t=jnp.int32(0)))(
        jnp.ones((5, 4))
    )
    assert batched.pos.shape == (5, 4) and batched.t.shape == (5,)
    final, _ = jax.lax.scan(
        lambda c, _: (c.replace(t=c.t + 1), None), s, None, length=3
    )
    assert int(final.t) == 5


def test_keyword_arguments_pass_through():
    @struct.dataclass(kw_only=True)
    class _Kw:
        a: int = 1
        b: int = 2

    k = _Kw(b=4)
    assert (k.a, k.b) == (1, 4)
    with pytest.raises(TypeError):
        _Kw(1, 2)
    assert jax.tree.leaves(k) == [1, 4]
