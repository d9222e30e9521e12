"""Counter-based PRF for the fused packed steps.

The fused packed steps (``ops/fused_*.py``) need a random-bits primitive
that

* is cheap (~a dozen integer ops per word — JAX's threefry is ~120),
* is plain ``jnp`` integer arithmetic, bit-identical wherever it runs
  (the per-env chain can recompute a fused step's draws exactly), and
* is counter-based: ``bits = f(key, counter, index)`` with no sequential
  state, so draws parallelize over cells and batch lanes.

The construction is two chained murmur3 finalizers (fmix32) over the
counter/index mixed with the 64-bit key — a standard GPU-style stateless
hash. It is NOT cryptographic; it only needs to pass the distributional
checks used for env randomness (see ``tests/test_prng.py``).

The reference consumes ``numpy.random.Generator`` draws
(``firemaker_ex_ma.py:615-621``); the batched device path is only
distributionally faithful (PARITY.md), which this hash satisfies.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_M1 = np.uint32(0x85EB_CA6B)
_M2 = np.uint32(0xC2B2_AE35)
_C1 = np.uint32(0x9E37_79B9)  # golden-ratio increment
_C2 = np.uint32(0x7FEB_352D)


def fmix32(h):
    """murmur3 32-bit finalizer (avalanche mixer) on uint32 arrays."""
    h = h ^ (h >> np.uint32(16))
    h = h * _M1
    h = h ^ (h >> np.uint32(13))
    h = h * _M2
    h = h ^ (h >> np.uint32(16))
    return h


def hash_u32(key_hi, key_lo, ctr, idx):
    """Random uint32 word ``f(key, ctr, idx)``.

    Args:
      key_hi/key_lo: uint32 arrays (broadcastable), the per-stream key.
      ctr: uint32 array, the draw-site counter (unique per step/site).
      idx: uint32 array, the within-site index (e.g. board cell).

    All arguments broadcast; the result has the broadcast shape.
    """
    h = (
        jnp.asarray(ctr, jnp.uint32) * _C1
        ^ jnp.asarray(idx, jnp.uint32) * _C2
    )
    h = fmix32(h ^ jnp.asarray(key_lo, jnp.uint32))
    h = fmix32(h ^ jnp.asarray(key_hi, jnp.uint32))
    return h


def uniform01(bits):
    """[0, 1) float32 from uint32 bits (24-bit mantissa resolution).

    The top 24 bits fit in an int32, so the conversion goes through int32 —
    Mosaic has no direct uint32→float32 cast."""
    top = (bits >> np.uint32(8)).astype(jnp.int32)
    return top.astype(jnp.float32) * np.float32(1.0 / 16777216.0)


def uniform(key_hi, key_lo, ctr, idx):
    return uniform01(hash_u32(key_hi, key_lo, ctr, idx))


def derive_keys(seed: int, batch: int) -> np.ndarray:
    """Per-environment (hi, lo) key pairs for a batch, derived on host.

    Returns uint32 [2, batch].
    """
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, 2**32, size=(2, batch), dtype=np.uint32)
