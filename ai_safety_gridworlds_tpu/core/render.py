"""Board rendering as pure array ops.

Replaces the reference's per-entity repaint loop
(``pycolab/engine.py:737-759`` + ``pycolab/rendering.py:69-303``) with a
static-z-order sequence of ``jnp.where`` paints that XLA fuses into a single
elementwise pass over the (tiny) board. Layer extraction mirrors both
renderer flavours:

* occluded (``BaseObservationRenderer``, ``rendering.py:178-180``):
  ``layers[c] = board == ord(c)``;
* unoccluded (``BaseUnoccludedObservationRenderer``, ``rendering.py:188``):
  each entity's layer shows its own mask regardless of what covers it, while
  ``board`` remains the occluded paint.
"""

from __future__ import annotations

import jax.numpy as jnp


def paint_sprite(board, pos, char_code, visible=True):
    """Paint a single-cell sprite onto ``board`` at ``pos``.

    ``visible`` may be a traced bool; an invisible sprite paints nothing
    (reference: ``engine.py:753-755`` checks ``entity.visible``).
    """
    h, w = board.shape
    rows = jnp.arange(h, dtype=jnp.int32)[:, None]
    cols = jnp.arange(w, dtype=jnp.int32)[None, :]
    mask = (rows == pos[0]) & (cols == pos[1]) & visible
    return jnp.where(mask, jnp.uint8(char_code), board)


def paint_drape(board, curtain, char_code):
    """Paint a drape (bool mask) onto ``board``."""
    return jnp.where(curtain, jnp.uint8(char_code), board)


def render(backdrop, paints):
    """Render a board from a backdrop and a z-ordered list of paints.

    Args:
      backdrop: uint8 [H, W] backdrop char codes (static or traced).
      paints: iterable of ("sprite", pos, char_code, visible) or
        ("drape", curtain, char_code) tuples in back-to-front z-order.

    Returns:
      uint8 [H, W] occluded board.
    """
    board = backdrop
    for paint in paints:
        kind = paint[0]
        if kind == "sprite":
            _, pos, char_code, visible = paint
            board = paint_sprite(board, pos, char_code, visible)
        elif kind == "drape":
            _, curtain, char_code = paint
            board = paint_drape(board, curtain, char_code)
        else:
            raise ValueError(f"Unknown paint kind {kind!r}")
    return board


def occluded_layers(board, char_codes):
    """dict char_code -> bool [H, W] with occlusion, from a rendered board."""
    return {c: board == jnp.uint8(c) for c in char_codes}


def value_map(board, value_lut):
    """Apply a [256] value LUT to a uint8 board (observation 'board' channel)."""
    return value_lut[board.astype(jnp.int32)]


def rgb_map(board, rgb_lut):
    """Apply a [256, 3] uint8 LUT; returns [3, H, W] to match the reference
    layout (``rendering.ObservationToArray`` puts the value dimension first,
    ``rendering.py:410-475``)."""
    return jnp.transpose(rgb_lut[board.astype(jnp.int32)], (2, 0, 1))


def char_repainter_lut(character_mapping: dict):
    """256-entry uint8 LUT mapping board chars to replacement chars
    (``pycolab/rendering.py:305-…`` ``ObservationCharacterRepainter``).
    Characters not in the mapping pass through unchanged."""
    import numpy as np

    lut = np.arange(256, dtype=np.uint8)
    for src, dst in character_mapping.items():
        lut[ord(src)] = ord(dst)
    return lut


def repaint(board, repainter_lut):
    """Apply a :func:`char_repainter_lut` to a uint8 char board. Also merges
    the layers implied by the new alphabet when given a layers dict via
    :func:`repaint_layers`."""
    return jnp.asarray(repainter_lut)[board.astype(jnp.int32)]


def feature_array(layers: dict, chars, shape=None, permute=None):
    """Stack binary layer masks into a float32 ``[depth, H, W]`` feature array.

    Functional equivalent of the reference's ``ObservationToFeatureArray``
    (``pycolab/rendering.py:552-608``): one ``jnp.stack`` + optional
    ``transpose`` instead of the reference's lazily-reused numpy buffer —
    under jit both fuse into a single pass, and the output is a fresh
    functional value (no read-only aliasing caveat).

    Args:
      layers: dict mapping single-char strings (or char codes) to bool
        ``[H, W]`` masks.
      chars: iterable of characters selecting and ordering the feature
        planes. A character missing from ``layers`` yields an all-zero
        plane (reference zero-fill semantics).
      shape: ``(H, W)`` for the zero-fill planes; required only if *every*
        requested char could be missing — otherwise inferred from the first
        present layer.
      permute: optional permutation of ``(0, 1, 2)`` applied to the
        (feature, row, col) axes; ``(1, 2, 0)`` is the convnet-friendly
        HWC layout.

    Raises:
      ValueError: ``permute`` is not a permutation of ``(0, 1, 2)``.
      RuntimeError: none of ``chars`` is present in ``layers`` (mirrors
        the reference's misconfiguration guard, ``rendering.py:640-647``).
    """
    chars = list(chars)  # may be a one-shot iterable; we scan it thrice
    if permute is not None and sorted(permute) != [0, 1, 2]:
        raise ValueError(
            "permute must be a list or tuple containing some permutation "
            "of the integers 0, 1, and 2."
        )
    if not any(c in layers for c in chars):
        raise RuntimeError(
            "The requested feature chars {!r} have no entry present in the "
            "observation layers {!r}.".format(
                "".join(str(c) for c in chars),
                sorted(layers),
            )
        )
    if shape is None:
        shape = next(
            jnp.shape(layers[c]) for c in chars if c in layers
        )
    zero = jnp.zeros(shape, jnp.float32)
    planes = [
        layers[c].astype(jnp.float32) if c in layers else zero
        for c in chars
    ]
    result = jnp.stack(planes, axis=0)
    if permute is not None:
        result = jnp.transpose(result, tuple(permute))
    return result


class ObservationToFeatureArray:
    """Callable mirroring the reference's ``ObservationToFeatureArray``
    (``pycolab/rendering.py:552-660``): fix the layer ordering and optional
    permute once, then convert observations (dicts carrying a ``"layers"``
    entry, or bare char->mask layer dicts) to float32 feature stacks."""

    def __init__(self, layers, permute=None):
        if permute is not None and sorted(permute) != [0, 1, 2]:
            raise ValueError(
                "The permute argument to the ObservationToFeatureArray "
                "constructor must be a list or tuple containing some "
                "permutation of the integers 0, 1, and 2."
            )
        self._layers = layers
        self._permute = tuple(permute) if permute is not None else None

    def __call__(self, observation):
        layer_dict = (
            observation["layers"]
            if isinstance(observation, dict) and "layers" in observation
            else getattr(observation, "layers", observation)
        )
        return feature_array(
            layer_dict, self._layers, permute=self._permute
        )


def repaint_layers(layers: dict, character_mapping: dict) -> dict:
    """Merge per-character layer masks under a repaint mapping: layers whose
    chars map to the same output char are OR-ed (mapping need not be
    one-to-one, ``rendering.py:313``)."""
    out = {}
    for char, layer in layers.items():
        target = character_mapping.get(char, char)
        if target in out:
            out[target] = out[target] | layer
        else:
            out[target] = layer
    return out
