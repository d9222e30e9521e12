"""Functional scrolling-world machinery (the Scrolly-drape substrate).

The reference's egocentric scrolling stack — ``Scrolly`` drapes holding a
huge ``whole_pattern`` with a board-sized window
(``pycolab/prefab_parts/drapes.py:30-695``), plus the plot-mediated
scrolling protocol (``pycolab/protocols/scrolling.py:287-532``) — keeps its
pattern static on the device and addresses board windows by an integer ORIGIN:

* Scrolling moves the origin; egocentric walkers' screen positions stay
  fixed while the window slides.
* "Teleportation" pattern rolls (``t_maze.py``'s
  ``PseudoTeleportingScrolly``: ``np.roll(whole_pattern, -shift)``) become
  ``origin += shift`` with wraparound — the pattern never moves, windows
  are read modulo the pattern shape via a 2x-tiled pattern and one
  ``dynamic_slice``.

The protocol itself (per-frame permission masks, order issuing/obedience,
corner clamping) is game logic and lives in the env step functions (see
``envs/t_maze.py``); this module provides the shape-static, jit/vmap-safe
pattern-window reads they build on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class ScrollingWorld:
    """A static whole-pattern with a board-sized window addressed by origin.

    Args:
      pattern_masks: dict char -> bool [Hp, Wp] whole-pattern masks
        (``Scrolly.PatternInfo.kwargs``, ``prefab_drapes.py:30-…``).
      board_shape: (h, w) of the game board (the window).
    """

    def __init__(self, pattern_masks: dict, board_shape):
        self.h, self.w = board_shape
        first = next(iter(pattern_masks.values()))
        self.hp, self.wp = first.shape
        # 2x2 tiling makes every wrapped window a contiguous dynamic_slice.
        self._tiled = {
            c: jnp.asarray(np.tile(np.asarray(m, bool), (2, 2)))
            for c, m in pattern_masks.items()
        }

    def wrap(self, origin):
        """Origin modulo the pattern shape."""
        o = jnp.asarray(origin, jnp.int32)
        return jnp.stack([o[0] % self.hp, o[1] % self.wp])

    def window(self, char, origin):
        """The board-sized window of ``char``'s pattern at ``origin``
        (wraparound = the reference's accumulated ``np.roll``)."""
        o = self.wrap(origin)
        return jax.lax.dynamic_slice(
            self._tiled[char], (o[0], o[1]), (self.h, self.w)
        )

    def window_dynamic(self, pattern, origin):
        """Window into a per-episode (state-carried) pattern [Hp, Wp]."""
        o = self.wrap(origin)
        tiled = jnp.tile(pattern, (2, 2))
        return jax.lax.dynamic_slice(tiled, (o[0], o[1]), (self.h, self.w))

    def at(self, char, pattern_pos):
        """Gather one pattern cell (mod coordinates)."""
        p = jnp.asarray(pattern_pos, jnp.int32)
        return self._tiled[char][p[0] % self.hp, p[1] % self.wp]

def pattern_info(art_rows, board_art_rows, corner_mark="+"):
    """Extract (pattern chars -> masks, NW corner) from whole-world ASCII art
    (the ``Scrolly.PatternInfo`` helper, ``prefab_drapes.py``).

    Returns (masks dict for every non-blank char except the corner mark and
    sprite chars the caller strips beforehand, corner (row, col)).
    """
    arr = np.array([list(r) for r in art_rows])
    corner = tuple(np.argwhere(arr == corner_mark)[0])
    chars = sorted(set(arr.ravel()) - {" ", corner_mark})
    masks = {c: arr == c for c in chars}
    return masks, corner
