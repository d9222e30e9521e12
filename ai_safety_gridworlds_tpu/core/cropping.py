"""Observation croppers: fixed and scrolling windows over char boards.

JAX re-implementation of pycolab's observation post-processors
(``pycolab/cropping.py:30-598``): croppers take a rendered uint8 char board
and return a fixed-size window. ``FixedCropper`` cuts a static region
(``cropping.py:230-268``); ``ScrollingCropper`` pans the window to keep a
tracked entity in view with scroll margins and optional saccades
(``cropping.py:271-…``).

Unlike pycolab's engine-coupled croppers, these are pure functions of
(board, tracked-position, previous window corner): the scrolling state is an
explicit ``(row, col)`` carry, so the croppers compose with ``vmap``/``scan``
on device. ``jnp``-based fast paths use static window shapes and
``lax.dynamic_slice``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax


class ObservationCropper:
    """Base cropper: pass the observation through unchanged
    (``cropping.py:30-107``)."""

    def crop(self, board, **kwargs):
        return board

    @property
    def rows(self):
        return None

    @property
    def cols(self):
        return None


def _pad_and_slice(board, top, left, rows, cols, pad_value):
    """Extract ``board[top:top+rows, left:left+cols]`` padding out-of-bounds
    cells with ``pad_value`` (device-friendly: static shapes only)."""
    board = jnp.asarray(board)
    h, w = board.shape
    padded = jnp.pad(
        board,
        ((rows, rows), (cols, cols)),
        constant_values=board.dtype.type(pad_value),
    )
    return lax.dynamic_slice(
        padded,
        (jnp.asarray(top) + rows, jnp.asarray(left) + cols),
        (rows, cols),
    )


class FixedCropper(ObservationCropper):
    """Static window at ``top_left_corner`` of size ``rows x cols``
    (``cropping.py:230-268``). Without ``pad_char`` the window must lie
    entirely on the board."""

    def __init__(
        self,
        top_left_corner: Tuple[int, int],
        rows: int,
        cols: int,
        pad_char: Optional[str] = None,
    ):
        self._top_left = tuple(top_left_corner)
        self._rows = int(rows)
        self._cols = int(cols)
        self._pad = None if pad_char is None else ord(pad_char)

    @property
    def rows(self):
        return self._rows

    @property
    def cols(self):
        return self._cols

    def crop(self, board, **kwargs):
        board = jnp.asarray(board)
        h, w = board.shape
        top, left = self._top_left
        if self._pad is None:
            if (
                top < 0
                or left < 0
                or top + self._rows > h
                or left + self._cols > w
            ):
                raise ValueError(
                    "FixedCropper window exceeds the board and no pad_char "
                    "was given"
                )
            return board[top : top + self._rows, left : left + self._cols]
        # Static corner -> exact overlap arithmetic (the shared
        # _pad_and_slice pads by (rows, cols) only, so a window lying
        # further outside the board than its own size would silently
        # clamp onto board content).
        out = jnp.full(
            (self._rows, self._cols), board.dtype.type(self._pad),
            board.dtype,
        )
        t0, l0 = max(top, 0), max(left, 0)
        t1 = min(top + self._rows, int(h))
        l1 = min(left + self._cols, int(w))
        if t1 <= t0 or l1 <= l0:
            return out  # window fully off the board: all padding
        return out.at[t0 - top : t1 - top, l0 - left : l1 - left].set(
            board[t0:t1, l0:l1]
        )


class ScrollingCropper(ObservationCropper):
    """Egocentric window tracking an entity (``cropping.py:271-…``).

    The pycolab version reads tracked sprites from a live Engine; here the
    caller passes the tracked position explicitly and threads the window
    corner through as functional state:

        corner = cropper.initial_corner(position, board_shape)
        window, corner = cropper.crop(board, position=pos, corner=corner)

    Margins semantics match upstream: the window scrolls just enough to keep
    the entity ``scroll_margins`` away from the edge; ``None`` margins centre
    the entity (window dim must be odd); with ``saccade`` the window jumps to
    centre when the entity is more than one step out of bounds.
    """

    def __init__(
        self,
        rows: int,
        cols: int,
        pad_char: Optional[str] = None,
        scroll_margins: Tuple[Optional[int], Optional[int]] = (2, 3),
        saccade: bool = True,
        initial_offset: Optional[Tuple[int, int]] = None,
    ):
        self._rows = int(rows)
        self._cols = int(cols)
        # Upstream ``initial_offset``: the first window is shifted so the
        # tracked entity sits this far from the centre
        # (``cropping.py:271-…``; used by better_scrolly_maze).
        self._initial_offset = initial_offset
        self._pad = None if pad_char is None else ord(pad_char)
        mr, mc = scroll_margins
        if mr is None and rows % 2 == 0:
            raise ValueError("centred tracking requires odd rows")
        if mc is None and cols % 2 == 0:
            raise ValueError("centred tracking requires odd cols")
        self._margin_r = rows // 2 if mr is None else int(mr)
        self._margin_c = cols // 2 if mc is None else int(mc)
        if 2 * self._margin_r >= rows and mr is not None:
            raise ValueError("row scroll margins overlap")
        if 2 * self._margin_c >= cols and mc is not None:
            raise ValueError("column scroll margins overlap")
        self._saccade = saccade

    @property
    def rows(self):
        return self._rows

    @property
    def cols(self):
        return self._cols

    def initial_corner(self, position, board_shape):
        """Centre the window on the tracked position, shifted by the
        optional ``initial_offset``."""
        dr, dc = self._initial_offset or (0, 0)
        top = int(position[0]) - self._rows // 2 + dr
        left = int(position[1]) - self._cols // 2 + dc
        return self._clamp(top, left, board_shape)

    def _clamp(self, top, left, board_shape):
        if self._pad is None:
            h, w = board_shape
            top = np.clip(top, 0, max(0, h - self._rows))
            left = np.clip(left, 0, max(0, w - self._cols))
        return (int(top), int(left))

    def _scroll_axis(self, pos, corner, size, margin, board_dim):
        lo = corner + margin
        hi = corner + size - 1 - margin
        if pos < lo:
            shift = pos - lo
        elif pos > hi:
            shift = pos - hi
        else:
            shift = 0
        if abs(shift) > 1 and self._saccade:
            # Jump so the entity is centred (``cropping.py`` saccade rule).
            return pos - size // 2
        elif abs(shift) > 1 and not self._saccade:
            return corner  # wait for the entity to wander back in bounds
        return corner + shift

    def crop(self, board, position=None, corner=None, **kwargs):
        board = np.asarray(board)
        if position is None:
            raise ValueError("ScrollingCropper.crop needs position=")
        if corner is None:
            corner = self.initial_corner(position, board.shape)
        top = self._scroll_axis(
            int(position[0]), corner[0], self._rows, self._margin_r,
            board.shape[0],
        )
        left = self._scroll_axis(
            int(position[1]), corner[1], self._cols, self._margin_c,
            board.shape[1],
        )
        top, left = self._clamp(top, left, board.shape)
        pad = self._pad if self._pad is not None else 0
        window = np.asarray(
            _pad_and_slice(board, top, left, self._rows, self._cols, pad)
        )
        return window, (top, left)
