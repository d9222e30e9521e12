"""Fluvial Natation: swim against the current to the right bank.

Functional re-implementation of pycolab's ``examples/fluvial_natation.py``:
an unconfined MazeWalker swims left/right; the river current pushes one cell
west on even frames (``fluvial_natation.py:85-95``) while the river backdrop
rows roll west for the flowing-water effect (``fluvial_natation.py:112-115``).
Escaping past the right edge pays +1, past the left edge −1; both end the
episode via the walker's off-board VIRTUAL position
(``fluvial_natation.py:97-103``; ``core/movement.py`` virtual semantics).

Actions: 0=swim left 1=swim right 2=float.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.movement import is_on_board
from ai_safety_gridworlds_tpu.core.render import paint_sprite, rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

GAME_ART = [
    "===================================================",
    "     .      :   ,     `     ~          ,    .    ` ",
    "   ,    ~   P     :     .  `    ,    ,    ~    `   ",
    "     `   .     ~~   ,     .   :     .   `     `   ~",
    "===================================================",
]

COLOURS_FG = {
    "P": (0, 999, 0),
    "=": (576, 255, 0),
    " ": (0, 505, 999),
    ".": (999, 999, 999),
    ",": (999, 999, 999),
    "`": (999, 999, 999),
    ":": (999, 999, 999),
    "~": (999, 999, 999),
}


@struct.dataclass
class FluvialNatationState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2] VIRTUAL position (col may leave the board)
    river_shift: jnp.ndarray  # int32 [] accumulated westward backdrop roll


class FluvialNatation(SafetyGridworld):
    """The swimming-the-river demo (``fluvial_natation.py``)."""

    name = "fluvial_natation"
    action_min = 0
    action_max = 2
    max_iterations = 1000

    def __init__(self):
        board0 = art.art_to_uint8(GAME_ART)
        self.h, self.w = board0.shape
        self._pos0 = art.position_of(board0, "P")
        self._backdrop = art.replace_chars(board0, "P", " ")
        value_mapping = {c: float(i) for i, c in enumerate(" =.,`:~P")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS_FG)

    def initial_state(self, key, options=None) -> FluvialNatationState:
        # ``its_showtime`` runs one update sweep at frame 0 (an even frame):
        # the current pushes the swimmer west once and the river rolls once
        # before the first observation (verified against the reference).
        return FluvialNatationState(
            t=jnp.int32(0),
            key=key,
            pos=jnp.asarray(self._pos0) + jnp.asarray([0, -1]),
            river_shift=jnp.int32(1),
        )

    def engine_step(self, state: FluvialNatationState, action, options=None):
        # The walker is unconfined with an empty impassable set
        # (``fluvial_natation.py:80-83``), so motion is pure arithmetic on
        # the virtual column.
        even = (state.t % 2) == 0
        dcol = (
            jnp.where(even, -1, 0)  # the current
            + jnp.where(action == 0, -1, jnp.where(action == 1, 1, 0))
        )
        pos = state.pos + jnp.stack([jnp.int32(0), dcol])
        river_shift = state.river_shift + jnp.where(even, 1, 0)

        lost = pos[1] < 0
        won = pos[1] >= self.w
        reward = jnp.where(won, 1.0, jnp.where(lost, -1.0, 0.0))
        state = state.replace(pos=pos, river_shift=river_shift)
        return state, EngineStep.make(
            reward=reward,
            terminated=won | lost,
            termination_reason=jnp.int32(TerminationReason.TERMINATED),
            discount=jnp.float32(0.0),
        )

    def board(self, state: FluvialNatationState):
        board = jnp.asarray(self._backdrop)
        # River rows 1..3 roll west per even frame.
        shift = state.river_shift % self.w
        rolled = jnp.roll(board[1:4], -shift, axis=1)
        board = board.at[1:4].set(rolled)
        visible = is_on_board(state.pos, (self.h, self.w))
        painted = paint_sprite(board, state.pos, ord("P"))
        return jnp.where(visible, painted, board)

    def observe(self, state: FluvialNatationState) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
