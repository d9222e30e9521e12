"""Classic tabular-RL demo games: four-rooms, cliff-walk, chain-walk.

JAX re-implementations of pycolab's engine demo games
(``pycolab/examples/classics/four_rooms.py``, ``cliff_walk.py``,
``chain_walk.py``). They exercise the functional engine substrate (movement,
edge clamping, reward/termination directives) without any safety-suite
machinery — the same role the originals play for pycolab.

Native action ordering is preserved per game (the classics predate the
safety suites' enums): four_rooms/cliff_walk use 0=up 1=down 2=left 3=right
(4 = ignored no-op in cliff_walk); chain_walk uses 0=left 1=right.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.movement import attempt_move_masked
from ai_safety_gridworlds_tpu.core.render import paint_sprite, rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

# 0=up 1=down 2=left 3=right (``four_rooms.py:68-75``).
_CLASSIC_DELTAS = np.array(
    [(-1, 0), (1, 0), (0, -1), (0, 1), (0, 0)], np.int32
)

FOUR_ROOMS_ART = [
    "#############",
    "#     #     #",
    "#     #     #",
    "#     #     #",
    "#           #",
    "#     #     #",
    "#### ###### #",
    "#     #     #",
    "#     #     #",
    "#           #",
    "#     #     #",
    "# P   #     #",
    "#############",
]

CLIFF_WALK_ART = [
    "............",
    "............",
    "............",
    "P...........",
]

CHAIN_WALK_ART = ["..P..................."]

GAME_BG_COLOURS = {
    "#": (599, 599, 599),
    " ": (858, 858, 858),
    ".": (858, 858, 858),
    "P": (0, 706, 999),
}


@struct.dataclass
class ClassicState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2]


class _ClassicBase(SafetyGridworld):
    """Shared machinery for the classic demo games."""

    art_rows: list = []
    what_lies_beneath = " "
    action_min = 0
    action_max = 3

    def __init__(self, max_iterations: int = 1000):
        self.max_iterations = max_iterations
        board0 = art.art_to_uint8(self.art_rows)
        self._start_pos = art.position_of(board0, "P")
        self._backdrop = art.replace_chars(
            board0, "P", self.what_lies_beneath
        )
        self._wall_mask = art.char_mask(board0, "#")
        value_mapping = {"#": 0.0, " ": 1.0, ".": 1.0, "P": 2.0}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(GAME_BG_COLOURS)

    def initial_state(self, key, options=None) -> ClassicState:
        return ClassicState(
            t=jnp.int32(0), key=key, pos=jnp.asarray(self._start_pos)
        )

    def _move(self, state, action):
        delta = jnp.asarray(_CLASSIC_DELTAS)[jnp.clip(action, 0, 4)]
        new_pos, _ = attempt_move_masked(
            state.pos, delta, jnp.asarray(self._wall_mask)
        )
        return new_pos

    def board(self, state):
        board = jnp.asarray(self._backdrop)
        return paint_sprite(board, state.pos, ord("P"))

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }

    def _finish(self, state, new_pos, reward, terminated):
        state = state.replace(pos=new_pos)
        return state, EngineStep.make(
            jnp.asarray(reward, jnp.float32),
            terminated=terminated,
            termination_reason=jnp.where(
                terminated,
                jnp.int32(TerminationReason.TERMINATED),
                jnp.int32(TerminationReason.NONE),
            ),
            discount=0.0,
            actual_action=jnp.int32(-1),
        )


class FourRooms(_ClassicBase):
    """Four-rooms: +1 and terminate on the mystery spot (4, 3)
    (``four_rooms.py:77-80``)."""

    name = "four_rooms"
    art_rows = FOUR_ROOMS_ART

    def engine_step(self, state, action, options=None):
        new_pos = self._move(state, action)
        found = (new_pos[0] == 4) & (new_pos[1] == 3)
        return self._finish(
            state, new_pos, jnp.where(found, 1.0, 0.0), found
        )


class CliffWalk(_ClassicBase):
    """Cliff-walk: −1 per move, −100 falling off the cliff, episode ends on
    the bottom row right of start (``cliff_walk.py:70-83``)."""

    name = "cliff_walk"
    art_rows = CLIFF_WALK_ART
    what_lies_beneath = "."

    def engine_step(self, state, action, options=None):
        is_move = action < 4  # other actions ignored entirely
        new_pos = jnp.where(is_move, self._move(state, action), state.pos)
        h = len(self.art_rows)
        w = len(self.art_rows[0])
        on_bottom = new_pos[0] == h - 1
        on_cliff = on_bottom & (new_pos[1] > 0) & (new_pos[1] < w - 2)
        reward = jnp.where(
            is_move, jnp.where(on_cliff, -100.0, -1.0), 0.0
        )
        terminated = is_move & on_bottom & (new_pos[1] > 0)
        return self._finish(state, new_pos, reward, terminated)


class ChainWalk(_ClassicBase):
    """Chain-walk: 0=left 1=right; +1 at the left end, +100 at the right end
    (``chain_walk.py:56-67``)."""

    name = "chain_walk"
    art_rows = CHAIN_WALK_ART
    what_lies_beneath = "."
    action_max = 1

    def engine_step(self, state, action, options=None):
        delta = jnp.where(
            action == 0,
            jnp.asarray((0, -1), jnp.int32),
            jnp.where(
                action == 1,
                jnp.asarray((0, 1), jnp.int32),
                jnp.zeros((2,), jnp.int32),
            ),
        )
        new_pos, _ = attempt_move_masked(
            state.pos, delta, jnp.asarray(self._wall_mask)
        )
        w = len(self.art_rows[0])
        at_left = new_pos[1] == 0
        at_right = new_pos[1] == w - 1
        reward = jnp.where(at_left, 1.0, jnp.where(at_right, 100.0, 0.0))
        return self._finish(state, new_pos, reward, at_left | at_right)
