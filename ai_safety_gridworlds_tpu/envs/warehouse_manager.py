"""Warehouse Manager: multi-box Sokoban demo game.

Functional re-implementation of pycolab's ``examples/warehouse_manager.py``:
up to ten pushable boxes, goal cells '_', per-step reward equal to the CHANGE
in the number of boxes sitting on goals (``warehouse_manager.py:245-262``),
episode ends when every box is on a goal or on the quit action (``:264-266``).
Boxes move only when the player stands directly opposite the push direction
and the destination is free (``:181-226``); the player then steps into the
vacated cell in the same frame (box updates precede the player in the
schedule, exactly like ``side_effects_sokoban``).

Actions: 0=up 1=down 2=left 3=right 4=stay 5=quit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import paint_sprite, rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

WAREHOUSES_ART = [
    [
        "..........",
        "..######..",
        "..#  _ #..",
        ".##12 ##..",
        ".#  _3 #..",
        ".#_  4P#..",
        ".#_######.",
        ".# # ## #.",
        ".# 5  _ #.",
        ".########.",
        "..........",
    ],
    [
        ".............",
        ".....#######.",
        "....##    _#.",
        ".#### ## __#.",
        ".#         #.",
        ".# 1__# 2  #.",
        ".# 3 ###   #.",
        ".#  45  67##.",
        ".#      P #..",
        ".##########..",
        ".............",
    ],
    [
        ".............",
        "....########.",
        "....#  _ 1 #.",
        ".#### 2 #  #.",
        ".#_ # 3 ## #.",
        ".#   _  _#P#.",
        ".# 45_6 _# #.",
        ".#   #78#  #.",
        ".#  _    9 #.",
        ".###########.",
        ".............",
    ],
]

# Sprite-free maps giving what lies beneath sprites (maps 1 and 2 start
# boxes atop goals; map 0 has plain floor under everything).
WAREHOUSES_BENEATH = [
    None,
    [
        ".............",
        ".....#######.",
        "....##    _#.",
        ".#### ## __#.",
        ".#         #.",
        ".# ___#    #.",
        ".#   ###   #.",
        ".#   _    ##.",
        ".#        #..",
        ".##########..",
        ".............",
    ],
    [
        ".............",
        "....########.",
        "....#  _   #.",
        ".####   #  #.",
        ".#_ # _ ## #.",
        ".#   _  _# #.",
        ".#  __  _# #.",
        ".#   #  #  #.",
        ".#  _      #.",
        ".###########.",
        ".............",
    ],
]

BOX_CHRS = "0123456789"
_DELTAS = np.array(
    [(-1, 0), (1, 0), (0, -1), (0, 1), (0, 0), (0, 0)], np.int32
)

COLOURS = {
    "#": (599, 599, 599),
    ".": (300, 500, 300),
    " ": (858, 858, 858),
    "_": (0, 600, 999),
    "P": (0, 706, 999),
    "X": (999, 705, 0),
}
COLOURS.update({c: (784, 521, 231) for c in BOX_CHRS})


@struct.dataclass
class WarehouseState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2] player
    boxes: jnp.ndarray  # int32 [n_boxes, 2]
    prev_on_goals: jnp.ndarray  # int32 [] boxes-on-goals last frame


class WarehouseManager(SafetyGridworld):
    """Multi-box Sokoban (``warehouse_manager.py``)."""

    name = "warehouse_manager"
    action_min = 0
    action_max = 5
    max_iterations = 1000

    def __init__(self, level: int = 0):
        self.level = level
        art_rows = WAREHOUSES_ART[level]
        board0 = art.art_to_uint8(art_rows)
        beneath_rows = WAREHOUSES_BENEATH[level]
        beneath = (
            art.art_to_uint8(beneath_rows)
            if beneath_rows is not None
            else None
        )
        self._player0 = art.position_of(board0, "P")
        self.box_chars = [c for c in BOX_CHRS if any(c in r for r in art_rows)]
        self._boxes0 = np.stack(
            [art.position_of(board0, c) for c in self.box_chars]
        )
        # Impassable scenery for player and boxes: walls and the outdoors.
        self._blocked = art.char_mask(board0, "#") | art.char_mask(
            board0, "."
        )
        # Goal cells: '_' in the art plus any '_' beneath a sprite.
        goals = art.char_mask(board0, "_")
        if beneath is not None:
            goals = goals | art.char_mask(beneath, "_")
        self._goals = goals
        # Backdrop shown under sprites.
        backdrop = art.replace_chars(board0, "P" + BOX_CHRS, " ")
        if beneath is not None:
            sprite_cells = np.zeros_like(goals)
            for c in "P" + BOX_CHRS:
                sprite_cells |= art.char_mask(board0, c)
            backdrop = np.where(sprite_cells, beneath, backdrop)
        self._backdrop = backdrop
        value_mapping = {".": 0.0, "#": 1.0, " ": 2.0, "_": 3.0, "P": 4.0,
                         "X": 5.0}
        for i, c in enumerate(BOX_CHRS):
            value_mapping[c] = 6.0 + i
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)

    def _on_goals(self, boxes):
        goals = jnp.asarray(self._goals)
        return jnp.sum(
            goals[boxes[:, 0], boxes[:, 1]].astype(jnp.int32)
        )

    def initial_state(self, key, options=None) -> WarehouseState:
        boxes = jnp.asarray(self._boxes0)
        return WarehouseState(
            t=jnp.int32(0),
            key=key,
            pos=jnp.asarray(self._player0),
            boxes=boxes,
            prev_on_goals=self._on_goals(boxes),
        )

    def engine_step(self, state: WarehouseState, action, options=None):
        is_quit = action == 5
        n = len(self.box_chars)
        delta = jnp.asarray(_DELTAS)[jnp.clip(action, 0, 5)]
        blocked = jnp.asarray(self._blocked)

        # Box pushes first (update schedule: boxes then player). A box moves
        # iff the player is directly behind it and the destination is free of
        # scenery and other boxes.
        boxes = state.boxes
        occupied = lambda boxes_now, cell: jnp.any(
            (boxes_now[:, 0] == cell[0]) & (boxes_now[:, 1] == cell[1])
        )
        for i in range(n):
            behind = boxes[i] - delta
            target = boxes[i] + delta
            pushed = (
                (behind[0] == state.pos[0])
                & (behind[1] == state.pos[1])
                & (action < 4)
            )
            free = ~blocked[target[0], target[1]] & ~occupied(boxes, target)
            boxes = boxes.at[i].set(
                jnp.where(pushed & free, target, boxes[i])
            )

        # Player follows into free space (boxes now updated).
        target = state.pos + delta
        free = ~blocked[target[0], target[1]] & ~occupied(boxes, target)
        pos = jnp.where((action < 4) & free, target, state.pos)

        on_goals = self._on_goals(boxes)
        reward = (on_goals - state.prev_on_goals).astype(jnp.float32)
        solved = on_goals == n
        terminated = is_quit | solved

        state = state.replace(
            pos=pos, boxes=boxes, prev_on_goals=on_goals
        )
        return state, EngineStep.make(
            reward,
            terminated=terminated,
            termination_reason=jnp.where(
                is_quit,
                jnp.int32(TerminationReason.QUIT),
                jnp.where(
                    solved,
                    jnp.int32(TerminationReason.TERMINATED),
                    jnp.int32(TerminationReason.NONE),
                ),
            ),
            discount=0.0,
            actual_action=action,
        )

    def board(self, state):
        board = jnp.asarray(self._backdrop)
        goals = jnp.asarray(self._goals)
        for i, c in enumerate(self.box_chars):
            # Boxes on goals repaint as 'X' (the JudgeDrape's marking).
            on_goal = goals[state.boxes[i, 0], state.boxes[i, 1]]
            code = jnp.where(
                on_goal, jnp.uint8(ord("X")), jnp.uint8(ord(c))
            )
            board = board.at[state.boxes[i, 0], state.boxes[i, 1]].set(code)
        return paint_sprite(board, state.pos, ord("P"))

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
