"""Better Scrolly Maze: explore a big maze through cropped views.

Functional re-implementation of pycolab's ``examples/better_scrolly_maze.py``:
the engine renders the WHOLE maze; "scrolling" is pure observation cropping
(the design the reference recommends over the Scrolly drapes). Patrollers
wander horizontally every other frame, reversing at walls, and end the
episode on contact with the player (``better_scrolly_maze.py:275-301``);
coins pay +100 each and collecting them all wins
(``better_scrolly_maze.py:304-320``).

Deterministic, so the lockstep test drives the reference engine
frame-for-frame. Views come from :meth:`make_croppers` (player-tracking,
patroller-tracking, fixed teaser window).

Actions: 0=up 1=down 2=left 3=right 4=stay 5=quit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.cropping import FixedCropper, ScrollingCropper
from ai_safety_gridworlds_tpu.core.render import paint_sprite, rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

MAZES_ART = [
    [
        '#########################################################################################',
        '#       #               #       #           #           #  @   @   @   @    # @   @   @ #',
        '#   #   #####   #####   #   #   #####   #   #   #####   #############   # @ #########   #',
        '# @ #   #       #   #       #           #       #       #           # @ #    @   @   @  #',
        '#   #####   #####   #########   #################   #####   #   #   #   #################',
        '#   #       #     @    @    #           #       #           #   #   #                   #',
        '# @ #   #   # @ #########   #####   #   #   #   #########   #####   #   #############   #',
        '#   #   #   #     @ # @   @ #       #   #   #           #   #       #   #       #       #',
        '#   #   #############   #####   #########   #   #####   #####   #####   #   #   #########',
        '# @     # @   @   @ #   #       #       # @ #       #       # a             #           #',
        '#   #####   #####   # @ #   #####   #   #   #############   #   #####################   #',
        '#   # @   @ #   #   #   #           #   #   @   @   #       #   #  @    @    @   @  #   #',
        '# @ #   #####   # @ #   #####   #####   #########   #   #####   #####   #########   #####',
        '#   #   #       #     @ #   #       #       # @   @ #       #           #       #  @    #',
        '#   # @ #   #   #########   #####   #########   #############################   ##### @ #',
        '# @ #   #   #   #       #                   #   #           #           #       # @ #   #',
        '#   #   #   #   #   #   #################   # @ #   #####   #   #########   #####   #   #',
        '#     @ #   #       #       #           #   #       #   #   #           #   #   @   # @ #',
        '#########   #############   #   #####   #   #   #####   #   #########   #   #   #####   #',
        '#       #   #           #   #       #   #   # @ #           #       #   #     @ # @     #',
        '#   #   #############   #   #########   #   #   #   #########   #   #   #   #   ##### @ #',
        '#   #           #       # b                 #   #   #       #   #       #   #   @   #   #',
        '#   #########   #   #########   #   #   #####   #   #   #####   #####   #   #####   #   #',
        '#   #   #     @ #               # P #           #   #           #       #       # @ # @ #',
        '#   #   # @ #####################################   #   #####################   #   #   #',
        '#   #   #     @     #   @   #   #                   #   #                       #   @   #',
        '#   #   ######### @ #   #   #   #   #################   #########   #########   #########',
        '#   #   #       #     @ # @ #       #               #               #       #   #       #',
        '#   #   #####   #############   #########   #####   #################   #   #   #####   #',
        '#       #       #           #       #       #       #           #       #   #       #   #',
        '#   #####   #############   #####   #   #####   #####   #####   #   #############   #   #',
        '#       #           #       #   #       #       #       #       #           #           #',
        '#####   #   #########   #####   #########   #############   #   #########   #   #########',
        '#               #       # @ #           #   #           #   #       #           #       #',
        '#   #############   #####   #   #####   #   #   #####   #   #####   #   #   #####   #   #',
        '#       # @         #   @   #       #       #   #       #       #       #           #   #',
        '#####   #   #########   #########   #########   #####################################   #',
        '#       #   #   @   # @ #  @  @ #               # @    @    @   @   #     @ #  @  @ #   #',
        '#   ##### @ #   #####   #   #####   #############   #########   #   # @ #   #   #####   #',
        '#   #   #     @    @    # @   @     #           #   @   # @ #   # @     #  @    #       #',
        '#   #   #####   #################   #   #   #   #####   #   #   #################   #####',
        '#   #       #    @    @     # @     #   #   #       #  @    #   #   #               #   #',
        '#   #####   #########   #   #   #   #####   #####   #########   #   #   #############   #',
        '#                       # @     #           #       # c                                 #',
        '#########################################################################################',
    ],
    [
        '##############################',
        '#                            #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#     @   @   @   @   @   @  #',
        '#  @   @   @   @   @   @     #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#                            #',
        '#########  a         #########',
        '##########        b ##########',
        '#                            #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#     @   @   @   @   @   @  #',
        '#  @   @   @   @   @   @     #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#                            #',
        '#######       c        #######',
        '#                            #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#     @   @   @   @   @   @  #',
        '#  @   @   @   @   @   @     #',
        '#   @   @   @   @   @   @    #',
        '#    @   @   @   @   @   @   #',
        '#              P             #',
        '##############################',
    ],
    [
        '                                                                                         ',
        '   ###################################################################################   ',
        '   #  @  @  @  @  @  @  @  @  @  @           P                                       #   ',
        '   #   ###########################################################################   #   ',
        '   # @ #                                                                         #   #   ',
        '   #   #                                                                         #   #   ',
        '   # @ #                    ######################################################   #   ',
        '   #   #                    #                                                        #   ',
        '   # @ #                    #   ######################################################   ',
        '   #   #                    #   #                                                        ',
        '   # @ #                    #   #                                                        ',
        '   #   #                    #   ######################################################   ',
        '   # @ #                    #                                                        #   ',
        '   #   #                    ######################################################   #   ',
        '   # @ #                                                                         #   #   ',
        '   #   #                                                                         #   #   ',
        '   # @ #                                            ##############################   #   ',
        '   #   #                                           ##                            #   #   ',
        '   # @ #                                           #      @@@@@      #########   #   #   ',
        '   #   #                                           #   @@@@@@@@@@@   #       #   #   #   ',
        '   # @ ###########                                ##@@@@@@@@@@@@@@@@@##      #   #   #   ',
        '   #   # @  @  @ #                               ##@@@@@@@@@@@@@@@@@@@##     #   #   #   ',
        '   # @ #  a      #                              ##@@@@@@@@@@@@@@@@@@@@@##    #   #   #   ',
        '   #   #    b    #                             ##@@@@@@@@@@@@@@@@@@@@@@@##   #   #   #   ',
        '   # @ #      c  #                             ##@@@@@@@@@@@@@@@@@@@@@@@##   #   #   #   ',
        '   #   #######   #                              ##@@@@@@@@@@@@@@@@@@@@@##    #   #   #   ',
        '   # @  @  @     #                               ##@@@@@@@@@@@@@@@@@@@##     #       #   ',
        '   ###############                                #####################      #########   ',
        '                                                                                         ',
    ],
]

TEASER_CORNER = [(3, 9), (4, 5), (16, 53)]
STARTER_OFFSET = [(-2, -12), (10, 0), (-3, 0)]

COLOUR_FG = {
    " ": (0, 0, 0),
    "@": (999, 862, 110),
    "#": (764, 0, 999),
    "P": (0, 999, 999),
    "a": (999, 0, 780),
    "b": (145, 987, 341),
    "c": (987, 623, 145),
}

PATROLLERS = "abc"


@struct.dataclass
class BetterScrollyMazeState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2] player
    patrollers: jnp.ndarray  # int32 [3, 2]
    moving_east: jnp.ndarray  # bool [3]
    coins: jnp.ndarray  # bool [H, W]
    caught: jnp.ndarray  # bool [] player caught at the showtime sweep


class BetterScrollyMaze(SafetyGridworld):
    """The cropping-based scrolling maze (``better_scrolly_maze.py``)."""

    name = "better_scrolly_maze"
    action_min = 0
    action_max = 5
    max_iterations = 10_000

    def __init__(self, level=0):
        self.level = level
        board0 = art.art_to_uint8(MAZES_ART[level])
        self.h, self.w = board0.shape
        self._pos0 = art.position_of(board0, "P")
        self._patrollers0 = np.stack(
            [art.position_of(board0, c) for c in PATROLLERS]
        )
        self._backdrop = art.replace_chars(board0, "P@abc", " ")
        self._wall = art.char_mask(board0, "#")
        self._coins0 = art.char_mask(board0, "@")
        value_mapping = {c: float(i) for i, c in enumerate(" #@Pabc")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOUR_FG)

    # -------------------------------------------------------------- helpers

    def _patroller_sweep(self, patrollers, moving_east, frame, player_pos):
        """One patroller update for all three (``:285-301``): move on even
        frames, reverse at adjacent walls, catch the player on contact."""
        wall = jnp.asarray(self._wall)
        even = frame % 2 == 0
        caught = jnp.zeros((), bool)
        new_pat = patrollers
        new_dir = moving_east
        for k in range(3):
            r, c = new_pat[k, 0], new_pat[k, 1]
            wall_left = wall[
                jnp.clip(r, 0, self.h - 1), jnp.clip(c - 1, 0, self.w - 1)
            ]
            wall_right = wall[
                jnp.clip(r, 0, self.h - 1), jnp.clip(c + 1, 0, self.w - 1)
            ]
            east = jnp.where(
                wall_right, False, jnp.where(wall_left, True, new_dir[k])
            )
            target_c = c + jnp.where(east, 1, -1)
            blocked = wall[
                jnp.clip(r, 0, self.h - 1),
                jnp.clip(target_c, 0, self.w - 1),
            ]
            moved_c = jnp.where(even & ~blocked, target_c, c)
            new_pat = new_pat.at[k, 1].set(moved_c)
            new_dir = new_dir.at[k].set(jnp.where(even, east, new_dir[k]))
            caught = caught | (
                even
                & (new_pat[k] == player_pos).all()
            )
        return new_pat, new_dir, caught

    # --------------------------------------------------------------- resets

    def initial_state(self, key, options=None) -> BetterScrollyMazeState:
        # its_showtime runs one sweep at frame 0 (even): patrollers move.
        pat, east, caught = self._patroller_sweep(
            jnp.asarray(self._patrollers0),
            jnp.asarray([bool(ord(c) % 2) for c in PATROLLERS]),
            jnp.int32(0),
            jnp.asarray(self._pos0),
        )
        return BetterScrollyMazeState(
            t=jnp.int32(0),
            key=key,
            pos=jnp.asarray(self._pos0),
            patrollers=pat,
            moving_east=east,
            coins=jnp.asarray(self._coins0),
            caught=caught,
        )

    # ----------------------------------------------------------------- step

    def engine_step(self, state: BetterScrollyMazeState, action, options=None):
        is_quit = action == 5
        frame = state.t

        # Patrollers move first (schedule ['a','b','c','P','@']), catching
        # the player at its PRE-move position.
        pat, east, caught = self._patroller_sweep(
            state.patrollers, state.moving_east, frame, state.pos
        )
        caught = caught | state.caught

        # Player MazeWalker (impassable '#').
        delta = jnp.select(
            [action == 0, action == 1, action == 2, action == 3],
            [
                jnp.asarray([-1, 0]),
                jnp.asarray([1, 0]),
                jnp.asarray([0, -1]),
                jnp.asarray([0, 1]),
            ],
            jnp.asarray([0, 0]),
        )
        target = state.pos + delta
        in_b = (
            (target[0] >= 0) & (target[0] < self.h)
            & (target[1] >= 0) & (target[1] < self.w)
        )
        blocked = jnp.asarray(self._wall)[
            jnp.clip(target[0], 0, self.h - 1),
            jnp.clip(target[1], 0, self.w - 1),
        ] & in_b
        pos = jnp.where(blocked, state.pos, target)

        # Coins (``:311-320``).
        rr = jnp.clip(pos[0], 0, self.h - 1)
        cc = jnp.clip(pos[1], 0, self.w - 1)
        on_coin = state.coins[rr, cc] & in_b
        coins = state.coins.at[rr, cc].set(
            jnp.where(on_coin, False, state.coins[rr, cc])
        )
        all_collected = ~coins.any()

        state = state.replace(
            pos=pos,
            patrollers=pat,
            moving_east=east,
            coins=coins,
            caught=jnp.zeros((), bool),
        )
        return state, EngineStep.make(
            reward=jnp.where(on_coin, 100.0, 0.0),
            terminated=caught | all_collected | is_quit,
            termination_reason=jnp.where(
                is_quit,
                jnp.int32(TerminationReason.QUIT),
                jnp.int32(TerminationReason.TERMINATED),
            ),
            discount=jnp.float32(0.0),
        )

    # -------------------------------------------------------------- observe

    def board(self, state: BetterScrollyMazeState):
        board = jnp.asarray(self._backdrop)
        # z-order 'abc@P'.
        for k, c in enumerate(PATROLLERS):
            board = paint_sprite(board, state.patrollers[k], ord(c))
        board = jnp.where(state.coins, jnp.uint8(ord("@")), board)
        return paint_sprite(board, state.pos, ord("P"))

    def observe(self, state: BetterScrollyMazeState) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }

    def make_croppers(self):
        """The reference's three views (``better_scrolly_maze.py:224-247``)."""
        return [
            ScrollingCropper(
                rows=10, cols=30,
                initial_offset=STARTER_OFFSET[self.level],
            ),
            ScrollingCropper(
                rows=7, cols=10, pad_char=" ", scroll_margins=(None, 3)
            ),
            FixedCropper(
                TEASER_CORNER[self.level], rows=12, cols=20, pad_char=" "
            ),
        ]
