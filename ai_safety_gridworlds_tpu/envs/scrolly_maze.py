"""Scrolly maze: a large world explored through an egocentric window.

Functional re-implementation of pycolab's scrolling-world demo
(``pycolab/examples/scrolly_maze.py``) with FULL Scrolly/scrolling-protocol
semantics: the board is a 10x30 window whose northwest corner slides over
the maze pattern. Per frame (update schedule ``[['#'], ['a','b','c','P'],
['@']]``, ``scrolly_maze.py:241``):

* the walls drape decides the scroll: it scrolls one step iff the player's
  intended motion would enter a board margin (``drapes.py:661-687``,
  margins (2, 3)), the player declared that motion legal LAST frame
  (``scrolling.permit`` is tagged for frame+1, ``scrolling.py:418``), and
  the corner stays on the pattern;
* patrollers obey the order (screen shift) and walk horizontally every
  second frame, reversing at pattern walls (``scrolly_maze.py:274-305``);
  their kill check compares their post-move screen position against the
  player's PRE-update screen position — with a scroll this frame the kill
  condition in world coordinates is ``patroller == player + order``;
* the player obeys the order then moves (blocked only by on-screen '#';
  off-screen cells are the passable EDGE sentinel), and posts next frame's
  permitted motions;
* the coins drape checks the player's position against its own PRE-scROLL
  corner (``drapes.py:378-412``) — on scroll frames the checked pattern
  cell is displaced by ``-order`` from the player's true world position
  (a faithful reference quirk) — pays +100 per coin, and ends the episode
  when all coins are gone; it then applies the pending scroll order.

The pattern stays static in device memory; windows are ``dynamic_slice``
reads at the corner (``core/scrolling.py`` rationale).

Actions: 0=up 1=down 2=left 3=right 4=stay 5=quit
(``scrolly_maze.py:352-364``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import paint_sprite, rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

from ai_safety_gridworlds_tpu.envs import scrolly_maze_art as _art_mod

PLAYER_CHR = "P"
COIN_CHR = "@"
WALL_CHR = "#"
PATROLLER_CHRS = "abc"

# N, S, W, E, stay — reference action order (``scrolly_maze.py:262-271``).
_DELTAS = np.array(
    [(-1, 0), (1, 0), (0, -1), (0, 1), (0, 0)], np.int32
)

GAME_BG_COLOURS = {
    WALL_CHR: (764, 0, 999),
    " ": (0, 0, 0),
    ".": (949, 929, 999),
    PLAYER_CHR: (0, 999, 999),
    COIN_CHR: (999, 862, 110),
    "a": (999, 0, 780),
    "b": (145, 987, 341),
    "c": (987, 623, 145),
}


@struct.dataclass
class ScrollyMazeState:
    t: jnp.ndarray
    key: jnp.ndarray
    corner: jnp.ndarray  # int32 [2] shared Scrolly NW corner
    world_pos: jnp.ndarray  # int32 [2] player position in PATTERN coords
    permit: jnp.ndarray  # bool [4] motions (N,S,W,E) permitted THIS frame
    permit_posted: jnp.ndarray  # bool [] the player posted permits last frame
    coins: jnp.ndarray  # bool [Hp, Wp] pattern state
    patrol_world: jnp.ndarray  # int32 [3, 2] pattern coords
    patrol_east: jnp.ndarray  # bool [3]


class ScrollyMaze(SafetyGridworld):
    """Big-world maze with patrollers and coins (``scrolly_maze.py``)."""

    name = "scrolly_maze"
    action_min = 0
    action_max = 5

    def __init__(self, level: int = 0, max_iterations: int = 1000):
        self.level = level
        self.max_iterations = max_iterations
        maze_rows = _art_mod.MAZES_ART[level]
        beneath = _art_mod.MAZES_WHAT_LIES_BENEATH[level]
        arr = np.array([list(r) for r in maze_rows])
        corner = np.argwhere(arr == "+")[0]
        arr[tuple(corner)] = beneath
        self._pstart = np.argwhere(arr == PLAYER_CHR)[0].astype(np.int32)
        self._patrol0 = np.stack(
            [np.argwhere(arr == c)[0] for c in PATROLLER_CHRS]
        ).astype(np.int32)
        for c in PLAYER_CHR + PATROLLER_CHRS:
            arr[arr == c] = " "
        self._wall_pattern = arr == WALL_CHR
        self._coins0 = arr == COIN_CHR
        self._backdrop = np.array(
            [[ord(c) for c in r] for r in _art_mod.STAR_ART], np.uint8
        )
        self.h, self.w = self._backdrop.shape
        self._corner0 = corner.astype(np.int32)
        self._corner_limit = np.array(
            [arr.shape[0] - self.h, arr.shape[1] - self.w], np.int32
        )
        # Scroll margins (2, 3): the reference precomputes edge thresholds
        # (``drapes.py:355-358``).
        self._margin_n, self._margin_s = 1, self.h - 2
        self._margin_w, self._margin_e = 2, self.w - 3
        # Initial heading from character parity (``scrolly_maze.py:282``).
        self._patrol_east0 = np.array(
            [bool(ord(c) % 2) for c in PATROLLER_CHRS]
        )
        from ai_safety_gridworlds_tpu.core import art

        value_mapping = {WALL_CHR: 0.0, " ": 1.0, ".": 1.5, COIN_CHR: 2.0,
                         PLAYER_CHR: 3.0}
        for i, c in enumerate(PATROLLER_CHRS):
            value_mapping[c] = 4.0 + i
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(GAME_BG_COLOURS)

    # ------------------------------------------------------------ helpers

    def _patrol_move(self, pworld, east, corner):
        """One patroller sweep in pattern coords: reverse when the pattern
        has a wall ahead, then step unless the target is an ON-SCREEN wall
        (off-screen cells read as the passable EDGE sentinel for the
        unconfined walker, ``scrolly_maze.py:292-303``)."""
        wall = jnp.asarray(self._wall_pattern)
        ahead = pworld[:, 1] + jnp.where(east, 1, -1)
        flip = wall[pworld[:, 0], ahead]
        east = east ^ flip
        tgt_col = pworld[:, 1] + jnp.where(east, 1, -1)
        tgt_scr_r = pworld[:, 0] - corner[0]
        tgt_scr_c = tgt_col - corner[1]
        on_screen = (
            (tgt_scr_r >= 0) & (tgt_scr_r < self.h)
            & (tgt_scr_c >= 0) & (tgt_scr_c < self.w)
        )
        blocked = on_screen & wall[pworld[:, 0], tgt_col]
        pworld = pworld.at[:, 1].set(
            jnp.where(blocked, pworld[:, 1], tgt_col)
        )
        return pworld, east

    def _permits(self, world_pos, vpos):
        """Cardinal motions the player declares legal for NEXT frame: an
        off-board target is the EDGE sentinel (passable, the player is not
        confined); an on-board target blocks iff it shows '#'
        (``sprites.py:461-477``)."""
        wall = jnp.asarray(self._wall_pattern)
        deltas = jnp.asarray(_DELTAS[:4])
        scr = vpos[None, :] + deltas
        on_board = (
            (scr[:, 0] >= 0) & (scr[:, 0] < self.h)
            & (scr[:, 1] >= 0) & (scr[:, 1] < self.w)
        )
        wr = jnp.clip(world_pos[0] + deltas[:, 0], 0,
                      wall.shape[0] - 1)
        wc = jnp.clip(world_pos[1] + deltas[:, 1], 0,
                      wall.shape[1] - 1)
        return ~on_board | ~wall[wr, wc]

    # -------------------------------------------------------------- reset

    def initial_state(self, key, options=None) -> ScrollyMazeState:
        # its_showtime sweep (frame 0, actions None): the walls drape and
        # player dispatch nothing (no scroll, no permits posted), but the
        # patrollers DO move (``the_plot.frame % 2`` is falsy at frame 0).
        corner = jnp.asarray(self._corner0)
        pworld, east = self._patrol_move(
            jnp.asarray(self._patrol0),
            jnp.asarray(self._patrol_east0),
            corner,
        )
        return ScrollyMazeState(
            t=jnp.int32(0),
            key=key,
            corner=corner,
            world_pos=jnp.asarray(self._pstart),
            permit=jnp.zeros((4,), bool),
            permit_posted=jnp.asarray(False),
            coins=jnp.asarray(self._coins0),
            patrol_world=pworld,
            patrol_east=east,
        )

    # --------------------------------------------------------------- step

    def engine_step(self, state: ScrollyMazeState, action, options=None):
        is_quit = action == 5
        dispatch = action <= 4  # motions reach '#'/'P' only for 0..4
        is_cardinal = action < 4
        m = jnp.asarray(_DELTAS)[jnp.clip(action, 0, 4)]
        frame = state.t  # base.step already advanced to the current frame
        wall = jnp.asarray(self._wall_pattern)
        vpos = state.world_pos - state.corner

        # Group 1 — walls drape scroll decision (margins case,
        # ``drapes.py:590-658``): demanded iff the player's motion enters
        # or deepens a margin, permitted by last frame's player permit,
        # and the corner stays on the pattern.
        new_scr = vpos + m
        vdemand = ((m[0] < 0) & (new_scr[0] <= self._margin_n)) | (
            (m[0] > 0) & (new_scr[0] >= self._margin_s)
        )
        hdemand = ((m[1] < 0) & (new_scr[1] <= self._margin_w)) | (
            (m[1] > 0) & (new_scr[1] >= self._margin_e)
        )
        possible = state.permit_posted & jnp.where(
            is_cardinal, state.permit[jnp.clip(action, 0, 3)], False
        )
        target_corner = state.corner + m
        corner_ok = jnp.all(
            (target_corner >= 0)
            & (target_corner <= jnp.asarray(self._corner_limit))
        )
        do_scroll = (
            is_cardinal & (vdemand | hdemand) & possible & corner_ok
        )
        order = jnp.where(do_scroll, m, jnp.zeros_like(m))
        corner = state.corner + order

        # Group 2 — patrollers (before 'P' in the update schedule). Kill
        # check: their post-move screen position vs the player's PRE-update
        # screen position, i.e. world == player + order on scroll frames.
        moving_turn = (frame % 2) == 0
        moved_pw, moved_east = self._patrol_move(
            state.patrol_world, state.patrol_east, corner
        )
        pworld = jnp.where(moving_turn, moved_pw, state.patrol_world)
        east = jnp.where(moving_turn, moved_east, state.patrol_east)
        caught = moving_turn & jnp.any(
            jnp.all(
                pworld == (state.world_pos + order)[None, :], axis=1
            )
        )

        # Group 2 — player: obey the order (screen -= order), then move if
        # the target is not an on-screen wall (off-screen = passable EDGE).
        obeyed = vpos - order
        tgt_scr = obeyed + m
        on_board_t = (
            (tgt_scr[0] >= 0) & (tgt_scr[0] < self.h)
            & (tgt_scr[1] >= 0) & (tgt_scr[1] < self.w)
        )
        tgt_world = state.world_pos + m
        twr = jnp.clip(tgt_world[0], 0, wall.shape[0] - 1)
        twc = jnp.clip(tgt_world[1], 0, wall.shape[1] - 1)
        blocked = on_board_t & wall[twr, twc]
        vpos_new = jnp.where(
            dispatch,
            jnp.where(blocked, obeyed, obeyed + m),
            vpos,
        )
        world_new = corner + vpos_new
        permit = self._permits(world_new, vpos_new)
        permit_posted = dispatch

        # Group 3 — coins drape: the coin check uses its PRE-scroll corner
        # (the frame's STARTING corner), so the checked pattern cell is the
        # player's true position displaced by -order on scroll frames. An
        # off-board player has true position (0, 0) (``sprites.py:391-408``).
        on_board_p = (
            (vpos_new[0] >= 0) & (vpos_new[0] < self.h)
            & (vpos_new[1] >= 0) & (vpos_new[1] < self.w)
        )
        p_true = jnp.where(on_board_p, vpos_new, jnp.zeros_like(vpos_new))
        cell = state.corner + p_true
        got = state.coins[cell[0], cell[1]]
        coins = state.coins.at[cell[0], cell[1]].set(False)
        reward = jnp.where(got, 100.0, 0.0)
        all_collected = ~jnp.any(coins)

        terminated = is_quit | all_collected | caught

        state = state.replace(
            corner=corner,
            world_pos=world_new,
            permit=permit,
            permit_posted=permit_posted,
            coins=coins,
            patrol_world=pworld,
            patrol_east=east,
        )
        return state, EngineStep.make(
            jnp.asarray(reward, jnp.float32),
            terminated=terminated,
            termination_reason=jnp.where(
                is_quit,
                jnp.int32(TerminationReason.QUIT),
                jnp.where(
                    terminated,
                    jnp.int32(TerminationReason.TERMINATED),
                    jnp.int32(TerminationReason.NONE),
                ),
            ),
            discount=0.0,
            actual_action=action,
        )

    # ------------------------------------------------------------ observe

    def _window(self, pattern, corner):
        import jax

        return jax.lax.dynamic_slice(
            pattern, (corner[0], corner[1]), (self.h, self.w)
        )

    def board(self, state):
        board = jnp.asarray(self._backdrop)
        # z-order 'abc@#P' (``scrolly_maze.py:242``): patrollers at the
        # bottom, then coins, walls, player on top.
        for i, c in enumerate(PATROLLER_CHRS):
            scr = state.patrol_world[i] - state.corner
            board = paint_sprite(board, scr, ord(c))
        coins_win = self._window(state.coins, state.corner)
        board = jnp.where(coins_win, jnp.uint8(ord(COIN_CHR)), board)
        walls_win = self._window(
            jnp.asarray(self._wall_pattern), state.corner
        )
        board = jnp.where(walls_win, jnp.uint8(ord(WALL_CHR)), board)
        return paint_sprite(
            board, state.world_pos - state.corner, ord(PLAYER_CHR)
        )

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
