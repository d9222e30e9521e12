"""T-maze: cue, teleport through limbo, pick the cued arm.

Functional re-implementation of pycolab's
``examples/research/lp-rnn/t_maze.py`` (the third lp-rnn memory task,
completing the trio with cued_catch and sequence_recall): the agent sees a
left/right cue in a small chamber, walks onto a teleporter that appears
after a delay, is frozen in a "limbo" cell for a time, then lands in one of
six T-mazes (difficulty = maze size) and must reach the cued goal arm
(+1/-1; -0.001 per frame; configurable timeout).

This game is the reference's showcase of the full Scrolly machinery
(``prefab_parts/drapes.py:487-659`` + ``protocols/scrolling.py:287-532``),
so the functional rebuild models that protocol exactly, one frame per
``engine_step``:

* All five Scrolly drapes share one window CORNER (clamped to the pattern,
  ``drapes.py:564-578``) plus a cumulative pattern ROLL (the
  ``PseudoTeleportingScrolly`` ``np.roll`` teleports, ``t_maze.py:315-331``).
* The scroll-permission handshake: the player declares which cardinal
  motions are legal for the NEXT frame from the MID-FRAME board
  (``sprites.py:459-477``) — walls already scrolled by update group 0,
  goal/teleporter curtains lagging one frame (they update in group 2,
  ``t_maze.py:210``), cue overlay current. Lagging overlay curtains
  therefore mask walls, which is observable reference behaviour.
* The player is a full egocentric MazeWalker: it obeys the (possibly
  clamped) scroll order by moving ``-order`` on screen, then applies its
  own motion only if the mid-frame board allows (``sprites.py:356-390``),
  so its screen position can drift off centre and even off the board
  (virtual positions, true position pinned to (0, 0) while off board).
* Quit (0/6) is ignored during teleport order-hold frames
  (``t_maze.py:232-245``), and skipping the move means no permissions are
  declared for the following frame.
* Goals check the player's true position against the PRE-scroll corner in
  the post-roll pattern (``pattern_position_prescroll``, ``t_maze.py:487``);
  the teleporter checks the POST-scroll corner (``t_maze.py:447``).

Actions: 1=up 2=down 3=left 4=right 5=stay 0/6=quit (``t_maze.py:524-528``).
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import (
    char_repainter_lut,
    repaint,
    rgb_map,
    value_map,
)
from ai_safety_gridworlds_tpu.core.scrolling import ScrollingWorld, pattern_info
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

MAZE_ART = [
    '                                                                                                                                                                                               ',
    '                                                                                                                                       ##   #   ##                                             ',
    '                                                                                                                                         ## # ##                                               ',
    '                                                                                         +  #####                                          ###                                                 ',
    '                                                                                            #ttt#                                      ##### #####                                             ',
    '                                                                                            #   #                                          ###                                                 ',
    '                                                                                            # P #                                        ## # ##                                               ',
    '                                                                                            #####                                      ##   #   ##                                             ',
    '                                                                                                                                                                                               ',
    '                                                                                                                                                                                               ',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '************************************************************************************#####################**************************************************************************************',
    '************************************************************************************#                   #**************************************************************************************',
    '************************************************************************************#                   #**************************************************************************************',
    '************************************************************************************#   #############   #**************************************************************************************',
    '************************************************************************************#   #***********#   #**************************************************************************************',
    '************************************************************************************#   #***********#   #**************************************************************************************',
    '************************************************************************************#lll#***********#rrr#**************************************************************************************',
    '************************************************************************************#####***********#####**************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '*******************************************************************************###############################*********************************************************************************',
    '*******************************************************************************#                             #*********************************************************************************',
    '*******************************************************************************#                             #*********************************************************************************',
    '*******************************************************************************#   #######################   #*********************************************************************************',
    '*******************************************************************************#   #*********************#   #*********************************************************************************',
    '*******************************************************************************#   #*********************#   #*********************************************************************************',
    '*******************************************************************************#lll#*********************#rrr#*********************************************************************************',
    '*******************************************************************************#####*********************#####*********************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '************************************************************************#############################################**************************************************************************',
    '************************************************************************#                                           #**************************************************************************',
    '************************************************************************#                                           #**************************************************************************',
    '************************************************************************#   #####################################   #**************************************************************************',
    '************************************************************************#   #***********************************#   #**************************************************************************',
    '************************************************************************#   #***********************************#   #**************************************************************************',
    '************************************************************************#lll#***********************************#rrr#**************************************************************************',
    '************************************************************************#####***********************************#####**************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************#######################################################################*************************************************************',
    '***********************************************************#                                                                     #*************************************************************',
    '***********************************************************#                                                                     #*************************************************************',
    '***********************************************************#   ###############################################################   #*************************************************************',
    '***********************************************************#   #*************************************************************#   #*************************************************************',
    '***********************************************************#   #*************************************************************#   #*************************************************************',
    '***********************************************************#lll#*************************************************************#rrr#*************************************************************',
    '***********************************************************#####*************************************************************#####*************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***************************************#################################################################################################################***************************************',
    '***************************************#                                                                                                               #***************************************',
    '***************************************#                                                                                                               #***************************************',
    '***************************************#   #########################################################################################################   #***************************************',
    '***************************************#   #*******************************************************************************************************#   #***************************************',
    '***************************************#   #*******************************************************************************************************#   #***************************************',
    '***************************************#lll#*******************************************************************************************************#rrr#***************************************',
    '***************************************#####*******************************************************************************************************#####***************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
    '***#########################################################################################################################################################################################***',
    '***#                                                                                                                                                                                       #***',
    '***#                                                                                                                                                                                       #***',
    '***#   #################################################################################################################################################################################   #***',
    '***#   #*******************************************************************************************************************************************************************************#   #***',
    '***#   #*******************************************************************************************************************************************************************************#   #***',
    '***#lll#*******************************************************************************************************************************************************************************#rrr#***',
    '***#####*******************************************************************************************************************************************************************************#####***',
    '***********************************************************************************************************************************************************************************************',
    '***********************************************************************************************************************************************************************************************',
]

CUE_ART = [
    '           ',
    '           ',
    '           ',
    '           ',
    'QQ       QQ',
    'QQ       QQ',
    'QQ       QQ',
]

REPAINT_MAPPING = {"t": "~", "l": "~", "r": "~", "*": "#"}

COLOURS = {
    " ": (0, 0, 0),
    "#": (764, 0, 999),
    "P": (0, 999, 999),
    "Q": (0, 999, 0),
    "~": (0, 0, 999),
}

# Limbo cell and goal-hallway column offset (``t_maze.py:407-412``).
LIMBO = (4, 140)
TELEPORT_DX = -46

# Cardinal motions in the permission-mask order N, S, W, E.
_MOTIONS = np.asarray([[-1, 0], [1, 0], [0, -1], [0, 1]], np.int32)
# action 1..4 -> index into _MOTIONS (up, down, left, right).
_ACTION_DIR = np.asarray([-1, 0, 1, 2, 3, -1, -1], np.int32)


@struct.dataclass
class TMazeState:
    t: jnp.ndarray
    key: jnp.ndarray
    corner: jnp.ndarray  # int32 [2] shared Scrolly NW corner (clamped)
    roll: jnp.ndarray  # int32 [2] accumulated teleport pattern roll
    vpos: jnp.ndarray  # int32 [2] player's virtual (screen) position
    perm_mask: jnp.ndarray  # bool [4] scroll permissions for THIS frame (NSWE)
    which_goal: jnp.ndarray  # int32: 0 left, 1 right
    speckle: jnp.ndarray  # bool [Hp, Wp] per-episode speckle pattern
    cue_cleared: jnp.ndarray  # bool [] the cue curtain was blanked
    teleported: jnp.ndarray  # bool [] plot's consumable teleported flag
    teleport_delay: jnp.ndarray  # int32 [] frames until teleporter shows
    in_limbo: jnp.ndarray  # bool []
    limbo_countdown: jnp.ndarray  # int32 []
    order_frame: jnp.ndarray  # int32 [] frame a teleport roll executes (-1)
    order_shift: jnp.ndarray  # int32 [2]
    timeout: jnp.ndarray  # int32 [] frame at which the episode times out


class TMaze(SafetyGridworld):
    """The scrolling T-maze memory task (``t_maze.py``)."""

    name = "t_maze"
    action_min = 0
    action_max = 6
    max_iterations = 100_000  # the in-plot timeout governs

    def __init__(self, level=4, cue_after_teleport=False,
                 timeout_frames=-1, teleport_delay=0, limbo_time=10):
        self.level = level
        self.cue_after_teleport = cue_after_teleport
        self.timeout_frames = (
            2**30 if timeout_frames < 0 else int(timeout_frames)
        )
        self.teleport_delay_frames = int(teleport_delay)
        self.limbo_time = int(limbo_time)
        self.teleport_dy = 11 * level + 9
        masks, corner = pattern_info(MAZE_ART, CUE_ART, corner_mark="+")
        if self.teleport_dy + 5 > masks["#"].shape[0]:
            raise ValueError(f"There is no {level} difficulty level.")
        player_mask = masks.pop("P")
        self.world = ScrollingWorld(masks, (len(CUE_ART), len(CUE_ART[0])))
        self.h, self.w = len(CUE_ART), len(CUE_ART[0])
        # Corner clamp bounds (``drapes.py:342-343``).
        self._corner_limit = np.asarray(
            [self.world.hp - self.h, self.world.wp - self.w], np.int32
        )
        player_pattern = tuple(np.argwhere(player_mask)[0])
        self._corner0 = np.asarray(corner, np.int32)
        self._vpos0 = np.asarray(
            [player_pattern[0] - corner[0], player_pattern[1] - corner[1]],
            np.int32,
        )
        self._speckle0 = np.asarray(masks["*"], bool)
        cue = art.art_to_uint8(CUE_ART)
        self._cue_full = cue == np.uint8(ord("Q"))
        value_mapping = {c: float(i) for i, c in enumerate(" #QP~*tlr")}
        self._value_lut = art.char_lut(value_mapping)
        self._repainter = char_repainter_lut(REPAINT_MAPPING)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)

    # -------------------------------------------------------------- helpers

    def _cue_mask(self, which_goal, cue_cleared):
        """The cue curtain: half blanked per goal (``t_maze.py:262-266``),
        zeroed once consumed."""
        half = jnp.where(
            which_goal == 0,
            jnp.arange(self.w) < 6,
            jnp.arange(self.w) >= 6,
        )[None, :]
        return jnp.asarray(self._cue_full) & half & ~cue_cleared

    def _impassable_midframe(self, corner_now, roll_now, corner_lag,
                             roll_lag, t_visible_lag, cue):
        """Impassability of each board cell on the MID-frame board the player
        sees (rendered after update group 0): walls at this frame's
        corner/roll, goal+teleporter curtains one frame behind, cue current.
        A cell blocks iff it SHOWS '#' under z-order '*#ltrQP'
        (``t_maze.py:211``); overlays above '#' mask walls."""
        world = self.world
        walls = world.window("#", corner_now + roll_now)
        lag = corner_lag + roll_lag
        overlay = world.window("l", lag) | world.window("r", lag)
        overlay = overlay | (world.window("t", lag) & t_visible_lag)
        return walls & ~overlay & ~cue

    def _permissions(self, vpos, impassable):
        """The player's ``_update_scroll_permissions``: which of the four
        cardinal motions are legal from ``vpos`` against the mid-frame board
        (``sprites.py:459-477``). Off-board neighbours are EDGE, which is
        passable for this unconfined walker (``sprites.py:516-518``)."""
        targets = vpos[None, :] + jnp.asarray(_MOTIONS)
        on_board = (
            (targets[:, 0] >= 0) & (targets[:, 0] < self.h)
            & (targets[:, 1] >= 0) & (targets[:, 1] < self.w)
        )
        rows = jnp.clip(targets[:, 0], 0, self.h - 1)
        cols = jnp.clip(targets[:, 1], 0, self.w - 1)
        blocked = on_board & impassable[rows, cols]
        return ~blocked

    # -------------------------------------------------------------- resets

    def host_reset_options(self) -> dict:
        """Build-time draws in reference construction order: the cue side
        from the ``random`` module (``t_maze.py:262``), then the speckle
        pattern from global numpy (``t_maze.py:365``)."""
        which = 0 if random.random() < 0.5 else 1
        keep = ~(np.random.rand(*self._speckle0.shape) < 0.4)
        return {"which_goal": np.int32(which), "speckle_keep": keep}

    def sample_reset_options(self, key) -> dict:
        k1, k2 = jax.random.split(key)
        return {
            "which_goal": jax.random.randint(k1, (), 0, 2),
            "speckle_keep": jax.random.uniform(
                k2, self._speckle0.shape
            ) >= 0.4,
        }

    def initial_state(self, key, options=None) -> TMazeState:
        if options is None or "which_goal" not in options:
            key, sub = jax.random.split(key)
            options = self.sample_reset_options(sub)
        corner = jnp.asarray(self._corner0)
        roll = jnp.zeros((2,), jnp.int32)
        vpos = jnp.asarray(self._vpos0)
        which = jnp.asarray(options["which_goal"], jnp.int32)
        # The showtime sweep (frame 0, actions None; everything executes
        # ``_stay`` because ``frame - (-1) <= 1``): the teleporter delay
        # counts down one tick (``t_maze.py:425-428``) and the player
        # declares the first scroll permissions from the initial board,
        # whose teleporter curtain is construction-state (cleared iff a
        # delay was configured, ``t_maze.py:397-400``).
        delay0 = self.teleport_delay_frames
        t_visible0 = jnp.asarray(delay0 <= 0)
        cue0 = self._cue_mask(which, jnp.asarray(False))
        imp0 = self._impassable_midframe(
            corner, roll, corner, roll, t_visible0, cue0
        )
        perm0 = self._permissions(vpos, imp0)
        if delay0 > 0:
            delay0 -= 1
        return TMazeState(
            t=jnp.int32(0),
            key=key,
            corner=corner,
            roll=roll,
            vpos=vpos,
            perm_mask=perm0,
            which_goal=which,
            speckle=jnp.asarray(self._speckle0)
            & jnp.asarray(options["speckle_keep"], bool),
            cue_cleared=jnp.asarray(False),
            teleported=jnp.asarray(False),
            teleport_delay=jnp.int32(delay0),
            in_limbo=jnp.asarray(False),
            limbo_countdown=jnp.int32(self.limbo_time),
            order_frame=jnp.int32(-1),
            order_shift=jnp.zeros((2,), jnp.int32),
            timeout=jnp.int32(self.timeout_frames),
        )

    # ---------------------------------------------------------------- step

    def engine_step(self, state: TMazeState, action, options=None):
        frame = state.t
        world = self.world
        order_hold = (frame - state.order_frame >= 0) & (
            frame - state.order_frame <= 1
        )

        # --- group 0: cue + scenery ---------------------------------------
        # CueDrape: consume the teleported flag and blank the curtain
        # (``t_maze.py:273-275``); timeout / existence penalty (:280-283).
        if self.cue_after_teleport:
            consume = jnp.asarray(False)
        else:
            consume = state.teleported & ~state.cue_cleared
        cue_cleared = state.cue_cleared | consume
        teleported = state.teleported & ~consume
        timed_out = frame >= state.timeout
        reward = jnp.where(~timed_out & (frame > 1), -0.001, 0.0)
        cue = self._cue_mask(state.which_goal, cue_cleared)

        # MazeDrape/SpeckleDrape: execute a pending teleport roll
        # (``t_maze.py:315-320``), then maybe scroll. The scroll order is
        # issued iff the action maps to a cardinal motion, no order-hold is
        # in force, and the player permitted that motion last frame; each
        # component is clamped against the pattern bounds
        # (``drapes.py:550-588``).
        execute = state.order_frame == frame
        roll_new = jnp.where(
            execute,
            (state.roll + state.order_shift)
            % jnp.asarray([world.hp, world.wp], jnp.int32),
            state.roll,
        )
        dir_idx = jnp.asarray(_ACTION_DIR)[jnp.clip(action, 0, 6)]
        is_move = (dir_idx >= 0) & ~order_hold
        motion = jnp.asarray(_MOTIONS)[jnp.maximum(dir_idx, 0)]
        possible = is_move & state.perm_mask[jnp.maximum(dir_idx, 0)]
        target_corner = state.corner + motion
        can_scroll = (target_corner >= 0) & (
            target_corner <= jnp.asarray(self._corner_limit)
        )
        order = jnp.where(possible & can_scroll, motion, 0)
        corner_new = state.corner + order

        # The mid-frame board the player checks against (see class docs).
        t_visible_lag = state.teleport_delay <= 0
        impassable = self._impassable_midframe(
            corner_new, roll_new, state.corner, state.roll,
            t_visible_lag, cue,
        )

        # --- group 1: the player (egocentric MazeWalker) -------------------
        # Quit is swallowed by the order-hold branch (``t_maze.py:232-245``).
        is_quit = ((action == 0) | (action == 6)) & ~order_hold
        timeout = jnp.where(is_quit, frame + 1, state.timeout)
        # Obey the scroll order: -order on screen (``sprites.py:416-447``).
        vpos = state.vpos - order
        # Then apply own motion if the mid-frame board allows.
        tgt = vpos + motion
        tgt_on_board = (
            (tgt[0] >= 0) & (tgt[0] < self.h)
            & (tgt[1] >= 0) & (tgt[1] < self.w)
        )
        blocked = tgt_on_board & impassable[
            jnp.clip(tgt[0], 0, self.h - 1), jnp.clip(tgt[1], 0, self.w - 1)
        ]
        vpos = jnp.where(is_move & ~blocked, tgt, vpos)
        # Declare next frame's scroll permissions — unless the player's
        # update skipped ``_move`` entirely (quit, ``t_maze.py:244-245``).
        perm_mask = jnp.where(
            is_quit,
            jnp.zeros((4,), bool),
            self._permissions(vpos, impassable),
        )
        # True position: (0, 0) while the virtual position is off board
        # (``sprites.py:344-349``).
        on_board = (
            (vpos[0] >= 0) & (vpos[0] < self.h)
            & (vpos[1] >= 0) & (vpos[1] < self.w)
        )
        true_pos = jnp.where(on_board, vpos, jnp.zeros((2,), jnp.int32))

        # --- group 2: goals + teleporter ------------------------------------
        # Goals check the PRE-scroll corner in the post-roll pattern
        # (``pattern_position_prescroll``, ``t_maze.py:487-492``).
        goal_pos = state.corner + roll_new + true_pos
        on_left = world.at("l", goal_pos)
        on_right = world.at("r", goal_pos)
        goal_hit = (on_left | on_right) & (frame < timeout)
        goal_reward = jnp.where(
            (on_left & (state.which_goal == 0))
            | (on_right & (state.which_goal == 1)),
            1.0,
            -1.0,
        )
        reward = reward + jnp.where(goal_hit, goal_reward, 0.0)
        timeout = jnp.where(goal_hit, frame + 1, timeout)

        # TeleporterDrape: delay countdown (``t_maze.py:425-428``), then the
        # teleport check at the POST-scroll corner (:446-459), then the limbo
        # countdown (:463-468). Teleport orders execute next frame.
        delay = jnp.where(
            state.teleport_delay > 0,
            state.teleport_delay - 1,
            state.teleport_delay,
        )
        tele_pos = corner_new + roll_new + true_pos
        on_tele = ~teleported & (delay <= 0) & world.at("t", tele_pos)
        teleported = teleported | on_tele
        bypass = state.limbo_countdown <= 0
        pat_pos = corner_new + true_pos  # rolled-pattern coordinates
        shift_to_limbo = jnp.asarray(LIMBO, jnp.int32) - pat_pos
        shift_to_maze = jnp.asarray([self.teleport_dy, 0], jnp.int32)
        order_frame = jnp.where(on_tele, frame + 1, state.order_frame)
        order_shift = jnp.where(
            on_tele,
            jnp.where(bypass, shift_to_maze, shift_to_limbo),
            state.order_shift,
        )
        in_limbo = state.in_limbo | (on_tele & ~bypass)
        limbo_countdown = jnp.where(
            in_limbo, state.limbo_countdown - 1, state.limbo_countdown
        )
        limbo_done = in_limbo & (limbo_countdown == 0)
        in_limbo = in_limbo & ~limbo_done
        order_frame = jnp.where(limbo_done, frame + 1, order_frame)
        order_shift = jnp.where(
            limbo_done,
            jnp.asarray([self.teleport_dy, TELEPORT_DX], jnp.int32),
            order_shift,
        )

        state = state.replace(
            corner=corner_new,
            roll=roll_new,
            vpos=vpos,
            perm_mask=perm_mask,
            cue_cleared=cue_cleared,
            teleported=teleported,
            teleport_delay=delay,
            in_limbo=in_limbo,
            limbo_countdown=limbo_countdown,
            order_frame=order_frame,
            order_shift=order_shift,
            timeout=timeout,
        )
        return state, EngineStep.make(
            reward=reward,
            terminated=timed_out,
            termination_reason=jnp.int32(TerminationReason.TERMINATED),
            discount=jnp.float32(0.0),
        )

    # ------------------------------------------------------------- observe

    def board(self, state: TMazeState):
        """Render the end-of-frame board: every curtain current, z-order
        '*#ltrQP' (``t_maze.py:211``)."""
        world = self.world
        origin = state.corner + state.roll
        board = jnp.full((self.h, self.w), ord(" "), jnp.uint8)
        board = jnp.where(
            world.window_dynamic(state.speckle, origin),
            jnp.uint8(ord("*")),
            board,
        )
        board = jnp.where(
            world.window("#", origin), jnp.uint8(ord("#")), board
        )
        board = jnp.where(
            world.window("l", origin), jnp.uint8(ord("l")), board
        )
        board = jnp.where(
            world.window("t", origin) & (state.teleport_delay <= 0),
            jnp.uint8(ord("t")),
            board,
        )
        board = jnp.where(
            world.window("r", origin), jnp.uint8(ord("r")), board
        )
        board = jnp.where(
            self._cue_mask(state.which_goal, state.cue_cleared),
            jnp.uint8(ord("Q")),
            board,
        )
        on_board = (
            (state.vpos[0] >= 0) & (state.vpos[0] < self.h)
            & (state.vpos[1] >= 0) & (state.vpos[1] < self.w)
        )
        row = jnp.clip(state.vpos[0], 0, self.h - 1)
        col = jnp.clip(state.vpos[1], 0, self.w - 1)
        return jnp.where(
            on_board
            & (jnp.arange(self.h)[:, None] == row)
            & (jnp.arange(self.w)[None, :] == col),
            jnp.uint8(ord("P")),
            board,
        )

    def observe(self, state: TMazeState) -> dict:
        board = self.board(state)
        repainted = repaint(board, jnp.asarray(self._repainter))
        return {
            "board": value_map(repainted, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(repainted, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
