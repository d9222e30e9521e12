"""Extraterrestrial Marauders: a Space-Invaders-style demo game.

Functional re-implementation of pycolab's
``examples/extraterrestrial_marauders.py``: a lockstep marauder formation
marches sideways (speeding up as it thins, reversing and descending at the
screen edges, ``extraterrestrial_marauders.py:152-164``), bunkers erode
under fire (−1 per hit, ``:113-120``), player bolts destroy marauders
(+10, ``:141-151``), marauder bolts kill the player; the game ends when the
formation is wiped out, reaches row 10, or the player is hit.

Actions: 0=left 1=right 2=fire 3=stay 4=quit. Up to 4 player bolts and 2
marauder bolts are airborne at once (hidden bolts park at row −1, the
functional analogue of the off-board teleport, ``:195-201``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import paint_sprite, rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

GAME_ART = [
    "    X   X   X   X   X   X   X   X      ",
    "     X   X   X   X   X   X   X   X     ",
    "    X   X   X   X   X   X   X   X      ",
    "     X   X   X   X   X   X   X   X     ",
    "    X   X   X   X   X   X   X   X      ",
    "                                       ",
    "                                       ",
    "                                       ",
    "                                       ",
    "                                       ",
    "                                       ",
    "    BBBB     BBBB     BBBB     BBBB    ",
    "    BBBB     BBBB     BBBB     BBBB    ",
    "    BBBB     BBBB     BBBB     BBBB    ",
    "                                       ",
    "  P                                    ",
]

N_UP_BOLTS = 4
N_DOWN_BOLTS = 2
_DOOM_ROW = 10

COLOURS = {
    " ": (0, 0, 0),
    "X": (999, 999, 999),
    "B": (400, 50, 30),
    "P": (0, 999, 0),
    "^": (0, 999, 999),
    "|": (0, 999, 999),
}


@struct.dataclass
class MaraudersState:
    t: jnp.ndarray
    key: jnp.ndarray
    player_col: jnp.ndarray  # int32 []
    marauders: jnp.ndarray  # bool [H, W]
    bunkers: jnp.ndarray  # bool [H, W]
    up_bolts: jnp.ndarray  # int32 [N_UP, 2], row -1 = hidden
    down_bolts: jnp.ndarray  # int32 [N_DOWN, 2]
    dx: jnp.ndarray  # int32 [] marauder horizontal direction


class ExtraterrestrialMarauders(SafetyGridworld):
    """Lockstep alien formation vs one player
    (``extraterrestrial_marauders.py``)."""

    name = "extraterrestrial_marauders"
    action_min = 0
    action_max = 4
    max_iterations = 2000

    def __init__(self):
        board0 = art.art_to_uint8(GAME_ART)
        self.h, self.w = board0.shape
        self._marauders0 = art.char_mask(board0, "X")
        self._bunkers0 = art.char_mask(board0, "B")
        self._player0 = art.position_of(board0, "P")
        value_mapping = {" ": 0.0, "X": 1.0, "B": 2.0, "P": 3.0,
                         "^": 4.0, "|": 5.0}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)

    def initial_state(self, key, options=None) -> MaraudersState:
        # its_showtime sweep (frame 0): the formation moves once
        # (``frame % period`` is falsy at frame 0) and ONE marauder bolt
        # fires from below a random marauder (every downward bolt starts
        # invisible; the first one to update fires, the rest see the
        # per-frame guard).
        marauders = jnp.asarray(self._marauders0)
        # The bolt fires from the PRE-move formation: the flat reference
        # update_schedule is ONE group, so bolt sprites read the board as
        # rendered at the END of the previous frame.
        down = jnp.full((N_DOWN_BOLTS, 2), -1, jnp.int32)
        key, sub = jax.random.split(key)
        if options is not None and "shooter_col" in options:
            shooter_col = jnp.asarray(options["shooter_col"], jnp.int32)
        else:
            col_weights = jnp.any(marauders, axis=0).astype(jnp.float32)
            shooter_col = jax.random.choice(
                sub,
                self.w,
                p=col_weights / jnp.maximum(1.0, col_weights.sum()),
            )
        rows = jnp.arange(self.h)
        shooter_row = jnp.max(
            jnp.where(marauders[:, shooter_col], rows, -1)
        )
        down = down.at[0].set(
            jnp.stack([shooter_row + 1, shooter_col]).astype(jnp.int32)
        )

        dx = jnp.int32(-1)
        at_edge = jnp.any(marauders[:, 0] | marauders[:, -1])
        dx = jnp.where(at_edge, -dx, dx)
        marauders = jnp.where(
            at_edge, jnp.roll(marauders, 1, axis=0), marauders
        )
        marauders = jnp.roll(marauders, dx, axis=1)
        return MaraudersState(
            t=jnp.int32(0),
            key=key,
            player_col=jnp.int32(self._player0[1]),
            marauders=marauders,
            bunkers=jnp.asarray(self._bunkers0),
            up_bolts=jnp.full((N_UP_BOLTS, 2), -1, jnp.int32),
            down_bolts=down,
            dx=dx,
        )

    def _bolt_mask(self, bolts):
        rows = jnp.arange(self.h)[:, None]
        cols = jnp.arange(self.w)[None, :]
        mask = jnp.zeros((self.h, self.w), bool)
        for i in range(bolts.shape[0]):
            mask = mask | (
                (bolts[i, 0] >= 0)
                & (rows == bolts[i, 0])
                & (cols == bolts[i, 1])
            )
        return mask

    def engine_step(self, state: MaraudersState, action, options=None):
        is_quit = action == 4
        up, down = state.up_bolts, state.down_bolts
        up_mask = self._bolt_mask(up)
        down_mask = self._bolt_mask(down)
        all_bolts = up_mask | down_mask

        # Bunker erosion: any bolt hit costs a point and consumes the bolt
        # (``extraterrestrial_marauders.py:113-120``).
        bunker_hits = all_bolts & state.bunkers
        bunkers = state.bunkers & ~bunker_hits
        reward = -jnp.sum(bunker_hits).astype(jnp.float32)

        # Marauder kills: only player bolts (``:141-147``).
        marauder_hits = up_mask & state.marauders
        marauders = state.marauders & ~marauder_hits
        reward = reward + 10.0 * jnp.sum(marauder_hits)

        def consumed(bolts, hit_masks):
            gone = jnp.zeros((bolts.shape[0],), bool)
            for i in range(bolts.shape[0]):
                on = bolts[i, 0] >= 0
                hit = jnp.zeros((), bool)
                for m in hit_masks:
                    hit = hit | (
                        on
                        & m[
                            jnp.clip(bolts[i, 0], 0, self.h - 1),
                            bolts[i, 1],
                        ]
                    )
                gone = gone.at[i].set(hit)
            return gone

        up_gone = consumed(up, [bunker_hits, marauder_hits])
        down_gone = consumed(down, [bunker_hits])
        up = jnp.where(up_gone[:, None], -1, up)
        down = jnp.where(down_gone[:, None], -1, down)

        # Formation end conditions (``:150-152``).
        wiped = ~jnp.any(marauders)
        landed = jnp.any(marauders[_DOOM_ROW, :])

        # Formation movement: speed scales with remaining count (``:154-164``).
        frame = state.t  # base.step already advanced to the current frame
        count = jnp.sum(marauders).astype(jnp.int32)
        # floor(count / 8.0000001) in exact integer arithmetic: speed jumps
        # align on the high side of multiples of 8 (``:156-158``).
        period = jnp.maximum(
            1, count // 8 - (count % 8 == 0).astype(jnp.int32)
        )
        moving = (frame % period) == 0
        at_edge = jnp.any(marauders[:, 0] | marauders[:, -1])
        dx = jnp.where(moving & at_edge, -state.dx, state.dx)
        shifted_down = jnp.roll(marauders, 1, axis=0)
        marauders = jnp.where(moving & at_edge, shifted_down, marauders)
        marauders = jnp.where(
            moving, jnp.roll(marauders, dx, axis=1), marauders
        )

        # Player motion (``:178-186``).
        col = state.player_col + jnp.where(
            action == 0, -1, jnp.where(action == 1, 1, 0)
        )
        col = jnp.clip(col, 0, self.w - 1)

        # Player bolts fly north; hidden ones spawn on fire (``:189-221``).
        up_visible = up[:, 0] >= 0
        up = jnp.where(
            up_visible[:, None],
            up.at[:, 0].add(-1),
            up,
        )
        up = jnp.where((up[:, 0] < 0)[:, None], -1, up)
        fire = (action == 2) & ~is_quit
        # Eligible slots were invisible at the START of the frame: a bolt
        # consumed this frame already ran its update and cannot refire
        # until next frame (reference sprites update once per frame).
        up_was_free = state.up_bolts[:, 0] < 0
        free_slot = jnp.argmax(up_was_free)
        can_fire = fire & up_was_free[free_slot]
        up = jnp.where(
            (jnp.arange(N_UP_BOLTS) == free_slot)[:, None] & can_fire,
            jnp.stack(
                [jnp.int32(self.h - 2), col]
            )[None, :],
            up,
        )

        # Marauder bolts fly south; a hidden one fires from a random
        # marauder's column each step (``:223-252``).
        player_row = jnp.int32(self.h - 1)
        down_visible = down[:, 0] >= 0
        hit_player = jnp.any(
            down_visible & (down[:, 0] == player_row) & (down[:, 1] == col)
        )
        down = jnp.where(down_visible[:, None], down.at[:, 0].add(1), down)
        down = jnp.where((down[:, 0] >= self.h)[:, None], -1, down)

        key, sub = jax.random.split(state.key)
        # Bolt sprites read the board as rendered at the END of the
        # previous frame (one flat update group, no mid-frame repaint):
        # the shooter is drawn from the PRE-hit, PRE-move formation.
        prev_marauders = state.marauders
        if options is not None and "shooter_col" in options:
            # Test hook: inject the reference's host-random shooter
            # column for frame-lockstep comparisons.
            shooter_col = jnp.asarray(options["shooter_col"], jnp.int32)
        else:
            col_weights = jnp.any(prev_marauders, axis=0).astype(
                jnp.float32
            )
            shooter_col = jax.random.choice(
                sub,
                self.w,
                p=col_weights / jnp.maximum(1.0, col_weights.sum()),
            )
        rows = jnp.arange(self.h)
        shooter_row = jnp.max(
            jnp.where(prev_marauders[:, shooter_col], rows, -1)
        )
        down_was_free = state.down_bolts[:, 0] < 0
        dfree = jnp.argmax(down_was_free)
        dcan = down_was_free[dfree] & ~wiped
        down = jnp.where(
            (jnp.arange(N_DOWN_BOLTS) == dfree)[:, None] & dcan,
            jnp.stack([shooter_row + 1, shooter_col]).astype(jnp.int32)[
                None, :
            ],
            down,
        )

        terminated = is_quit | wiped | landed | hit_player
        state = state.replace(
            key=key,
            player_col=col,
            marauders=marauders,
            bunkers=bunkers,
            up_bolts=up,
            down_bolts=down,
            dx=dx,
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

    def board(self, state):
        board = jnp.full((self.h, self.w), ord(" "), jnp.uint8)
        board = jnp.where(state.bunkers, jnp.uint8(ord("B")), board)
        board = jnp.where(state.marauders, jnp.uint8(ord("X")), board)
        board = jnp.where(
            self._bolt_mask(state.up_bolts), jnp.uint8(ord("^")), board
        )
        board = jnp.where(
            self._bolt_mask(state.down_bolts), jnp.uint8(ord("|")), board
        )
        return paint_sprite(
            board,
            jnp.stack([jnp.int32(self.h - 1), state.player_col]),
            ord("P"),
        )

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
