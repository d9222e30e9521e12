"""Apprehend: a Catch-style falling-ball demo game.

Functional re-implementation of pycolab's ``examples/apprehend.py``: a ball
falls from the top row toward a random landing column (fractional horizontal
velocity in (-2.499, 2.499)/(rows-1), accumulated with ±0.5 hysteresis,
``apprehend.py:101-123``); the player moves left/right along the bottom row.
Catching the ball pays +1 and ends the game; the ball passing the bottom row
pays −1 (``apprehend.py:84-86,128-131``).

Demonstrates per-episode device randomness (the velocity is drawn from the
state PRNG at reset), off-board "virtual" sprite rows, and the character
repainter (player and ball render identically as 'X', ``REPAINT_MAPPING``).

Actions: 0=left 1=right 2=stay.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import (
    char_repainter_lut,
    paint_sprite,
    repaint,
    rgb_map,
    value_map,
)
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

GAME_ART = [
    "   b   ",
    "       ",
    "       ",
    "       ",
    "       ",
    "       ",
    "       ",
    "       ",
    "       ",
    "   P   ",
]

PLAYER_CHR = "P"
BALL_CHR = "b"
REPAINT_MAPPING = {"b": "X", "P": "X"}

COLOURS = {" ": (0, 0, 0), "X": (999, 999, 999),
           "P": (999, 999, 999), "b": (999, 999, 999)}


@struct.dataclass
class ApprehendState:
    t: jnp.ndarray
    key: jnp.ndarray
    player_col: jnp.ndarray  # int32 []
    ball: jnp.ndarray  # int32 [2] (row may exceed the board: virtual)
    dx: jnp.ndarray  # f32 [] per-row horizontal velocity
    x_acc: jnp.ndarray  # f32 [] hysteresis accumulator


class Apprehend(SafetyGridworld):
    """Falling-ball catch game (``apprehend.py``)."""

    name = "apprehend"
    action_min = 0
    action_max = 2
    max_iterations = 100

    def __init__(self):
        board0 = art.art_to_uint8(GAME_ART)
        self.h, self.w = board0.shape
        self._player0 = art.position_of(board0, PLAYER_CHR)
        self._ball0 = art.position_of(board0, BALL_CHR)
        value_mapping = {" ": 0.0, BALL_CHR: 1.0, PLAYER_CHR: 1.0}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)
        self._repainter = char_repainter_lut(REPAINT_MAPPING)

    def initial_state(self, key, options=None) -> ApprehendState:
        key, sub = jax.random.split(key)
        if options is not None and "dx" in options:
            # Test hook: inject the reference sprite's host-random
            # velocity for frame-lockstep comparisons.
            dx = jnp.asarray(options["dx"], jnp.float32)
        else:
            dx = jax.random.uniform(
                sub, (), minval=-2.499, maxval=2.499
            ) / (self.h - 1.0)
        # ``its_showtime`` runs one update sweep before the first
        # observation (``engine.py``): the ball falls a row (with its
        # horizontal hysteresis step) and the player stays put.
        acc = dx
        shift = jnp.where(acc < -0.5, -1, jnp.where(acc > 0.5, 1, 0))
        acc = acc - shift
        ball = jnp.stack(
            [
                jnp.int32(self._ball0[0] + 1),
                jnp.clip(
                    jnp.int32(self._ball0[1]) + shift, 0, self.w - 1
                ),
            ]
        )
        return ApprehendState(
            t=jnp.int32(0),
            key=key,
            player_col=jnp.int32(self._player0[1]),
            ball=ball,
            dx=dx,
            x_acc=jnp.asarray(acc, jnp.float32),
        )

    def engine_step(self, state: ApprehendState, action, options=None):
        # Player slides along the bottom row, confined to the board.
        col = state.player_col + jnp.where(
            action == 0, -1, jnp.where(action == 1, 1, 0)
        )
        col = jnp.clip(col, 0, self.w - 1)

        # Caught before the ball moves? (player updates first in the
        # reference schedule ['b', 'P']... actually ball first: schedule is
        # ['b', 'P'] so the ball falls, then the player moves and checks.)
        ball_row = state.ball[0] + 1  # always falling
        acc = state.x_acc + state.dx
        shift = jnp.where(acc < -0.5, -1, jnp.where(acc > 0.5, 1, 0))
        acc = acc - shift
        ball_col = jnp.clip(state.ball[1] + shift, 0, self.w - 1)

        caught = (ball_row == self.h - 1) & (ball_col == col)
        lost = ball_row >= self.h
        reward = jnp.where(caught, 1.0, jnp.where(lost, -1.0, 0.0))
        terminated = caught | lost

        state = state.replace(
            player_col=col,
            ball=jnp.stack([ball_row, ball_col]),
            x_acc=acc,
        )
        return state, EngineStep.make(
            jnp.asarray(reward, jnp.float32),
            terminated=terminated,
            termination_reason=jnp.where(
                terminated,
                jnp.int32(TerminationReason.TERMINATED),
                jnp.int32(TerminationReason.NONE),
            ),
            discount=0.0,
            actual_action=action,
        )

    def board(self, state):
        board = jnp.full((self.h, self.w), ord(" "), jnp.uint8)
        on_board = state.ball[0] < self.h
        board = paint_sprite(
            board,
            jnp.stack(
                [jnp.clip(state.ball[0], 0, self.h - 1), state.ball[1]]
            ),
            ord(BALL_CHR),
            visible=on_board,
        )
        return paint_sprite(
            board,
            jnp.stack([jnp.int32(self.h - 1), state.player_col]),
            ord(PLAYER_CHR),
        )

    def observe(self, state) -> dict:
        board = self.board(state)
        # The human view renders player and ball identically ('X').
        repainted = repaint(board, jnp.asarray(self._repainter))
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(repainted, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
