"""Tennnnnnnnnnnnnnnnnnnnnnnnis: two paddles, one very long corridor.

Functional re-implementation of pycolab's
``examples/tennnnnnnnnnnnnnnnnnnnnnnnis.py``: a ball bounces between two
paddles down a 223-column court; paddle hits re-draw the vertical bounce
cadence (``random.randrange(1, 6)``) and direction (``random.choice``)
(``tennnnn...is.py:113-117``); wall hits score a point for the opponent as a
2-vector reward (``:126-133``); first to four points ends the match. Paddles
"blink" at 2 Hz once the ball is past them, which makes them intangible on
odd frames (``:152-160``) — a faithful quirk.

Actions: int32 [2] per-paddle (0=stay 1=up 2=down, 3=quit); rewards are
length-2 vectors (player 1, player 2). Views are the reference's three
croppers (:func:`make_croppers`).
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

# The court (reference MAZE_ART, ``tennnnn...is.py:39-50``).
MAZE_ART = [
    '%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%',
    '%                   ##                                               # ###   # ###                                                                ###    ###                                              #             %',
    '%   1          #####                                         # ###   ##   #  ##   #  # ###                                                 ###   #      #       ###                                      #              %',
    '%   1   @     #   #    ###                           # ###   ##   #  #    #  #    #  ##   #  # ###                            #     ###   #       #      #     #       ###                               #              %',
    '%                 #   #   #                  # ###   ##   #  #    # #    #  #    #   #    #  ##   #  # ###                         #       #   ###    ###       #     #       ###                  ###  #               %',
    '%                 #  #####   # ###   # ###   ##   #  #    # #    #                  #    #   #    #  ##   #  # ###   # ###    #     #   ###                  ###       #     #       ###    ###   #                     %',
    '%                #   #       ##   #  ##   #  #    # #    #                                  #    #   #    #  ##   #  ##   #   #  ###                                ###       #     #      #       #   #            2   %',
    '%                     ####   #    #  #    # #    #                                                  #    #   #    #  #    #  #                                             ###       #      #   ###                 2   %',
    '%                           #    #  #    #                                                                  #    #  #    #                                                        ###    ###                            %',
    '%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%',
]

COLOUR_FG = {
    " ": (0, 0, 0),
    "%": (82, 383, 86),
    "#": (123, 574, 129),
    "1": (999, 999, 999),
    "2": (999, 999, 999),
    "@": (787, 999, 227),
}

STAY, UP, DOWN, QUIT = 0, 1, 2, 3


@struct.dataclass
class TennisState:
    t: jnp.ndarray
    key: jnp.ndarray
    ball: jnp.ndarray  # int32 [2]
    dy: jnp.ndarray  # int32 []
    dx: jnp.ndarray  # int32 []
    modulus: jnp.ndarray  # int32 [] vertical-shift cadence
    score: jnp.ndarray  # int32 [2]
    paddle_tops: jnp.ndarray  # int32 [2]
    blink_col: jnp.ndarray  # int32 [] pre-move ball col (paddle repaint)


class Tennis(SafetyGridworld):
    """The long-corridor tennis demo (``tennnnnnnnnnnnnnnnnnnnnnnnis.py``)."""

    name = "tennis"
    action_min = 0
    action_max = 3
    max_iterations = 10_000

    def __init__(self):
        board0 = art.art_to_uint8(MAZE_ART)
        self.h, self.w = board0.shape
        self._backdrop = art.replace_chars(board0, "12@", " ")
        self._wall = art.char_mask(board0, "%")
        self._ball0 = art.position_of(board0, "@")
        p1 = np.argwhere(board0 == np.uint8(ord("1")))
        p2 = np.argwhere(board0 == np.uint8(ord("2")))
        self._paddle_cols = np.array(
            [p1[:, 1].min(), p2[:, 1].min()], np.int32
        )
        self._paddle_tops0 = np.array(
            [p1[:, 0].min(), p2[:, 0].min()], np.int32
        )
        value_mapping = {c: float(i) for i, c in enumerate(" %#12@")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOUR_FG)

    def zero_reward(self):
        return jnp.zeros((2,), jnp.float32)

    # ------------------------------------------------------------- helpers

    def _paddle_visible(self, k, paddle_col, ball_col, frame):
        """The blink rule (``tennnnn...is.py:152-160``): once the ball is
        past a paddle it is only painted on even frames."""
        past = jnp.where(
            k == 0, ball_col <= paddle_col, ball_col >= paddle_col
        )
        return ~past | (frame % 2 == 0)

    def _ball_update(self, state, frame, draws=None):
        """One BallSprite update (``tennnnn...is.py:100-140``). ``draws`` may
        inject (modulus, dy) for host parity; the device path draws from the
        state key. Returns (ball, dy, dx, modulus, reward2, key)."""
        row, col = state.ball[0], state.ball[1]
        dy = jnp.where(row == 1, 1, jnp.where(row == 8, -1, state.dy))
        row = jnp.where(frame % state.modulus == 0, row + dy, row)
        col = col + state.dx

        # Paddle curtains for the hit test use this frame's paddle state
        # (paddles update before the ball in the schedule ['1','2','@']).
        tops = state.paddle_tops
        cols = jnp.asarray(self._paddle_cols)

        def paddle_hit(k, test_col):
            on_rows = (row >= tops[k]) & (row < tops[k] + 2)
            visible = self._paddle_visible(
                k, cols[k], state.ball[1], frame
            )
            return (test_col == cols[k]) & on_rows & visible

        hit1 = paddle_hit(0, col - 1)
        hit2 = paddle_hit(1, col + 1)
        wall = jnp.asarray(self._wall)
        wl = wall[jnp.clip(row, 0, self.h - 1), jnp.clip(col - 1, 0, self.w - 1)]
        wr = wall[jnp.clip(row, 0, self.h - 1), jnp.clip(col + 1, 0, self.w - 1)]
        wall1 = ~hit1 & ~hit2 & wl
        wall2 = ~hit1 & ~hit2 & ~wl & wr
        bounce = hit1 | hit2 | wall1 | wall2

        if draws is not None:
            new_mod, new_dy = draws
            key = state.key
        else:
            key, k1, k2 = jax.random.split(state.key, 3)
            new_mod = jax.random.randint(k1, (), 1, 6)
            new_dy = jax.random.choice(k2, jnp.asarray([-1, 1]))
        modulus = jnp.where(bounce, new_mod, state.modulus)
        dy = jnp.where(bounce, new_dy, dy)
        dx = jnp.where(
            hit1 | wall1, 1, jnp.where(hit2 | wall2, -1, state.dx)
        )
        reward = jnp.stack(
            [wall2.astype(jnp.float32), wall1.astype(jnp.float32)]
        )
        return jnp.stack([row, col]), dy, dx, modulus, reward, key

    # -------------------------------------------------------------- resets

    def initial_state(self, key, options=None) -> TennisState:
        # ``its_showtime`` runs one sweep at frame 0: paddles repaint (no
        # motion for STAY) and the ball moves once (dx=-1, dy=0, modulus=1).
        state = TennisState(
            t=jnp.int32(0),
            key=key,
            ball=jnp.asarray(self._ball0),
            dy=jnp.int32(0),
            dx=jnp.int32(-1),
            modulus=jnp.int32(1),
            score=jnp.zeros((2,), jnp.int32),
            paddle_tops=jnp.asarray(self._paddle_tops0),
            blink_col=jnp.int32(self._ball0[1]),
        )
        ball, dy, dx, modulus, _, key = self._ball_update(
            state, jnp.int32(0), draws=(jnp.int32(1), jnp.int32(0))
        )
        return state.replace(ball=ball, dy=dy, dx=dx, modulus=modulus, key=key)

    def host_step_options(self, state, action) -> dict:
        """Pre-draw the bounce randomness exactly as the reference consumes
        the ``random`` module (``tennnnn...is.py:113-117``)."""
        import random

        # Simulate the deterministic prefix to know whether a bounce occurs.
        actions = np.asarray(action).reshape(-1)
        tops = np.asarray(state.paddle_tops).copy()
        for k in range(2):
            a = actions[k] if actions.size > 1 else actions[0]
            if a == UP and tops[k] > 1:
                tops[k] -= 1
            elif a == DOWN and tops[k] < 7:
                tops[k] += 1
        sim = state.replace(paddle_tops=jnp.asarray(tops))
        frame = int(np.asarray(state.t)) + 1
        ball, dy, dx, modulus, reward, _ = jax.tree.map(
            np.asarray,
            self._ball_update(
                sim, jnp.int32(frame), draws=(jnp.int32(0), jnp.int32(0))
            ),
        )
        bounced = int(np.asarray(modulus)) == 0  # injected 0 marks a bounce
        if bounced:
            return {
                "modulus": np.int32(random.randrange(1, 6)),
                "dy": np.int32(random.choice([-1, 1])),
            }
        return {}

    # ---------------------------------------------------------------- step

    def engine_step(self, state: TennisState, action, options=None):
        action = jnp.asarray(action, jnp.int32).reshape(-1)
        a1 = action[0]
        a2 = action[1] if action.shape[0] > 1 else action[0]
        is_quit = (a1 == QUIT) | (a2 == QUIT)
        frame = state.t

        # --- paddles (schedule ['1', '2', '@']) ----------------------------
        tops = state.paddle_tops
        for k, a in enumerate((a1, a2)):
            up = (a == UP) & (tops[k] > 1)
            down = (a == DOWN) & (tops[k] < 7)
            tops = tops.at[k].add(
                jnp.where(up, -1, jnp.where(down, 1, 0))
            )
        state = state.replace(paddle_tops=tops)

        # --- ball -----------------------------------------------------------
        draws = None
        if options is not None and "modulus" in options:
            draws = (
                jnp.asarray(options["modulus"], jnp.int32),
                jnp.asarray(options["dy"], jnp.int32),
            )
        ball, dy, dx, modulus, reward, key = self._ball_update(
            state, frame, draws=draws
        )
        score = state.score + reward.astype(jnp.int32)
        over = (score >= 4).any() | is_quit

        state = state.replace(
            key=key, ball=ball, dy=dy, dx=dx, modulus=modulus, score=score,
            blink_col=state.ball[1],
        )
        return state, EngineStep.make(
            reward=reward,
            terminated=over,
            termination_reason=jnp.where(
                is_quit,
                jnp.int32(TerminationReason.QUIT),
                jnp.int32(TerminationReason.TERMINATED),
            ),
            discount=jnp.float32(0.0),
        )

    # ------------------------------------------------------------- observe

    def board(self, state: TennisState):
        board = jnp.asarray(self._backdrop)
        cols = jnp.asarray(self._paddle_cols)
        rows = jnp.arange(self.h, dtype=jnp.int32)[:, None]
        colg = jnp.arange(self.w, dtype=jnp.int32)[None, :]
        frame = state.t
        for k, c in ((0, ord("1")), (1, ord("2"))):
            visible = self._paddle_visible(
                k, cols[k], state.blink_col, frame
            )
            mask = (
                (colg == cols[k])
                & (rows >= state.paddle_tops[k])
                & (rows < state.paddle_tops[k] + 2)
                & visible
            )
            board = jnp.where(mask, jnp.uint8(c), board)
        return paint_sprite(board, state.ball, ord("@"))

    def observe(self, state: TennisState) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }

    def make_croppers(self):
        """The reference's three views (``tennnnn...is.py:85-99``): player 1
        window, ball-tracking window, player 2 window."""
        return [
            FixedCropper((0, 0), rows=10, cols=10),
            ScrollingCropper(rows=10, cols=31, scroll_margins=(0, None)),
            FixedCropper((0, self.w - 10), rows=10, cols=10),
        ]
