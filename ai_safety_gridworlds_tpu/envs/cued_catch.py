"""Cued Catch: a long-term-memory association demo game.

Functional re-implementation of pycolab's
``examples/research/lp-rnn/cued_catch.py``: a "programming" phase shows
each of four cues paired with a ball symbol (top/bottom); in the trial
phase, balls approach the player and only the cue is shown — the player
must remember which ball each cue was paired with and position itself on
the correct row (+1 per caught correct ball). Supports the paper's control
and robustness flags: ``always_show_ball_symbol`` (no memory needed),
``reward_sigma`` (noisy rewards), ``reward_free_trials`` (no reward for the
first K trials, ``cued_catch.py:116-168``).

Actions: 1=up 2=down 3=stay; 0/4 quit (``cued_catch.py:137-145``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

H, W = 7, 12
PLAYER_COL = 3
BALL_COL = 8
NUM_CUES = 4

COLOURS = {
    " ": (0, 0, 0),
    "P": (999, 999, 999),
    "Q": (0, 999, 0),
    "a": (999, 999, 0),
    "b": (0, 999, 999),
}

VALUE_MAPPING = {" ": 0.0, "Q": 1.0, "a": 2.0, "b": 3.0, "P": 4.0}


@struct.dataclass
class CuedCatchState:
    t: jnp.ndarray
    key: jnp.ndarray
    player_row: jnp.ndarray  # int32 [] 1 or 2
    cues_to_balls: jnp.ndarray  # int32 [NUM_CUES] 0=top 1=bottom
    phase_tick: jnp.ndarray  # int32 [] steps left in the programming phase
    ball_col: jnp.ndarray  # int32 [] current ball column (trial phase)
    cue_choice: jnp.ndarray  # int32 [] current trial's cue
    cue_tick: jnp.ndarray  # int32 [] steps the cue stays visible
    trials_left: jnp.ndarray  # int32 []
    trials_till_reward: jnp.ndarray  # int32 []


class CuedCatch(SafetyGridworld):
    """Remember cue->ball pairings across trials (``cued_catch.py``)."""

    name = "cued_catch"
    action_min = 0
    action_max = 4

    def __init__(
        self,
        initial_cue_duration=10,
        cue_duration=10,
        num_trials=100,
        always_show_ball_symbol=False,
        reward_sigma=0.0,
        reward_free_trials=0,
    ):
        self.initial_cue_duration = initial_cue_duration
        self.cue_duration = cue_duration
        self.num_trials = num_trials
        self.always_show_ball_symbol = always_show_ball_symbol
        self.reward_sigma = reward_sigma
        self.reward_free_trials = reward_free_trials
        self.max_iterations = (
            NUM_CUES * initial_cue_duration
            + (num_trials + 2) * (W - PLAYER_COL)
            + 10_000
        )
        from ai_safety_gridworlds_tpu.core import art as _art

        self._value_lut = _art.char_lut(VALUE_MAPPING)
        self._rgb_lut = _art.rgb_lut_from_colours(COLOURS)

    def initial_state(self, key, options=None) -> CuedCatchState:
        key, k1, k2 = jax.random.split(key, 3)
        # Half the cues map to the top ball, half to the bottom, shuffled
        # (``cued_catch.py:235-238``).
        base = jnp.asarray(
            [0] * (NUM_CUES // 2) + [1] * (NUM_CUES // 2), jnp.int32
        )
        if options is not None and "cues_to_balls" in options:
            # Test hook: the reference draws this mapping from host
            # ``random.sample`` — injectable for lockstep comparisons.
            cues_to_balls = jnp.asarray(
                options["cues_to_balls"], jnp.int32
            )
        else:
            cues_to_balls = jax.random.permutation(k1, base)
        return CuedCatchState(
            t=jnp.int32(0),
            key=key,
            player_row=jnp.int32(1),
            cues_to_balls=cues_to_balls,
            # its_showtime already ran one CueDrape tick (the reference
            # decrements _first_phase_tick at frame 0).
            phase_tick=jnp.int32(
                NUM_CUES * self.initial_cue_duration - 1
            ),
            ball_col=jnp.int32(BALL_COL),
            cue_choice=jnp.int32(-1),
            cue_tick=jnp.int32(-1),
            trials_left=jnp.int32(self.num_trials),
            trials_till_reward=jnp.int32(self.reward_free_trials),
        )

    def engine_step(self, state: CuedCatchState, action, options=None):
        is_quit = (action == 0) | (action == 4)

        # Player: constrained vertical motion (``cued_catch.py:137-145``).
        row = state.player_row
        row = jnp.where((action == 1) & (row > 1), row - 1, row)
        row = jnp.where((action == 2) & (row < 2), row + 1, row)

        # The reference completes the programming phase on the frame its
        # tick REACHES zero (checked post-decrement): that frame already
        # runs the first trial reset.
        phase_tick = state.phase_tick - 1  # may go negative (trial phase)
        in_programming = phase_tick > 0

        # Trial phase: balls march left; passing the player column resets
        # them and starts a new trial with a fresh random cue.
        key = state.key
        ball_col = state.ball_col
        cue_choice = state.cue_choice
        cue_tick = state.cue_tick
        trials_left = state.trials_left
        terminated = is_quit

        ball_col = jnp.where(
            in_programming, ball_col, ball_col - 1
        )
        # The ball sprite resets when its PRE-move column is already past
        # the player (it checks before marching), one frame after the
        # march that crossed the line.
        reset_trial = (~in_programming) & (
            (state.ball_col < PLAYER_COL) | (state.cue_choice < 0)
        )
        key, sub = jax.random.split(key)
        if options is not None and "cue_choice" in options:
            # Test hook: inject the reference's host-random trial cue for
            # frame-lockstep comparisons.
            new_cue = jnp.asarray(options["cue_choice"], jnp.int32)
        else:
            new_cue = jax.random.randint(
                sub, (), 0, NUM_CUES, dtype=jnp.int32
            )
        cue_choice = jnp.where(reset_trial, new_cue, cue_choice)
        # Stored post-decrement, like the reference (which shows the cue
        # then decrements — EXCEPT on the phase-completion reset, which
        # happens in the first-phase handler with no decrement): visible
        # while the stored value is >= 0.
        cue_tick = jnp.where(
            reset_trial,
            jnp.where(
                state.cue_choice < 0,
                jnp.int32(self.cue_duration),
                jnp.int32(self.cue_duration - 1),
            ),
            cue_tick - 1,
        )
        ball_col = jnp.where(reset_trial, jnp.int32(BALL_COL), ball_col)
        # Running out of trials ends the episode (``cued_catch.py:291-293``).
        terminated = terminated | (reset_trial & (trials_left <= 0))
        trials_left = jnp.where(reset_trial, trials_left - 1, trials_left)

        # Catch reward: the player updates FIRST in the reference
        # schedule, so the check compares the post-move player against
        # the ball's PRE-move cell and the PREVIOUS trial cue — a catch
        # registers on the frame after the visual overlap.
        which_ball = state.cues_to_balls[
            jnp.clip(state.cue_choice, 0, NUM_CUES - 1)
        ]
        correct_row = 1 + which_ball  # top ball row 1, bottom row 2
        prev_in_programming = state.phase_tick > 0
        caught = (
            (~prev_in_programming)
            & (state.cue_choice >= 0)
            & (state.ball_col == PLAYER_COL)
            & (row == correct_row)
        )
        rewardable = state.trials_till_reward <= 0
        reward = (caught & rewardable).astype(jnp.float32)
        if self.reward_sigma:
            key, nk = jax.random.split(key)
            noise = self.reward_sigma * jax.random.normal(nk, ())
            on_col = (~prev_in_programming) & (
                state.ball_col == PLAYER_COL
            )
            reward = jnp.where(
                on_col & rewardable, reward + noise, jnp.float32(0.0)
            )
        trials_till_reward = jnp.where(
            (~prev_in_programming)
            & (state.ball_col == PLAYER_COL)
            & (state.trials_till_reward > 0),
            state.trials_till_reward - 1,
            state.trials_till_reward,
        )

        state = state.replace(
            key=key,
            player_row=row,
            phase_tick=phase_tick,
            ball_col=ball_col,
            cue_choice=cue_choice,
            cue_tick=cue_tick,
            trials_left=trials_left,
            trials_till_reward=trials_till_reward,
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

    # ------------------------------------------------------------- observe

    def board(self, state: CuedCatchState):
        rows = jnp.arange(H)[:, None]
        cols = jnp.arange(W)[None, :]
        board = jnp.full((H, W), ord(" "), jnp.uint8)

        # Display convention: the COMPLETION frame (stored tick == 0)
        # still shows first-phase visuals — the reference drape draws the
        # phase cue before transitioning; balls appear the next frame.
        in_programming = state.phase_tick >= 0
        q = jnp.zeros((H, W), bool)
        # Phase cue: corner blocks during programming (``:296-301``).
        corner = ((rows >= 1) & (rows < 3)) & ((cols < 2) | (cols >= W - 2))
        q = q | (corner & in_programming)
        # Programming phase: current cue + its ball symbol (``:258-264``).
        prog_cue = jnp.clip(
            state.phase_tick // self.initial_cue_duration,
            0,
            NUM_CUES - 1,
        )
        shown_cue = jnp.where(in_programming, prog_cue, state.cue_choice)
        cue_visible = in_programming | (state.cue_tick >= 0)
        width = W // NUM_CUES
        cue_band = (
            (rows >= H - 2)
            & (cols >= shown_cue * width)
            & (cols < (shown_cue + 1) * width)
        )
        q = q | (cue_band & cue_visible & (shown_cue >= 0))
        # Ball symbol rows 3:5 (``:303-308``).
        ball_for_symbol = state.cues_to_balls[
            jnp.clip(shown_cue, 0, NUM_CUES - 1)
        ]
        show_symbol = in_programming | (
            jnp.asarray(self.always_show_ball_symbol) & (state.cue_tick >= 0)
        )
        symbol_band = (
            (rows >= 3)
            & (rows < 5)
            & jnp.where(ball_for_symbol == 0, cols < 6, cols >= W - 6)
        )
        q = q | (symbol_band & show_symbol & (shown_cue >= 0))
        board = jnp.where(q, jnp.uint8(ord("Q")), board)

        # Player under the balls: the reference declares 'P' first, so
        # the balls draw on top when they share a cell.
        board = board.at[state.player_row, PLAYER_COL].set(ord("P"))
        # Balls (trial phase only, ``:189-200``).
        balls_visible = ~in_programming
        col = jnp.clip(state.ball_col, 0, W - 1)
        board = jnp.where(
            balls_visible & (rows == 1) & (cols == col),
            jnp.uint8(ord("a")),
            board,
        )
        board = jnp.where(
            balls_visible & (rows == 2) & (cols == col),
            jnp.uint8(ord("b")),
            board,
        )
        return board

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
