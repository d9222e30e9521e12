"""Shockwave: reach the top while dodging expanding rings of fire.

Functional re-implementation of pycolab's ``examples/shockwave.py``: a
shockwave impact point is drawn uniformly at random whenever the wave has
left the board (``shockwave.py:128-140``); the burning ring is the set of
cells whose euclidean distance from the impact lies in
``(steps, steps + width]``, masked by walls (``shockwave.py:142-146``) — the
reference's ``ndimage.distance_transform_edt`` of a single-point impact map
reduces to a closed-form distance field, so the device step is pure
elementwise math. The player is a confined MazeWalker (impassable '=');
reaching the top safe row pays +1, standing in an exposed cell under fire
pays −1; both end the episode (``shockwave.py:148-161``).

Actions: 0=up 1=left 2=right 3=stay (``shockwave.py:194-199``).
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

LEVELS = [
    [
        "^^^^^^^^^^^^^^^",
        "               ",
        "  +           +",
        "  ==   ++  == +",
        "              +",
        "=======       +",
        " +            +",
        "   +      ++   ",
        "+        ==    ",
        "+        +     ",
        "   =           ",
        " +++ P    ++   ",
    ],
]

COLOURS = {
    "+": (0, 0, 999),
    "P": (0, 999, 0),
    " ": (500, 500, 500),
    "^": (700, 700, 700),
    "=": (999, 600, 200),
    "@": (999, 0, 0),
}

WAVE_WIDTH = 2


@struct.dataclass
class ShockwaveState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2]
    impact: jnp.ndarray  # int32 [2]
    steps_since_impact: jnp.ndarray  # int32 []
    pending: jnp.ndarray  # int32 [] showtime verdict: 0 none, +1 win, -1 dead


class Shockwave(SafetyGridworld):
    """The expanding-ring dodge game (``shockwave.py``)."""

    name = "shockwave"
    action_min = 0
    action_max = 3
    max_iterations = 1000

    def __init__(self, level=0):
        board0 = art.art_to_uint8(LEVELS[level])
        self.h, self.w = board0.shape
        self._pos0 = art.position_of(board0, "P")
        self._backdrop = art.replace_chars(board0, "P", "+")
        self._wall = art.char_mask(board0, "=")
        self._danger = art.char_mask(board0, " ")
        self._safe_top = art.char_mask(board0, "^")
        value_mapping = {c: float(i) for i, c in enumerate("+ ^=@P")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)

    # ------------------------------------------------------------- helpers

    def _distance(self, impact):
        rows = jnp.arange(self.h, dtype=jnp.float32)[:, None]
        cols = jnp.arange(self.w, dtype=jnp.float32)[None, :]
        return jnp.sqrt(
            (rows - impact[0].astype(jnp.float32)) ** 2
            + (cols - impact[1].astype(jnp.float32)) ** 2
        )

    def _curtain(self, impact, steps):
        d = self._distance(impact)
        s = steps.astype(jnp.float32)
        return (d > s) & (d <= s + WAVE_WIDTH) & ~jnp.asarray(self._wall)

    def _wave_verdict(self, pos, curtain):
        """(+1 safe-zone win, −1 burned, 0 continue) for the current frame
        (``shockwave.py:148-161``)."""
        on_safe = jnp.asarray(self._safe_top)[pos[0], pos[1]]
        under_fire = curtain[pos[0], pos[1]]
        in_danger = jnp.asarray(self._danger)[pos[0], pos[1]]
        return jnp.where(
            on_safe, 1, jnp.where(under_fire & in_danger, -1, 0)
        ).astype(jnp.int32)

    # -------------------------------------------------------------- resets

    def host_reset_options(self) -> dict:
        # The first impact is drawn at ``its_showtime`` from the global
        # numpy RNG (``shockwave.py:128-131``).
        idx = np.random.randint(0, self.h * self.w)
        return {"impact": np.array([idx // self.w, idx % self.w], np.int32)}

    def sample_reset_options(self, key) -> dict:
        idx = jax.random.randint(key, (), 0, self.h * self.w)
        return {"impact": jnp.stack([idx // self.w, idx % self.w]).astype(
            jnp.int32
        )}

    def initial_state(self, key, options=None) -> ShockwaveState:
        if options is None or "impact" not in options:
            key, sub = jax.random.split(key)
            options = self.sample_reset_options(sub)
        impact = jnp.asarray(options["impact"], jnp.int32)
        pos = jnp.asarray(self._pos0)
        # The showtime sweep runs the shockwave update once at frame 0:
        # curtain for steps=0 + the safety check, then steps -> 1.
        curtain = self._curtain(impact, jnp.int32(0))
        pending = self._wave_verdict(pos, curtain)
        return ShockwaveState(
            t=jnp.int32(0),
            key=key,
            pos=pos,
            impact=impact,
            steps_since_impact=jnp.int32(1),
            pending=pending,
        )

    def host_step_options(self, state, action) -> dict:
        # A new impact is drawn mid-step when the previous wave has fully
        # left the board (empty curtain).
        # Emptiness is judged on the curtain as LAST RENDERED, i.e. with
        # the pre-increment step count (``shockwave.py:126-128``).
        curtain = np.asarray(
            self._curtain(state.impact, state.steps_since_impact - 1)
        )
        if not curtain.any():
            idx = np.random.randint(0, self.h * self.w)
            return {
                "impact": np.array([idx // self.w, idx % self.w], np.int32)
            }
        return {}

    # ---------------------------------------------------------------- step

    def engine_step(self, state: ShockwaveState, action, options=None):
        # Showtime verdict: the reference episode ends during its_showtime.
        showtime_over = state.pending != 0

        # --- player (update schedule [' ', '^', 'P', '@']) ----------------
        delta = jnp.where(
            action == 0,
            jnp.asarray([-1, 0]),
            jnp.where(
                action == 1,
                jnp.asarray([0, -1]),
                jnp.where(action == 2, jnp.asarray([0, 1]), jnp.asarray([0, 0])),
            ),
        )
        target = state.pos + delta
        tr = jnp.clip(target[0], 0, self.h - 1)
        tc = jnp.clip(target[1], 0, self.w - 1)
        in_bounds = (
            (target[0] >= 0)
            & (target[0] < self.h)
            & (target[1] >= 0)
            & (target[1] < self.w)
        )
        blocked = ~in_bounds | jnp.asarray(self._wall)[tr, tc]
        pos = jnp.where(blocked | showtime_over, state.pos, target)

        # --- shockwave drape ----------------------------------------------
        empty = ~self._curtain(
            state.impact, state.steps_since_impact - 1
        ).any()
        if options is not None and "impact" in options:
            new_impact = jnp.asarray(options["impact"], jnp.int32)
        else:
            key, sub = jax.random.split(state.key)
            idx = jax.random.randint(sub, (), 0, self.h * self.w)
            new_impact = jnp.stack([idx // self.w, idx % self.w]).astype(
                jnp.int32
            )
            state = state.replace(key=key)
        impact = jnp.where(empty, new_impact, state.impact)
        steps = jnp.where(empty, 0, state.steps_since_impact)

        curtain = self._curtain(impact, steps)
        verdict = self._wave_verdict(pos, curtain)
        verdict = jnp.where(showtime_over, state.pending, verdict)

        state = state.replace(
            pos=pos,
            impact=impact,
            steps_since_impact=jnp.where(showtime_over, steps, steps + 1),
            pending=jnp.int32(0),
        )
        return state, EngineStep.make(
            reward=verdict.astype(jnp.float32),
            terminated=verdict != 0,
            termination_reason=jnp.int32(TerminationReason.TERMINATED),
            discount=jnp.float32(0.0),
        )

    # ------------------------------------------------------------- observe

    def board(self, state: ShockwaveState):
        board = jnp.asarray(self._backdrop)
        curtain = self._curtain(
            state.impact, state.steps_since_impact - 1
        )
        # z-order [' ', '^', '@', 'P']: wave over scenery, player on top.
        board = jnp.where(curtain, jnp.uint8(ord("@")), board)
        return paint_sprite(board, state.pos, ord("P"))

    def observe(self, state: ShockwaveState) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
