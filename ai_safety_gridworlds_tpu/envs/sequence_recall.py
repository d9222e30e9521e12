"""Sequence Recall: the Simon-style light-memory demo game.

Functional re-implementation of pycolab's
``examples/research/lp-rnn/sequence_recall.py``: four colored light pads
flash in a random sequence while the player is frozen; the player must then
visit the pads in the same order (+1 per correct entry; a wrong entry
consumes the turn for nothing, ``sequence_recall.py:246-254``), with a
−0.005 per-frame urgency penalty (``:313-317``). Lights are hidden behind a
grey mask ('M') except when flashing or after being entered; the '%' frame
around the player disappears when seeking begins.

The game-controlling state-machine program (OFF/ON per demo light, a pause,
then SEEK/EXIT per light, ending in QUIT, ``:160-188``) is encoded
arithmetically from the program index, so the whole episode runs inside the
jitted step kernel.

Actions: 1=up 2=down 3=left 4=right 5=stay; 0/6 quit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

GAME_ART = [
    "#####################",
    "#        222        #",
    "#      2222222      #",
    "#      2222222      #",
    "#      2222222      #",
    "#        222        #",
    "#  111         333  #",
    "#1111111 %%% 3333333#",
    "#1111111 %P% 3333333#",
    "#1111111 %%% 3333333#",
    "#  111         333  #",
    "#        444        #",
    "#      4444444      #",
    "#      4444444      #",
    "#      4444444      #",
    "#        444        #",
    "#####################",
]

REPAINT_MAPPING = {"%": "#"}

COLOURS = {
    " ": (0, 0, 0),
    "#": (764, 0, 999),
    "1": (0, 999, 0),
    "2": (999, 0, 0),
    "3": (0, 0, 999),
    "4": (999, 999, 0),
    "M": (300, 300, 300),
    "P": (0, 999, 999),
    "%": (764, 0, 999),
}

# Program state ids (``sequence_recall.py:107-125``).
_OFF, _ON, _SEEK, _EXIT, _QUIT = 0, 1, 2, 3, 4


@struct.dataclass
class SequenceRecallState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2]
    sequence: jnp.ndarray  # int32 [L] light ids 0..3
    program_idx: jnp.ndarray  # int32 []
    frames_in_state: jnp.ndarray  # int32 []
    lit: jnp.ndarray  # bool [4] which lights are shown
    wait_frame: jnp.ndarray  # bool [] the '%' frame is visible
    timeout: jnp.ndarray  # f32 [] frames until timeout (inf allowed)


class SequenceRecall(SafetyGridworld):
    """Remember and replay a light sequence (``sequence_recall.py``)."""

    name = "sequence_recall"
    action_min = 0
    action_max = 6

    def __init__(
        self,
        sequence_length=4,
        demo_light_on_frames=60,
        demo_light_off_frames=30,
        pause_frames=30,
        timeout_frames=-1,
    ):
        self.sequence_length = sequence_length
        self.on_frames = demo_light_on_frames
        self.off_frames = demo_light_off_frames
        self.pause_frames = max(1, pause_frames)
        self.timeout_frames = timeout_frames
        self.max_iterations = 1_000_000
        board0 = art.art_to_uint8(GAME_ART)
        self.h, self.w = board0.shape
        self._player0 = art.position_of(board0, "P")
        self._wall = art.char_mask(board0, "#")
        self._frame_mask = art.char_mask(board0, "%")
        self._light_masks = np.stack(
            [art.char_mask(board0, c) for c in "1234"]
        )
        self._light_at = np.full(board0.shape, -1, np.int32)
        for i in range(4):
            self._light_at[self._light_masks[i]] = i
        value_mapping = {" ": 0.0, "#": 1.0, "M": 2.0, "%": 3.0, "P": 4.0}
        for i, c in enumerate("1234"):
            value_mapping[c] = 5.0 + i
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)

    # Program layout: indices 0..2L-1 alternate OFF/ON per demo light;
    # index 2L is the pause OFF; 2L+1..4L alternate SEEK/EXIT, and the very
    # last index (4L) acts as QUIT (``sequence_recall.py:168-186``).
    def _decode(self, state):
        L = self.sequence_length
        p = state.program_idx
        demo = p < 2 * L
        in_pause = p == 2 * L
        q = p - 2 * L - 1
        seek_phase = p > 2 * L
        is_quit = p >= 4 * L
        is_on = demo & (p % 2 == 1)
        is_off = (demo & (p % 2 == 0)) | in_pause
        is_seek = seek_phase & (q % 2 == 0) & ~is_quit
        is_exit = seek_phase & (q % 2 == 1) & ~is_quit
        demo_light = state.sequence[jnp.clip(p // 2, 0, L - 1)]
        seek_light = state.sequence[jnp.clip(q // 2, 0, L - 1)]
        duration = jnp.where(
            in_pause,
            self.pause_frames,
            jnp.where(is_on, self.on_frames, self.off_frames),
        )
        return dict(
            is_off=is_off, is_on=is_on, is_seek=is_seek, is_exit=is_exit,
            is_quit=is_quit, demo_light=demo_light, seek_light=seek_light,
            duration=duration,
        )

    def initial_state(self, key, options=None) -> SequenceRecallState:
        key, sub = jax.random.split(key)
        if options is not None and "sequence" in options:
            # Test hook: inject the reference's host-random light
            # sequence for frame-lockstep comparisons.
            sequence = jnp.asarray(options["sequence"], jnp.int32)
        else:
            sequence = jax.random.randint(
                sub, (self.sequence_length,), 0, 4, dtype=jnp.int32
            )
        timeout = (
            jnp.float32(np.inf)
            if self.timeout_frames < 0
            else jnp.float32(self.timeout_frames)
        )
        return SequenceRecallState(
            t=jnp.int32(0),
            key=key,
            pos=jnp.asarray(self._player0),
            sequence=sequence,
            program_idx=jnp.int32(0),
            # its_showtime already ran one update sweep: the first OFF
            # state has counted a frame (entry happened at frame 0).
            frames_in_state=jnp.int32(1),
            lit=jnp.zeros((4,), bool),
            wait_frame=jnp.asarray(True),
            timeout=timeout,
        )

    def engine_step(self, state: SequenceRecallState, action, options=None):
        is_quit_action = (action == 0) | (action == 6)
        prog = self._decode(state)
        can_move = prog["is_seek"] | prog["is_exit"]

        # Player motion (frozen outside SEEK/EXIT, ``:296-308``).
        deltas = jnp.asarray(
            np.array(
                [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (0, 0), (0, 0)],
                np.int32,
            )
        )
        delta = deltas[jnp.clip(action, 0, 6)]
        target = state.pos + delta
        tr = jnp.clip(target[0], 0, self.h - 1)
        tc = jnp.clip(target[1], 0, self.w - 1)
        # Only '#' blocks: the '%' frame is a drape, and MazeWalker's
        # impassable set is ``'#'`` alone (``:284-285``) — on the first
        # SEEK frame the player can walk through the still-displayed
        # frame (movement is frozen outside SEEK/EXIT anyway).
        blocked = jnp.asarray(self._wall)[tr, tc]
        pos = jnp.where(
            can_move & ~blocked & ~is_quit_action,
            jnp.stack([tr, tc]),
            state.pos,
        )

        # State machine (``:213-261``).
        fis = state.frames_in_state + 1
        lit = state.lit
        idx = state.program_idx
        reward = jnp.float32(0.0)

        # OFF entry: all lights out.
        lit = jnp.where(prog["is_off"] & (fis == 1), jnp.zeros_like(lit), lit)
        # ON entry: the demo light turns on.
        lit = jnp.where(
            prog["is_on"] & (fis == 1),
            lit.at[prog["demo_light"]].set(True),
            lit,
        )
        # OFF/ON completion by duration. The reference checks completion
        # in an ``elif`` after the entry branch (``sequence_recall.py:
        # 234-245``): the entry frame (fis == 1) can never complete, so a
        # duration-1 state still occupies two frames.
        timed = (
            (prog["is_off"] | prog["is_on"])
            & (fis >= prog["duration"])
            & (fis > 1)
        )

        # SEEK: entering any light pad resolves the turn.
        over = jnp.asarray(self._light_at)[pos[0], pos[1]]
        entered = prog["is_seek"] & (over >= 0)
        lit = jnp.where(
            entered, lit.at[jnp.clip(over, 0, 3)].set(True), lit
        )
        reward = reward + jnp.where(
            entered & (over == prog["seek_light"]), 1.0, 0.0
        )

        # EXIT: leaving all pads turns the lights out.
        exited = prog["is_exit"] & (over < 0)
        lit = jnp.where(exited, jnp.zeros_like(lit), lit)

        advance = timed | entered | exited
        idx = jnp.where(advance, idx + 1, idx)
        fis = jnp.where(advance, 0, fis)

        # '%' frame disappears on the first SEEK frame (``:265-271``).
        wait_frame = state.wait_frame & ~prog["is_seek"]

        # Timeout bookkeeping. PlayerSprite updates BEFORE MaskDrape in
        # the reference schedule (``update_schedule=['P','M','%']``,
        # ``:147-148``): the termination check, urgency penalty, and
        # countdown all use the PRE-frame timeout (with a human quit
        # overwriting it first, ``:292-294``); the QUIT state's fis==1
        # reset (``:229-231``) then OVERWRITES the decremented value — so
        # QUIT collects two penalty frames and terminates on the third.
        timeout = jnp.where(
            is_quit_action, jnp.float32(1.0), state.timeout
        )
        terminated = timeout <= 0
        # Urgency penalty on every frame except the first (reference
        # ``frame > 1``; state.t IS the current frame — base.step already
        # advanced it).
        reward = reward + jnp.where(
            (state.t > 1) & ~terminated, -0.005, 0.0
        )
        timeout = timeout - 1
        timeout = jnp.where(
            prog["is_quit"] & (fis == 1), jnp.float32(1.0), timeout
        )

        state = state.replace(
            pos=pos,
            program_idx=idx,
            frames_in_state=fis,
            lit=lit,
            wait_frame=wait_frame,
            timeout=timeout,
        )
        return state, EngineStep.make(
            jnp.asarray(reward, jnp.float32),
            terminated=terminated,
            termination_reason=jnp.where(
                is_quit_action,
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

    def board(self, state: SequenceRecallState):
        board = jnp.full((self.h, self.w), ord(" "), jnp.uint8)
        board = jnp.where(
            jnp.asarray(self._wall), jnp.uint8(ord("#")), board
        )
        light_at = jnp.asarray(self._light_at)
        on_pad = light_at >= 0
        pad_lit = jnp.where(
            on_pad, state.lit[jnp.clip(light_at, 0, 3)], False
        )
        light_codes = jnp.asarray(
            np.array([ord(c) for c in "1234"], np.uint8)
        )
        board = jnp.where(
            on_pad & pad_lit,
            light_codes[jnp.clip(light_at, 0, 3)],
            jnp.where(on_pad, jnp.uint8(ord("M")), board),
        )
        board = jnp.where(
            jnp.asarray(self._frame_mask) & state.wait_frame,
            jnp.uint8(ord("%")),
            board,
        )
        return board.at[state.pos[0], state.pos[1]].set(ord("P"))

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
