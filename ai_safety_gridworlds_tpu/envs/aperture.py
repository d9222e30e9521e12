"""Aperture: blast portals into special walls, teleport to the cranachan.

Functional re-implementation of pycolab's ``examples/aperture.py``: the
player keeps up to two "apertures"; shooting the blaster walks a ray from
the player until it leaves the board, hits a normal wall or an existing
aperture, or converts the first special wall hit into a new aperture (FIFO
of two, ``aperture.py:160-198``). Walking onto an aperture teleports to the
oldest other aperture (``aperture.py:138-142``); reaching the cranachan pays
+1 and wins (``aperture.py:133-136``).

The raycast becomes a fixed-length vectorized scan: all cells along the ray
are gathered at once, the first blocking/creating event is an ``argmax``
over the event mask — no data-dependent loops, fully jit/vmap-compatible.
The game is deterministic, so the lockstep test drives the reference engine
frame-for-frame.

Actions: 0=up 1=down 2=left 3=right 4=noop 5..8=shoot w/a/s/d 9=quit
(``aperture.py:216-232``).
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
        "##############",
        "## A ...    @#",
        "##   ...    @#",
        "##@@@...    @#",
        "##......    @#",
        "##......    @#",
        "#@   ...    @#",
        "#@   ...    @#",
        "##   .......##",
        "## C .......##",
        "##############",
    ],
    [
        "#####################",
        "##A#@###########C#@##",
        "## # #         # # ##",
        "##   #  ZZ ZZ  #   ##",
        "## ### Z  Z  Z ### ##",
        "##.#    ZZ ZZ    ..##",
        "##.#    ZZZZZ    ..##",
        "##.#   Z Z Z Z   ..##",
        "##.#  Z  Z Z  Z  # ##",
        "## #  Z Z   Z Z  # ##",
        "## #             # ##",
        "## ............... @#",
        "##@##################",
        "#####################",
    ],
    [
        "####################",
        "#########@@@########",
        "##C         ########",
        "########## ##@######",
        "#A #.........     ##",
        "## #.....   ..... @#",
        "## #..... @ ..... @#",
        "## #......#......###",
        "##  ..  ..#..  ..@##",
        "##  .. @##Z##@ .. ##",
        "##  ..  ..#..  .. ##",
        "##@@......#...... ##",
        "####..... @ ..... ##",
        "##@ .....   ..... ##",
        "##@ ............. @#",
        "####...     .....###",
        "#######@@@@@########",
        "####################",
    ],
]

FG_COLOURS = {
    "A": (999, 500, 0),
    "X": (200, 200, 999),
    "#": (700, 700, 700),
    "@": (400, 400, 600),
    ".": (100, 300, 100),
    "C": (999, 0, 0),
    " ": (200, 200, 200),
    "Z": (0, 999, 0),
}

# Blaster ray directions per action 5..8: (dy, dx) (``aperture.py:163-171``).
_SHOOT_DELTAS = np.array(
    [(-1, 0), (0, -1), (1, 0), (0, 1)], np.int32
)  # w, a, s, d

_SENTINEL = -1


@struct.dataclass
class ApertureState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2]
    apertures: jnp.ndarray  # int32 [2, 2] FIFO; row of -1 = unset


class Aperture(SafetyGridworld):
    """The portal-blaster puzzle (``aperture.py``)."""

    name = "aperture"
    action_min = 0
    action_max = 9
    max_iterations = 1000

    def __init__(self, level=0):
        board0 = art.art_to_uint8(LEVELS[level])
        self.h, self.w = board0.shape
        self._pos0 = art.position_of(board0, "A")
        self._backdrop = art.replace_chars(board0, "A", " ")
        self._wall = art.char_mask(board0, "#")
        self._ooze = art.char_mask(board0, ".")
        self._special = art.char_mask(board0, "@")
        self._goal = art.char_mask(board0, "C")
        self._ray_len = max(self.h, self.w)
        value_mapping = {c: float(i) for i, c in enumerate(" #@.CZXA")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(FG_COLOURS)

    def initial_state(self, key, options=None) -> ApertureState:
        return ApertureState(
            t=jnp.int32(0),
            key=key,
            pos=jnp.asarray(self._pos0),
            apertures=jnp.full((2, 2), _SENTINEL, jnp.int32),
        )

    # ---------------------------------------------------------------- step

    def _aperture_mask_at(self, apertures, cells):
        """Whether each of ``cells`` [K, 2] is an existing aperture."""
        hit = jnp.zeros(cells.shape[:1], bool)
        for k in range(2):
            valid = apertures[k, 0] >= 0
            hit = hit | (
                valid & (cells == apertures[k][None, :]).all(axis=1)
            )
        return hit

    def engine_step(self, state: ApertureState, action, options=None):
        is_quit = action == 9

        # --- player group (sees the PREVIOUS frame's aperture layer) ------
        # Impassable '#.@' on the rendered board: a '@' cell holding an
        # aperture renders as 'X' and is therefore passable
        # (``aperture.py:120-122`` + z-order ['X', 'A']).
        aperture_cells = jnp.zeros((self.h, self.w), bool)
        for k in range(2):
            valid = state.apertures[k, 0] >= 0
            rk = jnp.clip(state.apertures[k, 0], 0, self.h - 1)
            ck = jnp.clip(state.apertures[k, 1], 0, self.w - 1)
            aperture_cells = aperture_cells.at[rk, ck].max(valid)
        blocked_mask = (
            jnp.asarray(self._wall)
            | jnp.asarray(self._ooze)
            | (jnp.asarray(self._special) & ~aperture_cells)
        )
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
        tr = jnp.clip(target[0], 0, self.h - 1)
        tc = jnp.clip(target[1], 0, self.w - 1)
        pos = jnp.where(blocked_mask[tr, tc], state.pos, target)

        # Win check before teleporting (``aperture.py:133-136``).
        won = jnp.asarray(self._goal)[pos[0], pos[1]]

        # Teleport: WALKING onto an aperture jumps to the OLDEST other one
        # (``aperture.py:138-142``; FIFO order of the aperture list). The
        # check reads the occluding layer render: an aperture under the
        # player's own previous position is hidden, so standing still on an
        # aperture never re-teleports.
        on_ap = (
            self._aperture_mask_at(state.apertures, pos[None, :])[0]
            & ~(pos == state.pos).all()
        )
        dest = pos
        for k in (1, 0):  # select oldest (index 0) last so it wins
            cand = state.apertures[k]
            valid = (cand[0] >= 0) & ~(cand == pos).all()
            dest = jnp.where(valid, cand, dest)
        pos = jnp.where(on_ap & ~won, dest, pos)

        # --- aperture drape group (blaster) --------------------------------
        shooting = (action >= 5) & (action <= 8)
        d = jnp.asarray(_SHOOT_DELTAS)[jnp.clip(action - 5, 0, 3)]
        ks = jnp.arange(1, self._ray_len, dtype=jnp.int32)
        cells = pos[None, :] + ks[:, None] * d[None, :]
        in_b = (
            (cells[:, 0] >= 0)
            & (cells[:, 0] < self.h)
            & (cells[:, 1] >= 0)
            & (cells[:, 1] < self.w)
        )
        rr = jnp.clip(cells[:, 0], 0, self.h - 1)
        cc = jnp.clip(cells[:, 1], 0, self.w - 1)
        wall_hit = jnp.asarray(self._wall)[rr, cc] & in_b
        x_hit = self._aperture_mask_at(state.apertures, cells) & in_b
        special_hit = jnp.asarray(self._special)[rr, cc] & in_b
        blockers = ~in_b | wall_hit | x_hit
        event = blockers | special_hit
        first = jnp.argmax(event)
        creates = (
            shooting
            & event.any()
            & special_hit[first]
            & ~blockers[first]
        )
        new_cell = cells[first]
        apertures = jnp.where(
            creates,
            jnp.stack([state.apertures[1], new_cell]),
            state.apertures,
        )

        state = state.replace(pos=pos, apertures=apertures)
        return state, EngineStep.make(
            reward=jnp.where(won, 1.0, 0.0),
            terminated=won | is_quit,
            termination_reason=jnp.where(
                is_quit & ~won,
                jnp.int32(TerminationReason.QUIT),
                jnp.int32(TerminationReason.TERMINATED),
            ),
            discount=jnp.float32(0.0),
        )

    # ------------------------------------------------------------- observe

    def board(self, state: ApertureState):
        board = jnp.asarray(self._backdrop)
        for k in range(2):
            valid = state.apertures[k, 0] >= 0
            painted = paint_sprite(board, state.apertures[k], ord("X"))
            board = jnp.where(valid, painted, board)
        return paint_sprite(board, state.pos, ord("A"))

    def observe(self, state: ApertureState) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
