"""The Ordeal: a three-chapter Story demo (slay the dragon/duck!).

Functional re-implementation of pycolab's ``examples/ordeal.py`` — the
canonical `storytelling.Story` demonstration: three sub-games (Kansas, the
castle, the cavern) chained behind one interface. Walking off designated
map edges moves between chapters with position carry-over; the cavern's
sword (+1) persists in the shared plot; the castle's dragonduck chases the
player diagonally, and contact ends the story (+1 with the sword, −1
without, ``ordeal.py:141-186``).

Actions: 0=up 1=down 2=left 3=right 4=quit.
Use :func:`make_ordeal_story`; the Kansas chapter pairs with a
``ScrollingCropper(8, 15, scroll_margins=(2, 3))`` for display, exactly as
upstream.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core import art
from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.cropping import ScrollingCropper
from ai_safety_gridworlds_tpu.core.render import paint_sprite, rgb_map, value_map
from ai_safety_gridworlds_tpu.core.storytelling import Story
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason
from ai_safety_gridworlds_tpu.helpers.safety_env import SafetyEnvironment

GAME_ART_CASTLE = [
    "##  ##   ##  ##",
    "###############",
    "#             #",
    "#      D      #",
    "#             #",
    "#             #",
    "#             #",
    "###### P ######",
]

GAME_ART_CAVERN = [
    "@@@@@@@@@@@@@@@",
    "@@@@@@     @@@@",
    "@@@@@      @@@@",
    "@ @@    S    @@",
    "            @@@",
    "P @@@     @@@@@",
    "@@@@@@  @@@@@@@",
    "@@@@@@@@@@@@@@@",
]

GAME_ART_KANSAS = [
    "######%%%######wwwwwwwwwwwwwwwwwwwwww@wwwwwww",
    "w~~~~~%%%~~~~~~~~~~~~~~~~@~~~wwwww~~~~~~~~~~@",
    "ww~~~~%%%~~~~~~~~~@~~~~~~~~~~~~~~~~~~~~~~@@@@",
    "ww~~~~~%%%%~~~~~~~~~~~~~~~~~~~~~~~~~~~~~@@@@@",
    "@ww~~~~~~%%%%~~~~~~~~~~~~~@~~%%%%%%%%%%%%%%%%",
    "ww~~~~~~~~~~%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%%",
    "w~~~~~~@~~~~~~~~%%%%%%%%%%%%%%~~~~~~~~~~~~@@@",
    "ww~~~~~~~~~~P~~~~~~~~~~~~~~~~~~~~~~~~~@~~~@@@",
    "wwww~@www~~~~~~~~~wwwwww~~~@~~~~wwwww~~~~~~ww",
    "wwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwww",
]

IMPASSABLE = "@#w"
_DELTAS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1), (0, 0)], np.int32)

COLOURS = {
    "#": (599, 599, 599),
    "@": (465, 265, 0),
    "w": (0, 350, 780),
    "~": (280, 680, 200),
    "%": (660, 570, 200),
    " ": (858, 858, 858),
    "P": (0, 706, 999),
    "D": (999, 200, 200),
    "S": (999, 862, 110),
}


@struct.dataclass
class OrdealState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2] player
    dragon: jnp.ndarray  # int32 [2] (castle only; (-1,-1) elsewhere)
    has_sword: jnp.ndarray  # bool []
    sword_present: jnp.ndarray  # bool [] (cavern only)
    exit_code: jnp.ndarray  # int32 [] 0=none 1=north 2=south 3=west 4=east


class _OrdealChapter(SafetyGridworld):
    """Shared chapter machinery: player motion, edge exits, quit."""

    art_rows: list = []
    what_lies_beneath = " "
    action_min = 0
    action_max = 4
    max_iterations = 10_000
    # Which edge exits are open, as action -> exit code.
    edge_exits: dict = {}

    def __init__(self, plot=None):
        self.plot = plot if plot is not None else {}
        board0 = art.art_to_uint8(self.art_rows)
        self.h, self.w = board0.shape
        self._player0 = art.position_of(board0, "P")
        self._blocked = np.zeros_like(board0, bool)
        for c in IMPASSABLE:
            self._blocked |= art.char_mask(board0, c)
        self._backdrop = art.replace_chars(
            board0, "PDS", self.what_lies_beneath
        )
        value_mapping = {c: float(i) for i, c in enumerate(" ~%#@w")}
        value_mapping.update({"P": 6.0, "D": 7.0, "S": 8.0})
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(COLOURS)

    def _start_pos(self):
        """Chapter entry position: line up with where the player left the
        previous chapter (``ordeal.py:248-264``)."""
        prior = self.plot.get("prior_chapter")
        last = self.plot.get("last_position")
        if prior is None or last is None:
            return self._player0
        return self._carry_position(prior, last)

    def _carry_position(self, prior, last):
        return self._player0

    def _move_player(self, state, action):
        delta = jnp.asarray(_DELTAS)[jnp.clip(action, 0, 4)]
        target = state.pos + delta
        inb = (
            (target[0] >= 0)
            & (target[0] < self.h)
            & (target[1] >= 0)
            & (target[1] < self.w)
        )
        tr = jnp.clip(target[0], 0, self.h - 1)
        tc = jnp.clip(target[1], 0, self.w - 1)
        blocked = ~inb | jnp.asarray(self._blocked)[tr, tc]
        return jnp.where((action < 4) & ~blocked, target, state.pos)

    def _edge_exit(self, state, action):
        """Exit code if this action walks off an open edge
        (``ordeal.py:212-239``)."""
        code = jnp.int32(0)
        for act, (pred, exit_code) in self.edge_exits.items():
            code = jnp.where(
                (action == act) & pred(state), jnp.int32(exit_code), code
            )
        return code

    def initial_state(self, key, options=None) -> OrdealState:
        pos = np.asarray(self._start_pos(), np.int32)
        return OrdealState(
            t=jnp.int32(0),
            key=key,
            pos=jnp.asarray(pos),
            dragon=jnp.asarray(
                getattr(self, "_dragon0", np.array([-1, -1], np.int32))
            ),
            has_sword=jnp.asarray(bool(self.plot.get("has_sword", False))),
            sword_present=jnp.asarray(
                not bool(self.plot.get("has_sword", False))
            ),
            exit_code=jnp.int32(0),
        )

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }

    def board(self, state):
        board = jnp.asarray(self._backdrop)
        return paint_sprite(board, state.pos, ord("P"))


class KansasChapter(_OrdealChapter):
    """The overworld: north edge -> castle, east edge -> cavern."""

    name = "ordeal_kansas"
    art_rows = GAME_ART_KANSAS
    what_lies_beneath = "~"

    def __init__(self, plot=None):
        super().__init__(plot)
        self.edge_exits = {
            0: (lambda s: s.pos[0] <= 0, 1),  # north -> castle
            3: (lambda s: s.pos[1] >= self.w - 1, 4),  # east -> cavern
        }

    def _carry_position(self, prior, last):
        if prior == "castle":
            return np.array([0, last[1]], np.int32)
        if prior == "cavern":
            return np.array([last[0], self.w - 1], np.int32)
        return self._player0

    def engine_step(self, state, action, options=None):
        is_quit = action == 4
        exit_code = self._edge_exit(state, action)
        pos = jnp.where(exit_code > 0, state.pos, self._move_player(state, action))
        terminated = is_quit | (exit_code > 0)
        state = state.replace(pos=pos, exit_code=exit_code)
        return state, EngineStep.make(
            jnp.float32(0.0),
            terminated=terminated,
            termination_reason=jnp.where(
                terminated,
                jnp.int32(TerminationReason.TERMINATED),
                jnp.int32(TerminationReason.NONE),
            ),
            discount=0.0,
            actual_action=action,
        )


class CastleChapter(_OrdealChapter):
    """The castle: a diagonal-chasing dragonduck; south edge -> kansas."""

    name = "ordeal_castle"
    art_rows = GAME_ART_CASTLE

    def __init__(self, plot=None):
        super().__init__(plot)
        board0 = art.art_to_uint8(self.art_rows)
        self._dragon0 = art.position_of(board0, "D")
        self.edge_exits = {
            1: (lambda s: s.pos[0] >= self.h - 1, 2),  # south -> kansas
        }

    def _carry_position(self, prior, last):
        if prior == "kansas":
            return np.array([self.h - 1, last[1]], np.int32)
        return self._player0

    def engine_step(self, state, action, options=None):
        is_quit = action == 4
        exit_code = self._edge_exit(state, action)
        pos = jnp.where(
            exit_code > 0, state.pos, self._move_player(state, action)
        )

        # Dragonduck shuffles toward the player, diagonals allowed, walls
        # impassable (``ordeal.py:141-167``); it rests on frame 0.
        d = state.dragon
        step_r = jnp.sign(pos[0] - d[0])
        step_c = jnp.sign(pos[1] - d[1])
        target = d + jnp.stack([step_r, step_c])
        tr = jnp.clip(target[0], 0, self.h - 1)
        tc = jnp.clip(target[1], 0, self.w - 1)
        ok = ~jnp.asarray(self._blocked)[tr, tc]
        dragon = jnp.where(ok, jnp.stack([tr, tc]), d)

        # Battle check against the LAST-RENDERED player layer (the
        # reference reads ``layers['P']`` — the player's PRE-move cell —
        # precisely so swap-throughs still battle, ``ordeal.py:170-176``).
        battle = (dragon[0] == state.pos[0]) & (dragon[1] == state.pos[1])
        reward = jnp.where(
            battle,
            jnp.where(state.has_sword, 1.0, -1.0),
            0.0,
        )
        # Battle ends the whole story (next_chapter None); edge exit only
        # ends the chapter.
        exit_code = jnp.where(battle, jnp.int32(-1), exit_code)
        terminated = is_quit | battle | (exit_code > 0)
        state = state.replace(pos=pos, dragon=dragon, exit_code=exit_code)
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
        board = jnp.asarray(self._backdrop)
        # Terminal battle z-dance (``ordeal.py:180-185``, applied by the
        # engine's post-directive re-render, ``engine.py:628-637``): with
        # the sword the dragonduck is moved in front of the player;
        # without, the player is moved in front (already the default).
        d_on_top = (state.exit_code == -1) & state.has_sword
        p_top = paint_sprite(
            paint_sprite(board, state.dragon, ord("D")),
            state.pos, ord("P"),
        )
        d_top = paint_sprite(
            paint_sprite(board, state.pos, ord("P")),
            state.dragon, ord("D"),
        )
        return jnp.where(d_on_top, d_top, p_top)


class CavernChapter(_OrdealChapter):
    """The cavern: collect the sword (+1); west edge -> kansas."""

    name = "ordeal_cavern"
    art_rows = GAME_ART_CAVERN

    def __init__(self, plot=None):
        super().__init__(plot)
        board0 = art.art_to_uint8(self.art_rows)
        self._sword_pos = art.position_of(board0, "S")
        self.edge_exits = {
            2: (lambda s: s.pos[1] <= 0, 3),  # west -> kansas
        }

    def _carry_position(self, prior, last):
        if prior == "kansas":
            return np.array([last[0], 0], np.int32)
        return self._player0

    def engine_step(self, state, action, options=None):
        is_quit = action == 4
        exit_code = self._edge_exit(state, action)
        pos = jnp.where(
            exit_code > 0, state.pos, self._move_player(state, action)
        )
        on_sword = (
            state.sword_present
            & (pos[0] == self._sword_pos[0])
            & (pos[1] == self._sword_pos[1])
        )
        reward = jnp.where(on_sword, 1.0, 0.0)
        state = state.replace(
            pos=pos,
            has_sword=state.has_sword | on_sword,
            sword_present=state.sword_present & ~on_sword,
            exit_code=exit_code,
        )
        terminated = is_quit | (exit_code > 0)
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
        board = jnp.asarray(self._backdrop)
        board = paint_sprite(
            board, jnp.asarray(self._sword_pos), ord("S"),
            visible=state.sword_present,
        )
        return paint_sprite(board, state.pos, ord("P"))


class _ChapterShell(SafetyEnvironment):
    """Stateful shell that writes chapter-transition facts into the shared
    plot when its episode ends (the functional analogue of the reference
    sprites writing ``the_plot.next_chapter`` / ``last_position``)."""

    _EXIT_TO_CHAPTER = {1: "castle", 2: "kansas", 3: "kansas", 4: "cavern"}

    def __init__(self, game, chapter_name, plot):
        self._chapter_name = chapter_name
        self._plot = plot
        super().__init__(game)

    def step(self, action):
        timestep = super().step(action)
        state = self._state
        self._plot["has_sword"] = bool(np.asarray(state.has_sword))
        self._plot["last_position"] = tuple(
            int(x) for x in np.asarray(state.pos)
        )
        if timestep.step_type.last():
            code = int(np.asarray(state.exit_code))
            self._plot["prior_chapter"] = self._chapter_name
            if code in self._EXIT_TO_CHAPTER:
                self._plot["next_chapter"] = self._EXIT_TO_CHAPTER[code]
            else:
                self._plot["next_chapter"] = None  # battle or quit: the end
        return timestep


def make_ordeal_story() -> Story:
    """Assemble the three chapters behind one Story (``ordeal.py:80-108``)."""

    def castle(plot):
        return _ChapterShell(CastleChapter(plot), "castle", plot)

    def cavern(plot):
        return _ChapterShell(CavernChapter(plot), "cavern", plot)

    def kansas(plot):
        return _ChapterShell(KansasChapter(plot), "kansas", plot)

    return Story(
        {"castle": castle, "cavern": cavern, "kansas": kansas},
        first_chapter="kansas",
        # Per-chapter croppers exactly like the reference
        # (``ordeal.py:104-110``): only Kansas is windowed, tracking the
        # player with margins (2, 3) and no padding (the window clamps to
        # the board).
        croppers={
            "kansas": (
                kansas_cropper(),
                lambda env: np.asarray(env._state.pos),
            )
        },
    )


def kansas_cropper() -> ScrollingCropper:
    """The upstream display cropper for the Kansas overworld
    (``ordeal.py:104-105``: rows=8, cols=15, margins (2, 3), no pad)."""
    return ScrollingCropper(8, 15, scroll_margins=(2, 3))
