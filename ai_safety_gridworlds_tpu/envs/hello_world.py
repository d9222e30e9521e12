"""Hello World: move text around the board.

Functional re-implementation of pycolab's ``examples/hello_world.py``: a
rolling '@' drape shifts by one cell along either axis per motion action
(``hello_world.py:76-91``) while four digit sprites slide diagonally with
modular wrap-around (``hello_world.py:94-125``); every motion pays +1 and
action 4 quits.

The drape roll becomes a static-shift ``jnp.roll`` selected by action; the
sprites' modular diagonal moves are pure index arithmetic — the whole step is
one fused elementwise kernel under jit/vmap.

Actions: 0=up 1=down 2=left 3=right 4=quit (``hello_world.py:135-138``).
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

HELLO_ART = [
    "                                    ",
    "  #   #  ### #    #     ###         ",
    "  #   # #    #    #    #   #        ",
    "  ##### #### #    #    #   #        ",
    "  #   # #    #    #    #   #        ",
    "  #   #  ###  ###  ###  ###         ",
    "                                    ",
    "     @   @  @@@   @@@  @    @@@@  1 ",
    "     @   @ @   @ @   @ @    @   @ 2 ",
    "     @ @ @ @   @ @@@@  @    @   @ 3 ",
    "     @ @ @ @   @ @   @ @    @   @   ",
    "      @@@   @@@  @   @  @@@ @@@@  4 ",
    "                                    ",
]

HELLO_COLOURS = {
    " ": (123, 123, 123),
    "#": (595, 791, 928),
    "@": (54, 501, 772),
    "1": (999, 222, 222),
    "2": (222, 999, 222),
    "3": (999, 999, 111),
    "4": (222, 222, 999),
}

# Per-sprite diagonal motion tables (``hello_world.py:97-100``): direction
# set i gives sprite i its (dx, dy) mapping per action 0..3.
_DX = ([-1, 1, -1, 1], [-1, 1, -1, 1], [1, -1, 1, -1], [1, -1, 1, -1])
_DY = ([-1, 1, 1, -1], [1, -1, -1, 1], [1, -1, -1, 1], [-1, 1, 1, -1])

# Drape rolls per action (``hello_world.py:72-74``).
_ROLL_AXES = [0, 0, 1, 1]
_ROLL_SHIFTS = [-1, 1, -1, 1]


@struct.dataclass
class HelloWorldState:
    t: jnp.ndarray
    key: jnp.ndarray
    curtain: jnp.ndarray  # bool [H, W] the '@' drape
    sprites: jnp.ndarray  # int32 [4, 2] digit sprite positions


class HelloWorld(SafetyGridworld):
    """The rolling-text demo game (``hello_world.py``)."""

    name = "hello_world"
    action_min = 0
    action_max = 4
    max_iterations = 1000

    def __init__(self):
        board0 = art.art_to_uint8(HELLO_ART)
        self.h, self.w = board0.shape
        self._backdrop = art.replace_chars(board0, "@1234", " ")
        self._curtain0 = board0 == np.uint8(ord("@"))
        self._sprites0 = np.stack(
            [art.position_of(board0, c) for c in "1234"]
        )
        value_mapping = {c: float(i) for i, c in enumerate(" #@1234")}
        self._value_lut = art.char_lut(value_mapping)
        self._rgb_lut = art.rgb_lut_from_colours(HELLO_COLOURS)

    def initial_state(self, key, options=None) -> HelloWorldState:
        return HelloWorldState(
            t=jnp.int32(0),
            key=key,
            curtain=jnp.asarray(self._curtain0),
            sprites=jnp.asarray(self._sprites0),
        )

    def engine_step(self, state: HelloWorldState, action, options=None):
        is_quit = action == 4
        is_motion = action < 4
        a = jnp.clip(action, 0, 3)

        # Drape: one of four static rolls, selected by action
        # (z-order '12@34' is irrelevant to the roll itself).
        rolled = jnp.stack(
            [
                jnp.roll(state.curtain, _ROLL_SHIFTS[i], axis=_ROLL_AXES[i])
                for i in range(4)
            ]
        )[a]
        curtain = jnp.where(is_motion, rolled, state.curtain)

        # Sprites: modular diagonal slides (``hello_world.py:121-124``).
        dx = jnp.asarray(_DX, jnp.int32)[:, a]
        dy = jnp.asarray(_DY, jnp.int32)[:, a]
        rows = (state.sprites[:, 0] + dy) % self.h
        cols = (state.sprites[:, 1] + dx) % self.w
        sprites = jnp.where(
            is_motion, jnp.stack([rows, cols], axis=1), state.sprites
        )

        state = state.replace(curtain=curtain, sprites=sprites)
        return state, EngineStep.make(
            reward=jnp.where(is_motion, 1.0, 0.0),
            terminated=is_quit,
            termination_reason=jnp.int32(TerminationReason.QUIT),
            discount=jnp.float32(0.0),
        )

    def board(self, state: HelloWorldState):
        board = jnp.asarray(self._backdrop)
        # z-order '12@34': sprites 1, 2 under the drape, 3, 4 above.
        board = paint_sprite(board, state.sprites[0], ord("1"))
        board = paint_sprite(board, state.sprites[1], ord("2"))
        board = jnp.where(state.curtain, jnp.uint8(ord("@")), board)
        board = paint_sprite(board, state.sprites[2], ord("3"))
        board = paint_sprite(board, state.sprites[3], ord("4"))
        return board

    def observe(self, state: HelloWorldState) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
