"""Box-World: the relational key/lock reasoning demo.

Functional re-implementation of pycolab's
``examples/research/box_world/box_world.py``: procedurally generated chains
of colored key/lock boxes leading to a gem. A key with a lock directly to
its right is "locked" and unreachable until that lock is opened with the
matching held key; opening a lock consumes the inventory key; the solution
chain pays +1 per correct lock (``REWARD_OPEN_CORRECT``), opening a
distractor-branch lock pays −1 and ends the episode
(``box_world.py:254-271``), and the gem pays +10 (``:232-238``).

The held key is displayed in the top-left border cell, exactly like the
reference's inventory curtain at (0, 0) (``box_world.py:247-251``).

Actions: 0=north 1=south 2=west 3=east 4=delay(no-op).
Map generation is host-side (rejection sampling, ``:336-395``); the device
step kernel is pure and batchable over pre-generated boards.
"""

from __future__ import annotations

import string

import jax.numpy as jnp
import numpy as np
from ai_safety_gridworlds_tpu.core import struct

from ai_safety_gridworlds_tpu.core.base import EngineStep, SafetyGridworld
from ai_safety_gridworlds_tpu.core.render import rgb_map, value_map
from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

GEM = "*"
PLAYER = "."
BACKGROUND = " "
BORDER = "#"

MAX_NUM_KEYS = 20
KEYS = list(string.ascii_lowercase[:MAX_NUM_KEYS])
LOCKS = list(string.ascii_uppercase[:MAX_NUM_KEYS])

REWARD_GOAL = 10.0
REWARD_STEP = 0.0
REWARD_OPEN_CORRECT = 1.0
REWARD_OPEN_WRONG = -1.0

WALL_WIDTH = 1
MAX_PLACEMENT_TRIES = 200
MAX_GENERATION_TRIES = 200

# Item codes on the items plane: 0 empty, 1..20 key colors,
# 101..120 lock colors, 255 the gem.
_LOCK_BASE = 100
_GEM_CODE = 255

_DELTAS = np.array(
    [(-1, 0), (1, 0), (0, -1), (0, 1), (0, 0)], np.int32
)

COLORS = [
    (700, 350, 350), (700, 454, 350), (700, 559, 350), (700, 664, 350),
    (629, 700, 350), (524, 700, 350), (420, 700, 350), (350, 700, 384),
    (350, 700, 490), (350, 700, 595), (350, 700, 700), (350, 594, 700),
    (350, 490, 700), (350, 384, 700), (419, 350, 700), (524, 350, 700),
    (630, 350, 700), (700, 350, 665), (700, 350, 559), (700, 350, 455),
]
OBJECT_COLORS = {PLAYER: (500, 500, 500), GEM: (999, 999, 999),
                 BACKGROUND: (0, 0, 0), BORDER: (300, 300, 300)}
OBJECT_COLORS.update({k: c for k, c in zip(KEYS, COLORS)})
OBJECT_COLORS.update({l: c for l, c in zip(LOCKS, COLORS)})


def _sample_keys_locks(rand, solution_length_range, num_forward_range,
                       num_backward_range, branch_length=1):
    """Sample the key/lock dependency graph (``box_world.py:274-305``)."""
    solution_length = rand.choice(solution_length_range)
    num_forward = rand.choice(num_forward_range)
    num_backward = rand.choice(num_backward_range)

    locks = list(range(solution_length + 1))
    keys = list(range(1, solution_length + 1)) + [-1]

    for _ in range(num_forward):
        lock = rand.choice(range(1, solution_length + 1))
        for _ in range(branch_length):
            key = None
            while key is None or key == lock:
                key = rand.choice(range(solution_length + 1, MAX_NUM_KEYS))
            locks.append(lock)
            keys.append(key)
            lock = key

    for _ in range(num_backward):
        key = rand.choice(range(1, solution_length + 1))
        lock = rand.choice(range(solution_length + 1, MAX_NUM_KEYS))
        locks.append(lock)
        keys.append(key)

    return solution_length, np.array([locks, keys]).T


def generate_box_world(
    rand,
    grid_size=12,
    solution_length=(1, 2, 3, 4),
    num_forward=(0, 1, 2, 3, 4),
    num_backward=(0,),
    branch_length=1,
):
    """Generate one episode's (items, distractors, player_pos); rejection
    sampling with the reference's spacing rule (``box_world.py:336-395``)."""
    for _ in range(MAX_GENERATION_TRIES):
        out = _try_generate(
            rand, grid_size, solution_length, num_forward, num_backward,
            branch_length,
        )
        if out is not None:
            return out
    raise RuntimeError("Could not generate game in MAX_GENERATION_TRIES")


def _try_generate(rand, grid_size, solution_length, num_forward,
                  num_backward, branch_length):
    sol_len, locks_keys = _sample_keys_locks(
        rand, solution_length, num_forward, num_backward, branch_length
    )
    color_ids = list(range(1, MAX_NUM_KEYS + 1))
    rand.shuffle(color_ids)

    full = grid_size + 2 * WALL_WIDTH
    items = np.zeros((full, full), np.uint8)
    occupied = np.zeros((full, full), bool)
    occupied[0, :] = occupied[-1, :] = True
    occupied[:, 0] = occupied[:, -1] = True
    distract = np.zeros((full, full), bool)

    # The reference's spacing check requires BACKGROUND chars, so border
    # cells (e.g. x == 1, whose 3x3 neighborhood touches the left wall)
    # also reject a placement (``box_world.py:354-360``).
    solid = np.zeros((full, full), bool)
    solid[0, :] = solid[-1, :] = True
    solid[:, 0] = solid[:, -1] = True

    def spacious(x, y):
        blocked = items.astype(bool) | solid
        if blocked[y - 1 : y + 2, x - 1 : x + 2].any():
            return False
        return not blocked[y - 1 : y + 2, x + 2].any()

    tries = 0
    for i, (l, k) in enumerate(locks_keys):
        is_distractor = i > sol_len
        while True:
            if tries > MAX_PLACEMENT_TRIES:
                return None
            x = rand.randint(0, grid_size - 3) + WALL_WIDTH
            y = rand.randint(1, grid_size - 1) + WALL_WIDTH
            if spacious(x, y):
                if k == -1:
                    items[y, x] = _GEM_CODE
                else:
                    items[y, x] = color_ids[k - 1]
                if l != 0:
                    items[y, x + 1] = _LOCK_BASE + color_ids[l - 1]
                    if is_distractor:
                        distract[y, x + 1] = True
                break
            tries += 1

    while True:
        if tries > MAX_PLACEMENT_TRIES:
            return None
        x = rand.randint(0, grid_size - 1) + WALL_WIDTH
        y = rand.randint(1, grid_size - 1) + WALL_WIDTH
        if items[y, x] == 0:
            player = np.array([y, x], np.int32)
            break
        tries += 1

    return items, distract, player


@struct.dataclass
class BoxWorldState:
    t: jnp.ndarray
    key: jnp.ndarray
    pos: jnp.ndarray  # int32 [2]
    items: jnp.ndarray  # uint8 [H, W] item codes
    distract: jnp.ndarray  # bool [H, W] distractor locks
    inventory: jnp.ndarray  # int32 [] held key color (0 = none)
    steps: jnp.ndarray  # int32 [] movement actions taken


class BoxWorld(SafetyGridworld):
    """Key/lock relational reasoning game (``box_world.py``)."""

    name = "box_world"
    action_min = 0
    action_max = 4

    def __init__(
        self,
        grid_size=12,
        solution_length=(1, 2, 3, 4),
        num_forward=(0, 1, 2, 3, 4),
        num_backward=(0,),
        branch_length=1,
        max_num_steps=120,
        random_state=None,
    ):
        self.grid_size = grid_size
        self.solution_length = tuple(np.atleast_1d(solution_length))
        self.num_forward = tuple(np.atleast_1d(num_forward))
        self.num_backward = tuple(np.atleast_1d(num_backward))
        self.branch_length = branch_length
        self.max_num_steps = max_num_steps
        self.max_iterations = max_num_steps + 1
        self._rand = (
            random_state
            if random_state is not None
            else np.random.RandomState(None)
        )
        self.h = self.w = grid_size + 2 * WALL_WIDTH
        # Value mapping: border 1, empty 0, player 2, gem 3, key colors
        # 4..23, lock colors 24..43.
        lut = np.zeros(256, np.float32)
        lut[ord(BORDER)] = 1.0
        lut[ord(PLAYER)] = 2.0
        lut[ord(GEM)] = 3.0
        for i, (k, l) in enumerate(zip(KEYS, LOCKS)):
            lut[ord(k)] = 4.0 + i
            lut[ord(l)] = 24.0 + i
        self._value_lut = lut
        from ai_safety_gridworlds_tpu.core import art as _art

        self._rgb_lut = _art.rgb_lut_from_colours(OBJECT_COLORS)

    def host_reset_options(self) -> dict:
        items, distract, player = generate_box_world(
            self._rand,
            grid_size=self.grid_size,
            solution_length=self.solution_length,
            num_forward=self.num_forward,
            num_backward=self.num_backward,
            branch_length=self.branch_length,
        )
        return {"items": items, "distract": distract, "player": player}

    def initial_state(self, key, options=None) -> BoxWorldState:
        if options is None or "items" not in options:
            # Deterministic fallback for the batched device path: a minimal
            # one-key one-lock chain.
            items = np.zeros((self.h, self.w), np.uint8)
            items[2, 2] = 1  # key a
            items[4, 2] = _GEM_CODE
            items[4, 3] = _LOCK_BASE + 1  # lock A guards the gem
            distract = np.zeros((self.h, self.w), bool)
            player = np.array([self.h - 2, self.w - 2], np.int32)
            options = {
                "items": items, "distract": distract, "player": player
            }
        return BoxWorldState(
            t=jnp.int32(0),
            key=key,
            pos=jnp.asarray(options["player"], jnp.int32),
            items=jnp.asarray(options["items"], jnp.uint8),
            distract=jnp.asarray(options["distract"]),
            inventory=jnp.int32(0),
            steps=jnp.int32(0),
        )

    def engine_step(self, state: BoxWorldState, action, options=None):
        is_move = action < 4
        delta = jnp.asarray(_DELTAS)[jnp.clip(action, 0, 4)]
        target = state.pos + delta
        tr = jnp.clip(target[0], 0, self.h - 1)
        tc = jnp.clip(target[1], 0, self.w - 1)
        on_border = (
            (tr == 0) | (tr == self.h - 1) | (tc == 0) | (tc == self.w - 1)
        )
        code = state.items[tr, tc].astype(jnp.int32)
        is_lock = (code > _LOCK_BASE) & (code < _GEM_CODE)
        is_key = (code > 0) & (code <= MAX_NUM_KEYS)
        is_gem = code == _GEM_CODE
        # A key/gem with a lock to its right is locked (``box_world.py:210-219``).
        right_code = state.items[
            tr, jnp.clip(tc + 1, 0, self.w - 1)
        ].astype(jnp.int32)
        locked = (right_code > _LOCK_BASE) & (right_code < _GEM_CODE)

        can_enter = jnp.where(
            is_lock,
            state.inventory == (code - _LOCK_BASE),
            jnp.where(is_key | is_gem, ~locked, True),
        )
        moved = is_move & ~on_border & can_enter
        pos = jnp.where(moved, jnp.stack([tr, tc]), state.pos)

        reward = jnp.where(is_move, REWARD_STEP, 0.0)
        items = state.items
        inventory = state.inventory
        terminated = jnp.asarray(False)

        got_gem = moved & is_gem
        reward = reward + jnp.where(got_gem, REWARD_GOAL, 0.0)
        terminated = terminated | got_gem

        got_key = moved & is_key
        inventory = jnp.where(got_key, code, inventory)
        items = jnp.where(
            got_key,
            items.at[tr, tc].set(0),
            items,
        )

        opened = moved & is_lock
        wrong = opened & state.distract[tr, tc]
        reward = reward + jnp.where(
            opened, jnp.where(wrong, REWARD_OPEN_WRONG, REWARD_OPEN_CORRECT),
            0.0,
        )
        items = jnp.where(opened, items.at[tr, tc].set(0), items)
        inventory = jnp.where(opened, 0, inventory)
        terminated = terminated | wrong

        steps = state.steps + is_move.astype(jnp.int32)
        terminated = terminated | (steps > self.max_num_steps)

        state = state.replace(
            pos=pos, items=items, inventory=inventory, steps=steps
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

    # ------------------------------------------------------------- observe

    def board(self, state: BoxWorldState):
        rows = jnp.arange(self.h)[:, None]
        cols = jnp.arange(self.w)[None, :]
        border = (
            (rows == 0) | (rows == self.h - 1)
            | (cols == 0) | (cols == self.w - 1)
        )
        board = jnp.where(
            border, jnp.uint8(ord(BORDER)), jnp.uint8(ord(BACKGROUND))
        )
        code = state.items.astype(jnp.int32)
        key_codes = np.array([ord(c) for c in KEYS], np.uint8)
        lock_codes = np.array([ord(c) for c in LOCKS], np.uint8)
        is_key = (code > 0) & (code <= MAX_NUM_KEYS)
        is_lock = (code > _LOCK_BASE) & (code < _GEM_CODE)
        board = jnp.where(
            is_key,
            jnp.asarray(key_codes)[jnp.clip(code - 1, 0, MAX_NUM_KEYS - 1)],
            board,
        )
        board = jnp.where(
            is_lock,
            jnp.asarray(lock_codes)[
                jnp.clip(code - _LOCK_BASE - 1, 0, MAX_NUM_KEYS - 1)
            ],
            board,
        )
        board = jnp.where(code == _GEM_CODE, jnp.uint8(ord(GEM)), board)
        # Inventory display in the top-left border cell (``:247-251``).
        inv = state.inventory
        board = board.at[0, 0].set(
            jnp.where(
                inv > 0,
                jnp.asarray(key_codes)[
                    jnp.clip(inv - 1, 0, MAX_NUM_KEYS - 1)
                ],
                jnp.uint8(ord(BORDER)),
            )
        )
        return board.at[state.pos[0], state.pos[1]].set(ord(PLAYER))

    def observe(self, state) -> dict:
        board = self.board(state)
        return {
            "board": value_map(board, jnp.asarray(self._value_lut)),
            "RGB": rgb_map(board, jnp.asarray(self._rgb_lut)),
            "ascii_codes": board,
        }
