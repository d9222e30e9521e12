"""Fully-fused batched island_navigation_ex_ma packed step.

Same architecture as :mod:`ops.fused_firemaker` / :mod:`ops.fused_savanna`:
the WHOLE multi-agent step — action draws, randomized agent order, every
sequential sub-step (relative direction updates, move + collision, goal,
drink/food consumption with scalar availability, gold/silver, gap visits,
satiation homeostasis, water death drape, sustainability regrowth),
finalize, and auto-reset — restructured into one scatter-free, gather-free
computation over a packed batch layout ([cells, B] boards, batch on the
minor lane axis), run by ``FusedMaBase``'s drivers as one jitted
``lax.scan`` per rollout chunk.

This environment is the cheapest of the three MA flagships to fuse: the
sub-step consumes NO per-cell randomness (no predators, no fire), and
resource availability is a per-environment scalar — so the only
[cells, B]-scale work per sub-step is two one-hot reductions (wall at the
move candidate, combined tile code + water distance at the new position).
Every agent's current tile value is cached in a ``vcode`` row and updated
only when that agent moves, which the per-sub-step water-death drape and
the regrowth gate read without touching the board again.

Unlike the fused savanna kernel, ``sustainability_challenge=True`` IS
supported: depletion/regrowth act on the scalar availability, never on the
curtains (``island_navigation_ex_ma.py:619-704,760-840`` in the reference
``/root/reference/ai_safety_gridworlds/environments/island_navigation_ex_ma.py``).
All direction modes (0 fixed / 1 relative / 2 relative-with-turns), agent
counts, thirst-death / oversatiation / proportional-reward flags, and
per-lane map randomization are supported.

Equivalence is asserted by ``tests/test_fused_island_ma.py`` by injecting
this kernel's draws (agent order + actions; there are no others) into the
per-env ``apply_substep`` chain, which is itself lockstep-tested against
the reference (``tests/test_island_navigation_ex_ma.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core.actions import (
    ACTION_DELTAS_MO,
    ActionsMo,
    Directions,
    DIR_TO_ACTION_MO,
    MODE_DIR_TABLES,
)
from ai_safety_gridworlds_tpu.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_tpu.ops import prng
from ai_safety_gridworlds_tpu.ops.fused_base import FusedMaBase, min_water_dist

_I32 = jnp.int32
_F32 = jnp.float32

FIRST = int(StepType.FIRST)
MID = int(StepType.MID)
LAST = int(StepType.LAST)
DEAD = int(StepType.DEAD)
NONE = int(TerminationReason.NONE)
QUIT_R = int(TerminationReason.QUIT)
TERMINATED_R = int(TerminationReason.TERMINATED)

NOOP = int(ActionsMo.NOOP)
QUIT = int(ActionsMo.QUIT)

# Tile-code ids for the combined static board. Exactly one char per cell
# (agent start cells read as gap, matching ``_nongap_static`` which
# excludes agent chars), so codes are mutually exclusive.
TILE_CODES = {
    "gap": 0, "wall": 1, "water": 2, "goal": 3,
    "drink": 4, "food": 5, "gold": 6, "silver": 7,
}


def _table_sel(table_2d, action_ids, dir_ids):
    """table[action, dir] for a tiny static [n_actions, 4] table via a
    select chain (gathers are banned in the packed layout)."""
    out = jnp.zeros_like(dir_ids)
    for d in range(4):
        row = jnp.zeros_like(action_ids) + int(table_2d[0, d])
        for a in range(1, table_2d.shape[0]):
            row = jnp.where(action_ids == a, int(table_2d[a, d]), row)
        out = jnp.where(dir_ids == d, row, out)
    return out


class FusedIslandMa(FusedMaBase):
    """Packed batched island_navigation_ex_ma with a fused step."""

    # In-step linear-policy features per agent (``set_policies``):
    # normalized row/col, drink/food satiation, drink/food availability,
    # action-direction one-hot.
    POLICY_FEATURES = 10

    def __init__(self, env):
        if (
            env.observation_direction_mode == 2
            and env.action_direction_mode == 0
        ):
            # Match the per-env path (``core/actions.py:217-219``), which
            # rejects this combination.
            raise NotImplementedError(
                "observation mode 2 with fixed action mode"
            )
        self.env = env
        self.n = env.n_agents
        self.D = env.reward_space.n_dims
        h, w = env._wall_mask.shape
        self.h, self.w, self.HW = h, w, h * w
        cfg = env.cfg
        self.cfg = cfg
        self.max_iterations = int(env.max_iterations)
        self.amin, self.amax = int(env.action_min), int(env.action_max)
        self.adm = int(env.action_direction_mode)
        self.odm = int(env.observation_direction_mode)

        from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
            DANGER_TILE_CHR, DRINK_CHR, FOOD_CHR, GOLD_CHR, SILVER_CHR,
            ULTIMATE_GOAL_CHR,
        )

        self._chr = {
            "water": DANGER_TILE_CHR, "goal": ULTIMATE_GOAL_CHR,
            "drink": DRINK_CHR, "food": FOOD_CHR, "gold": GOLD_CHR,
            "silver": SILVER_CHR,
        }
        self.has = {
            "goal": env._has[ULTIMATE_GOAL_CHR],
            "drink": env._has[DRINK_CHR],
            "food": env._has[FOOD_CHR],
            "gold": env._has[GOLD_CHR],
            "silver": env._has[SILVER_CHR],
            "water": env._has[DANGER_TILE_CHR],
        }
        self.thirst_death = bool(
            cfg["thirst_hunger_death"]
            and (self.has["drink"] or self.has["food"])
        )

        # Reward vectors tiled over [n*D] rows; all-zero vectors drop their
        # terms (the per-env path adds exact zeros there).
        def tiled(mo):
            try:
                vec = np.asarray(env.rvec(mo), np.float32)
            except ValueError:
                return None
            if not np.abs(vec).sum():
                return None
            return np.tile(vec, self.n).reshape(self.n * self.D, 1)

        self.rv = {
            k: tiled(cfg[k])
            for k in (
                "MOVEMENT_REWARD", "FINAL_REWARD", "DRINK_REWARD",
                "FOOD_REWARD", "GOLD_REWARD", "SILVER_REWARD",
                "DANGER_TILE_REWARD", "THIRST_HUNGER_DEATH_REWARD",
                "DRINK_DEFICIENCY_REWARD", "FOOD_DEFICIENCY_REWARD",
                "DRINK_OVERSATIATION_REWARD", "FOOD_OVERSATIATION_REWARD",
                "NON_DRINK_REWARD", "NON_FOOD_REWARD", "GAP_REWARD",
            )
        }

        row_agent = (np.arange(self.n * self.D) // self.D).astype(np.int32)
        vrows = np.arange(self.n * 5, dtype=np.int32)
        self.consts = {
            "row_agent": row_agent.reshape(-1, 1).astype(np.float32),
            "vrow_agent": (vrows // 5).reshape(-1, 1),
            "vrow_col": (vrows % 5).reshape(-1, 1),
        }
        for k, v in self.rv.items():
            if v is not None:
                self.consts["rv_" + k] = v
        for j in range(self.n):
            self.consts[f"arm_{j}"] = (
                (row_agent == j).astype(np.float32).reshape(-1, 1)
            )

        # Draw sites per step: 0 actions, 1 permutation. The sub-steps
        # themselves consume no randomness.
        self.n_sites = 2

    # ------------------------------------------------------------- packing

    def _code_and_dist(self, boards):
        """[HW, B] combined static board for per-lane uint8 boards."""
        env = self.env
        HW, w, batch = self.HW, self.w, boards.shape[1]
        code = np.zeros((HW, batch), np.float32)
        for name, cid in TILE_CODES.items():
            if name in ("gap", "wall"):
                continue
            code += cid * (boards == ord(self._chr[name]))
        from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
            WALL_CHR,
        )

        code += TILE_CODES["wall"] * (boards == ord(WALL_CHR))
        # Min-Manhattan distance to water per lane (99 when none), matching
        # ``_apply_board``'s ``_water_dist`` table exactly.
        dist = min_water_dist(
            boards == ord(self._chr["water"]), self.h, w
        )
        return code + 16.0 * dist.astype(np.float32)

    def init_packed(self, seed: int, batch: int, layout_pool: int = 1) -> dict:
        """Pack a batch into the [rows, B] layout. With map randomization
        enabled, one independent layout is drawn per lane on the host (the
        same interior shuffle as ``host_reset_options_with_generator``);
        in-step auto-reset restores each lane's OWN initial map.
        ``layout_pool=K > 1`` draws K independent layouts per lane and the
        auto-reset cycles them per episode (``ep_idx % K``) — approximating
        fresh-map-per-episode semantics (see ``fused_savanna.init_packed``)."""
        env = self.env
        n, HW = self.n, self.HW
        K = int(layout_pool)
        if K < 1:
            raise ValueError("layout_pool must be >= 1")
        if K > 1 and not env.cfg["map_randomization_frequency"] >= 1:
            raise ValueError(
                "layout_pool > 1 requires map_randomization_frequency >= 1"
            )
        keys = prng.derive_keys(seed, batch)
        from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
            AGENT_CHRS, GAME_ART, GAP_CHR,
        )
        from ai_safety_gridworlds_tpu.mo.map_randomization import (
            randomize_map,
        )

        cfg = env.cfg
        base = np.asarray(env._orig_board, np.uint8)
        rng = np.random.Generator(np.random.PCG64(seed ^ 0x15A17D))

        def draw_boards():
            if not cfg["map_randomization_frequency"] >= 1:
                return np.tile(base.reshape(-1, 1), (1, 1))  # [HW, 1]
            counts = {c: 1 for c in env.agent_chars}
            for c in AGENT_CHRS[env.n_agents :]:
                if any(c in row for row in GAME_ART[env.level]):
                    counts[c] = 0
            return np.stack(
                [
                    randomize_map(
                        base, rng,
                        what_lies_beneath=GAP_CHR,
                        what_lies_outside=self._chr["water"],
                        tile_type_counts=counts,
                        map_randomization_frequency=cfg[
                            "map_randomization_frequency"
                        ],
                        preserve_map_edges=True,
                        map_width=cfg["map_width"],
                        map_height=cfg["map_height"],
                    ).reshape(-1)
                    for _ in range(batch)
                ],
                axis=1,
            )  # [HW, B]

        from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
            WALL_CHR,
        )

        def layout_statics(boards):
            wall = (boards == ord(WALL_CHR)).astype(np.float32)
            sboard = self._code_and_dist(boards)
            bl = boards.shape[1]
            pos0 = np.zeros((n, bl), np.int32)
            for i, c in enumerate(env.agent_chars):
                pos0[i] = np.argmax(boards == ord(c), axis=0)
            # Cached tile value at each agent's start cell. Start cells
            # hold the agent char itself -> code 0 (gap), but the distance
            # part matters.
            vcode0 = np.take_along_axis(sboard, pos0, axis=0).astype(
                np.float32
            )
            return {
                "wall": wall, "sboard": sboard, "pos0": pos0,
                "vcode0": vcode0,
            }

        pool_boards = [draw_boards() for _ in range(K)]
        pools = [layout_statics(b) for b in pool_boards]
        kstatics = dict(pools[0])
        for k in range(1, K):
            for key_, v in pools[k].items():
                kstatics[key_ + f"_p{k}"] = v
        self.layout_pool = K
        self._kstatics_np = kstatics
        self.packed_batch = int(batch)
        self._invalidate_device_cache()
        self._boards_np = pool_boards[0]
        self._boards_np_pool = pool_boards
        boards = pool_boards[0]
        pos0, vcode0 = pools[0]["pos0"], pools[0]["vcode0"]

        def tile_b(arr):
            return (
                jnp.asarray(np.tile(arr, (1, batch)))
                if arr.shape[1] == 1 and batch > 1
                else jnp.asarray(arr)
            )

        sat0 = {
            "drink": float(cfg["DRINK_DEFICIENCY_INITIAL"]),
            "food": float(cfg["FOOD_DEFICIENCY_INITIAL"]),
        }
        self.sat0 = sat0
        av0 = {
            "drink": float(cfg["DRINK_AVAILABILITY_INITIAL"]),
            "food": float(cfg["FOOD_AVAILABILITY_INITIAL"]),
        }
        self.av0 = av0

        state = {
            "pos": tile_b(pos0),
            "vcode": tile_b(vcode0),
            "reasons": jnp.full((n, batch), NONE, _I32),
            "step_types": jnp.full((n, batch), FIRST, _I32),
            "act_dir": jnp.full((n, batch), int(Directions.UP), _I32),
            "obs_dir": jnp.full((n, batch), int(Directions.UP), _I32),
            "drink_sat": jnp.full((n, batch), sat0["drink"], _F32),
            "food_sat": jnp.full((n, batch), sat0["food"], _F32),
            "drink_avail": jnp.full((1, batch), av0["drink"], _F32),
            "food_avail": jnp.full((1, batch), av0["food"], _F32),
            "drink_frac": jnp.zeros((1, batch), _F32),
            "food_frac": jnp.zeros((1, batch), _F32),
            "visits": jnp.zeros((n * 5, batch), _I32),
            "safety": jnp.full((n, batch), 3, _I32),
            "t": jnp.zeros((1, batch), _I32),
            "key": jnp.asarray(keys),
            "draw_ctr": jnp.zeros((1, batch), jnp.uint32),
            "stats_rewards": jnp.zeros((n * self.D, batch), _F32),
            "stats_episodes": jnp.zeros((1, batch), _I32),
        }
        fields = tuple(f for f in self.STATE_FIELDS if f != "ep_idx")
        if K > 1:
            state["ep_idx"] = jnp.zeros((1, batch), _I32)
            fields = fields + ("ep_idx",)
        self.STATE_FIELDS = fields
        return state

    STATE_FIELDS = (
        "pos", "vcode", "reasons", "step_types", "act_dir", "obs_dir",
        "drink_sat", "food_sat", "drink_avail", "food_avail", "drink_frac",
        "food_frac", "visits", "safety", "t", "key", "draw_ctr",
        "stats_rewards", "stats_episodes",
    )

    # ----------------------------------------------------------- step body

    def _policy_feats(self, pos, drink_sat, food_sat, drink_av, food_av,
                      act_dir):
        """Per-agent [1, B] feature rows for in-step linear policies
        (observed at the start of the step, post auto-reset)."""
        feats = []
        for j in range(self.n):
            pos_f, onehot = self._pos_dir_feats(pos, act_dir, j)
            feats.append(
                pos_f
                + [
                    drink_sat[j : j + 1] * _F32(0.1),
                    food_sat[j : j + 1] * _F32(0.1),
                    drink_av * _F32(0.05),
                    food_av * _F32(0.05),
                ]
                + onehot
            )
        return feats

    def _step(self, S, statics, consts, collect_draws: bool = False):
        """One full MA step on packed arrays (pure jnp)."""
        env, cfg = self.env, self.cfg
        n, D, HW, W, H = self.n, self.D, self.HW, self.w, self.h
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        iota_n = jax.lax.broadcasted_iota(_I32, (n, 1), 0)
        iota_hw = jax.lax.broadcasted_iota(_I32, (HW, 1), 0)

        # ---- auto-reset lanes whose episode ended last step ----------------
        types = S["step_types"]
        over = jnp.all(
            (types == LAST) | (types == DEAD), axis=0, keepdims=True
        )

        # Layout pool: per-episode layout via a K-way select (ep_idx % K).
        pooled, ep_idx = self._pool_select(statics, over, S)

        wall_f = pooled("wall")
        sboard = pooled("sboard")
        pos0 = pooled("pos0").astype(_I32)
        vcode0 = pooled("vcode0")

        pos = jnp.where(over, pos0, S["pos"])
        vcode = jnp.where(over, vcode0, S["vcode"])
        reasons = jnp.where(over, NONE, S["reasons"])
        types = jnp.where(over, FIRST, types)
        act_dir = jnp.where(over, int(Directions.UP), S["act_dir"])
        obs_dir = jnp.where(over, int(Directions.UP), S["obs_dir"])
        drink_sat = jnp.where(over, _F32(self.sat0["drink"]), S["drink_sat"])
        food_sat = jnp.where(over, _F32(self.sat0["food"]), S["food_sat"])
        drink_av = jnp.where(over, _F32(self.av0["drink"]), S["drink_avail"])
        food_av = jnp.where(over, _F32(self.av0["food"]), S["food_avail"])
        drink_fr = jnp.where(over, 0.0, S["drink_frac"])
        food_fr = jnp.where(over, 0.0, S["food_frac"])
        visits = jnp.where(over, 0, S["visits"])
        safety = jnp.where(over, 3, S["safety"])
        t = jnp.where(over, 0, S["t"])

        ctr0 = S["draw_ctr"] * np.uint32(self.n_sites)
        feats = None
        if "pol_w" in statics or "mlp_w1" in statics:
            feats = self._policy_feats(
                pos, drink_sat, food_sat, drink_av, food_av, act_dir
            )
        actions, order, pol = self._draw_actions_and_order(
            S, over, reasons, ctr0, iota_n, feats=feats, statics=statics
        )

        rewards = jnp.zeros((n * D,) + actions.shape[1:], _F32)
        row_agent = consts["row_agent"]
        vrow_agent = consts["vrow_agent"]
        vrow_col = consts["vrow_col"]
        arm = {j: consts[f"arm_{j}"] for j in range(n)}
        rv = {
            k: (consts["rv_" + k] if v is not None else None)
            for k, v in self.rv.items()
        }

        def addr(rewards, key_, sel_nd, cond_f):
            if rv[key_] is None:
                return rewards
            return rewards + rv[key_] * sel_nd * cond_f

        def code_of(v):
            dw = jnp.floor(v * _F32(1.0 / 16.0))
            return v - 16.0 * dw, dw

        deltas = np.asarray(ACTION_DELTAS_MO)
        growth_limits = {
            # Faithful reference quirks: the drink regrowth *condition*
            # consults the DEFAULT growth limit, and food regrowth uses the
            # DRINK exponent (``envs/island_navigation_ex_ma.py:843-868``).
            "drink_cond": None,
            "food_cond": float(cfg["FOOD_GROWTH_LIMIT"]),
        }
        from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
            DEFAULTS as _DEFAULTS,
        )

        growth_limits["drink_cond"] = float(_DEFAULTS["DRINK_GROWTH_LIMIT"])

        for slot in range(n):
            i = order[slot : slot + 1]  # [1, B]
            # One-hot extraction returns actions[i] verbatim (incl. -1).
            a = jnp.sum(
                jnp.where(iota_n == i, actions, 0), axis=0, keepdims=True
            )
            acting = a >= 0
            actf = acting.astype(_F32)
            sel = iota_n == i
            sel_f = sel.astype(_F32)
            sel_nd = (row_agent == i.astype(_F32)).astype(_F32)
            is_quit = a == QUIT
            is_noop = a == NOOP
            dead_i = jnp.any(sel & (reasons != NONE), axis=0, keepdims=True)
            active = acting & ~is_quit & ~dead_i
            activef = active.astype(_F32)
            t = t + acting.astype(_I32)
            a_cl = jnp.clip(a, 0, 9)

            # --- direction updates (``engine_substep:561-610``) -------------
            dir_i = jnp.sum(jnp.where(sel, act_dir, 0), axis=0, keepdims=True)
            odir_i = jnp.sum(
                jnp.where(sel, obs_dir, 0), axis=0, keepdims=True
            )
            if self.odm != 0:
                if self.odm == 1:
                    otab = MODE_DIR_TABLES[1 if self.adm in (1, 2) else 0]
                else:
                    otab = MODE_DIR_TABLES[2]
                new_odir = _table_sel(otab, a_cl, odir_i)
                obs_dir = jnp.where(sel & active, new_odir, obs_dir)
            if self.adm == 0:
                abs_action = a
            else:
                is_move = (a >= 1) & (a <= 4)
                rel = _table_sel(MODE_DIR_TABLES[1], a_cl, dir_i)
                abs_move = jnp.zeros_like(rel) + int(DIR_TO_ACTION_MO[0])
                for d in range(1, 4):
                    abs_move = jnp.where(
                        rel == d, int(DIR_TO_ACTION_MO[d]), abs_move
                    )
                abs_action = jnp.where(is_move, abs_move, a)
                new_adir = _table_sel(MODE_DIR_TABLES[self.adm], a_cl, dir_i)
                act_dir = jnp.where(sel & active, new_adir, act_dir)

            # --- move with explicit bounds (board edges are not all-wall:
            # water borders are passable-and-lethal) ------------------------
            pos_i = jnp.sum(jnp.where(sel, pos, 0), axis=0, keepdims=True)
            r_i = pos_i // W
            c_i = pos_i % W
            dr = jnp.zeros_like(a)
            dc = jnp.zeros_like(a)
            for aid in range(deltas.shape[0]):
                if deltas[aid, 0]:
                    dr = jnp.where(abs_action == aid, int(deltas[aid, 0]), dr)
                if deltas[aid, 1]:
                    dc = jnp.where(abs_action == aid, int(deltas[aid, 1]), dc)
            cr, cc2 = r_i + dr, c_i + dc
            inb = (cr >= 0) & (cr < H) & (cc2 >= 0) & (cc2 < W)
            cand = jnp.clip(cr, 0, H - 1) * W + jnp.clip(cc2, 0, W - 1)
            cand_oh = iota_hw == cand
            occ = jnp.any((pos == cand) & ~sel, axis=0, keepdims=True)
            wall_at = (
                jnp.sum(cand_oh * wall_f, axis=0, keepdims=True) > 0.5
            )
            moved = active & inb & ~wall_at & ~occ
            new_pos_i = jnp.where(moved, cand, pos_i)
            pos = jnp.where(sel, new_pos_i, pos)
            reasons = jnp.where(sel & is_quit & ~dead_i, QUIT_R, reasons)

            np_oh = iota_hw == new_pos_i
            v_at = jnp.sum(
                np_oh.astype(_F32) * sboard, axis=0, keepdims=True
            )
            vcode = jnp.where(sel, v_at, vcode)
            code_at, dw_at = code_of(v_at)

            rewards = addr(
                rewards, "MOVEMENT_REWARD", sel_nd,
                (active & ~is_noop).astype(_F32),
            )
            safety = jnp.where(sel & active, dw_at.astype(_I32), safety)

            # --- satiation decrements + thirst/hunger death -----------------
            sat_sel = sel_f * activef
            if cfg["penalise_oversatiation"]:
                drink_sat = drink_sat + sat_sel * _F32(
                    cfg["DRINK_DEFICIENCY_RATE"]
                )
                food_sat = food_sat + sat_sel * _F32(
                    cfg["FOOD_DEFICIENCY_RATE"]
                )
            if self.thirst_death:
                dsat_i = jnp.sum(drink_sat * sel_f, axis=0, keepdims=True)
                fsat_i = jnp.sum(food_sat * sel_f, axis=0, keepdims=True)
                dying = active & (
                    (dsat_i <= _F32(cfg["DRINK_DEFICIENCY_LIMIT"]))
                    | (fsat_i <= _F32(cfg["FOOD_DEFICIENCY_LIMIT"]))
                )
                rewards = addr(
                    rewards, "THIRST_HUNGER_DEATH_REWARD", sel_nd,
                    dying.astype(_F32),
                )
                reasons = jnp.where(
                    sel & dying & (reasons == NONE), TERMINATED_R, reasons
                )

            # --- ultimate goal ---------------------------------------------
            if self.has["goal"]:
                on_goal = (code_at == float(TILE_CODES["goal"])) & active
                rewards = addr(
                    rewards, "FINAL_REWARD", sel_nd, on_goal.astype(_F32)
                )
                reasons = jnp.where(
                    sel & on_goal & (reasons == NONE), TERMINATED_R, reasons
                )

            # --- drink / food with scalar availability ----------------------
            def consume(rewards, sat, av, ckey, rkey, rate, limit,
                        visit_col):
                on_tile = (code_at == float(TILE_CODES[ckey])) & active
                nonlocal visits
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == visit_col)
                ).astype(_I32) * on_tile.astype(_I32)
                got = on_tile & (av > 0)
                gotf = got.astype(_F32)
                rewards = addr(rewards, rkey, sel_nd, gotf)
                if cfg["penalise_oversatiation"]:
                    sat = sat + sel_f * gotf * jnp.minimum(
                        av, _F32(rate)
                    )
                if limit >= 0:
                    sat_i = jnp.sum(sat * sel_f, axis=0, keepdims=True)
                    clamp = got & (sat_i > 0)
                    sat = jnp.where(
                        sel & clamp, jnp.minimum(_F32(limit), sat), sat
                    )
                av = jnp.where(got, jnp.maximum(0.0, av - _F32(rate)), av)
                return rewards, sat, av

            if self.has["drink"]:
                rewards, drink_sat, drink_av = consume(
                    rewards, drink_sat, drink_av, "drink", "DRINK_REWARD",
                    float(cfg["DRINK_EXTRACTION_RATE"]),
                    float(cfg["DRINK_OVERSATIATION_LIMIT"]), 1,
                )
                on_drink_t = (
                    code_at == float(TILE_CODES["drink"])
                ) & active
                rewards = addr(
                    rewards, "NON_DRINK_REWARD", sel_nd,
                    (active & ~on_drink_t).astype(_F32),
                )
            if self.has["food"]:
                rewards, food_sat, food_av = consume(
                    rewards, food_sat, food_av, "food", "FOOD_REWARD",
                    float(cfg["FOOD_EXTRACTION_RATE"]),
                    float(cfg["FOOD_OVERSATIATION_LIMIT"]), 2,
                )
                on_food_t = (
                    code_at == float(TILE_CODES["food"])
                ) & active
                rewards = addr(
                    rewards, "NON_FOOD_REWARD", sel_nd,
                    (active & ~on_food_t).astype(_F32),
                )
            if self.has["gold"]:
                on_gold = (code_at == float(TILE_CODES["gold"])) & active
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == 3)
                ).astype(_I32) * on_gold.astype(_I32)
                rewards = addr(
                    rewards, "GOLD_REWARD", sel_nd, on_gold.astype(_F32)
                )
            if self.has["silver"]:
                on_silver = (code_at == float(TILE_CODES["silver"])) & active
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == 4)
                ).astype(_I32) * on_silver.astype(_I32)
                rewards = addr(
                    rewards, "SILVER_REWARD", sel_nd, on_silver.astype(_F32)
                )

            # --- gap visit ---------------------------------------------------
            others = jnp.any((pos == new_pos_i) & ~sel, axis=0, keepdims=True)
            on_gap = (code_at == 0.0) & ~others & active
            visits = visits + (
                (vrow_agent == i) & (vrow_col == 0)
            ).astype(_I32) * on_gap.astype(_I32)
            rewards = addr(
                rewards, "GAP_REWARD", sel_nd, on_gap.astype(_F32)
            )

            # --- homeostasis thresholds (``engine_substep:772-806``) --------
            def homeo(rewards, sat, dkey, okey, enabled):
                if not enabled:
                    return rewards
                sat_i = jnp.sum(sat * sel_f, axis=0, keepdims=True)
                deficient = (
                    sat_i < _F32(cfg[dkey + "_THRESHOLD"])
                ) & active
                if cfg["use_satiation_proportional_reward"]:
                    if rv[dkey + "_REWARD"] is not None:
                        rewards = rewards + (
                            rv[dkey + "_REWARD"] * sel_nd
                            * jnp.where(deficient, -sat_i, 0.0)
                        )
                else:
                    rewards = addr(
                        rewards, dkey + "_REWARD", sel_nd,
                        deficient.astype(_F32),
                    )
                if cfg["penalise_oversatiation"]:
                    overs = (
                        (sat_i > _F32(cfg[okey + "_THRESHOLD"]))
                        & ~deficient & active
                    )
                    if cfg["use_satiation_proportional_reward"]:
                        if rv[okey + "_REWARD"] is not None:
                            rewards = rewards + (
                                rv[okey + "_REWARD"] * sel_nd
                                * jnp.where(overs, sat_i, 0.0)
                            )
                    else:
                        rewards = addr(
                            rewards, okey + "_REWARD", sel_nd,
                            overs.astype(_F32),
                        )
                return rewards

            rewards = homeo(
                rewards, drink_sat, "DRINK_DEFICIENCY",
                "DRINK_OVERSATIATION", self.has["drink"],
            )
            rewards = homeo(
                rewards, food_sat, "FOOD_DEFICIENCY",
                "FOOD_OVERSATIATION", self.has["food"],
            )

            # --- water-death drape: ALL agents, every sub-step --------------
            # (``engine_substep:810-824``); reads the cached tile codes.
            codes_all, _ = code_of(vcode)  # [n, B]
            if self.has["water"]:
                in_water = codes_all == float(TILE_CODES["water"])
                in_water_nd = jnp.zeros_like(rewards[:1])
                for j in range(n):
                    in_water_nd = in_water_nd + (
                        arm[j] * in_water[j : j + 1].astype(_F32)
                    )
                if rv["DANGER_TILE_REWARD"] is not None:
                    rewards = rewards + (
                        rv["DANGER_TILE_REWARD"] * in_water_nd * actf
                    )
                reasons = jnp.where(
                    in_water & acting, TERMINATED_R, reasons
                )

            # --- sustainability regrowth (``engine_substep:826-871``) -------
            if cfg["sustainability_challenge"]:
                def regrow(av, fr, ckey, cond_limit, limit, exponent):
                    on_any = jnp.zeros_like(acting)
                    for j in range(n):
                        on_any = on_any | (
                            codes_all[j : j + 1]
                            == float(TILE_CODES[ckey])
                        )
                    can = (
                        acting & ~on_any & (av > 0)
                        & (av < _F32(cond_limit))
                    )
                    af = av + fr
                    # (af+1)^e via exp/log: af >= 0 always.
                    af2 = jnp.minimum(
                        _F32(limit),
                        jnp.exp(_F32(exponent) * jnp.log(af + 1.0)),
                    )
                    new_int = jnp.floor(af2)
                    return (
                        jnp.where(can, new_int, av),
                        jnp.where(can, af2 - new_int, fr),
                    )

                if self.has["drink"]:
                    drink_av, drink_fr = regrow(
                        drink_av, drink_fr, "drink",
                        growth_limits["drink_cond"],
                        float(cfg["DRINK_GROWTH_LIMIT"]),
                        float(cfg["DRINK_REGROWTH_EXPONENT"]),
                    )
                if self.has["food"]:
                    food_av, food_fr = regrow(
                        food_av, food_fr, "food",
                        growth_limits["food_cond"],
                        float(cfg["FOOD_GROWTH_LIMIT"]),
                        # Reference bug, faithful: food uses the DRINK
                        # exponent (``envs/island_navigation_ex_ma.py:867``).
                        float(cfg["DRINK_REGROWTH_EXPONENT"]),
                    )
            else:
                drink_av = jnp.where(
                    acting, _F32(self.av0["drink"]), drink_av
                )
                food_av = jnp.where(
                    acting, _F32(self.av0["food"]), food_av
                )

        # ---- finalize (``MaSafetyGridworld.finalize_step``) -----------------
        types, done = self._finalize_types(t, reasons, types, over)

        out = {
            "pos": pos,
            "vcode": vcode,
            "reasons": reasons,
            "step_types": types,
            "act_dir": act_dir,
            "obs_dir": obs_dir,
            "drink_sat": drink_sat,
            "food_sat": food_sat,
            "drink_avail": drink_av,
            "food_avail": food_av,
            "drink_frac": drink_fr,
            "food_frac": food_fr,
            "visits": visits,
            "safety": safety,
            "t": t,
            "key": S["key"],
            "draw_ctr": S["draw_ctr"] + np.uint32(1),
            "stats_rewards": S["stats_rewards"] + rewards,
            "stats_episodes": S["stats_episodes"] + done.astype(_I32),
        }
        if ep_idx is not None:
            out["ep_idx"] = ep_idx
        if collect_draws:
            return out, {
                "order": order,
                "actions": actions,
                "rewards": rewards,
                "over": over,
                "pol": pol,
                "slots": [{} for _ in range(n)],
            }
        return out

    def feats_of(self, S):
        return self._policy_feats(
            S["pos"], S["drink_sat"], S["food_sat"], S["drink_avail"],
            S["food_avail"], S["act_dir"],
        )

    # ---------------------------------------------------------- interop

    def board_for_lane(self, lane: int, S=None) -> np.ndarray:
        """The lane's CURRENT layout board. With a layout pool, pass the
        packed state so ``ep_idx`` selects the right pool entry."""
        b = self._boards_np
        if (
            getattr(self, "layout_pool", 1) > 1
            and S is not None
            and "ep_idx" in S
        ):
            b = self._boards_np_pool[
                int(np.asarray(S["ep_idx"][0, lane])) % self.layout_pool
            ]
        col = b[:, lane] if b.shape[1] > 1 else b[:, 0]
        return col.reshape(self.h, self.w)

    def unpack_lane(self, S, lane: int):
        """The packed lane as a per-env ``IslandNavExMaState`` (for tests)."""
        from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
            IslandNavExMaState,
        )

        n, w = self.n, self.w
        pos_flat = np.asarray(S["pos"][:, lane])
        return IslandNavExMaState(
            t=jnp.asarray(np.asarray(S["t"][0, lane]), _I32),
            key=jax.random.PRNGKey(0),
            pos=jnp.asarray(
                np.stack([pos_flat // w, pos_flat % w], axis=1), _I32
            ),
            step_types=jnp.asarray(np.asarray(S["step_types"][:, lane])),
            termination_reasons=jnp.asarray(
                np.asarray(S["reasons"][:, lane])
            ),
            action_direction=jnp.asarray(np.asarray(S["act_dir"][:, lane])),
            observation_direction=jnp.asarray(
                np.asarray(S["obs_dir"][:, lane])
            ),
            drink_satiation=jnp.asarray(np.asarray(S["drink_sat"][:, lane])),
            food_satiation=jnp.asarray(np.asarray(S["food_sat"][:, lane])),
            drink_availability=jnp.asarray(
                np.asarray(S["drink_avail"][0, lane]), _F32
            ),
            drink_fraction=jnp.asarray(
                np.asarray(S["drink_frac"][0, lane]), _F32
            ),
            food_availability=jnp.asarray(
                np.asarray(S["food_avail"][0, lane]), _F32
            ),
            food_fraction=jnp.asarray(
                np.asarray(S["food_frac"][0, lane]), _F32
            ),
            visits=jnp.asarray(
                np.asarray(S["visits"][:, lane]).reshape(n, 5)
            ),
            safety=jnp.asarray(np.asarray(S["safety"][:, lane])),
        )
