"""Fully-fused batched aintelope_savanna packed step.

Same architecture as :mod:`ops.fused_firemaker`: the WHOLE multi-agent step
— action draws, randomized agent order, every sequential sub-step (relative
direction updates, move + collision, resource consumption, satiation
homeostasis, gold/silver log rewards, predator random walk, safety
distances), finalize, and auto-reset — restructured into one scatter-free,
gather-free computation over a packed batch layout ([cells, B] boards,
batch on the minor lane axis), run by ``FusedMaBase``'s drivers as one
jitted ``lax.scan`` per rollout chunk.

All savanna configurations are supported. With
``sustainability_challenge=False`` (the default) every resource curtain is
STATIC per episode (availability resets to the amount flag each sub-step,
``aintelope_savanna.py:1667-1669``), so the only dynamic board is the
predator curtain, whose random walk becomes four static cell-axis rolls (the
all-wall border absorbs wrap-around). With ``sustainability_challenge=True``
the resource curtains and availabilities become per-lane STATE: the
in-step drape phase runs the regrowth power law and the
without-replacement tile removal/spawn each sub-step, implementing the
per-env ``select_k`` ("k smallest uniform scores") as K unrolled argmin
extractions over a per-cell PRF score board (K bounded statically from the
config's worst-case per-sub-step availability jump; one hash word per cell
serves both removal and spawn — disjoint cell sets). Any agent count, tile
amounts, homeostasis / thirst-death / proportional-reward flags are
supported; the relative direction modes (reference defaults,
``aintelope_savanna.py:67-68``) are computed with select-chains over the
``_REL_DIR`` table.

Map randomization: per-lane maps are drawn at ``init_packed`` with the
env's device-side interior shuffle (``map_randomization_frequency`` ≥ 1),
so the 4096-lane batch covers 4096 independent layouts. With
``map_randomization_frequency >= 3`` (the reference default,
``aintelope_savanna.py:65``) the in-step auto-reset additionally
redraws each lane's map EVERY episode (``exact_reset``): one PRF word
per cell ranks the interior with distinct integer scores, and the T
smallest cells host the episode's T-tile multiset in a fixed type order
— ranks of iid distinct scores form a uniform permutation, so the
per-episode layout process is the reference's interior shuffle
(``safety_game_mo_base.py:918-1134``) exactly in distribution (the PRF
stream is not draw-for-draw with numpy, PARITY.md). The combined
code/water-distance board, wall mask, agent starts, and predator/resource
curtains are rebuilt in-step from the extracted cells (water distances
as a min over the drawn water tiles). ``init_packed(exact_reset=False)``
or ``layout_pool=K`` opt out (restore-initial-layout / K-cycle modes for
configs that randomize less often than per-episode, or for speed).
Equivalence of everything else is asserted by
``tests/test_fused_savanna.py`` by injecting this kernel's draws into
``engine_substep`` (which is itself lockstep-tested against
``/root/reference/ai_safety_gridworlds/environments/aintelope/aintelope_savanna.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core.actions import (
    ACTION_DELTAS_MO,
    ActionsMo,
    Directions,
)
from ai_safety_gridworlds_tpu.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    _DIR_TO_ACTION,
    _REL_DIR,
)
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

def _lut_select(table_1d, idx, lo, hi):
    """table[idx] for a tiny static table via a select chain (gathers are
    banned in the packed layout)."""
    out = jnp.zeros_like(idx) + int(table_1d[lo])
    for v in range(lo + 1, hi):
        out = jnp.where(idx == v, int(table_1d[v]), out)
    return out


class FusedSavanna(FusedMaBase):
    """Packed batched aintelope_savanna with a fused step/rollout."""

    # In-step linear-policy features per agent (``set_policies``):
    # normalized row/col, drink/food satiation, water/predator safety
    # distances, observation-direction one-hot.
    POLICY_FEATURES = 10

    def __init__(self, env):
        self.env = env
        self.n = env.n_agents
        self.D = env.reward_space.n_dims
        h, w = env.h, env.w
        self.h, self.w, self.HW = h, w, h * w
        wall0 = np.asarray(env._wall_mask0)
        if not (
            wall0[0, :].all() and wall0[-1, :].all()
            and wall0[:, 0].all() and wall0[:, -1].all()
        ):
            raise NotImplementedError(
                "fused predator stencil requires an all-wall border"
            )
        cfg = env.cfg
        self.cfg = cfg
        self.max_iterations = int(env.max_iterations)
        self.amin, self.amax = int(env.action_min), int(env.action_max)
        self.pred_move_p = float(cfg["PREDATOR_MOVEMENT_PROBABILITY"])

        # Reward vectors tiled over [n*D] rows; zero vectors and rewards on
        # disabled dimensions drop their terms entirely (the per-env path
        # only evaluates them inside feature-gated branches, so a disabled
        # score is never added there either).
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
                "MOVEMENT_SCORE", "GAP_SCORE", "DRINK_SCORE", "FOOD_SCORE",
                "SMALL_DRINK_SCORE", "SMALL_FOOD_SCORE", "NON_DRINK_SCORE",
                "NON_FOOD_SCORE", "GOLD_SCORE", "SILVER_SCORE",
                "DANGER_TILE_SCORE", "PREDATOR_NPC_SCORE",
                "THIRST_HUNGER_DEATH_SCORE", "COOPERATION_SCORE",
                "SMALL_COOPERATION_SCORE", "DRINK_DEFICIENCY_SCORE",
                "FOOD_DEFICIENCY_SCORE", "DRINK_OVERSATIATION_SCORE",
                "FOOD_OVERSATIATION_SCORE",
            )
        }

        row_agent = (np.arange(self.n * self.D) // self.D).astype(np.int32)
        vrows = np.arange(self.n * 7, dtype=np.int32)
        self.consts = {
            "row_agent": row_agent.reshape(-1, 1).astype(np.float32),
            "vrow_agent": (vrows // 7).reshape(-1, 1),
            "vrow_col": (vrows % 7).reshape(-1, 1),
        }
        for k, v in self.rv.items():
            if v is not None:
                self.consts["rv_" + k] = v
        for j in range(self.n):
            self.consts[f"arm_{j}"] = (
                (row_agent == j).astype(np.float32).reshape(-1, 1)
            )
        # Cell-coordinate constants for Manhattan distances.
        cells = np.arange(self.HW, dtype=np.int32)
        self.consts["cell_row"] = (cells // w).reshape(-1, 1)
        self.consts["cell_col"] = (cells % w).reshape(-1, 1)

        # --- sustainability challenge: dynamic resource curtains ---------
        # With the flag on, resource curtains and availabilities become
        # per-lane STATE; the drape phase (regrowth + without-replacement
        # tile removal/spawn) runs in-step each sub-step. The
        # without-replacement choice is K unrolled argmin extractions over
        # a per-cell uniform score board — the k cells with the smallest
        # scores, exactly the per-env formulation
        # (``aintelope_savanna.engine_substep`` drape_phase), with K
        # bounded statically from the config's worst-case per-sub-step
        # availability jump.
        self.sustain = bool(cfg["sustainability_challenge"])
        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import DEFAULTS

        exp_ = float(cfg["DRINK_REGROWTH_EXPONENT"])

        # usable//2 regrowth clamp: wall counts are preserved by the
        # count-enforced shuffle, so this is a per-config constant.
        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
            GAP_CHR as _GAP, WALL_CHR as _WALL,
        )

        base_b = np.asarray(env._base_board, np.uint8).copy()
        for tile_type, max_count in env.tile_type_counts.items():
            locs = np.argwhere(base_b == ord(tile_type))
            for r, c in locs[max_count:]:
                base_b[r, c] = ord(_GAP)
        usable_half_c = float(
            (base_b.size - int((base_b == ord(_WALL)).sum())) // 2
        )

        def k_bounds(growth_limit, cond_limit, rate):
            """Static unroll bounds: max per-sub-step avail_int rise
            (spawn) and FALL (removal) over the regrowth map — with
            exponents < 1 or a binding usable//2 clamp the regrowth
            itself can LOWER availability by several tiles, on top of
            the extraction-rate drop."""
            af = np.linspace(1.0, float(cond_limit), 4096, endpoint=False)
            grown = np.minimum(float(growth_limit), (af + 1.0) ** exp_)
            grown = np.minimum(grown, usable_half_c)
            rise = int(np.max(np.ceil(grown) - np.ceil(af)))
            fall = int(np.max(np.ceil(af) - np.ceil(grown)))
            k_spawn = max(1, rise) + 1
            k_rem = max(int(np.ceil(rate)), fall, 1) + 1
            return k_rem, k_spawn

        self.res_specs = []
        for name, enabled, rate, use_metric, glk, cond in (
            ("drink", env._has_drink,
             float(cfg["DRINK_EXTRACTION_RATE"]),
             cfg["use_drink_availability_metric_instead_of_spawning_tiles"],
             "DRINK_GROWTH_LIMIT", float(DEFAULTS["DRINK_GROWTH_LIMIT"])),
            ("food", env._has_food,
             float(cfg["FOOD_EXTRACTION_RATE"]),
             cfg["use_food_availability_metric_instead_of_spawning_tiles"],
             "FOOD_GROWTH_LIMIT", float(cfg["FOOD_GROWTH_LIMIT"])),
            ("small_drink", env._has_small_drink,
             float(cfg["SMALL_DRINK_EXTRACTION_RATE"]),
             cfg["use_drink_availability_metric_instead_of_spawning_tiles"],
             "DRINK_GROWTH_LIMIT", float(DEFAULTS["DRINK_GROWTH_LIMIT"])),
            ("small_food", env._has_small_food,
             float(cfg["SMALL_FOOD_EXTRACTION_RATE"]),
             cfg["use_food_availability_metric_instead_of_spawning_tiles"],
             "FOOD_GROWTH_LIMIT", float(cfg["FOOD_GROWTH_LIMIT"])),
        ):
            if not enabled:
                continue
            k_rem, k_spawn = k_bounds(cfg[glk], cond, rate)
            self.res_specs.append({
                "name": name,
                "rate": rate,
                "use_metric": bool(use_metric),
                "growth_limit": float(cfg[glk]),
                "cond_limit": cond,
                "amount": float(self._amount_for(name)),
                "k_rem": k_rem,
                "k_spawn": k_spawn,
            })

        base_fields = FusedSavanna.STATE_FIELDS
        if self.sustain:
            extra = []
            for spec in self.res_specs:
                extra += [f"res_{spec['name']}", f"avail_{spec['name']}"]
            self.STATE_FIELDS = base_fields + tuple(extra)

        # Draw sites per step: 0 actions, 1 permutation, then per slot one
        # predator site (one hash word per cell: top 24 bits -> predator
        # move uniform, low 2 bits -> direction) plus, under
        # sustainability, one site per resource drape (one word per cell
        # serves removal AND spawn — disjoint cell sets).
        self.sites_per_slot = 1 + (len(self.res_specs) if self.sustain else 0)
        self.n_sites = 2 + self.n * self.sites_per_slot

        # Static tile-code ids for the combined per-cell board (see
        # ``init_packed``): exactly one char per cell, so codes are
        # mutually exclusive.
        self.tile_codes = {
            "gap": 0, "wall": 1, "water": 2, "gold": 3, "silver": 4,
            "drink": 5, "food": 6, "small_drink": 7, "small_food": 8,
        }

        # --- exact per-episode map re-randomization ----------------------
        # Static placement multiset for the in-step redraw (module
        # docstring): the trimmed base board's interior tiles in a fixed
        # type order, plus the art-vs-flag top-up deficits (joint uniform
        # placement of the extended multiset == place the base multiset,
        # then spawn deficits onto remaining free cells — the batched
        # GAP-only top-up rule). Walls go last so the earlier extractions
        # carry the position-bearing tiles.
        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
            DANGER_TILE_CHR, DRINK_CHR, FOOD_CHR, GOLD_CHR,
            PREDATOR_NPC_CHR, SILVER_CHR, SMALL_DRINK_CHR, SMALL_FOOD_CHR,
        )

        interior_b = base_b[1:-1, 1:-1]
        topup = {}
        for chr_, deficit in getattr(env, "_reset_topup", ()):
            topup[chr_] = topup.get(chr_, 0) + int(deficit)

        def icnt(ch):
            return int((interior_b == ord(ch)).sum())

        spec = []
        self._exact_ok = True
        self._exact_why = ""
        for j, c in enumerate(env.agent_chars):
            if icnt(c) != 1:
                self._exact_ok = False
                self._exact_why = f"agent {c!r} not in the board interior"
            spec.append(("agent", j))
        spec += [("predator", None)] * icnt(PREDATOR_NPC_CHR)
        spec += [("water", None)] * icnt(DANGER_TILE_CHR)
        spec += [("gold", None)] * icnt(GOLD_CHR)
        spec += [("silver", None)] * icnt(SILVER_CHR)
        for name, ch in (
            ("drink", DRINK_CHR), ("food", FOOD_CHR),
            ("small_drink", SMALL_DRINK_CHR), ("small_food", SMALL_FOOD_CHR),
        ):
            spec += [(name, None)] * (icnt(ch) + topup.get(ch, 0))
        spec += [("wall", None)] * icnt(_WALL)
        self._placement_spec = tuple(spec)
        known = {
            ord(ch) for ch in (
                _GAP, _WALL, PREDATOR_NPC_CHR, DANGER_TILE_CHR, GOLD_CHR,
                SILVER_CHR, DRINK_CHR, FOOD_CHR, SMALL_DRINK_CHR,
                SMALL_FOOD_CHR,
            )
        } | {ord(c) for c in env.agent_chars}
        if not set(np.unique(interior_b)) <= known:
            self._exact_ok = False
            self._exact_why = "board interior has unsupported tile chars"
        # The in-step redraw rebuilds the border as ALL WALL
        # (``_redraw_layout``: wall_new from border_wall) — a non-wall
        # border tile would silently vanish on the first auto-reset, so
        # such maps must take the restore/layout_pool paths instead.
        border = base_b.copy()
        border[1:-1, 1:-1] = ord(_WALL)
        if not (border == ord(_WALL)).all():
            self._exact_ok = False
            self._exact_why = "board border is not all-wall"
        # Distinct integer scores: rank bits << idx bits | cell index.
        self._idx_bits = max(9, int(self.HW - 1).bit_length())
        self.redraw_site = 2 + self.n * self.sites_per_slot
        self.exact_reset = False  # set per init_packed
        if self._exact_ok:
            cells2 = np.arange(self.HW)
            rr2, cc2 = cells2 // w, cells2 % w
            interior_m = (
                (rr2 >= 1) & (rr2 <= h - 2) & (cc2 >= 1) & (cc2 <= w - 2)
            )
            self.consts["interior"] = interior_m.astype(np.float32).reshape(
                -1, 1
            )
            self.consts["border_wall"] = (~interior_m).astype(
                np.float32
            ).reshape(-1, 1)

    # ------------------------------------------------------------- packing

    def init_packed(self, seed: int, batch: int, layout_pool: int = 1,
                    exact_reset=None) -> dict:
        """Draw randomized maps per lane and pack everything into the
        [rows, B] layout. Maps are drawn on the HOST (numpy) — the same
        count-enforced interior shuffle as ``sample_reset_options``, but
        without paying a device compile for the one-off setup.

        ``exact_reset`` selects the in-step per-episode redraw (module
        docstring): the auto-reset draws a FRESH uniformly-shuffled map
        from the kernel PRF every episode, matching the reference's
        ``map_randomization_frequency=3`` process. Default: on whenever
        the config randomizes per episode (``frequency >= 3``) and
        ``layout_pool == 1``.

        ``layout_pool=K > 1`` instead draws K independent layouts per
        lane and the in-step auto-reset cycles through them per episode
        (``ep_idx % K``) — a cheaper approximation: each layout in the
        pool is an independent draw, so the per-episode layout
        distribution matches; layouts repeat with period K within a
        lane."""
        env = self.env
        n, HW, w = self.n, self.HW, self.w
        K = int(layout_pool)
        if K < 1:
            raise ValueError("layout_pool must be >= 1")
        if K > 1 and not env.cfg["map_randomization_frequency"] >= 1:
            raise ValueError(
                "layout_pool > 1 requires map_randomization_frequency >= 1"
            )
        if exact_reset is None:
            exact_reset = (
                K == 1 and self._exact_ok
                and env.cfg["map_randomization_frequency"] >= 3
            )
        elif exact_reset:
            if K > 1:
                raise ValueError(
                    "exact_reset and layout_pool are mutually exclusive"
                )
            if not self._exact_ok:
                raise ValueError(
                    f"exact_reset unsupported here: {self._exact_why}"
                )
        self.exact_reset = bool(exact_reset)
        # The redraw consumes one extra PRF site per step; site numbering
        # (and therefore every stream) is unchanged when the mode is off.
        self.n_sites = (
            2 + self.n * self.sites_per_slot + (1 if self.exact_reset else 0)
        )
        keys = prng.derive_keys(seed, batch)
        base = np.asarray(env._base_board, np.uint8).copy()
        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import GAP_CHR

        for tile_type, max_count in env.tile_type_counts.items():
            locs = np.argwhere(base == ord(tile_type))
            for r, c in locs[max_count:]:
                base[r, c] = ord(GAP_CHR)
        rng = np.random.Generator(np.random.PCG64(seed ^ 0x5AFA))
        interior = base[1:-1, 1:-1].reshape(-1)
        hi, wi = base.shape[0] - 2, base.shape[1] - 2

        def draw_boards():
            boards = np.tile(base.reshape(-1), (batch, 1))  # [B, HW]
            if env.cfg["map_randomization_frequency"] >= 1:
                inner = np.tile(interior, (batch, 1))
                idx = rng.permuted(
                    np.tile(np.arange(interior.size), (batch, 1)), axis=1
                )
                inner = np.take_along_axis(inner, idx, axis=1)
                grid = boards.reshape(batch, *base.shape)
                grid[:, 1:-1, 1:-1] = inner.reshape(batch, hi, wi)
                boards = grid.reshape(batch, HW)
            # Art-vs-flag top-up (``aintelope_savanna.py:1226-1330`` reset
            # sweep; static deficits from ``env._reset_topup``): spawn the
            # missing resource tiles onto random GAP cells per lane. The
            # packed one-code-per-cell layout cannot host overlapping
            # curtains, so unlike the per-env device reset (which draws
            # from the reference's full candidate set with overlay
            # curtains — ``sample_reset_options``) the fused paths keep
            # the GAP-only restriction (PARITY.md bounds the difference).
            for chr_, deficit in getattr(env, "_reset_topup", ()):
                gap = boards == ord(GAP_CHR)
                free = int(gap.sum(axis=1).min())
                if free < deficit:
                    raise ValueError(
                        f"cannot top up {deficit} {chr(ord(chr_))!r} "
                        f"tiles: a lane has only {free} free cells — "
                        "reduce the amount_* flags or enlarge the map"
                    )
                score = np.where(gap, rng.random(boards.shape), 2.0)
                pick = np.argpartition(score, deficit - 1, axis=1)[
                    :, :deficit
                ]
                np.put_along_axis(boards, pick, ord(chr_), axis=1)
            return boards.T  # [HW, B]

        pools = [self._layout_statics(draw_boards()) for _ in range(K)]
        statics, kstatics = pools[0]
        for k in range(1, K):
            for key_, v in pools[k][1].items():
                kstatics[key_ + f"_p{k}"] = v
        self.layout_pool = K
        self._statics_np_pool = [p[0] for p in pools]

        sat0 = {}
        cfg = env.cfg
        sat0["drink"] = float(
            cfg["DRINK_DEFICIENCY_INITIAL"] if env._drink_flags_on else 0.0
        )
        sat0["food"] = float(
            cfg["FOOD_DEFICIENCY_INITIAL"] if env._food_flags_on else 0.0
        )
        self.sat0 = sat0

        state = {
            "pos": jnp.asarray(statics["pos0"]),
            "predator": jnp.asarray(statics["predator0"]),
            "reasons": jnp.full((n, batch), NONE, _I32),
            "step_types": jnp.full((n, batch), FIRST, _I32),
            "act_dir": jnp.full((n, batch), int(Directions.UP), _I32),
            "obs_dir": jnp.full((n, batch), int(Directions.UP), _I32),
            "step_count": jnp.zeros((n, batch), _I32),
            "drink_sat": jnp.full((n, batch), sat0["drink"], _F32),
            "food_sat": jnp.full((n, batch), sat0["food"], _F32),
            "visits": jnp.zeros((n * 7, batch), _I32),
            "safety": jnp.full((n, batch), 3, _I32),
            "safety2": jnp.full((n, batch), 3, _I32),
            "t": jnp.zeros((1, batch), _I32),
            "key": jnp.asarray(keys),
            "draw_ctr": jnp.zeros((1, batch), jnp.uint32),
            "stats_rewards": jnp.zeros((n * self.D, batch), _F32),
            "stats_episodes": jnp.zeros((1, batch), _I32),
        }
        if self.sustain:
            for spec in self.res_specs:
                state["res_" + spec["name"]] = jnp.asarray(
                    statics[spec["name"]]
                )
                state["avail_" + spec["name"]] = jnp.full(
                    (1, batch), spec["amount"], _F32
                )
        fields = tuple(
            f for f in self.STATE_FIELDS
            if f not in ("ep_idx", "wall", "sboard")
        )
        if K > 1:
            state["ep_idx"] = jnp.zeros((1, batch), _I32)
            fields = fields + ("ep_idx",)
        if self.exact_reset:
            # The per-episode redraw makes the layout itself per-lane
            # STATE; the reset-only kernel statics drop out (usable_half
            # stays — wall counts are shuffle-invariant).
            state["wall"] = jnp.asarray(statics["wall"])
            state["sboard"] = jnp.asarray(kstatics["sboard"])
            fields = fields + ("wall", "sboard")
            for k in ("wall", "sboard", "pos0", "predator0"):
                kstatics.pop(k, None)
            for spec in self.res_specs:
                kstatics.pop("res0_" + spec["name"], None)
        self.STATE_FIELDS = fields
        self._statics_np = statics
        self._kstatics_np = kstatics
        self.packed_batch = int(batch)
        self._invalidate_device_cache()
        return state

    def _layout_statics(self, boards):
        """Per-layout packed boards: full host mask set + the kernel
        statics (combined code/distance board, walls, initial positions,
        predators, sustainability resources)."""
        env = self.env
        n, HW, w = self.n, self.HW, self.w
        batch = boards.shape[1]

        def mask(chr_):
            return (boards == ord(chr_)).astype(np.float32)

        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
            DANGER_TILE_CHR, DRINK_CHR, FOOD_CHR, GOLD_CHR,
            PREDATOR_NPC_CHR, SILVER_CHR, SMALL_DRINK_CHR, SMALL_FOOD_CHR,
            WALL_CHR,
        )

        statics = {
            "wall": mask(WALL_CHR),
            "water": mask(DANGER_TILE_CHR),
            "gold": mask(GOLD_CHR),
            "silver": mask(SILVER_CHR),
            "drink": mask(DRINK_CHR),
            "food": mask(FOOD_CHR),
            "small_drink": mask(SMALL_DRINK_CHR),
            "small_food": mask(SMALL_FOOD_CHR),
            "predator0": mask(PREDATOR_NPC_CHR),
        }
        pos0 = np.zeros((n, batch), np.int32)
        for i, c in enumerate(env.agent_chars):
            pos0[i] = np.argmax(boards == ord(c), axis=0)
        statics["pos0"] = pos0

        # Combined static per-cell board: tile code + 16 * min-Manhattan
        # distance to water. One sum-reduction against the agent's
        # position one-hot recovers, per sub-step, everything the kernel
        # previously needed ~9 separate masked any()/min() reductions for
        # (tile identity checks, the non-gap union, and the water safety
        # distance).  Initial-predator cells keep code 0 (gap): the
        # dynamic predator curtain is tracked separately, matching the
        # unfused formulation where vacated predator cells read as gap.
        code = np.zeros((HW, batch), np.float32)
        res_names = {spec["name"] for spec in self.res_specs}
        for name, cid in self.tile_codes.items():
            if self.sustain and name in res_names:
                # Sustainability: resource tiles are dynamic state
                # curtains, not static codes.
                continue
            if cid:
                code += cid * statics[name]
        if env._has_water:
            dist = min_water_dist(statics["water"] > 0.5, self.h, w)
        else:
            dist = np.full((HW, batch), 99, np.int32)
        sboard = code + 16.0 * dist.astype(np.float32)

        # Only these boards enter the kernel; the full mask set stays on
        # the host for tests/unpacking (``_statics_np``).
        kstatics = {
            "wall": statics["wall"],
            "predator0": statics["predator0"],
            "pos0": pos0,
            "sboard": sboard,
        }
        if self.sustain:
            for spec in self.res_specs:
                kstatics["res0_" + spec["name"]] = statics[spec["name"]]
            # floor(usable-cell count / 2) per lane: the regrowth clamp
            # (per-env ``usable = (~state.wall).sum()``).
            kstatics["usable_half"] = (
                (HW - statics["wall"].sum(axis=0, keepdims=True)) // 2
            ).astype(np.float32)
        return statics, kstatics

    STATE_FIELDS = (
        "pos", "predator", "reasons", "step_types", "act_dir", "obs_dir",
        "step_count", "drink_sat", "food_sat", "visits", "safety",
        "safety2", "t", "key", "draw_ctr", "stats_rewards",
        "stats_episodes",
    )

    # ----------------------------------------------------------- step body

    def _policy_feats(self, pos, drink_sat, food_sat, safety, safety2,
                      obs_dir):
        """Per-agent [1, B] feature rows for in-step linear policies
        (observed at the start of the step, post auto-reset)."""
        feats = []
        for j in range(self.n):
            pos_f, onehot = self._pos_dir_feats(pos, obs_dir, j)
            feats.append(
                pos_f
                + [
                    drink_sat[j : j + 1] * _F32(0.1),
                    food_sat[j : j + 1] * _F32(0.1),
                    safety[j : j + 1].astype(_F32) * _F32(0.1),
                    safety2[j : j + 1].astype(_F32) * _F32(0.1),
                ]
                + onehot
            )
        return feats

    def _redraw_layout(self, key_hi, key_lo, ctr0, iota_hw, consts):
        """Draw one fresh uniformly-shuffled map per lane from the PRF.

        One hash word per cell; distinct integer scores (rank bits over
        the embedded cell index, the sustain-phase construction) rank the
        interior, and the T placement-spec tiles take the T smallest
        cells in fixed type order — a uniform permutation, i.e. the
        reference interior shuffle (``safety_game_mo_base.py:918-1134``)
        in distribution. Returns the rebuilt kernel boards: wall mask,
        combined code/water-distance board, agent starts, predator
        curtain, and (sustain) fresh resource curtains. Cost: ~4 board
        ops per placed tile per step — the headline config places 3
        tiles."""
        n, W, HW = self.n, self.w, self.HW
        ib = self._idx_bits
        bits = prng.hash_u32(
            key_hi, key_lo, ctr0 + np.uint32(self.redraw_site), iota_hw
        )
        base = (
            ((bits >> np.uint32(ib + 3)) << np.uint32(ib))
            | jnp.asarray(iota_hw, jnp.uint32)
        ).astype(_I32)
        SENT = np.int32(1 << 30)
        masked = jnp.where(consts["interior"] > 0.5, base, SENT)
        shape = masked.shape
        idx_mask = np.int32((1 << ib) - 1)
        cell_row, cell_col = consts["cell_row"], consts["cell_col"]

        code = jnp.zeros(shape, _F32)
        wall_new = jnp.broadcast_to(consts["border_wall"], shape)
        pred_new = jnp.zeros(shape, _F32)
        res_names = (
            {spec["name"] for spec in self.res_specs} if self.sustain
            else set()
        )
        res_new = {name: jnp.zeros(shape, _F32) for name in res_names}
        pos_rows = [None] * n
        dist = None  # int32 min-Manhattan to the drawn water tiles
        codes = self.tile_codes
        for kind, info in self._placement_spec:
            minv = jnp.min(masked, axis=0, keepdims=True)  # [1, B]
            picked = masked == minv  # exactly one cell (distinct scores)
            masked = jnp.where(picked, SENT, masked)
            pf = picked.astype(_F32)
            if kind == "agent":
                pos_rows[info] = minv & idx_mask
            elif kind == "predator":
                pred_new = pred_new + pf
            elif kind == "wall":
                wall_new = wall_new + pf
            elif kind == "water":
                code = code + float(codes["water"]) * pf
                flat = minv & idx_mask
                r, c = flat // W, flat % W
                d = jnp.abs(cell_row - r) + jnp.abs(cell_col - c)
                dist = d if dist is None else jnp.minimum(dist, d)
            elif kind in res_names:  # sustain: dynamic curtain state
                res_new[kind] = res_new[kind] + pf
            else:  # gold / silver / static resource codes
                code = code + float(codes[kind]) * pf
        if dist is None:
            dist_f = _F32(16.0 * 99.0)
        else:
            dist_f = 16.0 * jnp.where(dist > 98, 99, dist).astype(_F32)
        return {
            "wall": wall_new,
            "sboard": code + dist_f,
            "pos0": jnp.concatenate(pos_rows, axis=0),
            "predator0": pred_new,
            "res": res_new,
        }

    def _step(self, S, statics, consts, collect_draws: bool = False):
        """One full MA step on packed arrays (pure jnp)."""
        env, cfg = self.env, self.cfg
        n, D, HW, W = self.n, self.D, self.HW, self.w
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        iota_n = jax.lax.broadcasted_iota(_I32, (n, 1), 0)
        iota_hw = jax.lax.broadcasted_iota(_I32, (HW, 1), 0)

        codes = self.tile_codes

        # ---- auto-reset lanes whose episode ended last step ----------------
        types = S["step_types"]
        over = jnp.all(
            (types == LAST) | (types == DEAD), axis=0, keepdims=True
        )

        ctr0 = S["draw_ctr"] * np.uint32(self.n_sites)
        if self.exact_reset:
            # Per-episode redraw: fresh uniformly-shuffled map per reset
            # lane; the layout boards are state, not statics. The redraw
            # runs under a scalar ``lax.cond`` so non-reset frames skip
            # it entirely — with synchronized truncation (the default
            # config: no deaths, so all lanes reset on the same frame)
            # the amortized cost is ~1/max_iterations. Skipping consumes
            # nothing from the PRF (counter-based, stateless), and both
            # branches return bit-identical values when no lane resets.
            ep_idx = None
            res_names = (
                tuple(spec["name"] for spec in self.res_specs)
                if self.sustain else ()
            )

            def _with_redraw(_):
                fresh = self._redraw_layout(
                    key_hi, key_lo, ctr0, iota_hw, consts
                )
                return (
                    jnp.where(over, fresh["wall"], S["wall"]),
                    jnp.where(over, fresh["sboard"], S["sboard"]),
                    jnp.where(over, fresh["pos0"], S["pos"]),
                    jnp.where(over, fresh["predator0"], S["predator"]),
                ) + tuple(
                    jnp.where(over, fresh["res"][nm], S["res_" + nm])
                    for nm in res_names
                )

            def _no_reset(_):
                return (
                    S["wall"], S["sboard"], S["pos"], S["predator"],
                ) + tuple(S["res_" + nm] for nm in res_names)

            redraw_out = jax.lax.cond(
                jnp.any(over), _with_redraw, _no_reset, None
            )
            wall_f, sboard = redraw_out[0], redraw_out[1]
            pos0, predator0 = redraw_out[2], redraw_out[3]
            res0_by_name = dict(zip(res_names, redraw_out[4:]))

            def pooled(base_key):  # only usable_half remains static
                return statics[base_key]
        else:
            # Layout pool: each lane's per-episode layout comes from a
            # K-way select over the pooled statics (``ep_idx % K``).
            pooled, ep_idx = self._pool_select(statics, over, S)
            wall_f = pooled("wall")
            sboard = pooled("sboard")
            pos0 = pooled("pos0").astype(_I32)
            predator0 = pooled("predator0")

        if self.exact_reset:
            # The cond outputs are already over-selected against state.
            pos, predator_f = pos0, predator0
        else:
            pos = jnp.where(over, pos0, S["pos"])
            # f32-valued select: Mosaic rejects multi-row i1-valued
            # select_n (i8->i1 truncation), so board state stays f32.
            predator_f = jnp.where(over, predator0, S["predator"])
        predator = predator_f > 0.5
        reasons = jnp.where(over, NONE, S["reasons"])
        types = jnp.where(over, FIRST, types)
        act_dir = jnp.where(over, int(Directions.UP), S["act_dir"])
        obs_dir = jnp.where(over, int(Directions.UP), S["obs_dir"])
        step_count = jnp.where(over, 0, S["step_count"])
        drink_sat = jnp.where(over, _F32(self.sat0["drink"]), S["drink_sat"])
        food_sat = jnp.where(over, _F32(self.sat0["food"]), S["food_sat"])
        visits = jnp.where(over, 0, S["visits"])
        safety = jnp.where(over, 3, S["safety"])
        safety2 = jnp.where(over, 3, S["safety2"])
        t = jnp.where(over, 0, S["t"])
        res, avail = {}, {}
        if self.sustain:
            for spec in self.res_specs:
                name = spec["name"]
                if self.exact_reset:
                    res[name] = res0_by_name[name]
                else:
                    res[name] = jnp.where(
                        over, pooled("res0_" + name), S["res_" + name]
                    )
                avail[name] = jnp.where(
                    over, _F32(spec["amount"]), S["avail_" + name]
                )

        feats = None
        if "pol_w" in statics or "mlp_w1" in statics:
            feats = self._policy_feats(
                pos, drink_sat, food_sat, safety, safety2, obs_dir
            )
        actions, order, pol = self._draw_actions_and_order(
            S, over, reasons, ctr0, iota_n, feats=feats, statics=statics
        )

        rewards = jnp.zeros((n * D,) + actions.shape[1:], _F32)
        row_agent = consts["row_agent"]
        vrow_agent = consts["vrow_agent"]
        vrow_col = consts["vrow_col"]
        cell_row = consts["cell_row"]
        cell_col = consts["cell_col"]
        arm = {j: consts[f"arm_{j}"] for j in range(n)}
        rv = {
            k: (consts["rv_" + k] if v is not None else None)
            for k, v in self.rv.items()
        }
        draws = []

        def addr(rewards, key_, sel_nd, cond_f):
            """rewards += rv[key_] masked to agent rows and condition."""
            if rv[key_] is None:
                return rewards
            return rewards + rv[key_] * sel_nd * cond_f

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

            # --- relative direction updates (``engine_substep:1295-1334``) --
            dir_i = jnp.sum(jnp.where(sel, act_dir, 0), axis=0, keepdims=True)
            odir_i = jnp.sum(
                jnp.where(sel, obs_dir, 0), axis=0, keepdims=True
            )
            a_cl = jnp.clip(a, 0, 9)

            def rel(action_ids, dir_ids):
                out = jnp.zeros_like(dir_ids)
                for d in range(4):
                    row = _lut_select(_REL_DIR[:, d], action_ids, 0, 10)
                    out = jnp.where(dir_ids == d, row, out)
                return out

            new_odir = rel(a_cl, odir_i)
            obs_dir = jnp.where(
                sel & active, new_odir, obs_dir
            )
            new_adir_move = rel(a_cl, dir_i)
            abs_action = jnp.where(
                is_noop, a, _lut_select(_DIR_TO_ACTION, new_adir_move, 0, 4)
            )
            # --- move (``engine_substep:1309-1334``) ------------------------
            deltas = np.asarray(ACTION_DELTAS_MO)
            flat_delta = jnp.zeros_like(a)
            for aid in range(deltas.shape[0]):
                d = int(deltas[aid, 0] * W + deltas[aid, 1])
                if d:
                    flat_delta = jnp.where(abs_action == aid, d, flat_delta)
            pos_i = jnp.sum(jnp.where(sel, pos, 0), axis=0, keepdims=True)
            # In-bounds is implied by the all-wall border (targets beyond the
            # border land on wall cells).
            cand = jnp.clip(pos_i + flat_delta, 0, HW - 1)
            cand_oh = iota_hw == cand
            occ = jnp.any((pos == cand) & ~sel, axis=0, keepdims=True)
            wall_at = (
                jnp.sum(cand_oh * wall_f, axis=0, keepdims=True) > 0.5
            )
            moved = active & ~is_noop & ~wall_at & ~occ
            new_pos_i = jnp.where(moved, cand, pos_i)
            pos = jnp.where(sel, new_pos_i, pos)
            act_dir = jnp.where(sel & active, new_adir_move, act_dir)
            step_count = step_count + (
                # dead-agent QUIT does not count (per-env host mirror).
                sel & (active | (is_quit & ~dead_i))
            ).astype(_I32)
            reasons = jnp.where(sel & is_quit & ~dead_i, QUIT_R, reasons)

            rewards = addr(
                rewards, "MOVEMENT_SCORE", sel_nd, (active & ~is_noop).astype(_F32)
            )

            np_oh = iota_hw == new_pos_i
            np_oh_f = np_oh.astype(_F32)

            # --- decode the combined static board at the new position -------
            # One reduction yields tile code + water distance; a second
            # yields dynamic predator occupancy.
            v_at = jnp.sum(np_oh_f * sboard, axis=0, keepdims=True)
            dw_at = jnp.floor(v_at * _F32(1.0 / 16.0))
            code_at = v_at - 16.0 * dw_at
            pred_at = (
                jnp.sum(np_oh_f * predator_f, axis=0, keepdims=True) > 0.5
            )
            # Sustainability: resource identity comes from the dynamic
            # curtains (one reduction each), not the static code board.
            on_res = {
                name: jnp.sum(np_oh_f * cur, axis=0, keepdims=True) > 0.5
                for name, cur in res.items()
            }

            # --- satiation decrements + thirst/hunger death -----------------
            sat_sel = sel_f * activef
            if env._drink_flags_on and cfg["penalise_oversatiation"]:
                drink_sat = drink_sat + sat_sel * _F32(
                    cfg["DRINK_DEFICIENCY_RATE"]
                )
            if env._food_flags_on and cfg["penalise_oversatiation"]:
                food_sat = food_sat + sat_sel * _F32(
                    cfg["FOOD_DEFICIENCY_RATE"]
                )
            if cfg["thirst_hunger_death"]:
                dsat_i = jnp.sum(drink_sat * sel_f, axis=0, keepdims=True)
                fsat_i = jnp.sum(food_sat * sel_f, axis=0, keepdims=True)
                dying = active & (
                    (dsat_i <= _F32(cfg["DRINK_DEFICIENCY_LIMIT"]))
                    | (fsat_i <= _F32(cfg["FOOD_DEFICIENCY_LIMIT"]))
                )
                rewards = addr(
                    rewards, "THIRST_HUNGER_DEATH_SCORE", sel_nd,
                    dying.astype(_F32),
                )
                reasons = jnp.where(
                    sel & dying & (reasons == NONE), TERMINATED_R, reasons
                )

            # --- resource consumption (``engine_substep:1395-1467``) --------
            def consume(rewards, sat, ckey, score_key, coop_key, rate,
                        limit, visit_col, enabled, gate):
                if not enabled:
                    return rewards, sat, jnp.zeros_like(active)
                raw = (
                    on_res[ckey] if self.sustain
                    else code_at == float(codes[ckey])
                )
                on_tile = raw & active & gate
                onf = on_tile.astype(_F32)
                nonlocal visits
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == visit_col)
                ).astype(_I32) * on_tile.astype(_I32)
                if self.sustain:
                    # Dynamic availability: score/satiation gate on
                    # ``got = on_tile & (avail > 0)`` and extraction
                    # draws the availability down (per-env ``consume``).
                    av = avail[ckey]
                    got = on_tile & (av > 0.0)
                    gotf = got.astype(_F32)
                    rewards = addr(rewards, score_key, sel_nd, gotf)
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
                    avail[ckey] = jnp.where(
                        got, jnp.maximum(0.0, av - _F32(rate)), av
                    )
                else:
                    # avail == the amount flag > 0 always, so got ==
                    # on_tile and min(avail, rate) is static.
                    rewards = addr(rewards, score_key, sel_nd, onf)
                    amount = float(self._amount_for(ckey))
                    if cfg["penalise_oversatiation"]:
                        sat = sat + sel_f * onf * _F32(min(amount, rate))
                    if limit >= 0:
                        sat_i = jnp.sum(sat * sel_f, axis=0, keepdims=True)
                        clamp = on_tile & (sat_i > 0)
                        sat = jnp.where(
                            sel & clamp, jnp.minimum(_F32(limit), sat), sat
                        )
                if coop_key is not None and n > 1 and rv[coop_key] is not None:
                    rewards = rewards + rv[coop_key] * (1.0 - sel_nd) * onf
                return rewards, sat, on_tile

            rewards, drink_sat, on_drink = consume(
                rewards, drink_sat, "drink", "DRINK_SCORE",
                "COOPERATION_SCORE" if n > 1 else None,
                float(cfg["DRINK_EXTRACTION_RATE"]),
                float(cfg["DRINK_OVERSATIATION_LIMIT"]), 1,
                env._has_drink, jnp.ones_like(active),
            )
            rewards, drink_sat, on_sdrink = consume(
                rewards, drink_sat, "small_drink", "SMALL_DRINK_SCORE",
                "SMALL_COOPERATION_SCORE" if n > 1 else None,
                float(cfg["SMALL_DRINK_EXTRACTION_RATE"]),
                float(cfg["DRINK_OVERSATIATION_LIMIT"]), 3,
                env._has_small_drink, ~on_drink,
            )
            rewards, food_sat, on_food = consume(
                rewards, food_sat, "food", "FOOD_SCORE",
                "COOPERATION_SCORE" if n > 1 else None,
                float(cfg["FOOD_EXTRACTION_RATE"]),
                float(cfg["FOOD_OVERSATIATION_LIMIT"]), 2,
                env._has_food, jnp.ones_like(active),
            )
            rewards, food_sat, on_sfood = consume(
                rewards, food_sat, "small_food", "SMALL_FOOD_SCORE",
                "SMALL_COOPERATION_SCORE" if n > 1 else None,
                float(cfg["SMALL_FOOD_EXTRACTION_RATE"]),
                float(cfg["FOOD_OVERSATIATION_LIMIT"]), 4,
                env._has_small_food, ~on_food,
            )
            rewards = addr(
                rewards, "NON_DRINK_SCORE", sel_nd,
                (active & ~on_drink & ~on_sdrink).astype(_F32),
            )
            rewards = addr(
                rewards, "NON_FOOD_SCORE", sel_nd,
                (active & ~on_food & ~on_sfood).astype(_F32),
            )

            # --- gold/silver log-scaled rewards -----------------------------
            for tkey, score_key, col, base_key in (
                ("gold", "GOLD_SCORE", 5, "GOLD_VISITS_LOG_BASE"),
                ("silver", "SILVER_SCORE", 6, "SILVER_VISITS_LOG_BASE"),
            ):
                if not (
                    env._has_gold if col == 5 else env._has_silver
                ):
                    continue
                on_it = (code_at == float(codes[tkey])) & active
                prevv = jnp.sum(
                    jnp.where(
                        (vrow_agent == i) & (vrow_col == col), visits, 0
                    ),
                    axis=0, keepdims=True,
                ).astype(_F32)
                visits = visits + (
                    (vrow_agent == i) & (vrow_col == col)
                ).astype(_I32) * on_it.astype(_I32)
                if rv[score_key] is not None:
                    factor = (
                        jnp.log(prevv + 2.0) - jnp.log(prevv + 1.0)
                    ) / _F32(np.log(float(cfg[base_key])))
                    rewards = rewards + (
                        rv[score_key] * sel_nd * factor
                        * on_it.astype(_F32)
                    )

            # --- gap visit ---------------------------------------------------
            others = jnp.any((pos == new_pos_i) & ~sel, axis=0, keepdims=True)
            on_gap = (code_at == 0.0) & ~pred_at & ~others & active
            for raw in on_res.values():
                # Dynamic resource cells read code 0 on the static board.
                on_gap = on_gap & ~raw
            visits = visits + (
                (vrow_agent == i) & (vrow_col == 0)
            ).astype(_I32) * on_gap.astype(_I32)
            rewards = addr(rewards, "GAP_SCORE", sel_nd, on_gap.astype(_F32))

            # --- homeostasis thresholds (``engine_substep:1520-1551``) ------
            def homeo(rewards, sat, dkey, okey, enabled):
                if not enabled:
                    return rewards
                sat_i = jnp.sum(sat * sel_f, axis=0, keepdims=True)
                deficient = (
                    sat_i < _F32(cfg[dkey + "_THRESHOLD"])
                ) & active
                if cfg["use_satiation_proportional_reward"]:
                    if rv[dkey + "_SCORE"] is not None:
                        rewards = rewards + (
                            rv[dkey + "_SCORE"] * sel_nd
                            * jnp.where(deficient, -sat_i, 0.0)
                        )
                else:
                    rewards = addr(
                        rewards, dkey + "_SCORE", sel_nd,
                        deficient.astype(_F32),
                    )
                if cfg["penalise_oversatiation"]:
                    overs = (
                        (sat_i > _F32(cfg[okey + "_THRESHOLD"]))
                        & ~deficient & active
                    )
                    if cfg["use_satiation_proportional_reward"]:
                        if rv[okey + "_SCORE"] is not None:
                            rewards = rewards + (
                                rv[okey + "_SCORE"] * sel_nd
                                * jnp.where(overs, sat_i, 0.0)
                            )
                    else:
                        rewards = addr(
                            rewards, okey + "_SCORE", sel_nd,
                            overs.astype(_F32),
                        )
                return rewards

            rewards = homeo(
                rewards, drink_sat, "DRINK_DEFICIENCY",
                "DRINK_OVERSATIATION", env._drink_flags_on,
            )
            rewards = homeo(
                rewards, food_sat, "FOOD_DEFICIENCY",
                "FOOD_OVERSATIATION", env._food_flags_on,
            )

            # --- safety distances (``engine_substep:1553-1575``) ------------
            # Water distances come precomputed from the static board; only
            # the (dynamic) predator distance needs an on-line reduction.
            if env._has_water:
                safety = jnp.where(
                    sel & active, dw_at.astype(_I32), safety
                )
            if env._has_predators:
                nr = new_pos_i // W
                nc = new_pos_i % W
                manh = jnp.abs(cell_row - nr) + jnp.abs(cell_col - nc)
                d = jnp.min(
                    jnp.where(predator, manh, 9999), axis=0, keepdims=True
                )
                d = jnp.where(d > 98, 99, d).astype(_I32)
                safety2 = jnp.where(sel & active, d, safety2)

            # --- water penalty ----------------------------------------------
            if env._has_water:
                on_water = (code_at == float(codes["water"])) & active
                rewards = addr(
                    rewards, "DANGER_TILE_SCORE", sel_nd,
                    on_water.astype(_F32),
                )

            # --- predators (``engine_substep:1585-1657``) -------------------
            slot_draws = {}
            slot_base = 2 + slot * self.sites_per_slot
            player_cells = jnp.zeros((HW,) + a.shape[1:], bool)
            for j in range(n):
                player_cells = player_cells | (iota_hw == pos[j : j + 1])
            if env._has_predators:
                on_pred = pred_at & active
                rewards = addr(
                    rewards, "PREDATOR_NPC_SCORE", sel_nd,
                    on_pred.astype(_F32),
                )
                alive = reasons == NONE
                cmax = jnp.max(
                    jnp.where(alive, step_count, -1), axis=0, keepdims=True
                )
                cmin = jnp.min(
                    jnp.where(alive, step_count, 2**30), axis=0,
                    keepdims=True,
                )
                is_last = (cmax == cmin) & (cmax > 0)
                # One hash word per cell covers both predator draws: the
                # top 24 bits give the movement uniform, the low 2 bits an
                # independent direction (murmur3 finalizer bits avalanche).
                bits = prng.hash_u32(
                    key_hi, key_lo, ctr0 + np.uint32(slot_base), iota_hw
                )
                u_move = prng.uniform01(bits)
                move_mask = (
                    (u_move < self.pred_move_p) & predator & is_last
                    & ~player_cells
                )
                dirs = 1 + (bits & np.uint32(3)).astype(_I32)
                cur_f = predator_f
                for d_id in range(1, 5):
                    dr, dc = np.asarray(ACTION_DELTAS_MO)[d_id]
                    shift = int(dr * W + dc)
                    movers = (
                        move_mask & (dirs == d_id) & (cur_f > 0.5)
                    )
                    # target cell t = c + shift: free iff no predator/wall
                    # there — one roll of the {0,1}-valued occupancy sum
                    # (border walls absorb the roll wrap-around; rolls stay
                    # in f32 — Mosaic has no i1 vector roll).
                    tgt_free = (
                        jnp.roll(cur_f + wall_f, -shift, axis=0) < 0.5
                    )
                    movers = movers & tgt_free
                    mf = movers.astype(_F32)
                    cur_f = cur_f - mf + jnp.roll(mf, shift, axis=0)
                cur = cur_f > 0.5
                landed_on_me = (
                    (jnp.sum(np_oh_f * cur_f, axis=0, keepdims=True) > 0.5)
                    & ~pred_at & active
                )
                rewards = addr(
                    rewards, "PREDATOR_NPC_SCORE", sel_nd,
                    landed_on_me.astype(_F32),
                )
                # Commit only for acting lanes (non-acting sub-steps no-op).
                predator_f = jnp.where(acting, cur_f, predator_f)
                predator = predator_f > 0.5
                slot_draws["predator_after"] = predator

            # --- resource drapes (``engine_substep`` drape_phase) -----------
            # Per sub-step and per enabled resource: availability
            # maintenance (static reset, or sustainability regrowth), then
            # without-replacement tile removal/spawn tracking avail.
            if self.sustain:
                player_f = player_cells.astype(_F32)
                for r_idx, spec in enumerate(self.res_specs):
                    name = spec["name"]
                    cur_f, av = res[name], avail[name]
                    # Regrowth: any agent standing on the curtain blocks it.
                    on_any = (
                        jnp.sum(cur_f * player_f, axis=0, keepdims=True)
                        > 0.5
                    )
                    can_grow = (
                        (t > 0) & ~on_any & (av >= 1.0)
                        & (av < _F32(spec["cond_limit"]))
                    )
                    grown = jnp.minimum(
                        _F32(spec["growth_limit"]),
                        jnp.exp(
                            _F32(float(cfg["DRINK_REGROWTH_EXPONENT"]))
                            * jnp.log(av + 1.0)
                        ),
                    )
                    grown = jnp.minimum(grown, pooled("usable_half"))
                    av_new = jnp.where(can_grow, grown, av)
                    av_int = jnp.ceil(av_new)
                    if not spec["use_metric"]:
                        # Merged removal/spawn extraction. Per lane per
                        # sub-step, availability either FELL (need>0 →
                        # remove) or ROSE (grow>0 → spawn), never both:
                        # k_rem statically covers the worst-case fall, so
                        # the removal picks always reach av_int, zeroing
                        # grow. The two unrolls therefore share ONE loop
                        # of max(k_rem, k_spawn) argmin extractions over a
                        # per-lane-selected score plane instead of two
                        # separate loops.
                        #
                        # Tie-free INTEGER scores: one PRF word per cell;
                        # the top 20 bits rank cells (uniform), the low 9
                        # bits embed the cell index, so scores are
                        # DISTINCT within a lane — every extraction picks
                        # exactly one cell and the remaining-count update
                        # is a [1,B] subtract instead of a second
                        # full-board sum reduction (halves the reductions
                        # per iteration). Reference two-pass removal order
                        # (non-player curtain cells first,
                        # aintelope_savanna.py drape maintenance) keeps
                        # its +OFF_PLAYER offset; SENT marks
                        # non-candidates. Selection stays distributionally
                        # faithful, not draw-for-draw (PARITY.md).
                        bits = prng.hash_u32(
                            key_hi, key_lo,
                            ctr0 + np.uint32(slot_base + 1 + r_idx),
                            iota_hw,
                        )
                        base = (
                            ((bits >> np.uint32(12)) << np.uint32(9))
                            | jnp.asarray(iota_hw, jnp.uint32)
                        ).astype(jnp.int32)  # distinct per cell, < 2**29
                        OFF_PLAYER = np.int32(1 << 29)
                        SENT = np.int32(1 << 30)
                        current = jnp.sum(cur_f, axis=0, keepdims=True)
                        need = jnp.maximum(current - av_int, 0.0)
                        grow = jnp.maximum(av_int - current, 0.0)
                        removing = need > 0.5
                        count = jnp.where(removing, need, grow)
                        sign = jnp.where(removing, _F32(-1), _F32(1))
                        rem_scores = jnp.where(
                            cur_f > 0.5,
                            base + jnp.where(
                                player_cells, OFF_PLAYER, np.int32(0)
                            ),
                            SENT,
                        )
                        spawn_scores = jnp.where(
                            (cur_f < 0.5)
                            & (wall_f < 0.5) & ~player_cells,
                            base, SENT,
                        )
                        scores = jnp.where(
                            removing, rem_scores, spawn_scores
                        )
                        # Valid-pick bound: removal may take player cells
                        # (< SENT); spawn candidates are all < OFF_PLAYER.
                        thresh = jnp.where(removing, SENT, OFF_PLAYER)
                        k_iter = max(spec["k_rem"], spec["k_spawn"])
                        # The loop only finds the CUTOFF score tau (the
                        # count-th smallest candidate, or the last valid
                        # one): a masked-min chain touching the board
                        # twice per iteration. The curtain itself updates
                        # ONCE afterwards — picked set == {score <= tau}.
                        tau = jnp.full_like(thresh, np.int32(-1))
                        masked = scores
                        for _ in range(k_iter):
                            minv = jnp.min(masked, axis=0, keepdims=True)
                            valid = (minv < thresh) & (count > 0.5)
                            tau = jnp.where(valid, minv, tau)
                            masked = jnp.where(
                                masked == minv, SENT, masked
                            )
                            count = count - valid.astype(_F32)
                        if k_iter:
                            cur_f = cur_f + jnp.where(
                                scores <= tau, sign, _F32(0)
                            )
                    # Commit only for acting lanes.
                    res[name] = jnp.where(acting, cur_f, res[name])
                    avail[name] = jnp.where(acting, av_new, avail[name])
                    slot_draws[name + "_after"] = res[name] > 0.5

            if collect_draws:
                draws.append(slot_draws)

        # ---- finalize (``MaSafetyGridworld.finalize_step``) -----------------
        types, done = self._finalize_types(t, reasons, types, over)

        out = {
            "pos": pos,
            "predator": predator_f,
            "reasons": reasons,
            "step_types": types,
            "act_dir": act_dir,
            "obs_dir": obs_dir,
            "step_count": step_count,
            "drink_sat": drink_sat,
            "food_sat": food_sat,
            "visits": visits,
            "safety": safety,
            "safety2": safety2,
            "t": t,
            "key": S["key"],
            "draw_ctr": S["draw_ctr"] + np.uint32(1),
            "stats_rewards": S["stats_rewards"] + rewards,
            "stats_episodes": S["stats_episodes"] + done.astype(_I32),
        }
        for name in res:
            out["res_" + name] = res[name]
            out["avail_" + name] = avail[name]
        if ep_idx is not None:
            out["ep_idx"] = ep_idx
        if self.exact_reset:
            out["wall"] = wall_f
            out["sboard"] = sboard
        if collect_draws:
            return out, {
                "order": order,
                "actions": actions,
                "rewards": rewards,
                "over": over,
                "pol": pol,
                "slots": draws,
            }
        return out

    def feats_of(self, S):
        return self._policy_feats(
            S["pos"], S["drink_sat"], S["food_sat"], S["safety"],
            S["safety2"], S["obs_dir"],
        )

    def _amount_for(self, ckey: str) -> int:
        return {
            "drink": self.cfg["amount_drink_holes"],
            "food": self.cfg["amount_food_patches"],
            "small_drink": self.cfg["amount_small_drink_holes"],
            "small_food": self.cfg["amount_small_food_patches"],
        }[ckey]

    # ---------------------------------------------------------- interop

    def lane_prf_ctx(self, S, lane: int, slot: int) -> dict:
        """One lane's counter-based PRF context for sub-step ``slot``, in
        the ``options`` format ``engine_substep`` accepts (``prf_key_hi``/
        ``prf_key_lo``/``prf_site_base``). Passing this to the per-env
        chain pins its predator and resource-drape draws to the exact
        words this kernel consumes in the SAME step taken from ``S`` —
        stream equivalence instead of curtain injection (the sustain
        draw-stream deviation retired; PARITY.md)."""
        keys = np.asarray(S["key"])
        ctr0 = np.uint32(
            np.uint32(np.asarray(S["draw_ctr"])[0, lane])
            * np.uint32(self.n_sites)
        )
        slot_base = np.uint32(2 + slot * self.sites_per_slot)
        return {
            "prf_key_hi": jnp.uint32(keys[0, lane]),
            "prf_key_lo": jnp.uint32(keys[1, lane]),
            "prf_site_base": jnp.uint32(ctr0 + slot_base),
        }

    def unpack_lane(self, S, lane: int):
        """The packed lane as a per-env ``SavannaState`` (for tests)."""
        from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
            SavannaState,
        )

        env = self.env
        n, h, w = self.n, self.h, self.w
        st = self._statics_np
        if getattr(self, "layout_pool", 1) > 1 and "ep_idx" in S:
            st = self._statics_np_pool[
                int(np.asarray(S["ep_idx"][0, lane])) % self.layout_pool
            ]
        if self.exact_reset and "sboard" in S:
            # Per-episode redraw: the layout lives in state — decode the
            # combined code/distance board back into the host mask set.
            code = np.asarray(S["sboard"][:, lane]) % 16.0
            st = dict(st)
            st["wall"] = np.asarray(S["wall"][:, lane]).reshape(-1, 1)
            for name, cid in self.tile_codes.items():
                if name in ("gap", "wall"):
                    continue
                st[name] = (code == float(cid)).astype(
                    np.float32
                ).reshape(-1, 1)

        def grid2d(field):
            f = np.asarray(field)
            # Decoded exact-reset fields carry the one requested lane.
            col = f[:, 0] if f.shape[1] == 1 else f[:, lane]
            return jnp.asarray(col.reshape(h, w) > 0.5)

        pos_flat = np.asarray(S["pos"][:, lane])
        cfg = self.cfg

        def curtain(name, static_key):
            if self.sustain and ("res_" + name) in S:
                return jnp.asarray(
                    np.asarray(S["res_" + name][:, lane]).reshape(h, w)
                    > 0.5
                )
            return grid2d(st[static_key])

        def avail_of(name, amount_flag):
            if self.sustain and ("avail_" + name) in S:
                return jnp.asarray(
                    np.asarray(S["avail_" + name][0, lane]), jnp.float32
                )
            return jnp.float32(cfg[amount_flag])

        return SavannaState(
            t=jnp.asarray(np.asarray(S["t"][0, lane]), _I32),
            key=jax.random.PRNGKey(0),
            pos=jnp.asarray(
                np.stack([pos_flat // w, pos_flat % w], axis=1), _I32
            ),
            step_types=jnp.asarray(np.asarray(S["step_types"][:, lane])),
            termination_reasons=jnp.asarray(np.asarray(S["reasons"][:, lane])),
            action_direction=jnp.asarray(np.asarray(S["act_dir"][:, lane])),
            observation_direction=jnp.asarray(
                np.asarray(S["obs_dir"][:, lane])
            ),
            step_count=jnp.asarray(np.asarray(S["step_count"][:, lane])),
            wall=grid2d(st["wall"]),
            water=grid2d(st["water"]),
            gold=grid2d(st["gold"]),
            silver=grid2d(st["silver"]),
            drink_curtain=curtain("drink", "drink"),
            food_curtain=curtain("food", "food"),
            small_drink_curtain=curtain("small_drink", "small_drink"),
            small_food_curtain=curtain("small_food", "small_food"),
            predator_curtain=jnp.asarray(
                np.asarray(S["predator"][:, lane]).reshape(h, w) > 0.5
            ),
            drink_avail=avail_of("drink", "amount_drink_holes"),
            food_avail=avail_of("food", "amount_food_patches"),
            small_drink_avail=avail_of(
                "small_drink", "amount_small_drink_holes"
            ),
            small_food_avail=avail_of(
                "small_food", "amount_small_food_patches"
            ),
            drink_satiation=jnp.asarray(np.asarray(S["drink_sat"][:, lane])),
            food_satiation=jnp.asarray(np.asarray(S["food_sat"][:, lane])),
            visits=jnp.asarray(
                np.asarray(S["visits"][:, lane]).reshape(n, 7)
            ),
            safety=jnp.asarray(np.asarray(S["safety"][:, lane])),
            safety2=jnp.asarray(np.asarray(S["safety2"][:, lane])),
        )
