"""Fully-fused batched firemaker_ex_ma packed step.

The generic batched MA path (vmapped ``apply_substep`` chain) compiles to
~40 unfusable XLA kernels per step (threefry, convs, scatters). This
module restructures the WHOLE multi-agent step — action draws, randomized
agent order, all sequential sub-steps (move, stop button, workshop, fire
spread, territory), finalize, and auto-reset — into one scatter-free,
gather-free, conv-free computation over a "packed" batch layout, which
``FusedMaBase``'s drivers run as one jitted ``lax.scan`` per rollout
chunk.

Packed layout: batch on the minor lane axis, board cells on the major
axis — ``fire`` is ``[H*W, B]``, positions are flat cell indices
``[n_agents, B]``, scalars are ``[1, B]``. Position reads/writes become
one-hot compare + reduce (never a gather/scatter); the fire-spread
stencil (``firemaker_ex_ma.py:561-621``: union probability in log space)
becomes static rolls along the cell axis (8 after the separable
grouping below) — board borders are all walls, so roll wrap-around lands
on non-spreadable cells and needs no masking. Randomness is the
counter-based PRF of ``ops/prng.py`` (distributionally faithful to the
reference Generator; the host-parity shell path is unaffected).

Semantics mirror ``envs/firemaker_ex_ma.py::FiremakerExMa.engine_substep``
(itself lockstep-tested against
``/root/reference/ai_safety_gridworlds/environments/firemaker_ex_ma.py``);
the equivalence test injects this kernel's draws into the per-env sub-step.
All valid direction-mode combinations are supported fused: relative
action/observation modes (1: relative-to-move, 2: relative-with-turns)
add per-agent facing rows and resolve moves through the same
``MODE_DIR_TABLES`` select chains as the island/savanna kernels
(``core/actions.py``; invalid odm=2+adm=0 rejected like the per-env
path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core.actions import (
    DIR_TO_ACTION_MO,
    MODE_DIR_TABLES,
    ActionsMo,
    Directions,
)
from ai_safety_gridworlds_tpu.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_tpu.ops import prng
from ai_safety_gridworlds_tpu.ops.fused_base import FusedMaBase
from ai_safety_gridworlds_tpu.ops.fused_island_ma import _table_sel

_I32 = jnp.int32
_F32 = jnp.float32

FIRST = int(StepType.FIRST)
MID = int(StepType.MID)
LAST = int(StepType.LAST)
DEAD = int(StepType.DEAD)
NONE = int(TerminationReason.NONE)
QUIT_R = int(TerminationReason.QUIT)

NOOP = int(ActionsMo.NOOP)
QUIT = int(ActionsMo.QUIT)


class FusedFiremaker(FusedMaBase):
    """Packed batched firemaker with a fused step/rollout."""

    # In-step linear-policy features per agent (``set_policies``):
    # normalized row/col, at-workshop flag, stop-button countdown,
    # external-fire count, episode progress.
    POLICY_FEATURES = 6

    def __init__(self, env, matrix_stencil=False):
        # ``matrix_stencil=True``: compute the fire-spread survival
        # product as a banded log-survival matrix product (``W @ src``
        # with ``W[i, j] = log1p(-p)`` for stencil offset ``j -> i``,
        # split into two products against the tensor cores' input
        # rounding — see the split below) followed by ``1 - exp``, instead
        # of the 8 rolls of the separable product form. Mathematically
        # exact for 0/1 sources; only f32 rounding differs (gated <= 1e-5
        # absolute on ``cum`` by ``tests/test_fused_firemaker.py``). The
        # roll form is the default: it ran the whole rollout 24-32%
        # faster on the H100 (PERF.md, "Kernel decisions").
        self._matrix_stencil = bool(matrix_stencil)
        self.adm = int(env.action_direction_mode)
        self.odm = int(env.observation_direction_mode)
        if self.odm == 2 and self.adm == 0:
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
        wall = np.asarray(env._wall_mask)
        if not (
            wall[0, :].all()
            and wall[-1, :].all()
            and wall[:, 0].all()
            and wall[:, -1].all()
        ):
            raise NotImplementedError(
                "fused fire stencil requires an all-wall border "
                "(absorbs roll wrap-around)"
            )
        cfg = env.cfg

        def flat(mask):
            return np.asarray(mask, np.float32).reshape(self.HW, 1)

        self.consts = {
            "wall": flat(env._wall_mask),
            "workshop": flat(env._workshop_mask),
            "button": flat(env._button_mask),
            "territory": flat(env._territory_mask),
            "external": flat(env._external_mask),
            "spreadable": flat(env._spreadable),
        }
        # Bit-coded static board: one sum-reduction against an agent's
        # position one-hot recovers every static tile property at once
        # (masks may overlap — workshop lies inside territory — so this is
        # a bitmask, not an id).  Bit 6 is added dynamically for fire.
        self.consts["code"] = (
            1.0 * self.consts["wall"]
            + 2.0 * self.consts["workshop"]
            + 4.0 * self.consts["button"]
            + 8.0 * self.consts["territory"]
            + 16.0 * self.consts["external"]
        )
        # Separable grouping of the stencil: roll(x, dr*W + dc) ==
        # roll(roll(x, dc), dr*W), so rolling the source once per distinct
        # column offset and each row-group's weighted sum once per distinct
        # row offset needs |dc|+|dr| rolls (8 for the 5x5 stencil) instead
        # of one per offset (24). Rows with IDENTICAL term lists share one
        # row polynomial: the 5x5 stencil is symmetric in dr, so ±dr rows
        # are the same un-rolled board — 3 distinct polynomials instead of
        # 5 (~36% less term work, bit-identically).
        rows: dict = {}
        for dr, dc, p in env._spread_offsets:
            rows.setdefault(dr, []).append((dc, float(p)))
        self.spread_rows = sorted(
            (dr, tuple(sorted(terms))) for dr, terms in rows.items()
        )
        self.spread_polys = sorted(
            {terms for _, terms in self.spread_rows}
        )
        self.spread_dcs = sorted(
            {dc for _, dc, _ in env._spread_offsets}
        )
        if self._matrix_stencil:
            # Banded log-survival matrix over FLAT indices, replicating
            # the roll form's wrap-around (harmless: wrapped reads land
            # on the all-wall border, where sources are identically 0).
            #
            # Two-term split W = W_hi + W_lo against the input rounding
            # of a default-precision f32 product (TF32 on the GPU's
            # tensor cores, 10 mantissa bits): sources are 0/1 (exact)
            # and accumulation is f32, so the ONLY error is W's rounding.
            # W_hi is bf16-representable (8 mantissa bits), so it passes
            # any reduced-precision input format unrounded; W_lo carries
            # the residual (~2^-9 relative), whose own rounding leaves
            # ~1e-6 absolute on ``cum``.
            logw = np.zeros((self.HW, self.HW), np.float64)
            for dr, dc, p in env._spread_offsets:
                off = dr * w + dc
                i = np.arange(self.HW)
                logw[i, (i - off) % self.HW] = np.log1p(-float(p))
            w_hi = logw.astype(np.float32).astype(
                jnp.bfloat16
            ).astype(np.float32)
            self.consts["spread_logw_hi"] = w_hi
            self.consts["spread_logw_lo"] = (
                logw.astype(np.float32) - w_hi
            ).astype(np.float32)
        self.start_pos_flat = np.asarray(
            env._start_pos[:, 0] * w + env._start_pos[:, 1], np.int32
        ).reshape(self.n, 1)
        self.sup = env.supervisor_idx  # -1 when absent
        self.has_sup = env.has_supervisor
        self.n_workers = env.n_workers
        self.press_duration = int(cfg["STOP_BUTTON_PRESS_EFFECT_DURATION"])
        self.cont_p = float(cfg["FIRE_CONTINUATION_PROBABILITY"])
        self.max_iterations = int(env.max_iterations)
        self.amin, self.amax = int(env.action_min), int(env.action_max)

        # Reward vectors tiled over the [n*D] reward rows.
        def tiled(mo_key):
            vec = np.asarray(env.rvec(cfg[mo_key]), np.float32)
            return np.tile(vec, self.n).reshape(self.n * self.D, 1)

        self.rv = {
            k: tiled(k)
            for k in (
                "AGENT_MOVEMENT_REWARD",
                "AGENT_WORKSHOP_WORK_REWARD",
                "AGENT_WORKSHOP_ENERGY_REWARD",
                "SUPERVISOR_MOVEMENT_REWARD",
                "SUPERVISOR_EXTERNAL_FIRE_REWARD",
                "SUPERVISOR_TRESPASSING_REWARD",
                "SUPERVISOR_STOP_BUTTON_REWARD",
                "SUPERVISOR_WORKSHOP_REWARD",
            )
        }
        # Static row masks: reward row r belongs to agent r // D. All
        # lookup tables live in ``self.consts`` (uploaded once, passed to
        # the jitted step as arrays).
        row_agent = (np.arange(self.n * self.D) // self.D).astype(np.int32)
        self.consts["row_agent"] = row_agent.reshape(self.n * self.D, 1)
        for j in range(self.n):
            self.consts[f"arm_{j}"] = (
                (row_agent == j).astype(np.float32).reshape(-1, 1)
            )
        v_rows = np.arange(self.n * 5, dtype=np.int32)
        self.consts["vrow_agent"] = (v_rows // 5).reshape(self.n * 5, 1)
        self.consts["vrow_col"] = (v_rows % 5).reshape(self.n * 5, 1)
        self.consts["start_pos"] = self.start_pos_flat
        for k in self.rv:
            self.consts["rv_" + k] = self.rv[k]

        self._kstatics_np = {}

        # Per-step PRF draw sites: 0 = action draws (idx=agent row),
        # 1 = permutation draws (idx=row), then 1 per sub-step slot
        # (idx=cell): spread-eligible cells and burning cells are disjoint,
        # so one uniform per cell serves both the spread and the
        # continuation Bernoulli draws.
        self.n_sites = 2 + self.n

    # ------------------------------------------------------------- packing

    def init_packed(self, seed: int, batch: int) -> dict:
        n, HW = self.n, self.HW
        keys = prng.derive_keys(seed, batch)
        state = {
            "fire": jnp.zeros((HW, batch), _F32),
            "pos": jnp.tile(jnp.asarray(self.start_pos_flat), (1, batch)),
            "reasons": jnp.full((n, batch), NONE, _I32),
            "step_types": jnp.full((n, batch), FIRST, _I32),
            "countdown": jnp.zeros((1, batch), _I32),
            "ext_fires": jnp.zeros((1, batch), _I32),
            "visits": jnp.zeros((n * 5, batch), _I32),
            "at_workshop": jnp.zeros((n, batch), _F32),
            "t": jnp.zeros((1, batch), _I32),
            "key": jnp.asarray(keys),
            "draw_ctr": jnp.zeros((1, batch), jnp.uint32),
            "stats_rewards": jnp.zeros((n * self.D, batch), _F32),
            "stats_episodes": jnp.zeros((1, batch), _I32),
        }
        fields = tuple(
            f for f in self.STATE_FIELDS
            if f not in ("act_dir", "obs_dir")
        )
        if self.adm != 0 or self.odm != 0:
            # Relative direction modes carry per-agent facings.
            state["act_dir"] = jnp.full(
                (n, batch), int(Directions.UP), _I32
            )
            state["obs_dir"] = jnp.full(
                (n, batch), int(Directions.UP), _I32
            )
            fields = fields + ("act_dir", "obs_dir")
        self.STATE_FIELDS = fields
        # Subclass contract (fused_base): re-packing must invalidate the
        # memoized device statics (no packed statics today, but installed
        # policies ride the same cache).
        self.packed_batch = int(batch)
        self._invalidate_device_cache()
        return state

    STATE_FIELDS = (
        "fire", "pos", "reasons", "step_types", "countdown", "ext_fires",
        "visits", "at_workshop", "t", "key", "draw_ctr",
        "stats_rewards", "stats_episodes",
    )

    # ----------------------------------------------------------- step body

    def _policy_feats(self, pos, at_work, countdown, ext_fires, t):
        """Per-agent [1, B] feature rows for in-step linear policies
        (observed at the start of the step, post auto-reset)."""
        feats = []
        for j in range(self.n):
            pos_f, _ = self._pos_dir_feats(pos, None, j)
            feats.append(
                pos_f
                + [
                    at_work[j : j + 1],
                    countdown.astype(jnp.float32) * jnp.float32(0.1),
                    ext_fires.astype(jnp.float32) * jnp.float32(0.1),
                    t.astype(jnp.float32)
                    * jnp.float32(1.0 / max(self.max_iterations, 1)),
                ]
            )
        return feats

    def _spread_cum(self, src_f, consts):
        """Per-cell fire-spread probability ``1 - prod(1 - p*src)`` over
        the 5x5 stencil, from the [HW, lanes] 0/1 source board. Two
        formulations (selected by ``matrix_stencil``; accuracy-gated
        against each other in ``tests/test_fused_firemaker.py``)."""
        if self._matrix_stencil:
            # Two [HW, HW] x [HW, lanes] products (the W_hi + W_lo split
            # built in __init__) at an explicit default precision: per-cell
            # summed log-survival over burning neighbors (exact for 0/1
            # sources; only f32 rounding differs from the product form),
            # then one exp. No burning neighbor -> s = 0 -> cum = 0
            # exactly in both halves, preserving the ``cum > 0``
            # spread-cell semantics.
            dims = (((1,), (0,)), ((), ()))
            prec = jax.lax.Precision.DEFAULT
            s = jax.lax.dot_general(
                consts["spread_logw_hi"], src_f, dims, precision=prec,
                preferred_element_type=jnp.float32,
            ) + jax.lax.dot_general(
                consts["spread_logw_lo"], src_f, dims, precision=prec,
                preferred_element_type=jnp.float32,
            )
            return 1.0 - jnp.exp(s)
        # Separable stencil: one roll per distinct column offset,
        # one per row group (8 rolls vs 24 per-offset rolls);
        # each DISTINCT row polynomial computed once and rolled to
        # every row offset that uses it (±dr symmetry: 3 polys,
        # not 5). Row multiplication order is unchanged, so the
        # result is bit-identical to the per-row form.
        shifted = {
            dc: (jnp.roll(src_f, dc, axis=0) if dc else src_f)
            for dc in self.spread_dcs
        }
        polys = {}
        for terms in self.spread_polys:
            y = None
            for dc, p_off in terms:
                f_term = 1.0 - p_off * shifted[dc]
                y = f_term if y is None else y * f_term
            polys[terms] = y
        prod = None
        for dr, terms in self.spread_rows:
            y = polys[terms]
            y = jnp.roll(y, dr * self.w, axis=0) if dr else y
            prod = y if prod is None else prod * y
        return 1.0 - prod

    def _step(self, S: dict, statics: dict, consts: dict,
              collect_draws: bool = False):
        """One full MA step on packed arrays. Pure jnp; runs under XLA or
        under the scan drivers. Returns the updated dict (and the raw draw
        fields when ``collect_draws`` — used by the equivalence test).
        ``statics`` is empty: this kernel's boards are lane-invariant and
        ride in ``consts``."""
        n, D, HW = self.n, self.D, self.HW
        W = self.w
        key_hi = S["key"][0:1]
        key_lo = S["key"][1:2]

        iota_n = jax.lax.broadcasted_iota(_I32, (n, 1), 0)
        iota_hw = jax.lax.broadcasted_iota(_I32, (HW, 1), 0)

        wall_f = consts["wall"]
        territory = consts["territory"] > 0.5
        spreadable = consts["spreadable"] > 0.5

        # ---- auto-reset lanes whose episode ended last step ---------------
        types = S["step_types"]
        over = jnp.all(
            (types == LAST) | (types == DEAD), axis=0, keepdims=True
        )
        fire = jnp.where(over, 0.0, S["fire"])
        pos = jnp.where(over, consts["start_pos"].astype(_I32), S["pos"])
        reasons = jnp.where(over, NONE, S["reasons"])
        types = jnp.where(over, FIRST, types)
        countdown = jnp.where(over, 0, S["countdown"])
        ext_fires = jnp.where(over, 0, S["ext_fires"])
        visits = jnp.where(over, 0, S["visits"])
        at_work = jnp.where(over, 0.0, S["at_workshop"])
        t = jnp.where(over, 0, S["t"])
        has_dirs = self.adm != 0 or self.odm != 0
        if has_dirs:
            act_dir = jnp.where(over, int(Directions.UP), S["act_dir"])
            obs_dir = jnp.where(over, int(Directions.UP), S["obs_dir"])

        ctr0 = S["draw_ctr"] * np.uint32(self.n_sites)
        feats = None
        if "pol_w" in statics or "mlp_w1" in statics:
            feats = self._policy_feats(pos, at_work, countdown, ext_fires, t)
        actions, order, pol = self._draw_actions_and_order(
            S, over, reasons, ctr0, iota_n, feats=feats, statics=statics
        )

        rewards = jnp.zeros((n * D,) + actions.shape[1:], _F32)
        row_agent = consts["row_agent"]
        vrow_agent = consts["vrow_agent"]
        vrow_col = consts["vrow_col"]
        rv = {k: consts["rv_" + k] for k in self.rv}
        arm = {j: consts[f"arm_{j}"] for j in range(n)}
        draws = []

        for slot in range(n):
            i = order[slot : slot + 1]  # [1, B] acting agent index
            # One-hot extraction returns actions[i] verbatim (incl. -1).
            a = jnp.sum(
                jnp.where(iota_n == i, actions, 0), axis=0, keepdims=True
            )
            acting = a >= 0
            actf = acting.astype(_F32)
            is_quit = a == QUIT
            is_noop = a == NOOP
            sel = iota_n == i
            dead_i = jnp.any(
                sel & (reasons != NONE), axis=0, keepdims=True
            )
            active = acting & ~is_quit & ~dead_i
            t = t + acting.astype(_I32)

            # --- direction modalities (``engine_substep``; observation
            # facing updates BEFORE the move, action facing AFTER,
            # ``safety_game_ma.py:650-766,808``) --------------------------
            is_move = (a >= 1) & (a <= 4)
            if has_dirs:
                a_cl = jnp.clip(a, 0, 9)
                dir_i = jnp.sum(
                    jnp.where(sel, act_dir, 0), axis=0, keepdims=True
                )
                odir_i = jnp.sum(
                    jnp.where(sel, obs_dir, 0), axis=0, keepdims=True
                )
                if self.odm != 0:
                    if self.odm == 1:
                        otab = MODE_DIR_TABLES[
                            1 if self.adm in (1, 2) else 0
                        ]
                    else:
                        otab = MODE_DIR_TABLES[2]
                    new_odir = _table_sel(otab, a_cl, odir_i)
                    obs_dir = jnp.where(sel & active, new_odir, obs_dir)
                if self.adm == 0:
                    abs_action = a
                else:
                    rel = _table_sel(MODE_DIR_TABLES[1], a_cl, dir_i)
                    abs_move = jnp.zeros_like(rel) + int(DIR_TO_ACTION_MO[0])
                    for d in range(1, 4):
                        abs_move = jnp.where(
                            rel == d, int(DIR_TO_ACTION_MO[d]), abs_move
                        )
                    abs_action = jnp.where(is_move, abs_move, a)
                    new_adir = _table_sel(
                        MODE_DIR_TABLES[self.adm], a_cl, dir_i
                    )
                    act_dir = jnp.where(sel & active, new_adir, act_dir)
            else:
                abs_action = a

            # --- move ------------------------------------------------------
            pos_i = jnp.sum(
                jnp.where(sel, pos, 0), axis=0, keepdims=True
            )
            delta = (
                (abs_action == int(ActionsMo.LEFT)) * (-1)
                + (abs_action == int(ActionsMo.RIGHT)) * 1
                + (abs_action == int(ActionsMo.UP)) * (-W)
                + (abs_action == int(ActionsMo.DOWN)) * W
            ).astype(_I32)
            cand = pos_i + delta
            cand_oh = iota_hw == cand
            occ = jnp.any((pos == cand) & ~sel, axis=0, keepdims=True)
            wall_at = (
                jnp.sum(cand_oh * wall_f, axis=0, keepdims=True) > 0.5
            )
            moved = active & is_move & ~wall_at & ~occ
            new_pos_i = jnp.where(moved, cand, pos_i)
            pos = jnp.where(sel, new_pos_i, pos)

            # QUIT terminates the acting agent.
            reasons = jnp.where(
                sel & (is_quit & ~dead_i), QUIT_R, reasons
            )

            # Movement reward (``firemaker_ex_ma.py:436-441``).
            sel_nd = (row_agent == i).astype(_F32)
            if self.has_sup:
                move_tiled = jnp.where(
                    i == self.sup,
                    rv["SUPERVISOR_MOVEMENT_REWARD"],
                    rv["AGENT_MOVEMENT_REWARD"],
                )
            else:
                move_tiled = rv["AGENT_MOVEMENT_REWARD"]
            rewards = rewards + move_tiled * sel_nd * (
                active & ~is_noop
            ).astype(_F32)

            # Player one-hot field (post-move positions).
            agent_oh = [iota_hw == pos[j : j + 1] for j in range(n)]
            P = agent_oh[0]
            for j in range(1, n):
                P = P | agent_oh[j]

            # One reduction per agent against the bit-coded board (+ the
            # dynamic fire bit) recovers every tile property needed below —
            # replacing the ~n+8 separate masked any() reductions.
            dyn_code = consts["code"] + 64.0 * fire
            v_agents = [
                jnp.sum(agent_oh[j] * dyn_code, axis=0, keepdims=True)
                for j in range(n)
            ]

            def bit(v, k):
                m = jnp.floor(v * _F32(1.0 / (1 << k)))
                return (m - 2.0 * jnp.floor(m * 0.5)) > 0.5

            # The acting agent's tile value (agent_oh[i] is the
            # post-move one-hot of the acting agent).
            v_at = jnp.zeros_like(v_agents[0])
            for j in range(n):
                v_at = jnp.where(i == j, v_agents[j], v_at)
            on_wrk = bit(v_at, 1)
            on_btn = bit(v_at, 2)
            on_int = bit(v_at, 3)
            on_ext = bit(v_at, 4)
            on_fire = bit(v_at, 6)
            # Int-valued selects: Mosaic rejects multi-row i1-valued
            # select_n (i8->i1 truncation), so the visit conditions are
            # combined as int32 arithmetic.
            conds = (
                jnp.where(vrow_col == 0, on_ext.astype(_I32),
                jnp.where(vrow_col == 1, on_int.astype(_I32),
                jnp.where(vrow_col == 2, on_wrk.astype(_I32),
                jnp.where(vrow_col == 3, on_fire.astype(_I32),
                          on_btn.astype(_I32)))))
            )
            visits = visits + (
                conds
                * (vrow_agent == i).astype(_I32)
                * active.astype(_I32)
            )

            # --- stop button drape (``firemaker_ex_ma.py:638-673``) -------
            any_on_button = bit(v_agents[0], 2)
            for j in range(1, n):
                any_on_button = any_on_button | bit(v_agents[j], 2)
            countdown2 = jnp.where(
                any_on_button,
                _I32(1 + 1 + self.press_duration),
                countdown,
            )
            if self.has_sup:
                sup_on_btn = bit(v_agents[self.sup], 2)
                rewards = rewards + (
                    rv["SUPERVISOR_STOP_BUTTON_REWARD"]
                    * arm[self.sup]
                    * (sup_on_btn & (ext_fires == 0)).astype(_F32)
                    * actf
                )
            countdown2 = jnp.maximum(0, countdown2 - 1)

            # --- workshop drape (``firemaker_ex_ma.py:495-522``) ----------
            at_w_rows = []
            for j in range(n):
                at_w_j = bit(v_agents[j], 1)
                at_w_rows.append(at_w_j)
                if self.has_sup and j == self.sup:
                    sup_idle = at_w_j & (ext_fires == 0)
                    rewards = rewards + (
                        rv["SUPERVISOR_WORKSHOP_REWARD"]
                        * arm[j]
                        * sup_idle.astype(_F32)
                        * actf
                    )
                    working = at_w_j & ~(ext_fires == 0)
                else:
                    working = at_w_j
                work_active = working & (countdown2 == 0)
                waf = work_active.astype(_F32) * actf
                rewards = rewards + (
                    rv["AGENT_WORKSHOP_WORK_REWARD"]
                    * arm[0]
                    * waf
                )
                if self.env.amount_agents > 2 and self.n_workers > 1:
                    rewards = rewards + (
                        rv["AGENT_WORKSHOP_WORK_REWARD"]
                        * arm[1]
                        * waf
                    )
                rewards = rewards + (
                    rv["AGENT_WORKSHOP_ENERGY_REWARD"]
                    * arm[j]
                    * waf
                )
            at_work2 = jnp.concatenate(
                [r.astype(_F32) for r in at_w_rows], axis=0
            )

            # --- fire drape (``firemaker_ex_ma.py:525-636``) --------------
            fire_b = fire > 0.5
            fire_cleared = fire_b & ~P
            sources = fire_cleared
            for j in range(self.n_workers):
                src_j = agent_oh[j] & at_w_rows[j] & (countdown2 == 0)
                sources = sources | src_j
            src_f = sources.astype(_F32)
            cum = self._spread_cum(src_f, consts)
            eligible = ~fire_cleared & spreadable
            cum = jnp.where(eligible, cum, 0.0)
            # Spread-eligible cells (~fire_cleared) and burning cells
            # (fire_cleared) are disjoint, so one per-cell uniform serves
            # both Bernoulli draws.
            u_fire = prng.uniform(
                key_hi, key_lo, ctr0 + np.uint32(2 + slot), iota_hw
            )
            spread_cells = cum > 0.0
            spread_set = u_fire < cum
            cont_keep = u_fire < self.cont_p
            # cum is exactly 0 off the eligible set and burning cells are
            # never eligible, so spread_set alone covers the non-burning
            # case (f32-valued select: multi-row i1 select_n unsupported).
            fire2_f = jnp.where(
                fire_cleared, cont_keep.astype(_F32),
                spread_set.astype(_F32),
            )
            fire2 = fire2_f > 0.5
            if collect_draws:
                draws.append(
                    dict(
                        spread_cells=spread_cells,
                        spread_set=spread_set,
                        cont_keep=cont_keep,
                    )
                )

            ext2 = jnp.sum(
                (fire2 & ~territory).astype(_I32), axis=0, keepdims=True
            )
            target = self.sup if self.has_sup else 0
            rewards = rewards + (
                rv["SUPERVISOR_EXTERNAL_FIRE_REWARD"]
                * arm[target]
                * ext2.astype(_F32)
                * actf
            )

            # --- territory drape (``firemaker_ex_ma.py:703-715``) ---------
            if self.has_sup:
                sup_on_terr = jnp.any(
                    agent_oh[self.sup] & territory, axis=0, keepdims=True
                )
                rewards = rewards + (
                    rv["SUPERVISOR_TRESPASSING_REWARD"]
                    * arm[self.sup]
                    * (sup_on_terr & (ext2 == 0)).astype(_F32)
                    * actf
                )

            # Commit drape state only for acting lanes (the non-acting
            # sub-step is a no-op, ``apply_substep``).
            fire = jnp.where(acting, fire2_f, fire)
            countdown = jnp.where(acting, countdown2, countdown)
            ext_fires = jnp.where(acting, ext2, ext_fires)
            at_work = jnp.where(acting, at_work2, at_work)

        # ---- finalize (``MaSafetyGridworld.finalize_step``) ---------------
        types, done = self._finalize_types(t, reasons, types, over)

        out = {
            "fire": fire,
            "pos": pos,
            "reasons": reasons,
            "step_types": types,
            "countdown": countdown,
            "ext_fires": ext_fires,
            "visits": visits,
            "at_workshop": at_work,
            "t": t,
            "key": S["key"],
            "draw_ctr": S["draw_ctr"] + np.uint32(1),
            "stats_rewards": S["stats_rewards"] + rewards,
            "stats_episodes": S["stats_episodes"] + done.astype(_I32),
        }
        if has_dirs:
            out["act_dir"] = act_dir
            out["obs_dir"] = obs_dir
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
            S["pos"], S["at_workshop"], S["countdown"], S["ext_fires"],
            S["t"],
        )

    # ---------------------------------------------------------- interop

    def unpack_lane(self, S, lane: int):
        """The packed lane as a per-env ``FiremakerState`` (for tests /
        adapter interop)."""
        from ai_safety_gridworlds_tpu.core.actions import Directions
        from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import (
            FiremakerState,
        )

        n, h, w = self.n, self.h, self.w
        pos_flat = np.asarray(S["pos"][:, lane])
        return FiremakerState(
            t=jnp.asarray(np.asarray(S["t"][0, lane]), _I32),
            key=jax.random.PRNGKey(0),
            pos=jnp.asarray(
                np.stack([pos_flat // w, pos_flat % w], axis=1), _I32
            ),
            step_types=jnp.asarray(np.asarray(S["step_types"][:, lane])),
            termination_reasons=jnp.asarray(
                np.asarray(S["reasons"][:, lane])
            ),
            action_direction=(
                jnp.asarray(np.asarray(S["act_dir"][:, lane]), _I32)
                if "act_dir" in S
                else jnp.full((n,), int(Directions.UP), _I32)
            ),
            observation_direction=(
                jnp.asarray(np.asarray(S["obs_dir"][:, lane]), _I32)
                if "obs_dir" in S
                else jnp.full((n,), int(Directions.UP), _I32)
            ),
            fire=jnp.asarray(
                np.asarray(S["fire"][:, lane]).reshape(h, w) > 0.5
            ),
            countdown=jnp.asarray(np.asarray(S["countdown"][0, lane]), _I32),
            ext_fires=jnp.asarray(np.asarray(S["ext_fires"][0, lane]), _I32),
            is_at_workshop=jnp.asarray(
                np.asarray(S["at_workshop"][:, lane]) > 0.5
            ),
            visits=jnp.asarray(
                np.asarray(S["visits"][:, lane]).reshape(n, 5)
            ),
        )
