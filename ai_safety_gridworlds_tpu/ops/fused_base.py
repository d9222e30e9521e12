"""Shared scaffolding for the fused multi-agent step kernels.

The fused kernels (:mod:`.fused_firemaker`, :mod:`.fused_savanna`,
:mod:`.fused_island_ma`, :mod:`.fused_scalar`) share everything except
their step bodies: the packed [rows, B] layout, the action-draw +
Fisher-Yates agent-order prologue, the finalize epilogue
(``MaSafetyGridworld.finalize_step`` semantics), and the rollout drivers,
which run the step body as one jitted ``lax.scan``. This module holds
that machinery once so a fix in one place reaches all kernels.

Subclasses implement ``_step(S, statics, consts, collect_draws)`` plus
``init_packed`` (which must set ``self._kstatics_np``, the dict of static
board inputs — possibly empty — and call ``_invalidate_device_cache``),
and declare ``STATE_FIELDS``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ai_safety_gridworlds_tpu.core.timestep import StepType
from ai_safety_gridworlds_tpu.ops import prng

_I32 = jnp.int32
_F32 = jnp.float32

FIRST = int(StepType.FIRST)
MID = int(StepType.MID)
LAST = int(StepType.LAST)
DEAD = int(StepType.DEAD)


def min_water_dist(water_b: np.ndarray, h: int, w: int) -> np.ndarray:
    """Per-lane min-Manhattan distance to water, clamped to 99.

    ``water_b`` is bool [HW, B]; returns int32 [HW, B] (99 for lanes
    without water). Matches the device kernels' historical
    ``where(d > 98, 99, d)`` clamp and the per-env ``_water_dist``
    tables. Vectorized over 256-lane chunks (memory stays
    O(HW^2 * 256) regardless of batch), shared by the island and
    savanna packers.
    """
    HW, B = water_b.shape
    cells = np.arange(HW, dtype=np.int32)
    rr, cc = cells // w, cells % w
    d2 = (
        np.abs(rr[:, None] - rr[None, :])
        + np.abs(cc[:, None] - cc[None, :])
    ).astype(np.int16)  # [HW, HW]
    dist = np.empty((HW, B), np.int32)
    for s in range(0, B, 256):
        wchunk = water_b[:, s : s + 256]  # [HW, bc]
        dd = np.where(
            wchunk[None, :, :], d2[:, :, None].astype(np.int32), 9999
        )
        m = dd.min(axis=1)
        dist[:, s : s + 256] = np.where(m > 98, 99, m)
    return dist


class FusedMaBase:
    """Packed batched MA env with a fused step/rollout."""

    STATE_FIELDS: tuple = ()

    # Subclasses fill these in __init__/init_packed.
    consts: dict
    _kstatics_np: dict

    # ------------------------------------------------------------ prologue

    def _draw_actions_and_order(self, S, over, reasons, ctr0, iota_n,
                                feats=None, statics=None):
        """Uniform per-agent action draws (site 0) + Fisher-Yates agent
        order (site 1). Reset lanes and dead agents draw -1 (excluded from
        the reference actions dict, ``pycolab_interface_ma.py:183``).
        With ``feats``/``statics`` given and policies installed
        (``set_policies`` or MLP params under ``mlp_*`` keys), actions come
        from the per-lane policy instead of the uniform draw.

        Returns ``(actions, order, pol)`` where ``pol`` is ``None`` unless
        an MLP policy ran, in which case it carries the per-step policy
        emissions consumed by :meth:`rollout_collect` (``feats`` [n*F, B],
        ``logp``/``value`` [n, B])."""
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        n = iota_n.shape[0]
        u_act = prng.uniform(key_hi, key_lo, ctr0, iota_n)
        from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

        none_r = int(TerminationReason.NONE)
        actions = self.amin + jnp.floor(
            u_act * (self.amax - self.amin + 1)
        ).astype(_I32)
        actions = jnp.clip(actions, self.amin, self.amax)
        actions = jnp.where(over | (reasons != none_r), -1, actions)
        pol = None
        if feats is not None and statics is not None:
            if "mlp_w1" in statics:
                actions, pol = self._mlp_policy_actions(
                    actions, u_act, feats, statics
                )
            else:
                actions = self._policy_actions(actions, u_act, feats, statics)

        order = jnp.tile(iota_n, (1, actions.shape[1]))
        # getattr: single-agent scalar envs (ops/fused_scalar.py) have no
        # agent-order flag at all.
        randomize = getattr(self.env, "randomize_agent_actions_order", False)
        if randomize and n > 1:
            u_perm = prng.uniform(key_hi, key_lo, ctr0 + np.uint32(1), iota_n)
            for k in range(n - 1, 0, -1):
                jidx = jnp.clip(
                    jnp.floor(u_perm[k : k + 1] * (k + 1)).astype(_I32), 0, k
                )
                vk = order[k : k + 1]
                vj = jnp.sum(
                    jnp.where(iota_n == jidx, order, 0), axis=0, keepdims=True
                )
                order = jnp.where(iota_n == jidx, vk, order)
                order = jnp.where(iota_n == k, vj, order)
        return actions, order, pol

    def _policy_actions(self, uniform_actions, u_act, feats, statics):
        """Per-lane linear-policy action selection.

        When ``statics`` carries policy parameters (``pol_w`` [A*F, B],
        ``pol_b`` [A, B], ``pol_eps`` [1, B]; installed by
        ``set_policies``), each agent's action becomes the argmax of
        ``W @ feat + b`` over the A legal actions, except with
        probability eps the uniform draw is kept (exploration reuses the
        action-site uniform, so the draw-site layout is unchanged).
        ``feats`` is a list of [1, B] feature rows per agent (list of
        lists, indexed [agent][feature]). Returns [n, B] actions.
        """
        if "pol_w" not in statics:
            return uniform_actions
        A = self.amax - self.amin + 1
        W, bias = statics["pol_w"], statics["pol_b"]
        eps = statics["pol_eps"]
        n = len(feats)
        F = len(feats[0])
        rows = []
        for j in range(n):
            best_a = jnp.zeros_like(u_act[j : j + 1])
            best_v = None
            for a in range(A):
                logit = bias[a : a + 1]
                for f in range(F):
                    logit = logit + W[a * F + f : a * F + f + 1] * feats[j][f]
                if best_v is None:
                    best_v = logit
                else:
                    take = logit > best_v
                    best_v = jnp.where(take, logit, best_v)
                    best_a = jnp.where(take, float(a), best_a)
            rows.append(self.amin + best_a.astype(_I32))
        greedy = jnp.concatenate(rows, axis=0)
        explore = u_act * (self.amax - self.amin + 1) % 1.0 < eps
        out = jnp.where(explore, uniform_actions, greedy)
        # Preserve the -1 sentinel for reset lanes / dead agents.
        return jnp.where(uniform_actions < 0, uniform_actions, out)

    # ------------------------------------------------------- MLP policy

    def _mlp_forward_agent(self, X, statics):
        """Shared two-layer MLP head on one agent's packed features.

        ``X`` is [F, B] (batch on lanes); params live in
        ``statics`` under ``mlp_*`` keys (``mlp_w1`` [H, F], ``mlp_b1``
        [H, 1], ``mlp_w2`` [A+1, H], ``mlp_b2`` [A+1, 1] — the extra
        output row is the value head). Returns ``(z, log_se, value)``
        where ``z`` are max-shifted logits [A, B] and ``log_se`` the
        softmax log-normalizer [1, B]."""
        A = self.amax - self.amin + 1
        h = jnp.maximum(
            jnp.dot(statics["mlp_w1"], X, preferred_element_type=_F32)
            + statics["mlp_b1"],
            0.0,
        )
        out = (
            jnp.dot(statics["mlp_w2"], h, preferred_element_type=_F32)
            + statics["mlp_b2"]
        )
        logits = out[:A]
        value = out[A : A + 1]
        z = logits - jnp.max(logits, axis=0, keepdims=True)
        log_se = jnp.log(jnp.sum(jnp.exp(z), axis=0, keepdims=True))
        return z, log_se, value

    def _mlp_policy_actions(self, uniform_actions, u_act, feats, statics):
        """Sample per-agent actions from the in-step MLP policy.

        Each agent's action is a categorical draw from
        ``softmax(MLP(features))`` using the site-0 uniform (the same
        draw the uniform path consumes, so the draw-site layout is
        unchanged). Returns ``(actions [n, B], pol)`` with ``pol``
        carrying the trajectory emissions: the feature matrix, the
        sampled action's log-probability, and the value estimate —
        everything PPO needs besides rewards/dones (which
        :meth:`_collect_step` adds)."""
        A = self.amax - self.amin + 1
        n = len(feats)
        act_rows, logp_rows, val_rows, feat_rows = [], [], [], []
        for j in range(n):
            X = jnp.concatenate(feats[j], axis=0)  # [F, B]
            feat_rows.append(X)
            z, log_se, value = self._mlp_forward_agent(X, statics)
            p = jnp.exp(z - log_se)
            u = u_act[j : j + 1]
            # Inverse-CDF draw: idx = #{a : cdf_a <= u}. The loop runs to
            # A-2 so idx <= A-1 even when float cdf sums below 1.
            run = jnp.zeros_like(u)
            idx = jnp.zeros_like(u)
            for a in range(A - 1):
                run = run + p[a : a + 1]
                idx = idx + (run <= u).astype(_F32)
            aidx = idx.astype(_I32)
            z_sel = jnp.zeros_like(u)
            for a in range(A):
                z_sel = jnp.where(aidx == a, z[a : a + 1], z_sel)
            logp_rows.append(z_sel - log_se)
            val_rows.append(value)
            act_rows.append(self.amin + aidx)
        greedy = jnp.concatenate(act_rows, axis=0)
        actions = jnp.where(uniform_actions < 0, uniform_actions, greedy)
        pol = {
            "feats": jnp.concatenate(feat_rows, axis=0),   # [n*F, B]
            "logp": jnp.concatenate(logp_rows, axis=0),    # [n, B]
            "value": jnp.concatenate(val_rows, axis=0),    # [n, B]
        }
        return actions, pol

    # ------------------------------------------------------------ epilogue

    def _finalize_types(self, t, reasons, types, over):
        """Per-agent step-type transitions + episode-done flag
        (``MaSafetyGridworld.finalize_step``)."""
        from ai_safety_gridworlds_tpu.core.timestep import TerminationReason

        none_r = int(TerminationReason.NONE)
        truncated = t >= self.max_iterations
        game_over_pa = truncated | (reasons != none_r)
        new_types = jnp.where(
            game_over_pa,
            jnp.where((types == MID) | (types == FIRST), LAST, DEAD),
            MID,
        )
        # int32, not weak: a weak-typed carry would make the next
        # rollout call's input avals differ and compile a second time.
        out_types = jnp.where(over, FIRST, new_types).astype(_I32)
        done = jnp.all(game_over_pa, axis=0, keepdims=True) & ~over
        return out_types, done

    # Number of per-agent policy features; kernels that support in-step
    # policies override this and implement a feature extractor in _step.
    POLICY_FEATURES: int = 0

    def _pos_dir_feats(self, pos, dir_rows, j):
        """Common policy-feature scaffold for agent ``j``: normalized
        (row, col) from the flat position plus a 4-way direction one-hot
        (empty when ``dir_rows`` is None — kernels without direction
        state). Returns ``(pos_feats, onehot_feats)`` lists of [1, B]
        rows."""
        W, H = self.w, self.h
        pj = pos[j : j + 1].astype(jnp.float32)
        # +0.5 before the reciprocal multiply: f32(1/W) is inexact for
        # some widths (41, 47, ...) and floor(W * f32(1/W)) can land at
        # W-1; the half-cell offset keeps the quotient strictly inside
        # the right unit interval for any board that fits in f32 ints.
        row = jnp.floor((pj + 0.5) * jnp.float32(1.0 / W))
        col = pj - row * W
        pos_feats = [
            row * jnp.float32(1.0 / max(H - 1, 1)),
            col * jnp.float32(1.0 / max(W - 1, 1)),
        ]
        if dir_rows is None:
            return pos_feats, []
        dj = dir_rows[j : j + 1]
        onehot = [(dj == d).astype(jnp.float32) for d in range(4)]
        return pos_feats, onehot

    def set_policies(self, W, b, eps=0.0):
        """Install per-lane linear policies for in-step action selection.

        ``W``: [B, A, F] (one policy per batch lane) or [A, F] (shared);
        ``b``: [B, A] or [A]; ``eps``: exploration probability (scalar or
        [B]) — with probability eps the uniform action draw is kept.
        A = number of legal actions (amin..amax), F = POLICY_FEATURES.
        Policies persist across ``init_packed`` calls; pass ``W=None``
        to remove them.

        This turns the fused rollout into a policy-evaluation engine:
        ``stats_rewards`` accumulates each lane's returns under its own
        policy, so one rollout scores thousands of candidates — the
        building block for evolution-strategy / population-based search
        at fused-kernel throughput (see
        ``examples/policy_search_example.py``).
        """
        if self.POLICY_FEATURES == 0:
            raise NotImplementedError(
                "this kernel has no policy feature extractor"
            )
        if W is None:
            self._policy_np = {}
        else:
            A = self.amax - self.amin + 1
            F = self.POLICY_FEATURES
            W = np.asarray(W, np.float32)
            if W.ndim == 2:
                W = W[None]
            if W.shape[1:] != (A, F):
                raise ValueError(
                    f"policy W must be [B, {A}, {F}] or [{A}, {F}], "
                    f"got {W.shape}"
                )
            b = np.asarray(b, np.float32)
            if b.ndim == 1:
                b = b[None]
            if b.shape[1] != A:
                raise ValueError(
                    f"policy b must be [B, {A}] or [{A}], got {b.shape}"
                )
            eps_arr = np.asarray(eps, np.float32).reshape(-1)
            lane_dims = {
                d for d in (W.shape[0], b.shape[0], eps_arr.shape[0])
                if d != 1
            }
            if len(lane_dims) > 1:
                raise ValueError(
                    "policy W/b/eps lane dimensions disagree: "
                    f"{W.shape[0]}, {b.shape[0]}, {eps_arr.shape[0]}"
                )
            B = max(W.shape[0], b.shape[0], eps_arr.shape[0])
            Wf = W.reshape(W.shape[0], A * F)
            self._policy_np = {
                "pol_w": np.ascontiguousarray(
                    np.broadcast_to(Wf, (B, A * F)).T
                ),
                "pol_b": np.ascontiguousarray(
                    np.broadcast_to(b, (B, b.shape[1])).T
                ),
                "pol_eps": np.ascontiguousarray(
                    np.broadcast_to(eps_arr, (B,)).reshape(1, B)
                ),
            }
        # Statics are traced arguments of the jitted rollout, so a
        # value-only update retraces nothing; installing or removing
        # policies changes the key set and retraces once.
        self._invalidate_device_cache()

    # -------------------------------------------------------- layout pools

    def _pool_select(self, statics, over, S):
        """Per-episode layout selection for kernels with a host-drawn
        layout pool (``init_packed(layout_pool=K)``).

        Returns ``(pooled, ep_idx)``: ``pooled(base_key)`` resolves a
        static board through a K-way select on ``ep_idx % K`` (reads the
        statics directly when K == 1, no overhead), and ``ep_idx`` is the
        updated per-lane episode counter (``None`` when K == 1) —
        kernels put it in their output dict."""
        K = getattr(self, "layout_pool", 1)
        if K <= 1:
            return (lambda base_key: statics[base_key]), None
        ep_idx = jnp.where(over, S["ep_idx"] + 1, S["ep_idx"])
        li = jnp.mod(ep_idx, K)

        def pooled(base_key):
            v = statics[base_key]
            for k in range(1, K):
                v = jnp.where(li == k, statics[f"{base_key}_p{k}"], v)
            return v

        return pooled, ep_idx

    # ------------------------------------------------------------ backends

    @staticmethod
    def _to_device(np_dict):
        """numpy dict -> device dict, memo-safe: inside a trace
        ``jnp.asarray`` yields tracers, which must never be cached."""
        out = {k: jnp.asarray(v) for k, v in np_dict.items()}
        cacheable = not any(
            isinstance(v, jax.core.Tracer) for v in out.values()
        )
        return out, cacheable

    def _consts_jnp(self):
        cache = getattr(self, "_consts_dev", None)
        if cache is None:
            cache, ok = self._to_device(self.consts)
            if ok:
                self._consts_dev = cache
        return cache

    def _all_statics_np(self):
        """Kernel statics plus any installed policy parameters
        (``set_policies`` survives re-packing)."""
        pol = getattr(self, "_policy_np", None)
        if pol:
            return {**self._kstatics_np, **pol}
        return self._kstatics_np

    def _statics_jnp(self):
        cache = getattr(self, "_statics_dev", None)
        if cache is None:
            cache, ok = self._to_device(self._all_statics_np())
            if ok:
                self._statics_dev = cache
        return cache

    def _invalidate_device_cache(self):
        self._statics_dev = None

    @functools.partial(jax.jit, static_argnames=("self", "n_steps"))
    def _rollout_xla(self, S, statics, n_steps):
        consts = self._consts_jnp()

        def body(S, _):
            return self._step(S, statics, consts), None

        S, _ = jax.lax.scan(body, S, None, length=n_steps)
        return S

    def rollout(self, S, n_steps, statics=None):
        """Advance the packed batch ``n_steps`` full MA steps.

        Returns the updated packed state; cumulative reward sums and
        episode counts accumulate in ``stats_rewards``/``stats_episodes``.
        The steps run as one jitted ``lax.scan`` over the step body.

        ``statics`` overrides the kernel statics (same key set as
        ``_all_statics_np``); pass the lane-local shard when calling
        inside ``shard_map`` — per-lane statics (randomized layouts,
        policy params) must be sharded with the state, not closed over.
        """
        B = S["t"].shape[1]
        pol = getattr(self, "_policy_np", None)
        # Only sanity-check the per-lane policy batch when WE supply the
        # statics: inside shard_map, callers pass lane-local statics
        # whose B is the shard width, not the host-global policy batch.
        if pol and statics is None:
            pb = pol["pol_w"].shape[1]
            if pb not in (1, B):
                raise ValueError(
                    f"policy batch {pb} != packed batch {B} "
                    "(set_policies with per-lane params must match "
                    "init_packed's batch)"
                )
        if statics is None:
            statics = self._statics_jnp()
        return self._rollout_xla(S, statics, n_steps)

    # ------------------------------------------------- trajectory collection

    # Per-step trajectory fields written by the collect drivers, with the
    # row count of each packed [rows, B] record ("F" = POLICY_FEATURES,
    # "n" = n_agents) and dtype.
    def _traj_layout(self):
        n, F = self.n, self.POLICY_FEATURES
        return (
            ("feats", n * F, _F32),
            ("action", n, _I32),
            ("logp", n, _F32),
            ("value", n, _F32),
            ("reward", n, _F32),
            ("done", n, _I32),
        )

    def feats_of(self, S):
        """Per-agent policy-feature rows for a raw packed state (list of
        lists of [1, B] rows, same layout as the in-step extraction).
        Kernels with POLICY_FEATURES > 0 must implement this."""
        raise NotImplementedError

    def _bootstrap_value(self, S, statics):
        """Value head on the post-rollout state, [n, B]. Lanes whose
        episode just ended are masked by ``cont`` in the learner, so no
        auto-reset is applied here."""
        feats = self.feats_of(S)
        rows = []
        for j in range(self.n):
            X = jnp.concatenate(feats[j], axis=0)
            _, _, value = self._mlp_forward_agent(X, statics)
            rows.append(value)
        return jnp.concatenate(rows, axis=0)

    def _collect_step(self, S, statics, consts):
        """One policy step emitting the packed per-step trajectory record:
        policy features (post auto-reset — the MLP's actual input), the
        sampled action (-1 for reset lanes / dead agents), its logp, the
        value estimate, the per-agent scalarized reward (summed over the
        MO dimensions, the reference's ``scalarise`` semantics), and the
        per-agent episode-done flag."""
        out, ex = self._step(S, statics, consts, collect_draws=True)
        pol = ex["pol"]
        n, D = self.n, self.D
        r = ex["rewards"]  # [n*D, B]
        reward = jnp.concatenate(
            [
                jnp.sum(r[j * D : (j + 1) * D], axis=0, keepdims=True)
                for j in range(n)
            ],
            axis=0,
        )
        types2 = out["step_types"]
        done = ((types2 == LAST) | (types2 == DEAD)).astype(_I32)
        traj = {
            "feats": pol["feats"],
            "action": ex["actions"],
            "logp": pol["logp"],
            "value": pol["value"],
            "reward": reward,
            "done": done,
        }
        return out, traj

    @functools.partial(jax.jit, static_argnames=("self", "n_steps"))
    def _rollout_collect_xla(self, S, statics, n_steps):
        consts = self._consts_jnp()

        def body(S, _):
            return self._collect_step(S, statics, consts)

        S, traj = jax.lax.scan(body, S, None, length=n_steps)
        boot = self._bootstrap_value(S, statics)
        return S, traj, boot

    def rollout_collect(self, S, params, n_steps, statics=None):
        """Advance ``n_steps`` under the MLP policy ``params``, emitting
        the full per-step trajectory (the PPO collection path).

        ``params``: dict with ``mlp_w1`` [H, F], ``mlp_b1`` [H, 1],
        ``mlp_w2`` [A+1, H], ``mlp_b2`` [A+1, 1] (A action logits + one
        value row; F = ``POLICY_FEATURES``). Returns ``(S, traj, boot)``
        where ``traj`` maps each :meth:`_traj_layout` field to a
        ``[n_steps, rows, B]`` array and ``boot`` is the bootstrap value
        [n_agents, B] of the post-rollout state. Jit-traceable: call it
        inside a jitted train step with traced ``params``."""
        if self.POLICY_FEATURES == 0:
            raise NotImplementedError(
                "this kernel has no policy feature extractor"
            )
        for k in ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2"):
            if k not in params:
                raise ValueError(f"missing MLP param {k!r}")
        statics = {
            **(self._statics_jnp() if statics is None else statics),
            **params,
        }
        return self._rollout_collect_xla(S, statics, n_steps)

    # ------------------------------------------------------------ interop

    def step_xla(self, S, collect_draws=False, params=None):
        """One un-jitted packed step (for tests). ``params`` optionally
        installs the MLP policy for this step (collection parity tests)."""
        statics = self._statics_jnp()
        if params is not None:
            statics = {**statics, **params}
        return self._step(statics=statics, consts=self._consts_jnp(),
                          S=S, collect_draws=collect_draws)
