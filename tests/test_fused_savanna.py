"""Fused savanna kernel: equivalence, bit-identity, and auto-reset.

Mirrors ``tests/test_fused_firemaker.py``:

1. **Semantic equivalence** — one fused packed step, with its internal
   draws (agent order, actions, post-walk predator curtains) captured and
   injected into the per-env ``apply_substep`` chain (the path that is
   lockstep-tested against the reference). States and rewards must match
   exactly for every batch lane — on the default config AND a rich
   multi-agent config (predators, drink, gold, silver, water,
   homeostasis, thirst death).
2. **Driver bit-identity** — the jitted ``lax.scan`` rollout vs a Python
   loop over the jitted packed step.
3. **Auto-reset bookkeeping** — truncation, FIRST restart, episode counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_safety_gridworlds_tpu.core.timestep import StepType
from ai_safety_gridworlds_tpu.envs.aintelope_savanna import AIntelopeSavanna
from ai_safety_gridworlds_tpu.ops import reference_chain
from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna

RICH_KW = dict(
    level=13,
    amount_agents=2,
    amount_predators=2,
    amount_drink_holes=2,
    amount_gold_deposits=2,
    amount_silver_deposits=2,
    amount_water_tiles=2,
    penalise_oversatiation=True,
    thirst_hunger_death=True,
)


def _inject_opts(fused, dbg, slot, b, h, w):
    """Injection options for one per-env sub-step from the kernel's
    captured draws: post-walk predator curtain and (under sustainability)
    the post-drape resource curtains."""
    return reference_chain.savanna_opts(h, w)(dbg, slot, b, None)


def _run_equivalence(env, seed, steps, B=8, layout_pool=1, stream=False):
    """``stream=True`` passes NO post-hoc curtains: the per-env chain
    receives only the lane's PRF context (key + site counter) and must
    recompute the kernel's predator/drape draws itself — draw-for-draw
    stream equivalence rather than injected-curtain equivalence."""
    fused = FusedSavanna(env)
    S = fused.init_packed(seed=seed, batch=B, layout_pool=layout_pool)
    return reference_chain.savanna_chain(fused, S, steps, stream=stream)


def test_fused_step_matches_per_env_default_config():
    _run_equivalence(AIntelopeSavanna(), seed=3, steps=10)


def test_fused_step_matches_per_env_rich_config():
    _run_equivalence(AIntelopeSavanna(**RICH_KW), seed=5, steps=10)


def test_fused_rewards_match_per_env_substep_deltas():
    """Per-step reward rows agree with the per-env sub-step deltas."""
    env = AIntelopeSavanna(**RICH_KW)
    fused = FusedSavanna(env)
    B = 4
    S = fused.init_packed(seed=11, batch=B)
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    n, h, w, D = fused.n, fused.h, fused.w, fused.D
    for step in range(6):
        per_env = [fused.unpack_lane(S, b) for b in range(B)]
        prev_stats = np.asarray(S["stats_rewards"])
        S2, dbg = fused.step_xla(S, collect_draws=True)
        fused_step_rewards = np.asarray(S2["stats_rewards"]) - prev_stats
        order = np.asarray(dbg["order"])
        actions = np.asarray(dbg["actions"])
        over = np.asarray(dbg["over"])[0]
        for b in range(B):
            if over[b]:
                continue
            state_b = per_env[b]
            total = np.zeros((n, D), np.float32)
            for slot in range(n):
                i = int(order[slot, b])
                a = int(actions[i, b])
                opts = {}
                if dbg["slots"][slot]:
                    opts["inj_predator_curtain"] = jnp.asarray(
                        np.asarray(
                            dbg["slots"][slot]["predator_after"]
                        )[:, b].reshape(h, w)
                    )
                state_b, delta = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), opts or None, slot
                )
                total += np.asarray(delta)
            np.testing.assert_allclose(
                fused_step_rewards[:, b].reshape(n, D), total,
                rtol=0, atol=1e-5, err_msg=f"step {step} lane {b}",
            )
        S = S2


def test_xla_pallas_bit_identity():
    env = AIntelopeSavanna(**RICH_KW)
    fused = FusedSavanna(env)
    S0 = fused.init_packed(seed=7, batch=64)
    n_steps = 30
    Sx = fused.rollout(dict(S0), n_steps)
    Sl = reference_chain.step_loop(fused, dict(S0), n_steps)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.asarray(Sx["t"]).max() > 0
    assert np.abs(np.asarray(Sx["stats_rewards"])).sum() > 0


def test_auto_reset_counts_episodes():
    env = AIntelopeSavanna(max_iterations=8)
    fused = FusedSavanna(env)
    B = 32
    S = fused.init_packed(seed=5, batch=B)
    S = fused.rollout(S, 40)
    eps = np.asarray(S["stats_episodes"])
    # 8 sub-step frames / 1 agent = episodes of 8 steps + 1 reset step.
    assert (eps >= 3).all() and (eps <= 5).all(), eps
    types = np.asarray(S["step_types"])
    assert set(np.unique(types)) <= {
        int(StepType.FIRST), int(StepType.MID), int(StepType.LAST),
    }


def test_per_lane_maps_differ():
    env = AIntelopeSavanna(**RICH_KW)
    fused = FusedSavanna(env)
    fused.init_packed(seed=1, batch=16)
    food = fused._statics_np["food"]
    # Map randomization: not all lanes share a layout.
    assert np.unique(food.T, axis=0).shape[0] > 1


SUSTAIN_KW = dict(RICH_KW, sustainability_challenge=True)


def test_fused_step_matches_per_env_sustainability():
    """Dynamic resource curtains + availabilities: the in-kernel drape
    phase (regrowth, removal/spawn) stays lockstep with the per-env chain
    when the kernel's curtain draws are injected."""
    _run_equivalence(AIntelopeSavanna(**SUSTAIN_KW), seed=9, steps=12)


def test_fused_step_matches_per_env_sustainability_stream():
    """STREAM equivalence (no curtain injection): the per-env chain
    recomputes the kernel's removal/spawn draws from the shared PRF
    context and must reproduce every curtain exactly — the sustain
    draw-stream deviation (PARITY.md) retired. An unclamped per-env
    selection also cross-checks the kernel's static k-bound: if the
    clamp ever bound, this test would fail."""
    _run_equivalence(
        AIntelopeSavanna(**SUSTAIN_KW), seed=9, steps=12, stream=True
    )


def test_fused_step_matches_per_env_predators_stream():
    """STREAM equivalence for the predator random walk: move uniforms and
    directions recomputed from the shared PRF word, no curtain injected."""
    _run_equivalence(AIntelopeSavanna(**RICH_KW), seed=5, steps=10,
                     stream=True)


def test_fused_rewards_match_per_env_sustainability():
    env = AIntelopeSavanna(**SUSTAIN_KW)
    fused = FusedSavanna(env)
    B = 4
    S = fused.init_packed(seed=13, batch=B)
    apply_fn = jax.jit(env.apply_substep, static_argnames=("slot",))
    n, h, w, D = fused.n, fused.h, fused.w, fused.D
    for step in range(6):
        per_env = [fused.unpack_lane(S, b) for b in range(B)]
        prev_stats = np.asarray(S["stats_rewards"])
        S2, dbg = fused.step_xla(S, collect_draws=True)
        fused_step_rewards = np.asarray(S2["stats_rewards"]) - prev_stats
        order = np.asarray(dbg["order"])
        actions = np.asarray(dbg["actions"])
        over = np.asarray(dbg["over"])[0]
        for b in range(B):
            if over[b]:
                continue
            state_b = per_env[b]
            total = np.zeros((n, D), np.float32)
            for slot in range(n):
                i = int(order[slot, b])
                a = int(actions[i, b])
                opts = _inject_opts(fused, dbg, slot, b, h, w)
                state_b, delta = apply_fn(
                    state_b, jnp.int32(i), jnp.int32(a), opts or None, slot
                )
                total += np.asarray(delta)
            np.testing.assert_allclose(
                fused_step_rewards[:, b].reshape(n, D), total,
                rtol=0, atol=1e-5, err_msg=f"step {step} lane {b}",
            )
        S = S2


def test_xla_pallas_bit_identity_sustainability():
    env = AIntelopeSavanna(**SUSTAIN_KW)
    fused = FusedSavanna(env)
    B = 64
    S0 = fused.init_packed(seed=17, batch=B)
    Sx = fused.rollout(dict(S0), 20)
    Sl = reference_chain.step_loop(fused, dict(S0), 20)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    # The curtains actually changed (the drape phase is live).
    assert not np.array_equal(
        np.asarray(Sx["res_food"]), np.asarray(S0["res_food"])
    )


def test_layout_pool_cycles_per_episode():
    """K pooled layouts: independent draws with identical tile counts,
    cycled by the in-kernel reset (``ep_idx % K``)."""
    env = AIntelopeSavanna(**dict(RICH_KW, max_iterations=4))
    fused = FusedSavanna(env)
    K, B = 3, 8
    S = fused.init_packed(seed=21, batch=B, layout_pool=K)
    pools = fused._statics_np_pool
    assert len(pools) == K
    # Independent draws: layouts differ across the pool...
    assert not np.array_equal(pools[0]["pos0"], pools[1]["pos0"])
    # ...but every layout preserves the count-enforced tile totals
    # (distribution equivalence of the per-episode re-draw).
    for key in ("food", "gold", "silver", "wall", "drink"):
        c0 = pools[0][key].sum(axis=0)
        for p in pools[1:]:
            np.testing.assert_array_equal(p[key].sum(axis=0), c0)
    seen = set()
    for _ in range(30):
        S = fused.step_xla(S)
        seen.update(np.asarray(S["ep_idx"])[0].tolist())
    assert max(seen) >= K, "lanes never cycled through the pool"


def test_fused_step_matches_per_env_layout_pool():
    """Post-reset episodes replay against the NEW pooled layout: the
    per-env chain (rebuilt per lane from the pooled statics) stays in
    lockstep across in-kernel episode boundaries."""
    _run_equivalence(
        AIntelopeSavanna(**dict(RICH_KW, max_iterations=5)),
        seed=23, steps=12, layout_pool=3,
    )


def test_xla_pallas_bit_identity_layout_pool():
    env = AIntelopeSavanna(**dict(RICH_KW, max_iterations=6))
    fused = FusedSavanna(env)
    S0 = fused.init_packed(seed=29, batch=64, layout_pool=2)
    Sx = fused.rollout(dict(S0), 20)
    Sl = reference_chain.step_loop(fused, dict(S0), 20)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.asarray(Sx["ep_idx"]).max() >= 2


def test_make_fused_accepts_sustainability():
    from ai_safety_gridworlds_tpu import ops as ops_pkg

    env = AIntelopeSavanna(sustainability_challenge=True)
    fused = ops_pkg.make_fused(env)
    assert isinstance(fused, FusedSavanna) and fused.sustain


def test_sustainability_with_layout_pool_bit_identity():
    """Sustainability + layout pool compose: pooled res0_*/usable_half
    statics select per episode and the dynamic drape phase stays
    bit-identical between the scan driver and the step loop."""
    env = AIntelopeSavanna(**dict(SUSTAIN_KW, max_iterations=6))
    fused = FusedSavanna(env)
    S0 = fused.init_packed(seed=37, batch=32, layout_pool=2)
    Sx = fused.rollout(dict(S0), 16)
    Sl = reference_chain.step_loop(fused, dict(S0), 16)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.asarray(Sx["ep_idx"]).max() >= 1


def test_fused_art_flag_topup_counts_and_equivalence():
    """Art-vs-flag mismatched non-sustain config (art has 3 'F', flag asks
    4): init_packed tops every lane's packed layout up to the flag counts
    (PARITY.md "art-vs-flag"), and the fused kernel stays lockstep with
    the per-env chain on the topped-up boards."""
    env = AIntelopeSavanna(amount_food_patches=4, amount_drink_holes=5)
    fused = FusedSavanna(env)
    fused.init_packed(seed=31, batch=8)
    food = np.asarray(fused._statics_np["food"])     # [HW, B]
    drink = np.asarray(fused._statics_np["drink"])
    np.testing.assert_array_equal(food.sum(axis=0), 4)
    np.testing.assert_array_equal(drink.sum(axis=0), 5)
    _run_equivalence(
        AIntelopeSavanna(amount_food_patches=4, amount_drink_holes=5),
        seed=33, steps=8,
    )


def test_fused_art_flag_topup_refuses_overfull_board():
    """An amount flag the board cannot host fails loudly, not silently."""
    env = AIntelopeSavanna(amount_food_patches=200)
    fused = FusedSavanna(env)
    with pytest.raises(ValueError, match="top up"):
        fused.init_packed(seed=1, batch=4)


# --------------------------------------------------------------------------
# Exact per-episode map re-randomization (in-kernel redraw).
# Retires the PARITY.md "auto-reset restores the initial layout" deviation:
# with map_randomization_frequency >= 3 (the reference default) the
# auto-reset draws a FRESH uniformly-shuffled interior per episode, like
# the reference's sample_reset_options shuffle
# (reference safety_game_mo_base.py:918-1134, aintelope_savanna.py:65).
# --------------------------------------------------------------------------


def test_exact_reset_mode_selection():
    """Defaults on at frequency >= 3 with no pool; off otherwise; loud on
    contradictory requests."""
    fused = FusedSavanna(AIntelopeSavanna())
    fused.init_packed(seed=1, batch=4)
    assert fused.exact_reset

    low_freq = FusedSavanna(AIntelopeSavanna(map_randomization_frequency=2))
    low_freq.init_packed(seed=1, batch=4)
    assert not low_freq.exact_reset

    pooled = FusedSavanna(AIntelopeSavanna())
    pooled.init_packed(seed=1, batch=4, layout_pool=2)
    assert not pooled.exact_reset

    with pytest.raises(ValueError, match="mutually exclusive"):
        FusedSavanna(AIntelopeSavanna()).init_packed(
            seed=1, batch=4, layout_pool=2, exact_reset=True
        )

    opt_out = FusedSavanna(AIntelopeSavanna())
    opt_out.init_packed(seed=1, batch=4, exact_reset=False)
    assert not opt_out.exact_reset


def _lane_tile_counts(fused, sboard, wall):
    """Per-lane tile counts decoded from the packed code/distance board."""
    code = np.asarray(sboard) % 16.0
    counts = {"wall": np.asarray(wall).sum(axis=0)}
    for name, cid in fused.tile_codes.items():
        if name in ("gap", "wall"):
            continue
        counts[name] = (code == float(cid)).sum(axis=0)
    return counts


def test_exact_reset_redraws_fresh_layout_each_episode():
    """Across in-kernel resets the layout CHANGES (not restored) while the
    count-enforced tile multiset is preserved per lane."""
    env = AIntelopeSavanna(**dict(RICH_KW, max_iterations=4))
    fused = FusedSavanna(env)
    B = 32
    S = fused.init_packed(seed=41, batch=B)
    assert fused.exact_reset
    sb0 = np.asarray(S["sboard"]).copy()
    wall0 = np.asarray(S["wall"]).copy()
    counts0 = _lane_tile_counts(fused, sb0, wall0)
    S = fused.rollout(S, 40)
    assert np.asarray(S["stats_episodes"]).min() >= 2
    counts1 = _lane_tile_counts(fused, S["sboard"], S["wall"])
    for name in counts0:
        np.testing.assert_array_equal(counts1[name], counts0[name], name)
    # Fresh draws: essentially every lane's layout moved off its initial
    # one (a coincidental identical redraw is possible but vanishing).
    same = (np.asarray(S["sboard"]) == sb0).all(axis=0)
    assert same.sum() == 0, f"{same.sum()} lanes restored their layout"
    # Border walls never move.
    border = np.asarray(fused.consts["border_wall"]) > 0.5
    assert (np.asarray(S["wall"])[border[:, 0]] == 1.0).all()


def test_fused_step_matches_per_env_exact_reset():
    """Chain equivalence ACROSS in-kernel redraws: each step re-unpacks
    the per-env states from the kernel (including the freshly drawn
    layout) and the physics stays in lockstep on the new map."""
    _run_equivalence(
        AIntelopeSavanna(**dict(RICH_KW, max_iterations=5)),
        seed=43, steps=12,
    )


def test_xla_pallas_bit_identity_exact_reset():
    env = AIntelopeSavanna(**dict(RICH_KW, max_iterations=6))
    fused = FusedSavanna(env)
    S0 = fused.init_packed(seed=47, batch=64)
    assert fused.exact_reset
    Sx = fused.rollout(dict(S0), 20)
    Sl = reference_chain.step_loop(fused, dict(S0), 20)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.asarray(Sx["stats_episodes"]).max() >= 2


def test_xla_pallas_bit_identity_exact_reset_sustainability():
    """Redraw + dynamic resource curtains compose: fresh res curtains on
    reset come from the same redraw and stay bit-identical between the
    scan driver and the step loop."""
    env = AIntelopeSavanna(**dict(SUSTAIN_KW, max_iterations=6))
    fused = FusedSavanna(env)
    S0 = fused.init_packed(seed=53, batch=32)
    assert fused.exact_reset
    Sx = fused.rollout(dict(S0), 16)
    Sl = reference_chain.step_loop(fused, dict(S0), 16)
    reference_chain.assert_states_equal(Sx, Sl, fused.STATE_FIELDS)
    assert np.asarray(Sx["stats_episodes"]).max() >= 1


def _chi2_quantile(df, p_sigma=3.09):
    """Wilson-Hilferty approximation of the chi-square upper quantile
    (p_sigma=3.09 ~ the 0.999 quantile) — scipy-free."""
    t = 1.0 - 2.0 / (9.0 * df) + p_sigma * np.sqrt(2.0 / (9.0 * df))
    return df * t**3


def test_exact_reset_agent_start_is_uniform_over_interior():
    """Statistical gate for the redraw distribution: the agent's
    post-reset start cell is uniform over the board interior — the
    defining property of the reference's interior shuffle (ranks of iid
    distinct PRF scores form a uniform permutation). Chi-square at the
    0.999 quantile on ~3k in-kernel resets; fixed seed, deterministic."""
    env = AIntelopeSavanna(max_iterations=3)  # default: 1 agent
    fused = FusedSavanna(env)
    B = 256
    S = fused.init_packed(seed=59, batch=B)
    assert fused.exact_reset
    interior = np.asarray(fused.consts["interior"])[:, 0] > 0.5
    n_int = int(interior.sum())
    counts = np.zeros(fused.HW, np.int64)
    first = int(StepType.FIRST)
    for _ in range(60):
        S = fused.step_xla(S)
        is_first = np.asarray(S["step_types"])[0] == first
        if is_first.any():
            np.add.at(counts, np.asarray(S["pos"])[0][is_first], 1)
    n_resets = counts.sum()
    assert n_resets > 1500, n_resets
    assert counts[~interior].sum() == 0, "agent started outside interior"
    expected = n_resets / n_int
    chi2 = float(((counts[interior] - expected) ** 2 / expected).sum())
    assert chi2 < _chi2_quantile(n_int - 1), (chi2, n_int, n_resets)


def test_exact_reset_refuses_non_wall_border():
    """_redraw_layout rebuilds the border as ALL WALL; a map with a
    non-wall border tile must be refused for exact_reset (restore /
    layout_pool modes still work) rather than silently losing the tile
    on the first in-kernel reset."""
    env = AIntelopeSavanna(**RICH_KW)
    board = np.asarray(env._base_board).copy()
    board[0, 1] = ord("W")  # water on the border ring
    env._base_board = board
    fused = FusedSavanna(env)
    assert not fused._exact_ok
    assert "border" in fused._exact_why
    with pytest.raises(ValueError, match="border"):
        fused.init_packed(seed=1, batch=4, exact_reset=True)
    S = fused.init_packed(seed=1, batch=4)  # falls back to restore mode
    assert not fused.exact_reset
    assert S is not None


def test_exact_reset_food_placement_is_uniform_over_interior():
    """Statistical gate for the GAP-only top-up inside the in-kernel
    redraw: level 6 carries an art-vs-flag food deficit (1 'F' in art,
    amount_food_patches=2), so every episode places one art food tile
    AND one topped-up food tile. Marginally each food cell is uniform
    over the interior (ranks of iid distinct PRF scores form a uniform
    permutation; the top-up is just part of the placement multiset).
    Chi-square at the 0.999 quantile; fixed seed, deterministic."""
    env = AIntelopeSavanna(level=6, max_iterations=3)
    assert env._reset_topup == [("F", 1)]
    fused = FusedSavanna(env)
    B = 256
    S = fused.init_packed(seed=61, batch=B)
    assert fused.exact_reset
    interior = np.asarray(fused.consts["interior"])[:, 0] > 0.5
    n_int = int(interior.sum())
    food_code = float(fused.tile_codes["food"])
    counts = np.zeros(fused.HW, np.int64)
    first = int(StepType.FIRST)
    resets = 0
    for _ in range(60):
        S = fused.step_xla(S)
        is_first = np.asarray(S["step_types"])[0] == first
        if not is_first.any():
            continue
        code = np.asarray(S["sboard"]) % 16.0
        food = (code == food_code)[:, is_first]
        assert (food.sum(axis=0) == 2).all(), "food count drifted"
        counts += food.sum(axis=1)
        resets += int(is_first.sum())
    assert resets > 1500, resets
    assert counts[~interior].sum() == 0, "food placed outside interior"
    n_obs = counts.sum()
    assert n_obs == 2 * resets
    expected = n_obs / n_int
    chi2 = float(((counts[interior] - expected) ** 2 / expected).sum())
    assert chi2 < _chi2_quantile(n_int - 1), (chi2, n_int, n_obs)


def _expected_redraw_layout(fused, S_pre, lane):
    """Independent numpy reimplementation of the in-kernel redraw spec:
    rank the interior by the PRF score construction, place the
    ``_placement_spec`` multiset on the T smallest cells in fixed type
    order, rebuild codes/water distances. Used to pin the kernel's
    redraw DRAW-FOR-DRAW (not just in distribution)."""
    from ai_safety_gridworlds_tpu.ops import prng

    HW, W, n = fused.HW, fused.w, fused.n
    keys = np.asarray(S_pre["key"])
    ctr0 = np.uint32(
        np.uint32(np.asarray(S_pre["draw_ctr"])[0, lane])
        * np.uint32(fused.n_sites)
    )
    idx = np.arange(HW, dtype=np.uint32)
    bits = np.asarray(prng.hash_u32(
        np.uint32(keys[0, lane]), np.uint32(keys[1, lane]),
        ctr0 + np.uint32(fused.redraw_site), idx,
    ))
    ib = fused._idx_bits
    base = (((bits >> np.uint32(ib + 3)) << np.uint32(ib)) | idx).astype(
        np.int64
    )
    interior = np.asarray(fused.consts["interior"])[:, 0] > 0.5
    SENT = 1 << 30
    masked = np.where(interior, base, SENT)
    order = np.argsort(masked)  # distinct ints -> the extraction order
    idx_mask = (1 << ib) - 1

    codes = fused.tile_codes
    out = {
        "wall": (~interior).astype(np.float32),
        "code": np.zeros(HW, np.float32),
        "predator": np.zeros(HW, np.float32),
        "pos": np.zeros(n, np.int64),
        "res": {},
    }
    water_cells = []
    for t, (kind, info) in enumerate(fused._placement_spec):
        cell = int(masked[order[t]]) & idx_mask
        if kind == "agent":
            out["pos"][info] = cell
        elif kind == "predator":
            out["predator"][cell] += 1.0
        elif kind == "wall":
            out["wall"][cell] += 1.0
        elif kind == "water":
            out["code"][cell] += float(codes["water"])
            water_cells.append(cell)
        elif kind in out["res"] or (
            fused.sustain
            and kind in {s["name"] for s in fused.res_specs}
        ):
            out["res"].setdefault(kind, np.zeros(HW, np.float32))
            out["res"][kind][cell] += 1.0
        else:
            out["code"][cell] += float(codes[kind])
    rows, cols = np.arange(HW) // W, np.arange(HW) % W
    if water_cells:
        dist = np.min(
            [
                np.abs(rows - c // W) + np.abs(cols - c % W)
                for c in water_cells
            ],
            axis=0,
        )
        dist_f = 16.0 * np.where(dist > 98, 99, dist).astype(np.float32)
    else:
        dist_f = np.float32(16.0 * 99.0)
    out["sboard"] = out["code"] + dist_f
    return out


def test_exact_reset_redraw_is_stream_exact():
    """The kernel's per-episode redraw is pinned DRAW-FOR-DRAW against
    an independent numpy implementation of the spec (PRF ranking +
    fixed-type-order placement): wall, combined code/distance board,
    agent starts, and predator curtain all match bit-for-bit on every
    resetting lane."""
    env = AIntelopeSavanna(**dict(RICH_KW, max_iterations=4))
    fused = FusedSavanna(env)
    B = 32
    S = fused.init_packed(seed=67, batch=B)
    assert fused.exact_reset
    first = int(StepType.FIRST)
    checked = 0
    for _ in range(14):
        S_pre = S
        S = fused.step_xla(S)
        is_first = np.asarray(S["step_types"])[0] == first
        for b in np.nonzero(is_first)[0]:
            exp = _expected_redraw_layout(fused, S_pre, int(b))
            np.testing.assert_array_equal(
                np.asarray(S["wall"])[:, b], exp["wall"], "wall"
            )
            np.testing.assert_array_equal(
                np.asarray(S["sboard"])[:, b], exp["sboard"], "sboard"
            )
            np.testing.assert_array_equal(
                np.asarray(S["pos"])[:, b], exp["pos"], "pos"
            )
            np.testing.assert_array_equal(
                np.asarray(S["predator"])[:, b], exp["predator"],
                "predator",
            )
            checked += 1
    assert checked >= B, checked


def test_exact_reset_redraw_is_stream_exact_sustainability():
    """Same draw-for-draw redraw pin under sustainability: the fresh
    resource curtains drawn by the redraw match the independent spec
    implementation exactly as well."""
    env = AIntelopeSavanna(**dict(SUSTAIN_KW, max_iterations=4))
    fused = FusedSavanna(env)
    B = 16
    S = fused.init_packed(seed=71, batch=B)
    assert fused.exact_reset and fused.sustain
    first = int(StepType.FIRST)
    checked = 0
    for _ in range(14):
        S_pre = S
        S = fused.step_xla(S)
        is_first = np.asarray(S["step_types"])[0] == first
        for b in np.nonzero(is_first)[0]:
            exp = _expected_redraw_layout(fused, S_pre, int(b))
            np.testing.assert_array_equal(
                np.asarray(S["sboard"])[:, b], exp["sboard"], "sboard"
            )
            for name, expected in exp["res"].items():
                np.testing.assert_array_equal(
                    np.asarray(S["res_" + name])[:, b], expected, name
                )
            checked += 1
    assert checked >= B, checked
