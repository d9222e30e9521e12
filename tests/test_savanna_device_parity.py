"""Cross-validation of savanna's batched device kernel vs its host mirror.

The host path (``host_substep``) consumes the env Generator in exact
reference order; the device path (``engine_substep``) is the batched device
kernel. Here both are driven in lockstep from the same initial state, with
the host's random OUTCOMES (post-walk predator curtain, post-spawn resource
curtains) injected into the device sub-step via ``inj_*`` options — so every
non-injected computation (movement, consumption, satiation, homeostasis,
visits, safety, rewards, availability maintenance/regrowth) is asserted
identical between the two paths. A silent change to either one breaks this
test.

The flag values below are dyadic rationals so f32 (device) and f64 (host
shadow) satiation/availability arithmetic agree bit-exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_safety_gridworlds_tpu.core.timestep import TerminationReason
from ai_safety_gridworlds_tpu.envs.aintelope_savanna import AIntelopeSavanna

FLOAT_FIELDS = {
    "drink_satiation",
    "food_satiation",
    "drink_avail",
    "food_avail",
    "small_drink_avail",
    "small_food_avail",
}

DYADIC = dict(
    DRINK_DEFICIENCY_RATE=-0.25,
    FOOD_DEFICIENCY_RATE=-0.25,
    DRINK_EXTRACTION_RATE=1,
    FOOD_EXTRACTION_RATE=1,
    SMALL_DRINK_EXTRACTION_RATE=0.5,
    SMALL_FOOD_EXTRACTION_RATE=0.5,
)


def _compare_states(host, dev, ctx):
    for field in host.__dataclass_fields__:
        if field == "key":
            continue  # host path never consumes the jax key
        hv = np.asarray(getattr(host, field))
        dv = np.asarray(getattr(dev, field))
        if field in FLOAT_FIELDS:
            np.testing.assert_allclose(
                hv, dv, rtol=1e-6, atol=1e-6,
                err_msg=f"{ctx}: field {field}",
            )
        else:
            np.testing.assert_array_equal(
                hv, dv, err_msg=f"{ctx}: field {field}"
            )


def run_cross_validation(n_steps=80, seed=5, **flags):
    env = AIntelopeSavanna(**flags)
    np_random = np.random.default_rng(seed)
    rng = np.random.RandomState(seed + 1)
    n = env.n_agents
    apply = jax.jit(env.apply_substep, static_argnames=("slot",))

    def fresh_episode(ep):
        raw = env.host_reset_options_with_generator(np_random)
        options = {k: jnp.asarray(v) for k, v in raw.items()}
        state = jax.jit(env.initial_state)(
            jax.random.PRNGKey(seed * 1000 + ep), options
        )
        return env.host_reset_sweep(state, np_random)

    episode = 0
    host_state = fresh_episode(episode)
    dev_state = host_state
    substeps_validated = 0

    for t in range(n_steps):
        reasons = np.asarray(host_state.termination_reasons)
        all_done = (reasons != int(TerminationReason.NONE)).all()
        if all_done or int(np.asarray(host_state.t)) >= env.max_iterations:
            episode += 1
            host_state = fresh_episode(episode)
            dev_state = host_state
            continue
        acting = [
            j for j in range(n)
            if reasons[j] == int(TerminationReason.NONE)
        ]
        order = env.host_agent_order(np_random, acting)
        actions = {j: int(rng.randint(0, 5)) for j in acting}
        for slot in range(n):
            idx = int(order[slot])
            a = actions.get(idx, -1)
            if a < 0:
                continue
            host_state, dh = env.host_substep(
                host_state, idx, a, np_random
            )
            inj = {
                "inj_predator_curtain": host_state.predator_curtain,
                "inj_drink_curtain": host_state.drink_curtain,
                "inj_food_curtain": host_state.food_curtain,
                "inj_small_drink_curtain": host_state.small_drink_curtain,
                "inj_small_food_curtain": host_state.small_food_curtain,
            }
            dev_state, dd = apply(
                dev_state, jnp.int32(idx), jnp.int32(a), inj, slot
            )
            _compare_states(
                host_state, dev_state, f"step {t} slot {slot} agent {idx}"
            )
            np.testing.assert_allclose(
                np.asarray(dh, np.float64),
                np.asarray(dd, np.float64),
                rtol=1e-5, atol=1e-6,
                err_msg=f"step {t} slot {slot} rewards",
            )
            substeps_validated += 1
    assert substeps_validated > 40, "too few validated sub-steps"


def test_device_matches_host_default_config():
    run_cross_validation(
        amount_agents=2, amount_drink_holes=2, amount_gold_deposits=1,
        amount_silver_deposits=1, amount_water_tiles=2, **DYADIC,
    )


def test_device_matches_host_predators():
    run_cross_validation(
        amount_agents=2, amount_predators=3, amount_water_tiles=0,
        PREDATOR_MOVEMENT_PROBABILITY=0.75, seed=9, **DYADIC,
    )


def test_device_matches_host_sustainability():
    run_cross_validation(
        amount_agents=2, amount_drink_holes=2,
        sustainability_challenge=True,
        DRINK_REGROWTH_EXPONENT=1.0, seed=11, **DYADIC,
    )


def test_device_matches_host_homeostasis_death():
    run_cross_validation(
        amount_agents=2, amount_drink_holes=1,
        thirst_hunger_death=True, penalise_oversatiation=True,
        DRINK_DEFICIENCY_LIMIT=-4, FOOD_DEFICIENCY_LIMIT=-4,
        seed=13, **DYADIC,
    )


# ---------------------------------------------------------------------------
# Distribution-level checks of the device-only RNG paths (predator walk and
# sustainability spawn selection) against their reference frequencies.


def test_predator_walk_distribution():
    """Device predators move with PREDATOR_MOVEMENT_PROBABILITY on
    round-completing sub-steps and the count is always preserved."""
    env = AIntelopeSavanna(
        amount_agents=1, amount_predators=4,
        PREDATOR_MOVEMENT_PROBABILITY=0.5, **DYADIC,
    )
    key = jax.random.PRNGKey(0)
    options = env.sample_reset_options(key)
    state = jax.jit(env.initial_state)(key, options)
    apply = jax.jit(env.apply_substep, static_argnames=("slot",))
    moved = 0
    opportunities = 0
    for t in range(300):
        before = np.asarray(state.predator_curtain)
        state, _ = apply(state, jnp.int32(0), jnp.int32(0), {}, 0)
        after = np.asarray(state.predator_curtain)
        assert after.sum() == before.sum() == 4, t
        stayed = (before & after).sum()
        moved += 4 - stayed
        opportunities += 4
        if int(np.asarray(state.t)) >= env.max_iterations - 1:
            break
    rate = moved / opportunities
    # Expected: p=0.5 per predator per round, minus blocked moves (rare on
    # an open map). Loose 3-sigma band around 0.5.
    assert 0.35 < rate < 0.60, rate
