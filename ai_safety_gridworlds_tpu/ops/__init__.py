"""Fused packed-step engines for batched rollouts.

The production compute path is the fused packed steps (:mod:`.fused_scalar`,
:mod:`.fused_firemaker`, :mod:`.fused_savanna`, :mod:`.fused_island_ma`):
the whole RL step (action draws, agent order, sub-steps, finalize,
auto-reset) on a packed ``[rows, B]`` state, run as one jitted
``lax.scan`` per rollout chunk (:mod:`.fused_base`), backed by the
counter-based PRF of :mod:`.prng`. (Standalone per-op kernels were
benchmarked and removed — findings in ``docs/KERNELS.md``.)
"""

import importlib
import logging

# Registered env name -> (module, class) of its fused packed step.
_FUSED = {
    "firemaker_ex_ma": ("fused_firemaker", "FusedFiremaker"),
    "aintelope_savanna": ("fused_savanna", "FusedSavanna"),
    "island_navigation_ex_ma": ("fused_island_ma", "FusedIslandMa"),
    "boat_race": ("fused_scalar", "FusedBoatRace"),
    "island_navigation": ("fused_scalar", "FusedIslandNav"),
    "boat_race_ex": ("fused_scalar", "FusedBoatRaceEx"),
    "island_navigation_ex": ("fused_scalar", "FusedIslandNavEx"),
    "side_effects_sokoban": ("fused_scalar", "FusedSokoban"),
    "absent_supervisor": ("fused_scalar", "FusedAbsentSupervisor"),
    "distributional_shift": ("fused_scalar", "FusedDistributionalShift"),
    "safe_interruptibility": ("fused_scalar", "FusedSafeInterruptibility"),
    "whisky_gold": ("fused_scalar", "FusedWhiskyGold"),
    "tomato_watering": ("fused_scalar", "FusedTomatoWatering"),
    "tomato_crmdp": ("fused_scalar", "FusedTomatoWatering"),
    "conveyor_belt": ("fused_scalar", "FusedConveyorBelt"),
    "rocks_diamonds": ("fused_scalar", "FusedRocksDiamonds"),
    "conveyor_belt_ex": ("fused_scalar", "FusedConveyorBeltEx"),
    "safe_interruptibility_ex": (
        "fused_scalar", "FusedSafeInterruptibilityEx",
    ),
    "friend_foe": ("fused_scalar", "FusedFriendFoe"),
}

#: Every registered env name that has a fused packed step.
FUSED_ENV_NAMES = tuple(_FUSED)


def _load(module, cls):
    mod = importlib.import_module(f"{__name__}.{module}")
    return getattr(mod, cls)


def make_fused(env):
    """The fused packed-step driver for an env instance, or ``None`` when
    the env (or its configuration) has no fused step — callers fall back
    to the generic vmapped path then.

    A config-driven fallback is logged loudly: silently losing the fused
    path is a performance bug in the making.
    """
    name = getattr(env, "name", None)
    if name not in _FUSED:
        return None
    try:
        return _load(*_FUSED[name])(env)
    except NotImplementedError as e:
        logging.getLogger(__name__).warning(
            "%s has a fused step, but this configuration is not "
            "supported by it (%s); falling back to the generic vmapped "
            "path.",
            name,
            e,
        )
        return None


def __getattr__(name):
    # Lazy kernel classes (importing them pulls in env modules).
    for module, cls in _FUSED.values():
        if cls == name:
            return _load(module, cls)
    raise AttributeError(name)
