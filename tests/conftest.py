"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; sharding tests use
``--xla_force_host_platform_device_count=8`` to validate
``jax.sharding.Mesh`` programs without real devices. Tests that need a
GPU carry the ``gpu`` marker and skip on this CPU run.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# Persistent compilation cache: jit compiles dominate suite wall time, and
# the compiled programs are identical across runs.
from ai_safety_gridworlds_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

# Parity-oracle checkout of levitation-opensource/ai-safety-gridworlds.
# Lockstep tests skip cleanly when it is absent (e.g. plain CI runners);
# point AI_SAFETY_GRIDWORLDS_REFERENCE at a checkout to enable them.
REFERENCE_ROOT = os.environ.get(
    "AI_SAFETY_GRIDWORLDS_REFERENCE", "/root/reference"
)


def reference_available() -> bool:
    """Whether the reference implementation is importable as a parity oracle."""
    return os.path.isdir(REFERENCE_ROOT)


def add_reference_to_path():
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)


# The reference MoMa/Mo bases keep their CSV-log machinery in CLASS
# attributes (safety_game_mo.py:318-356,563-650): a later env instance
# with byte-identical flags/log_arguments sees create_new_log_file=False
# and silently reuses the previous instance's file handle — which, under
# pytest, points into an earlier test's (deleted) tmp dir. Tests that
# assert on fresh reference log output must scrub this state first.
_REF_STICKY_ATTRS = (
    "create_new_log_file", "enabled_agents_reward_dimensions",
    "enabled_reward_dimension_keys", "env_layout_seed", "env_seed",
    "episode_no", "flags", "log_arguments", "log_file_handle",
    "log_filename", "log_filename_comment", "metrics_keys",
    "next_experiment_no", "prev_experiment_no", "trial_no",
)


def scrub_reference_log_state():
    """Reset the reference envs' per-CLASS logging state (all imported
    subclasses of the reference SafetyEnvironmentMo/..MoBase), closing any
    leaked file handle, so the next construction starts a fresh log file
    exactly like a fresh process would."""
    bases = []
    for modname in (
        "ai_safety_gridworlds.environments.shared.safety_game_mo",
        "ai_safety_gridworlds.environments.shared.safety_game_mo_base",
        "ai_safety_gridworlds.environments.shared.safety_game_moma",
    ):
        mod = sys.modules.get(modname)
        for clsname in (
            "SafetyEnvironmentMo", "SafetyEnvironmentMoBase",
            "SafetyEnvironmentMoMa",
        ):
            cls = getattr(mod, clsname, None) if mod else None
            if cls is not None:
                bases.append(cls)

    seen = set()
    stack = list(bases)
    while stack:
        cls = stack.pop()
        if cls in seen:
            continue
        seen.add(cls)
        stack.extend(cls.__subclasses__())
        handle = cls.__dict__.get("log_file_handle")
        if handle is not None:
            try:
                handle.close()
            except Exception:
                pass
        for attr in _REF_STICKY_ATTRS:
            if attr in cls.__dict__:
                try:
                    delattr(cls, attr)
                except (AttributeError, TypeError):
                    pass
