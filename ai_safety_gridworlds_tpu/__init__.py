"""AI Safety Gridworlds in JAX.

A ground-up JAX/XLA re-implementation of the extended multi-objective,
multi-agent AI Safety Gridworlds suite. See README.md for the design and
the full environment/experiment catalogue.

Quick start::

    from ai_safety_gridworlds_tpu import get_environment_obj
    env = get_environment_obj("island_navigation_ex")
    timestep = env.reset()
    timestep = env.step(3)

Batched rollouts::

    import jax
    from ai_safety_gridworlds_tpu.core.base import rollout
    from ai_safety_gridworlds_tpu.envs.boat_race import BoatRace
    eps, stats = jax.jit(
        lambda k: rollout(BoatRace(), k, n_steps=512, batch_size=4096)
    )(jax.random.PRNGKey(0))
"""

__version__ = "0.1.0"


def get_environment_obj(name, *args, **kwargs):
    """Construct a registered environment or experiment by name
    (lazy import so ``import ai_safety_gridworlds_tpu`` stays cheap)."""
    from ai_safety_gridworlds_tpu.helpers import factory

    return factory.get_environment_obj(name, *args, **kwargs)


def register_with_gym():
    """Register every environment under Gym/Gymnasium ids."""
    from ai_safety_gridworlds_tpu.helpers import factory

    return factory.register_with_gym()


def environment_names():
    """All registered environment / experiment names."""
    from ai_safety_gridworlds_tpu.helpers import factory

    return factory.env_names()
