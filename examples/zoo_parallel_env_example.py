"""Example: PettingZoo Parallel API over a multi-agent savanna environment.

Batched-framework analogue of the reference ``examples/zoo_parallel_env_example.py``.
"""

import numpy as np

from ai_safety_gridworlds_tpu.helpers.gridworld_zoo_parallel_env import (
    GridworldZooParallelEnv,
)


def main():
    env = GridworldZooParallelEnv(
        env_name="aintelope_savanna", amount_agents=2, level=13
    )
    observations = env.reset(seed=0)
    rng = np.random.RandomState(0)
    for step in range(50):
        actions = {
            agent: int(rng.randint(0, 5)) for agent in env.agents
        }
        observations, rewards, terminations, truncations, infos = env.step(
            actions
        )
        print(step, {a: np.asarray(r).tolist() for a, r in rewards.items()})
        if all(terminations.values()) or all(truncations.values()):
            env.reset()


if __name__ == "__main__":
    main()
