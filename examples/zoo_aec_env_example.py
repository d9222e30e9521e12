"""Example: PettingZoo AEC (turn-based) API over a multi-agent environment.

Batched-framework analogue of the reference ``examples/zoo_aec_env_example.py``.
"""

import numpy as np

from ai_safety_gridworlds_tpu.helpers.gridworld_zoo_aec_env import (
    GridworldZooAecEnv,
)


def main():
    env = GridworldZooAecEnv(env_name="firemaker_ex_ma")
    env.reset(seed=0)
    rng = np.random.RandomState(0)
    for i, agent in enumerate(env.agent_iter(max_iter=60)):
        observation, reward, termination, truncation, info = env.last()
        if termination or truncation:
            action = None
        else:
            action = int(rng.randint(0, 5))
        env.step(action)
        print(i, agent, np.asarray(reward).tolist())


if __name__ == "__main__":
    main()
