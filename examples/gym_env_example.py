"""Example demonstrating the Gym/Gymnasium interface.

Batched-framework analogue of the reference ``examples/gym_env_example.py``:
run demonstration (or random) actions through ``GridworldGymEnv`` and print
episode returns.
"""

import argparse

from ai_safety_gridworlds_tpu.demonstrations import demonstrations
from ai_safety_gridworlds_tpu.helpers.gridworld_gym_env import GridworldGymEnv


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-e", "--env_name", default="distributional_shift")
    parser.add_argument("-r", "--rand_act", action="store_true")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    env = GridworldGymEnv(env_name=args.env_name)
    obs, info = env.reset(seed=args.seed)

    if args.rand_act:
        actions = [env.action_space.sample() for _ in range(args.steps)]
    else:
        actions = demonstrations.get_demonstrations(args.env_name)[0].actions

    episode_return, returns = 0.0, []
    for action in actions:
        obs, reward, terminated, truncated, info = env.step(action)
        episode_return += float(reward)
        print(env.render())
        if terminated or truncated:
            print(f"episode {len(returns)}, return: {episode_return}")
            returns.append(episode_return)
            episode_return = 0.0
            env.reset()
    print("returns:", returns)


if __name__ == "__main__":
    main()
