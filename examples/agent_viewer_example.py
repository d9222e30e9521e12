"""Example: watch a scripted agent play in the terminal via AgentViewer.

Batched-framework analogue of the reference ``examples/agent_viewer_example.py``.
"""

import argparse
import importlib

from ai_safety_gridworlds_tpu.demonstrations import demonstrations
from ai_safety_gridworlds_tpu.helpers import factory
from ai_safety_gridworlds_tpu.helpers.agent_viewer import AgentViewer


def get_color_map(environment_name):
    mod = importlib.import_module(
        "ai_safety_gridworlds_tpu.envs." + environment_name
    )
    return mod.GAME_BG_COLOURS, getattr(mod, "GAME_FG_COLOURS", {})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-e", "--environment_name", default="boat_race")
    parser.add_argument("--pause", type=float, default=0.2)
    parser.add_argument("--headless", action="store_true")
    args = parser.parse_args()

    color_bg, color_fg = get_color_map(args.environment_name)
    env = factory.get_environment_obj(args.environment_name)
    ts = env.reset()

    try:
        demo = demonstrations.get_demonstrations(args.environment_name)[0]
        actions = demo.actions
    except (KeyError, IndexError):
        actions = [1, 2, 3, 4] * 5

    with AgentViewer(
        args.pause, color_bg=color_bg, color_fg=color_fg,
        headless=args.headless,
    ) as av:
        av.display(env, ts)
        for action in actions:
            ts = env.step(action)
            av.display(env, ts)
            if ts.step_type.last():
                ts = env.reset()
        if args.headless:
            print("\n".join(av.last_frame))


if __name__ == "__main__":
    main()
