"""Regenerate docs/demo_rollout_torch.gif with the PyTorch port: the
autopilot driving a rich multi-lane town (banded facades with procedural
window grids, asphalt speckle, blob shadows, lane markings and zebra
crosswalks, crosswalk walkers and sidewalk strollers, junction turn fans,
light fog), the RGB camera on the left and the semantic camera on the
right, both from the exact rasterizer: kernel A's textured variant in RGB
at 2048 triangles on the card. The same scene, window search and GIF as
``docs/make_demo_gif.py``.

    python docs/make_demo_gif_torch.py [--device cuda|cpu] [--frames 160] [--out PATH]

It rolls 3 × ``--frames`` steps, then keeps the ``--frames`` window in
which the ego covers the most ground (a stopped ego makes a frozen GIF).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:     # run from a checkout without installing the package
    sys.path.insert(0, str(ROOT))

N_FRAMES = 160
OUT = ROOT / "docs" / "demo_rollout_torch.gif"


def demo_world():
    """The demo's town, sim parameters and camera → (params, town, rcfg)."""
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams

    town = make_town(blocks=3, n_buildings=24, n_lights=8, corner_radius=6.0,
                     lanes_per_direction=2, superblocks=True, turn_fans=True, seed=3)
    params = SimParams(n_agents=15, n_pedestrians=12, ped_sidewalk_frac=0.4,
                       lane_change_period=120, turn_period=80, agent_turn_prob=0.01)
    rcfg = RenderConfig(height=128, width=128, rgb=True, max_triangles=2048, facade_bands=3,
                        shadows=True, markings=True, fog_density=0.008, texture_detail=True)
    return params, town, rcfg


def demo_drive(n_steps: int, device: str | torch.device = "cuda"):
    """The autopilot's drive from seed 2, one env, auto-resets from the
    rollout's spawn pool → (params, town on the device, rcfg, the states
    before each of ``n_steps`` steps)."""
    from carla_imitation_learning_tpu_torch.device import resolve_device
    from carla_imitation_learning_tpu_torch.sim.world import (
        autopilot_control, pick_fresh_packed, reset_env, step_env,
    )
    from carla_imitation_learning_tpu_torch.training.closed_loop import rollout_spawn_pool

    dev = resolve_device(device)
    params, town, rcfg = demo_world()
    town = town.to(dev)
    pool = rollout_spawn_pool(params, town).to(dev)
    state = reset_env(params, town, torch.Generator().manual_seed(2), 1)
    states = []
    for _ in range(n_steps):
        states.append(state)
        fresh = pick_fresh_packed(pool, params, state)
        state = step_env(params, town, state, autopilot_control(params, town, state), fresh)[0]
    return params, town, rcfg, states


@torch.no_grad()
def demo_frames(n_steps: int, device: str | torch.device = "cuda"):
    """``demo_drive``'s states rendered → (frames: (128, 256, 3) uint8 each,
    RGB beside the semantic colours; (n_steps, 2) ego positions)."""
    from carla_imitation_learning_tpu_torch.render.pipeline import make_renderer

    params, town, rcfg, states = demo_drive(n_steps, device)
    render = make_renderer(params, town, rcfg, device=town.routes.device)
    frames = []
    for state in states:
        out = render(state)
        rgb = (out["rgb"][0].clamp(0, 1) * 255).to(torch.uint8)
        sem = (out["semantic_rgb"][0].clamp(0, 1) * 255).to(torch.uint8)
        frames.append(torch.cat([rgb, sem], dim=1).cpu().numpy())
    return frames, torch.cat([s.ego_pos for s in states]).cpu().numpy()


def best_window(pos: np.ndarray, n_frames: int) -> int:
    """Start of the ``n_frames`` window with the longest ego path."""
    dist = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
    return int(np.convolve(dist, np.ones(n_frames - 1), mode="valid").argmax())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--frames", type=int, default=N_FRAMES, help="frames in the GIF")
    parser.add_argument("--out", default=str(OUT), help="the GIF's path")
    args = parser.parse_args(argv)
    from PIL import Image

    all_frames, pos = demo_frames(3 * args.frames, args.device)
    start = best_window(pos, args.frames)
    imgs = [Image.fromarray(f).resize((512, 256), Image.NEAREST)
            for f in all_frames[start:start + args.frames]]
    imgs[0].save(args.out, save_all=True, append_images=imgs[1:], duration=100, loop=0)
    print(f"{args.out}: {len(imgs)} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
