"""Entry points of a compile check and a multi-device dry run (the JAX
package's root ``__graft_entry__.py``):

- ``entry(device)`` → ``(fn, args)``: the flagship model's forward, a
  ``PolicyCNN`` on an (8, 256, 256, 4) float32 stack → (8, 9) logits;
- ``dryrun_multichip(n_devices, device)``: one step of every model family
  data-parallel over a ``data`` mesh of ``n_devices`` ranks at tiny
  shapes, in the JAX dry run's order.

    python -m carla_imitation_learning_tpu_torch.graft_entry [N] [--device cpu]

runs ``dryrun_multichip(N)`` (N = 8 by default), then ``entry()``'s forward.

JAX runs the dry run as one SPMD program over N devices of one process.
The port spawns N ranks (``torch.multiprocessing``, a tcp rendezvous on
localhost) that join one process group and run ``_dryrun_work`` on their
rows: NCCL with one rank a card where the machine has N cards, otherwise
gloo ranks that share the cards (or the CPU). Each block asserts a finite
loss; rank 0 prints the JAX line's keys with the global run's figures.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.device import resolve_device

HW = 64          # the BC, VAE and fused-epoch frames
FLEET_HW = 32    # the fleets' camera (192 triangles)


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): ``fn(model, x)`` is a ``PolicyCNN``'s forward (the
    reference BC contract, 4 × 256² frames → 9 logits, bf16 compute),
    weights drawn as flax's defaults from seed 0, ``x`` zeros (8, 256, 256,
    4) float32 on ``device``."""
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_

    dev = resolve_device(device)
    model = flax_init_(PolicyCNN(), torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.zeros((8, 256, 256, 4), dtype=torch.float32, device=dev)

    def fn(model, x):
        with torch.no_grad():
            return model(x)

    return fn, (model, x)


def _finite(value, what: str) -> float:
    value = float(value)
    if not math.isfinite(value):
        raise RuntimeError(f"non-finite loss in the {what} dry run: {value}")
    return value


def _global_count(mesh, n: int) -> int:
    """The sum of ``n`` over the ranks."""
    return int(mesh.all_reduce_(torch.tensor([n], dtype=torch.float64,
                                             device=mesh.device)).item())


def _dryrun_work(mesh) -> dict:
    """Every family's step on this rank's rows of a global batch of 2 rows a
    rank (JAX's shapes), in JAX's order → the global figures and this
    rank's kernel launches."""
    from carla_imitation_learning_tpu_torch.bench import launch_counts
    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.models import ConvVAE, LatentWorldModel, PolicyCNN
    from carla_imitation_learning_tpu_torch.parallel.mesh import (
        batch_sharding, shard_batch, shard_train_state,
    )
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.planner import plan_to_goals, sample_goals
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import (
        bc_loss_fn, vae_loss_fn, world_model_loss_fn,
    )
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        assign_goals, make_rollout,
    )
    from carla_imitation_learning_tpu_torch.training.imagination import (
        LatentPolicy, RewardHead, init_module, make_imagination_update,
    )
    from carla_imitation_learning_tpu_torch.training.online_dagger import make_online_dagger
    from carla_imitation_learning_tpu_torch.training.rl import (
        ActorCriticCNN, PPOConfig, ppo_train,
    )
    from carla_imitation_learning_tpu_torch.training.steps import (
        ADAM_BETAS, ADAM_EPS, AdamConfig, create_train_state, make_fused_epoch,
        make_optimizer, make_train_step,
    )

    dev, n = mesh.device, mesh.size()
    B = 2 * n
    out = {}

    def gen(seed: int) -> torch.Generator:
        return torch.Generator().manual_seed(seed)

    def replicated(model, tx=None):
        state = create_train_state(model, tx or make_optimizer(
            {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [20, 30], "LR_GAMMA": 0.1,
             "gradient_clip_val": 0.5}, steps_per_epoch=4), generator=gen(0), device=dev)
        return shard_train_state(mesh, state)

    # data-parallel BC step: each rank's rows, the gradient bucket all-reduced
    state = replicated(PolicyCNN(dtype=torch.float32))
    x = torch.ones((B, HW, HW, 4), device=dev)
    y = torch.zeros((B,), dtype=torch.int64, device=dev)
    _, metrics = make_train_step(bc_loss_fn)(state, shard_batch(mesh, (x, y)), gen(0))
    out["bc_loss"] = _finite(metrics["loss"], "BC")

    # a second family under the same mesh: the VAE (noise drawn for the global batch)
    vstate = replicated(ConvVAE(channels=1, height=HW, width=HW, z_size=8,
                                dtype=torch.float32))
    xv = torch.ones((B, HW, HW, 1), device=dev)
    _, vmetrics = make_train_step(vae_loss_fn(0.75, 0.1))(
        vstate, (shard_batch(mesh, xv),), gen(0))
    out["vae_loss"] = _finite(vmetrics["loss"], "VAE")

    # the fused epoch: this rank's columns of each row of sample indices
    store = FrameStore.synthetic(n=4 * n + 8, height=HW, width=HW)
    ds = DeviceDataset(store, batch_size=B, frame_skip=4, sharding=batch_sharding(mesh),
                       device=dev)
    order = torch.as_tensor(np.stack([ds.epoch_indices()[:B]] * 2), dtype=torch.int64,
                            device=dev)
    _, _, fmetrics = make_fused_epoch(bc_loss_fn, ds.pure_batch, sharding=ds.sharding)(
        state, order, gen(0))
    out["fused_epoch_loss"] = _finite(fmetrics["loss"][-1], "fused-epoch")

    # the sharded fleet: the env axis split over 'data'
    town = make_town(blocks=2, n_buildings=4, n_lights=2).to(dev)
    sim_params = SimParams(n_agents=2)
    rcfg = RenderConfig(FLEET_HW, FLEET_HW, max_triangles=192)
    policy = state.model

    def policy_fn(obs):
        return policy(obs).argmax(-1)

    init_fn, rollout_fn = make_rollout(sim_params, town, rcfg, policy_fn, device=dev,
                                       mesh=mesh)
    carry = init_fn(gen(2), B)
    if carry[0].ego_pos.shape[0] != B // n:
        raise RuntimeError(f"env axis not sharded: {carry[0].ego_pos.shape[0]} envs "
                           f"on a rank of {n}")
    out["local_envs"] = int(carry[0].ego_pos.shape[0])
    _, traj = rollout_fn(carry, 2)
    out["rollout_steps"] = _global_count(mesh, traj["speed"].numel())

    # the goal-directed fleet: nav tables replicated, each env's goal on its rank
    nav_town = make_town(blocks=2, n_buildings=4, n_lights=2, superblocks=True,
                         turn_fans=True)
    nav_town = plan_to_goals(nav_town, sample_goals(nav_town, 0, 2)).to(dev)
    ginit, grollout = make_rollout(sim_params, nav_town, rcfg, None, device=dev, mesh=mesh)
    gcarry = assign_goals(ginit(gen(4), B), (np.arange(B) % 2)[mesh.rows(B)])
    _, gtraj = grollout(gcarry, 2)
    out["goal_rollout_steps"] = _global_count(mesh, gtraj["arrived"].numel())

    # PPO: the stochastic actor's rollout and one update, both sharded
    pstate = create_train_state(ActorCriticCNN(dtype=torch.float32),
                                AdamConfig(schedule=lambda count: 3e-4), generator=gen(0),
                                device=dev)
    _, hist = ppo_train(sim_params, town, rcfg, pstate, gen(3), n_envs=B, rollout_steps=4,
                     iterations=1, cfg=PPOConfig(update_epochs=1, num_minibatches=2),
                     device=dev, mesh=mesh)
    out["ppo_loss"] = _finite(hist[-1]["loss"], "PPO")

    # online DAgger: the (R, T, B) buffer and every batch on the env axis
    dstate = replicated(PolicyCNN(dtype=torch.float32))
    drun = make_online_dagger(lambda module, obs: module(obs), sim_params, town, rcfg,
                              n_envs=B, n_steps=6, rounds=2, train_steps=2, batch=B,
                              mesh=mesh, device=dev)
    _, dmetrics = drun(dstate, gen(5))
    out["dagger_online_loss"] = _finite(dmetrics["loss"][-1], "online-DAgger")

    # the world model's step, then the imagination update on a sharded z0
    wstate = replicated(LatentWorldModel(z_size=16, height=FLEET_HW, width=FLEET_HW,
                                         hidden_size=32, dtype=torch.float32))
    wseq = torch.zeros((B, 4, FLEET_HW, FLEET_HW, 1), device=dev)
    wact = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    _, wmetrics = make_train_step(world_model_loss_fn())(
        wstate, shard_batch(mesh, (wseq, wact)), gen(0))
    out["wm_loss"] = _finite(wmetrics["loss"], "world-model")

    head = init_module(RewardHead(16), gen(0)).to(dev)
    lpol = init_module(LatentPolicy(16, n_actions=9), gen(0)).to(dev)
    for t in [*head.state_dict().values(), *lpol.state_dict().values()]:
        mesh.broadcast_(t)
    opt = torch.optim.Adam(lpol.parameters(), lr=3e-4, betas=ADAM_BETAS, eps=ADAM_EPS)
    upd = make_imagination_update(wstate.model, head, lpol, opt, horizon=4, mesh=mesh)
    z0 = torch.zeros((B, 16), device=dev)[mesh.rows(B)]
    imetrics = upd(z0, gen(6))
    out["imag_loss"] = _finite(imetrics["loss"], "imagination")
    out["launches"] = launch_counts()
    return out


def ok_line(n_devices: int, res: dict, mesh_desc: str) -> str:
    """The JAX dry run's closing line, with the same keys."""
    return (f"dryrun_multichip({n_devices}) ok: bc_loss={res['bc_loss']:.4f}, "
            f"vae_loss={res['vae_loss']:.4f}, fused_epoch_loss={res['fused_epoch_loss']:.4f}, "
            f"rollout_steps={res['rollout_steps']}, "
            f"goal_rollout_steps={res['goal_rollout_steps']}, "
            f"ppo_loss={res['ppo_loss']:.4f}, dagger_online_loss={res['dagger_online_loss']:.4f}, "
            f"wm_loss={res['wm_loss']:.4f}, imag_loss={res['imag_loss']:.4f}, mesh={mesh_desc}")


def _rank_main(rank: int, n: int, port: int, device_type: str, backend: str, threads: int,
               out_dir: str) -> None:
    """One rank of the dry run: join the group, run ``_dryrun_work`` over a
    ``{"data": n, "model": 1}`` mesh, save its figures; rank 0 prints."""
    import torch.distributed as dist

    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh, multihost_initialize

    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    multihost_initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=n,
                         process_id=rank, backend=backend, device=device_type)
    try:
        mesh = make_mesh(axis_sizes={"data": n, "model": 1}, devices=device_type)
        res = _dryrun_work(mesh)
        if rank == 0:
            print(ok_line(n, res, f"{mesh.shape} over {backend} on {mesh.device.type}"),
                  flush=True)
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """One step of every family over a ``data`` mesh of ``n_devices`` ranks
    (BC, the VAE, the fused epoch, the sharded fleet, the goal-directed
    fleet, PPO, online DAgger, the world model, the imagination update):
    NCCL ranks one a card when ``device`` is CUDA and the machine has
    ``n_devices`` cards, else gloo ranks (sharing the cards, or on the CPU).
    The kernels are built once here, before the ranks start. Each rank
    asserts finite losses and rank 0 prints the JAX dry run's line. A
    rank's failure raises here. → rank 0's figures (global means and
    counts) with ``ranks``, every rank's (its ``launches`` among them)."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= n_devices
    if dev.type == "cuda":
        from carla_imitation_learning_tpu_torch.ops import cuda_lib

        cuda_lib.build()
    threads = max(1, torch.get_num_threads() // n_devices)
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        mp.spawn(_rank_main, args=(n_devices, _free_port(), dev.type,
                                   "nccl" if nccl else "gloo", threads, tmp),
                 nprocs=n_devices, join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(n_devices)]
    return {**ranks[0], "backend": "nccl" if nccl else "gloo", "ranks": ranks}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m carla_imitation_learning_tpu_torch.graft_entry",
        description="the multi-device dry run, then the flagship forward")
    parser.add_argument("n_devices", nargs="?", type=int, default=8,
                        help="ranks of the dry run's data mesh (default 8)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry() ok:", tuple(out.shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())
