"""Rank side of the port's data-parallel tests: ``spawn`` starts one group
of gloo ranks on the CPU (``torch.multiprocessing``, spawned, one intra-op
thread a rank) that runs one named job on inputs the test process saved,
and hands back each rank's results. This module imports the port and
never JAX, so the ranks run the port alone; the test process compares.

A job is ``fn(rank, job) -> dict``: ``job`` is the dict the test saved
with ``torch.save``; what the function returns is saved per rank.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import socket
from pathlib import Path

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job_name: str, job: dict, tmp_path: Path, world: int = 2) -> list:
    """Run ``job_name`` on ``world`` gloo ranks; → [rank 0's result, ...]."""
    import torch.multiprocessing as mp

    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(job, tmp_path / "job.pt")
    mp.spawn(_rank_main, args=(world, _free_port(), job_name, str(tmp_path)),
             nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, port: int, job_name: str, tmp: str) -> None:
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    from carla_imitation_learning_tpu_torch.parallel.mesh import multihost_initialize

    multihost_initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                         process_id=rank, backend="gloo", device="cpu")
    try:
        job = torch.load(Path(tmp) / "job.pt", weights_only=False)
        out = JOBS[job_name](rank, job)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class Cfg(dict):
    """A config with the dotted lookup ``maybe_mesh`` reads."""

    def get_dotted(self, key, default=None):
        return self.get(key, default)


@contextlib.contextmanager
def collectives(log: list):
    """Record every ``all_reduce`` and ``broadcast`` as (name, bytes)."""
    saved = dist.all_reduce, dist.broadcast

    def wrap(name, fn):
        def call(tensor, *a, **kw):
            log.append((name, tensor.numel() * tensor.element_size()))
            return fn(tensor, *a, **kw)
        return call

    dist.all_reduce, dist.broadcast = wrap("all_reduce", saved[0]), wrap("broadcast", saved[1])
    try:
        yield log
    finally:
        dist.all_reduce, dist.broadcast = saved


def loss_from_spec(spec):
    """A port loss function from (name in ``training.losses``, factory
    arguments or None for the function itself)."""
    from carla_imitation_learning_tpu_torch.training import losses

    name, args = spec
    fn = getattr(losses, name)
    return fn if args is None else fn(*args)


def _sharded_step(model, loss_spec, batch, tx_cfg, mesh, eps=None, audit=None):
    """One sharded train step of a copy of ``model`` → (metrics, state dict)."""
    from carla_imitation_learning_tpu_torch.models import vae as p_vae
    from carla_imitation_learning_tpu_torch.parallel.mesh import shard_batch, shard_train_state
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    state = shard_train_state(mesh, create_train_state(
        copy.deepcopy(model), make_optimizer(tx_cfg, 1), device="cpu"))
    local = shard_batch(mesh, batch)
    draw = p_vae.draw_noise
    if eps is not None:   # the JAX step's reparameterisation noise, global batch
        p_vae.draw_noise = lambda gen, shape, device, dtype: eps
    try:
        step = make_train_step(loss_from_spec(loss_spec))
        with collectives(audit if audit is not None else []):
            _, metrics = step(state, local, torch.Generator().manual_seed(0))
    finally:
        p_vae.draw_noise = draw
    return ({k: v.item() for k, v in metrics.items()},
            {k: v.clone() for k, v in state.model.state_dict().items()})


def loader_batches(store, sharding=None) -> dict:
    """Every batch of an epoch of the BC, sequence and VAE loaders over
    ``store`` (batch 8, shuffled from seed 3; a last BC batch of 5 rows)."""
    from carla_imitation_learning_tpu_torch.data import pipeline as pipe
    from carla_imitation_learning_tpu_torch.data import vae_data

    bc = pipe.DeviceDataset(store, 8, frame_skip=2, shuffle=True, seed=3, drop_last=False,
                            sharding=sharding, device="cpu")
    seq = pipe.SequenceDataset(store, 8, seq_len=4, seed=3, sharding=sharding, device="cpu")
    img = vae_data.ImageDataset(store.frames, 8, shuffle=True, seed=3, sharding=sharding,
                                device="cpu")
    return {"bc": list(bc), "seq": list(seq), "img": list(img)}


def mesh_checks(rank: int, job: dict) -> dict:
    """Wildcard, divisibility, the sharded BC step, every family's sharded
    step and the collective audit of a train step and of a rollout."""
    from carla_imitation_learning_tpu_torch.parallel.mesh import (
        batch_sharding, make_mesh, maybe_mesh, replicated_sharding,
    )
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl

    out = {"wildcard": make_mesh(axis_sizes={"data": -1, "model": 1}, devices="cpu").shape,
           "fixed": make_mesh(axis_sizes={"data": 2}, devices="cpu").shape}
    try:
        make_mesh(axis_sizes={"data": 4}, devices="cpu")
        out["too_large"] = None
    except ValueError as e:
        out["too_large"] = str(e)
    cfg = Cfg(device="cpu")
    out["maybe"] = [maybe_mesh(cfg, batch_size=16) is not None,
                    maybe_mesh(cfg, batch_size=15) is None, maybe_mesh(cfg) is not None]
    mesh = make_mesh(axis_sizes={"data": 2, "model": 1}, devices="cpu")
    out["rows"] = (mesh.rank(), mesh.rows(16), batch_sharding(mesh).rows(8),
                   replicated_sharding(mesh).mesh is mesh)

    out["loaders"] = loader_batches(job["store"], batch_sharding(mesh))

    bc = job["bc_step"]
    out["bc_step"] = _sharded_step(bc["model"], bc["loss"], bc["batch"], bc["tx"], mesh)
    out["families"] = {}
    for name, fam in job["families"].items():
        audit = []
        out["families"][name] = _sharded_step(fam["model"], fam["loss"], fam["batch"],
                                              job["family_tx"], mesh, fam.get("eps"), audit)
        out.setdefault("audit", {})[name] = audit

    ro = job["rollout"]
    init_fn, rollout_fn = cl.make_rollout(ro["params"], ro["town"], ro["rcfg"], None,
                                          device="cpu", mesh=mesh, noise=ro["noise"])
    carry = init_fn(torch.Generator().manual_seed(0), ro["n_envs"])
    plain_init, plain_roll = cl.make_rollout(ro["params"], ro["town"], ro["rcfg"], None,
                                             device="cpu", mesh=mesh)
    with collectives([]) as step_log:
        carry, _ = plain_roll(carry, 1)
    with collectives([]) as roll_log:
        _, traj = rollout_fn(carry, 3)
        metrics = cl.driving_metrics(ro["params"], traj, mesh)
    out["rollout_audit"] = {"step": step_log, "rollout": roll_log,
                            "env_steps": metrics["env_steps"]}
    return out


def rollout_checks(rank: int, job: dict) -> dict:
    """The sharded rollout from a seed and from a given global carry, a
    sharded evaluation, and ``run bc`` through the CLI."""
    from carla_imitation_learning_tpu_torch import cli
    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl

    mesh = make_mesh(axis_sizes={"data": 2}, devices="cpu")
    ro = job["rollout"]
    out = {}
    init_fn, rollout_fn = cl.make_rollout(ro["params"], ro["town"], ro["rcfg"], None,
                                          spawn_pool=ro["pool"], device="cpu", mesh=mesh)
    carry = init_fn(torch.Generator().manual_seed(0), ro["n_envs"])
    _, traj = rollout_fn(carry, ro["n_steps"])
    out["seeded"] = {k: traj[k] for k in ("speed", "action")}
    _, traj = rollout_fn(shard_batch(mesh, ro["carry"]), ro["n_steps"])
    out["from_carry"] = {k: traj[k] for k in ("speed", "action")}
    out["eval"] = cl.evaluate_policy(ro["params"], ro["town"], ro["rcfg"], None,
                                     torch.Generator().manual_seed(1), n_envs=8, n_steps=10,
                                     device="cpu", mesh=mesh)

    argv = list(job["bc_argv"]) + ["-o", f"log_dir={job['log_root']}/rank{rank}"]
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert cli.main(argv) == 0
    out["bc"] = json.loads(stdout.getvalue()) if stdout.getvalue() else None
    return out


JOBS = {"mesh_checks": mesh_checks, "rollout_checks": rollout_checks}
