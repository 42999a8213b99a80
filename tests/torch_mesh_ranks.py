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
        if dist.is_initialized():    # a failed sharded engine took it down already
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


@contextlib.contextmanager
def patched(*triples):
    """Set ``(obj, name, value)`` attributes for the block, then restore them."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    for obj, name, value in triples:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def pattern_renderer(hw: int):
    """A stand-in renderer computed in exact integer arithmetic from the
    state's step counter and route (``tests/test_torch_online_dagger.py``'s),
    as ``make_renderer``'s replacement."""
    def make(params, town, rcfg, device):
        ar = torch.arange(hw)

        def render(states):
            g = (ar[None, :, None] * 3 + ar[None, None, :] * 5
                 + (states.t * 7 + states.ego_route * 11)[:, None, None]) % 256
            return {"gray": g.to(torch.float32) / 255.0}

        return render

    return make


def run_online(job: dict, case: str, mesh) -> dict:
    """One online-DAgger run of ``job["cases"][case]`` on ``mesh`` (None:
    unsharded, in one process) from the job's initial weights → metrics,
    final parameters, every train step's windows (obs, labels, weights of
    this rank's rows) and its reduced gradient (flat).

    A case may inject the JAX package's draws (``states``, the first fleet;
    ``indices``, the global window indices of every step in order; ``pool``)
    and the pattern renderer (``pattern``), and may zero the weights of
    the first half of the global fleet's windows that end on an odd step
    (``unequal``), so that the ranks' weight sums differ."""
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training import online_dagger as p_od
    from carla_imitation_learning_tpu_torch.training import steps

    c = job["cases"][case]
    n_envs = job["n_envs"]
    offset = 0 if mesh is None else mesh.rank() * (n_envs // mesh.size())
    state = steps.create_train_state(PolicyCNN(dtype=torch.float32),
                                     steps.make_optimizer(job["cfg"]), device="cpu")
    state.model.load_state_dict(job["state_dict"])
    windows, grads = [], []
    gather, clip = p_od.gather_windows_at, steps.clip_by_global_norm_

    def gather_spy(frames, labels, dones, r_i, t_i, frame_skip, extras=()):
        obs, y, w, *ex = gather(frames, labels, dones, r_i, t_i, frame_skip, extras)
        if c.get("unequal"):
            env = offset + torch.arange(r_i.shape[0])[:, None].expand_as(t_i).reshape(-1)
            w = torch.where((env < n_envs // 2) & (t_i.reshape(-1) % 2 == 1), 0.0, w)
        windows.append((obs.clone(), y.clone(), w.clone()))
        return (obs, y, w, *ex)

    def clip_spy(gs, max_norm):
        grads.append(torch.cat([g.reshape(-1) for g in gs]).clone())
        clip(gs, max_norm)

    patches = [(p_od, "gather_windows_at", gather_spy), (steps, "clip_by_global_norm_", clip_spy)]
    if "states" in c:
        patches.append((p_od, "reset_env", lambda params, town, gen, n: c["states"]))
    if "indices" in c:
        queue = list(c["indices"])
        patches.append((p_od, "window_indices", lambda *a: queue.pop(0)))
    if "pool" in c:
        patches.append((p_od, "rollout_spawn_pool", lambda params, town: c["pool"]))
    if c.get("pattern"):
        patches.append((p_od, "make_renderer", pattern_renderer(job["rcfg"].height)))
    with patched(*patches):
        run = p_od.make_online_dagger(PolicyCNN.__call__, job["params"], job["town"],
                                      job["rcfg"], n_envs=n_envs, n_steps=job["n_steps"],
                                      rounds=job["rounds"], train_steps=job["train_steps"],
                                      batch=job["batch"], beta=c.get("beta", 0.0),
                                      mesh=mesh, device="cpu")
        state, metrics = run(state, torch.Generator().manual_seed(c.get("seed", 0)))
    return {"metrics": metrics, "step": state.step, "windows": windows, "grads": grads,
            "params": {k: v.clone() for k, v in state.model.state_dict().items()}}


def _cli_json(argv: list):
    """``cli.main(argv)``'s printed result (None where it printed nothing)."""
    from carla_imitation_learning_tpu_torch import cli

    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert cli.main(argv) == 0
    return json.loads(stdout.getvalue()) if stdout.getvalue() else None


def online_dagger_checks(rank: int, job: dict) -> dict:
    """Every case of ``run_online`` over a ``data`` mesh of two, then
    ``run dagger_online`` through the CLI with ``mesh.enabled=true``."""
    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(axis_sizes={"data": 2}, devices="cpu")
    out = {case: run_online(job, case, mesh) for case in job["cases"]}
    out["cli"] = _cli_json(list(job["cli_argv"]) +
                           ["-o", f"log_dir={job['log_root']}/rank{rank}"])
    return out


def _ppo_state(job: dict, state_dict: dict, continuous: bool = False):
    from carla_imitation_learning_tpu_torch.training import rl
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state,
    )

    cfg = rl.PPOConfig(**job["ppo"])
    model = rl.ActorCriticCNN(dtype=torch.float32, continuous=continuous)
    model.load_state_dict(state_dict)
    return create_train_state(model, AdamConfig(schedule=lambda c: cfg.learning_rate,
                                                clip=cfg.max_grad_norm), device="cpu"), cfg


def run_ppo(job: dict, mesh) -> dict:
    """One ``ppo_train`` iteration (a rollout and an update) on ``mesh``
    (None: unsharded) from the job's weights and seed → the rollout's
    actions, the normalised advantages (this rank's columns), the history
    and the parameters."""
    from carla_imitation_learning_tpu_torch.training import rl

    state, cfg = _ppo_state(job, job["state_dict"])
    seen = {"actions": [], "adv": [], "raw_adv": [], "values": []}
    make_update, normalize = rl.make_ppo_update, rl.normalize_advantages

    def make_update_spy(state, cfg, frame_skip):
        update = make_update(state, cfg, frame_skip)

        def spy(traj, last_value, generator):
            seen["actions"].append(traj["action"].clone())
            seen["values"].append(traj["policy_extra"][..., -1].clone())
            return update(traj, last_value, generator)

        return spy

    def normalize_spy(adv, mesh=None):
        seen["raw_adv"].append(adv.clone())
        out = normalize(adv, mesh)
        seen["adv"].append(out.clone())
        return out

    with patched((rl, "make_ppo_update", make_update_spy),
                 (rl, "normalize_advantages", normalize_spy)):
        state, history = rl.ppo_train(job["params"], job["town"], job["rcfg"], state,
                                      torch.Generator().manual_seed(job["seed"]),
                                      n_envs=job["n_envs"], rollout_steps=job["steps"],
                                      iterations=1, cfg=cfg, device="cpu", mesh=mesh)
    return {**{k: v[0] for k, v in seen.items()}, "history": history,
            "params": {k: v.clone() for k, v in state.model.state_dict().items()}}


def ppo_jax_update(job: dict, mesh) -> dict:
    """``make_ppo_update`` on this rank's columns of the JAX-made trajectory
    of ``job["jax"]``, its epoch permutations (global) injected → metrics
    and parameters."""
    from carla_imitation_learning_tpu_torch.parallel.mesh import shard_train_state
    from carla_imitation_learning_tpu_torch.training import rl

    j = job["jax"]
    state, cfg = _ppo_state(job, j["state_dict"])
    state = shard_train_state(mesh, state)
    rows = mesh.rows(j["last_value"].shape[0])
    perms = iter(j["perms"])
    with patched((rl, "epoch_permutations",
                  lambda gen, n_envs, n_steps, device: torch.from_numpy(next(perms)))):
        metrics = rl.make_ppo_update(state, cfg, 4)(
            {k: v[:, rows] for k, v in j["traj"].items()}, j["last_value"][rows], None)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.clone() for k, v in state.model.state_dict().items()}}


def ppo_checks(rank: int, job: dict) -> dict:
    """``run_ppo`` and ``ppo_jax_update`` over a ``data`` mesh of two, then
    ``run rl_finetune`` through the CLI with ``mesh.enabled=true``."""
    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(axis_sizes={"data": 2}, devices="cpu")
    return {"ppo": run_ppo(job, mesh), "jax": ppo_jax_update(job, mesh),
            "cli": _cli_json(list(job["cli_argv"]) +
                             ["-o", f"log_dir={job['log_root']}/rank{rank}"])}


def _post(url: str, body: bytes, headers: dict) -> tuple:
    """(status, JSON answer) of a POST, errors included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _octet(frames, **extra) -> dict:
    return {"Content-Type": "application/octet-stream",
            "X-Shape": ",".join(str(d) for d in frames.shape), **extra}


def serving_checks(rank: int, job: dict) -> dict:
    """Sharded serving over a ``data`` mesh of two: rank 0 builds the
    ladders, infers through a sharded engine, stops it, then serves the
    artifact over HTTP (warmed up) and asks for the actions of 5 frames,
    then serves the CIL artifact and asks for the logits of 4 frames with
    out-of-range commands and again with valid ones, then serves a policy
    that raises on rank 1's rows of a poisoned request (every pixel 255)
    and asks twice and for ``/healthz``; rank 1 follows every engine, the
    last until it raises. → each rank's rows per forward (rank 1's also
    those of the server's chunks), rank 0's ladders, logits and HTTP
    answers, rank 1's error."""
    import urllib.error
    import urllib.request

    import numpy as np

    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh
    from carla_imitation_learning_tpu_torch.serving import (
        InferenceEngine, PolicyServer, load_policy,
    )

    mesh = make_mesh(axis_sizes={"data": 2}, devices="cpu")
    policy = load_policy(job["artifact"], "cpu")
    rows = []

    def counting(*args):
        rows.append(int(args[0].shape[0]))
        return policy(*args)

    def poisoned(*args):
        if bool((args[0].flatten(1).amin(1) == 255).any()):
            raise ValueError("a poisoned row")
        return policy(*args)

    out = {"rows": rows}
    if rank != 0:
        InferenceEngine(counting, max_batch=32, mesh=mesh, device="cpu").follow()
        InferenceEngine(counting, max_batch=16, mesh=mesh, device="cpu").follow()
        InferenceEngine(load_policy(job["cil_artifact"], "cpu"), max_batch=8, mesh=mesh,
                        device="cpu").follow()
        try:
            InferenceEngine(poisoned, max_batch=4, mesh=mesh, device="cpu").follow()
        except ValueError as e:
            out["follow_error"] = str(e)
        return out
    out["ladders"] = [InferenceEngine(policy, max_batch=64, mesh=mesh, device="cpu").buckets,
                      InferenceEngine(policy, buckets=(3, 20), mesh=mesh, device="cpu").buckets]
    engine = InferenceEngine(counting, max_batch=32, mesh=mesh, device="cpu")
    out["logits"] = {b: engine.infer_logits(f) for b, f in job["frames"].items()}
    engine.stop()
    frames = np.asarray(job["http_frames"])
    with PolicyServer(job["artifact"], max_batch=16, window_ms=1.0, mesh=mesh,
                      device="cpu") as server:
        server.warmup()
        req = urllib.request.Request(
            server.url + "/v1/infer", data=frames.tobytes(), method="POST",
            headers=_octet(frames))
        out["http"] = json.loads(urllib.request.urlopen(req, timeout=60).read())
        out["server_buckets"] = server.engine.buckets
    cil = np.asarray(job["cil_frames"])
    with PolicyServer(job["cil_artifact"], max_batch=8, window_ms=1.0, mesh=mesh,
                      device="cpu") as server:
        out["cil"] = [_post(server.url + "/v1/logits", cil.tobytes(), _octet(
            cil, **{"X-Speed": ",".join(map(str, job["cil_speed"])),
                    "X-Command": ",".join(map(str, cmd))}))
            for cmd in job["cil_commands"]]
    bad = np.concatenate([frames[:2], np.full_like(frames[:2], 255)])
    with PolicyServer(poisoned, max_batch=4, window_ms=1.0, mesh=mesh,
                      device="cpu") as server:
        out["poisoned"] = [_post(server.url + "/v1/infer", f.tobytes(), _octet(f))[0]
                           for f in (bad, frames[:2])]
        try:
            urllib.request.urlopen(server.url + "/healthz", timeout=60)
        except urllib.error.HTTPError as e:
            out["healthz"] = e.code
        out["engine_failed"] = repr(server.engine.failed)
    return out


IMAG_Z, IMAG_BATCH = 16, 8


def imagination_run(case: str, mesh=None) -> dict:
    """One ``make_imagination_update`` step from seeded weights on rows of
    a global batch of IMAG_BATCH latents (this rank's under ``mesh``; None:
    one process over the whole batch) → its metrics and the policy's
    weights after Adam. ``discrete``: a GRU world model's Gumbel actions, a
    single head, horizon 5. ``continuous``: its normal exploration noise, a
    3-head ensemble with the disagreement penalty, the uncertainty stop and
    the anchor, horizon 4."""
    from carla_imitation_learning_tpu_torch.models import LatentWorldModel
    from carla_imitation_learning_tpu_torch.training import imagination as imag
    from carla_imitation_learning_tpu_torch.training.steps import ADAM_BETAS, ADAM_EPS

    continuous = case == "continuous"
    init = torch.Generator().manual_seed(11)
    wm = imag.init_module(LatentWorldModel(
        z_size=IMAG_Z, rnn="gru", height=32, width=32, hidden_size=32, dtype=torch.float32,
        action_space="continuous" if continuous else "discrete"), init)
    policy_cls = imag.ContinuousLatentPolicy if continuous else imag.LatentPolicy
    policy = imag.init_module(policy_cls(IMAG_Z), init)
    kw = {"horizon": 5}
    if continuous:
        heads = [imag.init_module(imag.RewardHead(IMAG_Z), init) for _ in range(3)]
        head = imag.HeadEnsemble(heads)
        kw = {"horizon": 4, "disagree_coef": 1.0, "anchor": imag.init_module(
            policy_cls(IMAG_Z), init).requires_grad_(False), "anchor_coef": 0.3,
            "uncertainty_stop": 0.05}
    else:
        head = imag.init_module(imag.RewardHead(IMAG_Z), init)
    opt = torch.optim.Adam(policy.parameters(), lr=3e-4, betas=ADAM_BETAS, eps=ADAM_EPS)
    update = imag.make_imagination_update(wm, head, policy, opt, mesh=mesh, **kw)
    z0 = torch.randn((IMAG_BATCH, IMAG_Z), generator=torch.Generator().manual_seed(12))
    if mesh is not None:
        z0 = z0[mesh.rows(IMAG_BATCH)]
    metrics = update(z0, torch.Generator().manual_seed(13))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().clone() for k, v in policy.state_dict().items()}}


def imagination_checks(rank: int, job: dict) -> dict:
    """``imagination_run`` of every case over a ``data`` mesh of two."""
    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(axis_sizes={"data": 2}, devices="cpu")
    return {case: imagination_run(case, mesh) for case in job["cases"]}


JOBS = {"mesh_checks": mesh_checks, "rollout_checks": rollout_checks,
        "serving_checks": serving_checks, "imagination_checks": imagination_checks,
        "online_dagger_checks": online_dagger_checks, "ppo_checks": ppo_checks}
