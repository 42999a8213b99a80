"""Named experiments (the JAX package's ``experiments.py``, the part that
the file-backed BC path runs). Each is ``fn(cfg, **kw) -> result dict``;
the CLI dispatches by name.

- ``split_folders``: sequential 80/10/10 split of a raw log;
- ``bc``: behaviour cloning per camera from the processed split, with
  best-k checkpoints (a CARLA-contract log is synthesized when ``data_dir``
  has none);
- ``test_eval``: accuracy of a checkpoint on each split, with the
  predictions dump and the histogram plot;
- ``collect_data``: expert collection on the card, written as a raw log
  (PNG frames and state.csv) and as a packed frame store;
- ``bc_streaming``: BC over the packed store, ``tier=direct`` (the store's
  frames copied to the card once, windows gathered there) or ``tier=host``
  (the C++ prefetcher and ``device_prefetch``);
- ``closed_loop_eval``: driving metrics of a checkpoint's policy and of the
  expert, rendered by kernel B;
- ``scenario_eval``: the same two scores under each named world and
  weather condition of ``SCENARIOS`` (rain, night, busy streets, multi-lane
  towns with lane changes, junction turn fans).

Everything runs on ``cfg.device`` (default ``"cuda"``; ``-o device=cpu``
runs the plain versions on the CPU). Options that wait for unported modules
raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import inspect
import time
from pathlib import Path

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.callbacks import (
    SaveBestMetricScores, SaveConfusionMatrix, SaveMetricsHeatmap,
)
from carla_imitation_learning_tpu_torch.data import frame_log as fl
from carla_imitation_learning_tpu_torch.data import pipeline as pipe
from carla_imitation_learning_tpu_torch.data import stats as stats_lib
from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.models.cnn import PolicyCNN
from carla_imitation_learning_tpu_torch.native import (
    DeviceShardStreamer, NativeFrameStore, PrefetchReader, save_framestore,
)
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.town import make_town_from_cfg
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as cl
from carla_imitation_learning_tpu_torch.training.loop import Trainer
from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
from carla_imitation_learning_tpu_torch.training.steps import (
    create_train_state, flax_init_, make_optimizer, make_train_step,
)
from carla_imitation_learning_tpu_torch.utils.checkpoint import (
    BestKCheckpointManager, restore_params, restore_pytree,
)
from carla_imitation_learning_tpu_torch.utils.logging import MetricLogger

EXPERIMENTS = {}


def experiment(name):
    """Register an experiment. Every keyword default of the function can be
    set from the config: a top-level key of the same name overrides it
    (explicit call-site keywords still win), cast to the default's type."""

    def deco(fn):
        sig = inspect.signature(fn)
        knobs = [p for p in sig.parameters.values()
                 if p.default is not inspect.Parameter.empty
                 and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]

        @functools.wraps(fn)
        def wrapper(cfg, *args, **kwargs):
            for p in knobs:
                if p.name in kwargs:
                    continue
                v = cfg.get(p.name) if hasattr(cfg, "get") else None
                if v is None:
                    continue
                d = p.default
                if isinstance(d, bool):
                    v = bool(v)
                elif isinstance(d, int):
                    v = int(v)
                elif isinstance(d, float):
                    v = float(v)
                elif isinstance(d, tuple):
                    v = tuple(v) if isinstance(v, (list, tuple)) else (v,)
                kwargs[p.name] = v
            return fn(cfg, *args, **kwargs)

        EXPERIMENTS[name] = wrapper
        return wrapper

    return deco


def _device(cfg) -> torch.device:
    return resolve_device(str(cfg.get("device", "cuda")))


def _dtype(cfg) -> torch.dtype:
    return (torch.bfloat16 if str(cfg.get("compute_dtype", "bfloat16")) == "bfloat16"
            else torch.float32)


def _generator(cfg) -> torch.Generator:
    return torch.Generator().manual_seed(int(cfg.get("seed", 0)))


def _flag(cfg, key: str, default: bool = False) -> bool:
    """Bool config value that reads CLI spellings: ``false``/``no``/``off``/
    ``0``/empty are False (an override's value arrives as a string unless
    it parses as a Python literal)."""
    v = cfg.get_dotted(key, default) if hasattr(cfg, "get_dotted") else cfg.get(key, default)
    if isinstance(v, str):
        return v.strip().lower() not in ("0", "false", "no", "off", "")
    return bool(v)


def _not_ported(option: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet (ROADMAP Queue 1, item {item})")


def _check_one_device(cfg) -> None:
    """The port runs on one device: a mesh that asks for more raises."""
    axes = cfg.get_dotted("mesh.axes", {}) or {}
    if _flag(cfg, "mesh.enabled") or any(int(v) > 1 for v in axes.values()):
        raise _not_ported("a mesh over more than one device", 12)


def _trainer_bits(cfg, name: str):
    """Trainer with the JSONL / CSV / TensorBoard logger, the best-k
    manager under ``<log_dir>/<name>/ckpt`` and the per-class callbacks."""
    log_dir = Path(cfg["log_dir"])
    logger = MetricLogger(log_dir, name)
    ck = cfg.get_dotted("trainer.checkpoint", {})
    ckpt = BestKCheckpointManager(
        log_dir / name / "ckpt", monitor=ck.get("monitor", "val_loss"),
        mode=ck.get("mode", "min"), save_top_k=int(ck.get("save_top_k", 1)),
        save_last=bool(ck.get("save_last", False)), filename=name)
    n_actions = int(cfg.get("n_actions", 9))
    callbacks = [SaveBestMetricScores(),
                 SaveMetricsHeatmap(n_actions, out_dir=str(log_dir / name)),
                 SaveConfusionMatrix(n_actions, out_dir=str(log_dir / name))]
    trainer = Trainer(cfg, logger=logger, callbacks=callbacks,
                      checkpoint_manager=ckpt, name=name, device=_device(cfg))
    return trainer, ckpt


def _fit(cfg, name, model, loss_fn, loaders):
    """Initial state (flax's initializer from ``seed``, or
    ``resume_checkpoint``'s payload) → ``Trainer.fit`` → test metrics."""
    spe = max(1, len(loaders["train_dataloader"]))
    state = create_train_state(model, make_optimizer(cfg, steps_per_epoch=spe),
                               generator=_generator(cfg),
                               ema_decay=float(cfg.get("EMA_DECAY", 0.0)),
                               device=_device(cfg))
    resume = cfg.get("resume_checkpoint")
    if resume:
        state.load_payload(restore_pytree(resume))
    trainer, _ = _trainer_bits(cfg, name)
    try:
        result = trainer.fit(state, loss_fn, loaders, max_epochs=int(
            cfg.get("NUM_EPOCHS", cfg.get_dotted("trainer.max_epochs", 1))))
        test_metrics = trainer.test(result.state, loss_fn, loaders)
    finally:
        trainer.logger.close()
    return {
        "history": result.history, "throughput": result.throughput,
        "best_metric": result.best_metric, "best_path": result.best_path,
        "test": test_metrics, "state": result.state,
    }


def _maybe_synthesize(cfg, camera: str = "camera") -> None:
    """Without ``processed/<log>`` under ``data_dir``, write a synthetic
    raw log (``synthetic_frames`` frames of the configured size, cameras
    ``camera`` and ``semantic``) and split it."""
    data_dir = Path(cfg["data_dir"])
    log = cfg["train_logs"][0]
    if (data_dir / "processed" / log).exists():
        return
    n = int(cfg.get("synthetic_frames", 120))
    h = int(cfg.get("image_height", 256))
    fl.write_synthetic_log(data_dir, log=log, cameras=(camera, "semantic"),
                           n_frames=n, height=h, width=int(cfg.get("image_width", h)),
                           seed=int(cfg.get("data_seed", 1337)))
    fl.split_frames(data_dir / "raw" / log, data_dir / "processed" / log,
                    ratio=(0.8, 0.1, 0.1), shuffle=False)


def _discrete_policy_model(cfg, obs_size: int) -> PolicyCNN:
    """The discrete-family policy: the reference ConvNet1 shape."""
    arch = str(cfg.get("policy_arch", "cnn"))
    if arch == "vit":
        raise _not_ported("policy_arch=vit", 9)
    if arch != "cnn":
        raise ValueError(f"unknown policy_arch {arch!r} (want 'cnn' or 'vit')")
    if _flag(cfg, "s2d_stem"):
        raise _not_ported("s2d_stem", 3)
    return PolicyCNN(obs_size=obs_size, n_actions=int(cfg.get("n_actions", 9)),
                     dtype=_dtype(cfg))


@experiment("split_folders")
def split_folders(cfg, **kw):
    """Sequential 80/10/10 split of raw/<log> into processed/<log>."""
    data_dir = Path(cfg["data_dir"])
    log = cfg["train_logs"][0]
    counts = fl.split_frames(data_dir / "raw" / log, data_dir / "processed" / log,
                             ratio=(0.8, 0.1, 0.1), shuffle=False,
                             seed=int(cfg.get("data_seed", 1337)))
    return {"counts": counts}


@experiment("bc")
def behavior_cloning(cfg, cameras=("camera", "semantic"), **kw):
    """Behaviour cloning of the ConvNet1 policy, one run per camera."""
    cameras = tuple(cfg.get("bc_cameras", cameras))
    _check_one_device(cfg)
    if _flag(cfg, "augment"):
        raise _not_ported("augment", 7)
    results = {}
    for camera in cameras:
        cfg_c = cfg.copy()
        cfg_c["camera"] = camera
        _maybe_synthesize(cfg_c, camera)
        loaders = pipe.sequential_train_val_test_iterator(cfg_c, device=_device(cfg))
        model = _discrete_policy_model(cfg, int(cfg["obs_size"]))
        results[camera] = _fit(cfg_c, f"imitation_{camera}", model, bc_loss_fn, loaders)
    return results


@experiment("test_eval")
def test_eval(cfg, checkpoint: str | None = None, **kw):
    """Restore a checkpoint's params; accuracy on each split, the
    predictions dump of the val split and its histogram plot."""
    cfg_c = cfg.copy()
    cfg_c["camera"] = kw.get("camera", "camera")
    _maybe_synthesize(cfg_c, cfg_c["camera"])
    dev = _device(cfg)
    loaders = pipe.sequential_train_val_test_iterator(cfg_c, device=dev)
    model = flax_init_(_discrete_policy_model(cfg, int(cfg["obs_size"])),
                       torch.Generator().manual_seed(0)).to(dev)
    if checkpoint:
        model.load_state_dict(restore_pytree(checkpoint)["params"])
    acc = {split: stats_lib.calculate_accuracy(model, loaders, f"{split}_dataloader")
           for split in ("train", "val", "test")}
    out = Path(cfg["log_dir"]) / "predWlabels.npy"
    stats_lib.save_predictions(model, loaders["val_dataloader"], str(out))
    plot = stats_lib.sample_output_plot(
        model, loaders["val_dataloader"], str(Path(cfg["log_dir"]) / "sample_output.png"),
        n_classes=int(cfg.get("n_actions", 9)))
    return {"accuracy": acc, "predictions_file": str(out),
            "sample_output_plot": str(plot)}


def _sim_bits(cfg):
    town = make_town_from_cfg(cfg, seed=int(cfg.get("data_seed", 0)))
    return town, SimParams.from_cfg(cfg), RenderConfig.from_cfg(cfg)


def _noise_bits(cfg) -> "cl.NoiseConfig | None":
    """Collection noise (``noise_injection=true``; ``noise_prob``,
    ``noise_duration``, ``noise_magnitude`` override its defaults)."""
    if not _flag(cfg, "noise_injection"):
        return None
    return cl.NoiseConfig(
        prob=float(cfg.get("noise_prob", 0.005)),
        duration=int(cfg.get("noise_duration", 20)),
        magnitude=float(cfg.get("noise_magnitude", 0.6)),
        seed=int(cfg.get("seed", 0)))


@experiment("collect_data")
def collect_data(cfg, n_envs: int = 32, n_steps: int = 300, n_goals: int = 0, **kw):
    """Expert collection on the card, written as a raw log in the CARLA
    contract (PNG frames and state.csv) and as a packed frame store."""
    if n_goals > 0:
        raise _not_ported("n_goals > 0", 6)
    town, params, rcfg = _sim_bits(cfg)
    t0 = time.perf_counter()
    store, state_log, _ = cl.collect_dataset(
        params, town, rcfg, _generator(cfg), n_envs=n_envs, n_steps=n_steps,
        frame_skip=int(cfg.get("frame_skip", 4)), noise=_noise_bits(cfg),
        device=_device(cfg))
    t1 = time.perf_counter()
    data_dir = Path(cfg["data_dir"])
    log = kw.get("log_name", "SimLog1")
    fl.save_frames(data_dir / "raw" / log / "camera", store.frames)
    fl.save_state_csv(data_dir / "raw" / log / "state.csv", state_log)
    fl.save_state_csv(data_dir / "raw" / "state.csv", state_log)
    t2 = time.perf_counter()
    packed = save_framestore(data_dir / "raw" / log / "frames.tpuilfs", store)
    seconds = {"collect": t1 - t0, "png_and_csv_write": t2 - t1,
               "packed_write": time.perf_counter() - t2}
    return {"frames": len(store), "log": str(data_dir / "raw" / log),
            "framestore": str(packed), "seconds": seconds,
            "action_histogram": stats_lib.action_histogram(store.actions).tolist()}


@experiment("bc_streaming")
def bc_streaming(cfg, n_envs: int = 32, n_steps: int = 200, epochs: int = 2,
                 tier: str = "direct", **kw):
    """BC over the packed frame store of a fresh expert collection.

    ``tier="direct"``: the store's frames go to the card once
    (``DeviceShardStreamer``) and each batch's windows are gathered there,
    one train step per batch. ``tier="host"``: the C++ prefetcher gathers
    uint8 window batches on 4 host threads and ``device_prefetch`` copies
    them to the card two batches ahead of the train step."""
    if tier not in ("direct", "host"):
        raise ValueError(f"tier must be 'direct' or 'host', got {tier!r}")
    dev = _device(cfg)
    town, params, rcfg = _sim_bits(cfg)
    store, _, _ = cl.collect_dataset(params, town, rcfg, _generator(cfg), n_envs, n_steps,
                                     device=dev)
    path = Path(cfg["log_dir"]) / "stream.tpuilfs"
    save_framestore(path, store)

    batch = int(cfg.get("BATCH_SIZE", 64))
    fs = int(cfg.get("frame_skip", 4))
    seed = int(cfg.get("seed", 0))
    # the reader comes first: the LR milestones are in epochs, so the
    # optimizer needs the real number of batches per epoch
    nfs = None
    if tier == "direct":
        reader = DeviceShardStreamer(path, batch=batch, frame_skip=fs, shuffle=True,
                                     seed=seed, device=dev)
    else:
        nfs = NativeFrameStore(path)
        reader = PrefetchReader(nfs, batch=batch, frame_skip=fs, n_threads=4,
                                shuffle=True, seed=seed)
    state = create_train_state(_discrete_policy_model(cfg, fs),
                               make_optimizer(cfg, steps_per_epoch=max(1, len(reader))),
                               generator=_generator(cfg), device=dev)
    step = make_train_step(bc_loss_fn)
    n_images, epoch_walls, last = 0, [], None
    t0 = time.perf_counter()
    try:
        for _ in range(epochs):
            te = time.perf_counter()
            if tier == "direct":
                batches = reader
            else:
                batches = ((frames.permute(0, 2, 3, 1).to(torch.float32) / 255.0, labels)
                           for frames, labels in pipe.device_prefetch(reader, device=dev))
            for x, y in batches:
                state, last = step(state, (x, y))
                n_images += x.shape[0]
            if last is None:
                raise ValueError(f"bc_streaming: no full batch of {batch} windows; "
                                 "lower BATCH_SIZE or collect more frames")
            float(last["loss"])  # waits for the epoch's steps
            epoch_walls.append(time.perf_counter() - te)
    finally:
        if nfs is not None:
            nfs.close()
    wall = time.perf_counter() - t0
    out = {"frames": len(store), "epochs": epochs, "tier": tier,
           "final_loss": float(last["loss"]), "final_accuracy": float(last["accuracy"]),
           "images_per_sec_streaming": n_images / wall, "framestore": str(path)}
    if len(epoch_walls) > 1:
        out["images_per_sec_steady"] = (n_images / epochs) / (
            sum(epoch_walls[1:]) / (len(epoch_walls) - 1))
        out["first_epoch_seconds"] = epoch_walls[0]
    return out


def _policy_bits(cfg, checkpoint: str | None, height: int, width: int):
    """The discrete policy (flax's initializer from ``seed``, then the
    checkpoint's weights, EMA preferred) → (argmax policy_fn, model)."""
    family = str(cfg.get("policy_family", "discrete"))
    if family != "discrete":
        raise _not_ported(f"policy_family={family}", 5 if family == "continuous" else 6)
    if cfg.get("surround_cameras"):
        raise _not_ported("surround_cameras", 10)
    model = flax_init_(_discrete_policy_model(cfg, int(cfg.get("frame_skip", 4))),
                       _generator(cfg)).to(_device(cfg))
    if checkpoint:
        model.load_state_dict(restore_params(checkpoint, model.state_dict()))

    def policy_fn(obs):
        return model(obs).argmax(-1)

    return policy_fn, model


@experiment("closed_loop_eval")
def closed_loop_eval(cfg, checkpoint: str | None = None, artifact: str | None = None,
                     n_envs: int = 64, n_steps: int = 200, **kw):
    """Driving metrics of a checkpoint's policy and of the expert on the
    same initial fleet."""
    if artifact:
        raise _not_ported("artifact=", 11)
    if _flag(cfg, "safety_shield"):
        raise _not_ported("safety_shield", 8)
    _check_one_device(cfg)
    dev = _device(cfg)
    town, params, rcfg = _sim_bits(cfg)
    policy_fn, _ = _policy_bits(cfg, checkpoint, rcfg.height, rcfg.width)
    policy = cl.evaluate_policy(params, town, rcfg, policy_fn, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps, device=dev)
    expert = cl.evaluate_policy(params, town, rcfg, None, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps, device=dev)
    return {"policy": policy, "expert": expert}


# Named evaluation scenarios: config deltas over the composed config, so the
# caller's overrides (fleet size, small test shapes) survive.
SCENARIOS: dict[str, dict] = {
    "clear": {},
    "fog": {"render.fog_density": 0.04},              # ~115 m visibility
    "storm": {"render.fog_density": 0.02, "render.rain": 0.8},
    "night": {"render.sun": 0.2},
    "night_rain": {"render.sun": 0.25, "render.rain": 0.6},
    "busy": {"sim.n_pedestrians": 12, "sim.n_agents": 24},
    "multilane": {"sim.town.lanes_per_direction": 2,
                  "sim.town.superblocks": True,
                  "sim.lane_change_period": 120, "sim.lane_change_window": 12},
    "turns": {"sim.town.lanes_per_direction": 2, "sim.town.superblocks": True,
              "sim.town.turn_fans": True, "sim.turn_period": 80,
              "sim.agent_turn_prob": 0.01},
}


def scenario_config(cfg, name: str):
    """``cfg`` with scenario ``name``'s delta applied; walkers raise
    ``render.max_triangles`` by the 10 triangles each one adds."""
    scfg = cfg.copy()
    for k, v in SCENARIOS[name].items():
        scfg.set_dotted(k, v)
    ped = int(scfg.get_dotted("sim.n_pedestrians", 0))
    if ped:
        cur = int(scfg.get_dotted("render.max_triangles", 512))
        scfg.set_dotted("render.max_triangles", cur + 10 * ped)
    return scfg


@experiment("scenario_eval")
def scenario_eval(cfg, checkpoint: str | None = None, artifact: str | None = None,
                  n_envs: int = 64, n_steps: int = 200, scenarios: str = "all", **kw):
    """Scenario suite: one policy's driving metrics under each named world
    and weather condition of ``SCENARIOS``, beside the expert's from the
    same fleet start as its ceiling."""
    if artifact:
        raise _not_ported("artifact=", 11)
    _check_one_device(cfg)
    names = (list(SCENARIOS) if scenarios in ("all", "", None)
             else [n.strip() for n in str(scenarios).split(",")])
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise ValueError(f"unknown scenarios {unknown}; have {list(SCENARIOS)}")
    dev = _device(cfg)
    policy_fn, _ = _policy_bits(cfg, checkpoint, int(cfg.get_dotted("render.height", 128)),
                                int(cfg.get_dotted("render.width", 128)))
    out, summary = {}, {}
    for name in names:
        town, params, rcfg = _sim_bits(scenario_config(cfg, name))
        pm = cl.evaluate_policy(params, town, rcfg, policy_fn, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps, device=dev)
        em = cl.evaluate_policy(params, town, rcfg, None, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps, device=dev)
        out[name] = {"policy": pm, "expert": em}
        summary[name] = {"policy": pm["driving_score"], "expert": em["driving_score"],
                         "policy_arc": pm["driving_score_arc"],
                         "expert_arc": em["driving_score_arc"]}
    return {"scenarios": out, "summary": summary,
            "mean_driving_score": float(np.mean([summary[n]["policy"] for n in names])),
            "mean_driving_score_arc": float(np.mean(
                [summary[n]["policy_arc"] for n in names]))}
