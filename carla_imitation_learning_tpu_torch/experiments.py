"""Named experiments (the JAX package's ``experiments.py``, the part that
the file-backed BC path runs). Each is ``fn(cfg, **kw) -> result dict``;
the CLI dispatches by name.

- ``split_folders``: sequential 80/10/10 split of a raw log;
- ``bc``: behaviour cloning per camera from the processed split, with
  best-k checkpoints (a CARLA-contract log is synthesized when ``data_dir``
  has none), and with ``augment`` the on-the-fly augmentation;
- ``bc_aux``: the multi-task ``AuxNet`` (recon, traffic light, action) on
  the same split; with ``aux_seg_weight`` > 0 its semantic-segmentation
  decoder, trained on an expert collection whose class plane kernel A
  renders, then scored in the closed loop;
- ``bc_raw_segment``: the shared-trunk dual-stream policy over the raw and
  semantic cameras;
- ``vae_pooled`` and ``vae_leave_one_out``: the conv VAE on pooled or
  leave-one-log-out splits of one camera;
- ``test_eval``: accuracy of a checkpoint on each split, with the
  predictions dump and the histogram plot;
- ``hpo``: random search over the BC recipe's learning rate, epochs and
  seed, trials run concurrently on a thread pool; ``hpo_vmap``: every
  learning-rate trial trained in one ``torch.func.vmap``; ``hpo_pbt``:
  Population Based Training of a vmapped population
  (``parallel/hpo.py``);
- ``collect_data``: expert collection on the card, written as a raw log
  (PNG frames and state.csv) and as a packed frame store;
- ``bc_streaming``: BC over the packed store, ``tier=direct`` (the store's
  frames copied to the card once, windows gathered there) or ``tier=host``
  (the C++ prefetcher and ``device_prefetch``);
- ``closed_loop_eval``: driving metrics of a checkpoint's policy and of the
  expert, rendered by kernel B;
- ``scenario_eval``: the same two scores under each named world and
  weather condition of ``SCENARIOS`` (rain, night, busy streets, multi-lane
  towns with lane changes, junction turn fans);
- ``bc_cil``: the command-conditioned branched policy (CIL) trained on an
  expert collection, goal-directed with ``n_goals`` and half of it on the
  mirrored town with ``mirror_collection``;
- ``bc_continuous``: regression BC of the expert's (steer, accel), then
  the closed loop under continuous control;
- ``route_eval``: A→B driving to goals planned by ``sim.planner``, the
  expert's arrival rate and, with a checkpoint, the policy's;
- ``dagger`` and ``dagger_online``: the DAgger loops of
  ``training/dagger.py``, in each policy family, goal-directed with
  ``n_goals``; ``dagger_uncertain``, the uncertainty-gated ensemble loop;
- ``rl_finetune``: PPO fine-tuning of a policy on the driving objective
  (``training/rl.py``), warm-started from a ``bc`` or ``bc_continuous``
  checkpoint;
- ``bc_rnn``: the recurrent (GRU) policy trained on episode-safe
  sequences, then driven with its hidden state in the rollout's carry;
- ``world_model``: the latent world model (encoder → LSTM or GRU →
  decoder, MSE or MS-SSIM image terms) on an expert collection;
  ``world_model_imagine`` scores its open-loop imagination against the
  real future per horizon step and writes a film strip;
  ``world_model_sweep`` runs the latent size × RNN × image loss grid of
  ``world_model`` trials, four at a time;
- ``dream_policy``: a latent policy trained in the world model's
  imagination (``training/imagination.py``), then driven in the real sim
  beside its latent-BC start and the expert;
- ``collect_multicamera``: one expert trajectory rendered from a whole
  camera rig (kernel A), written per camera as PNG frames and a packed
  store, with ``state.csv``;
- ``bc_surround``: BC of a policy that sees several rig views stacked
  camera-minor, collected by ``collect_multicamera`` and driven with the
  same rig;
- ``replay``: an episode record (initial state and executed controls) of
  the expert or a checkpoint's policy, replayed bit for bit, its most
  eventful env re-rendered in RGB with its class plane into a GIF.
- ``export_policy``: a (checkpoint-restored) policy exported with
  ``torch.export`` (``serving/``), float or int8, checked against the live
  model and served once through the bucketed engine; ``closed_loop_eval``,
  ``scenario_eval`` and ``route_eval`` take such an artifact
  (``artifact=``) in place of a checkpoint.

The closed-loop experiments read ``policy_family`` (``discrete``,
``continuous`` or ``cil``) to build the policy and its control space, and
``s2d_stem`` for the space-to-depth first conv, and ``policy_arch`` (``cnn``
or ``vit``) for the discrete family's network; ``closed_loop_eval`` reads
``safety_shield`` (``training/shield.py``). ``surround_cameras`` (rig
preset names, the driving view first) gives every policy experiment a
surround rig: the policy's channels are frame_skip × the number of views.

Everything runs on ``cfg.device`` (default ``"cuda"``; ``-o device=cpu``
runs the plain versions on the CPU). Options that wait for unported modules
raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.callbacks import (
    SaveBestMetricScores, SaveConfusionMatrix, SaveMetricsHeatmap,
)
from carla_imitation_learning_tpu_torch.data import frame_log as fl
from carla_imitation_learning_tpu_torch.data import pipeline as pipe
from carla_imitation_learning_tpu_torch.data import stats as stats_lib
from carla_imitation_learning_tpu_torch.data import vae_data
from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.models import (
    AuxNet, BranchedCILPolicy, ContinuousPolicyCNN, ConvVAE, DualStreamCNN, LatentWorldModel,
    PolicyCNN, RecurrentPolicy, ViTPolicy,
)
from carla_imitation_learning_tpu_torch.ops.ssim import ssim
from carla_imitation_learning_tpu_torch.parallel.mesh import (
    batch_sharding, maybe_mesh, shard_train_state,
)
from carla_imitation_learning_tpu_torch.native import (
    DeviceShardStreamer, NativeFrameStore, PrefetchReader, save_framestore,
)
from carla_imitation_learning_tpu_torch.render.camera import CAMERA_PRESETS
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.serving import (
    InferenceEngine, export_cil_policy, export_policy, load_policy, policy_fn_from_servable,
    quantize_params,
)
from carla_imitation_learning_tpu_torch.sim.planner import goal_setup
from carla_imitation_learning_tpu_torch.sim.town import (
    make_town_from_cfg, mirror_town, town_kwargs_from_cfg,
)
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as cl
from carla_imitation_learning_tpu_torch.training import imagination as imag
from carla_imitation_learning_tpu_torch.training import replay as rp
from carla_imitation_learning_tpu_torch.training.dagger import (
    run_dagger, run_dagger_online, run_dagger_uncertain,
)
from carla_imitation_learning_tpu_torch.training.loop import Trainer
from carla_imitation_learning_tpu_torch.training.losses import (
    aux_loss_fn, aux_seg_loss_fn, bc_augmented_loss_fn, bc_loss_fn, cil_loss_fn,
    continuous_bc_loss_fn, dual_stream_loss_fn, rnn_bc_loss_fn, vae_loss_fn,
    world_model_loss_fn,
)
from carla_imitation_learning_tpu_torch.training.rl import (
    ActorCriticCNN, PPOConfig, actor_policy_params_from, ppo_train, reward_from_traj,
    warm_start_from_policy,
)
from carla_imitation_learning_tpu_torch.training.shield import shield_from_cfg
from carla_imitation_learning_tpu_torch.training.steps import (
    AdamConfig, create_train_state, eval_params, flax_init_, make_eval_step, make_optimizer,
    make_train_step,
)
from carla_imitation_learning_tpu_torch.utils.checkpoint import (
    BestKCheckpointManager, restore_params, restore_pytree, save_pytree,
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


def _mesh_bits(cfg, batch_size: int | None = None):
    """(mesh, batch_sharding) for data-parallel experiments: the uniform
    treatment the reference gives every block through ``gpus=``. (None,
    None) on one rank; a mesh over more ranks than the world has raises."""
    mesh = maybe_mesh(cfg, batch_size=batch_size or int(cfg.get("BATCH_SIZE", 64)))
    return mesh, (batch_sharding(mesh) if mesh is not None else None)


def _trainer_bits(cfg, name: str, mesh=None):
    """Trainer with the JSONL / CSV / TensorBoard logger, the best-k
    manager under ``<log_dir>/<name>/ckpt`` and the per-class callbacks.
    Under a mesh only rank 0 writes: the other ranks get no logger and no
    callbacks, and a manager that keeps the same books without files."""
    log_dir = Path(cfg["log_dir"])
    writer = mesh is None or mesh.is_writer
    ck = cfg.get_dotted("trainer.checkpoint", {})
    ckpt = BestKCheckpointManager(
        log_dir / name / "ckpt", monitor=ck.get("monitor", "val_loss"),
        mode=ck.get("mode", "min"), save_top_k=int(ck.get("save_top_k", 1)),
        save_last=bool(ck.get("save_last", False)), filename=name, write=writer)
    logger, callbacks = None, []
    if writer:
        logger = MetricLogger(log_dir, name)
        n_actions = int(cfg.get("n_actions", 9))
        callbacks = [SaveBestMetricScores(),
                     SaveMetricsHeatmap(n_actions, out_dir=str(log_dir / name)),
                     SaveConfusionMatrix(n_actions, out_dir=str(log_dir / name))]
    trainer = Trainer(cfg, logger=logger, callbacks=callbacks,
                      checkpoint_manager=ckpt, name=name, device=_device(cfg))
    return trainer, ckpt


def _fit(cfg, name, model, loss_fn, loaders, mesh=None):
    """Initial state (flax's initializer from ``seed``, or
    ``resume_checkpoint``'s payload) → ``Trainer.fit`` → test metrics. The
    train steps draw (VAE noise, augmentation) from a generator on the
    device seeded with ``seed``. With a ``mesh`` the state is replicated
    (``shard_train_state``) and the loaders carry the batch sharding."""
    spe = max(1, len(loaders["train_dataloader"]))
    dev = _device(cfg)
    state = create_train_state(model, make_optimizer(cfg, steps_per_epoch=spe),
                               generator=_generator(cfg),
                               ema_decay=float(cfg.get("EMA_DECAY", 0.0)),
                               device=dev)
    resume = cfg.get("resume_checkpoint")
    if resume:
        state.load_payload(restore_pytree(resume))
    if mesh is not None:
        state = shard_train_state(mesh, state)
    trainer, _ = _trainer_bits(cfg, name, mesh)
    step_gen = torch.Generator(device=dev).manual_seed(int(cfg.get("seed", 0)))
    try:
        result = trainer.fit(state, loss_fn, loaders, step_gen, max_epochs=int(
            cfg.get("NUM_EPOCHS", cfg.get_dotted("trainer.max_epochs", 1))))
        test_metrics = (trainer.test(result.state, loss_fn, loaders)
                        if loaders.get("test_dataloader") else {})
    finally:
        if trainer.logger is not None:
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


def _discrete_policy_model(cfg, obs_size: int):
    """The discrete-family policy of ``policy_arch``: ``cnn``, the reference
    ConvNet1 shape (``s2d_stem`` for its space-to-depth stem), or ``vit``,
    ``ViTPolicy`` sized by ``vit_patch``/``vit_dim``/``vit_depth``/
    ``vit_heads``. Training and evaluation both build it here, so a checkpoint
    restores into the network it was trained as."""
    arch = str(cfg.get("policy_arch", "cnn"))
    if arch == "vit":
        return ViTPolicy(obs_size=obs_size, n_actions=int(cfg.get("n_actions", 9)),
                         patch=int(cfg.get("vit_patch", 16)), dim=int(cfg.get("vit_dim", 192)),
                         depth=int(cfg.get("vit_depth", 4)), heads=int(cfg.get("vit_heads", 3)),
                         dtype=_dtype(cfg))
    if arch != "cnn":
        raise ValueError(f"unknown policy_arch {arch!r} (want 'cnn' or 'vit')")
    return PolicyCNN(obs_size=obs_size, n_actions=int(cfg.get("n_actions", 9)),
                     dtype=_dtype(cfg), s2d_stem=_flag(cfg, "s2d_stem"))


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
    mesh, sharding = _mesh_bits(cfg)
    loss = bc_augmented_loss_fn() if _flag(cfg, "augment") else bc_loss_fn
    results = {}
    for camera in cameras:
        cfg_c = cfg.copy()
        cfg_c["camera"] = camera
        _maybe_synthesize_once(cfg_c, mesh, _maybe_synthesize, camera)
        loaders = pipe.sequential_train_val_test_iterator(cfg_c, sharding=sharding,
                                                          device=_device(cfg))
        model = _discrete_policy_model(cfg, int(cfg["obs_size"]))
        results[camera] = _fit(cfg_c, f"imitation_{camera}", model, loss, loaders, mesh)
    return results


@experiment("bc_aux")
def behavior_cloning_aux(cfg, cameras=("camera",), n_envs: int = 16, n_steps: int = 300,
                         eval_envs: int = 32, eval_steps: int = 200, **kw):
    """Multi-task AuxNet BC (recon, traffic light, action) per camera.

    ``aux_seg_weight`` > 0 trains the seg decoder instead, on an expert
    collection of ``n_envs`` × ``n_steps`` that records the class plane,
    then drives ``eval_envs`` × ``eval_steps`` in the closed loop
    (``_bc_aux_seg``)."""
    if float(cfg.get("aux_seg_weight", 0.0)) > 0.0:
        return _bc_aux_seg(cfg, n_envs, n_steps, eval_envs, eval_steps)
    mesh, sharding = _mesh_bits(cfg)
    results = {}
    for camera in cameras:
        cfg_c = cfg.copy()
        cfg_c["camera"] = camera
        _maybe_synthesize_once(cfg_c, mesh, _maybe_synthesize, camera)
        loaders = pipe.sequential_aux_train_val_test_iterator(cfg_c, sharding=sharding,
                                                              device=_device(cfg))
        model = AuxNet(obs_size=int(cfg["obs_size"]), n_actions=int(cfg["n_actions"]),
                       n_traffic_classes=int(cfg.get("n_traffic_classes", 2)),
                       image_hw=int(cfg.get("image_height", 256)), dtype=_dtype(cfg))
        loss = aux_loss_fn(float(cfg.get("aux_recon_weight", 0.0)),
                           float(cfg.get("aux_traffic_weight", 0.0)),
                           float(cfg.get("aux_action_weight", 1.0)))
        results[camera] = _fit(cfg_c, f"imitation_aux_{camera}", model, loss, loaders,
                               mesh)
    return results


def _bc_aux_seg(cfg, n_envs: int, n_steps: int, eval_envs: int, eval_steps: int):
    """AuxNet with the seg decoder, supervised by the renderer's per-pixel
    class plane (8 classes): an expert collection with ``record_semantic``,
    split 80/10/10, trained on recon + traffic + action + seg (speed
    dropout ``aux_speed_dropout`` on the train split), then the action
    head (of the EMA shadow when tracked) drives the closed loop. The result
    carries the test mIoU as ``seg_miou_test`` and the driving metrics as
    ``eval``."""
    town, params, rcfg = _sim_bits(cfg)
    if rcfg.height != rcfg.width:
        raise ValueError("aux_seg needs a square camera (AuxNet decoders upsample to "
                         f"image_hw); got {rcfg.height}x{rcfg.width}")
    fs = int(cfg.get("frame_skip", 4))
    dev, gen = _device(cfg), _generator(cfg)
    store, _, traj = cl.collect_dataset(params, town, rcfg, gen, n_envs, n_steps,
                                        frame_skip=fs, noise=_noise_bits(cfg),
                                        record_semantic=True, device=dev)
    sem = cl.semantic_stream(traj)
    del traj
    batch = int(cfg.get("BATCH_SIZE", 64))
    dropout = float(cfg.get("aux_speed_dropout", 0.3))
    mesh, sharding = _mesh_bits(cfg)
    loaders = {f"{k}_dataloader": pipe.AuxSegDataset(pipe.DeviceDataset(
        store.slice(a, b), batch, frame_skip=fs, shuffle=(k == "train"), aux=True,
        drop_last=(k == "train"), sharding=sharding if k == "train" else None,
        device=dev), sem[a:b],
        speed_dropout=dropout if k == "train" else 0.0)
        for k, (a, b) in _bounds(len(store)).items()}
    model = AuxNet(obs_size=fs, image_hw=rcfg.height, seg_classes=int(cfg.get("seg_classes", 8)),
                   dtype=_dtype(cfg))
    loss = aux_seg_loss_fn(float(cfg.get("aux_recon_weight", 0.0)),
                           float(cfg.get("aux_traffic_weight", 0.0)),
                           float(cfg.get("aux_action_weight", 1.0)),
                           float(cfg.get("aux_seg_weight", 0.5)))
    result = _fit(cfg, "bc_aux_seg", model, loss, loaders, mesh)
    trained = eval_params(result.pop("state"))
    result["eval"] = cl.evaluate_policy(params, town, rcfg, trained.as_policy_fn(), gen,
                                        n_envs=eval_envs, n_steps=eval_steps, frame_skip=fs,
                                        device=dev)
    result["seg_miou_test"] = result["test"].get("test_seg_miou")
    return result


@experiment("bc_raw_segment")
def behavior_cloning_raw_segment(cfg, **kw):
    """Shared-trunk dual-stream BC over the raw and semantic cameras."""
    mesh, sharding = _mesh_bits(cfg)
    cfg_c = cfg.copy()
    _maybe_synthesize_once(cfg_c, mesh, _maybe_synthesize, "camera")
    loaders = pipe.paired_sequential_iterator(cfg_c, sharding=sharding, device=_device(cfg))
    model = DualStreamCNN(obs_size=int(cfg["obs_size"]), n_actions=int(cfg["n_actions"]),
                          dtype=_dtype(cfg))
    return _fit(cfg_c, "imitation_raw_segment", model, dual_stream_loss_fn, loaders, mesh)


@experiment("vae_pooled")
def vae_pooled(cfg, **kw):
    """Conv VAE on the pooled random split of every log in ``logs``."""
    cfg_c = cfg.copy()
    cfg_c["camera"] = kw.get("camera", "SL")
    cfg_c["train_logs"] = cfg["logs"]
    mesh, sharding = _mesh_bits(cfg_c)
    _maybe_synthesize_once(cfg_c, mesh, _maybe_synthesize_vae)
    return _fit_vae(cfg_c, "vae_pooled", vae_data.train_val_test_iterator(
        cfg_c, "pooled_data", device=_device(cfg), sharding=sharding), mesh)


@experiment("vae_leave_one_out")
def vae_leave_one_out(cfg, **kw):
    """Conv VAE trained on all of ``logs`` but the last, tested on the last."""
    cfg_c = cfg.copy()
    cfg_c["camera"] = kw.get("camera", "SL")
    cfg_c["train_logs"] = cfg["logs"][:-1]
    cfg_c["test_logs"] = cfg["logs"][-1:]
    mesh, sharding = _mesh_bits(cfg_c)
    _maybe_synthesize_once(cfg_c, mesh, _maybe_synthesize_vae)
    return _fit_vae(cfg_c, "vae_leave_one_out", vae_data.train_val_test_iterator(
        cfg_c, "leave_one_out_data", device=_device(cfg), sharding=sharding), mesh)


def _maybe_synthesize_once(cfg, mesh, synthesize, *args) -> None:
    """``synthesize(cfg, *args)`` on rank 0 alone; under a mesh the other
    ranks wait until its log is on disk."""
    if mesh is None or mesh.is_writer:
        synthesize(cfg, *args)
    if mesh is not None:
        mesh.barrier()


def _maybe_synthesize_vae(cfg) -> None:
    """A synthetic raw log of ``synthetic_frames`` frames at ``image_size``
    for every train and test log without the camera's folder; each log's
    seed is the CRC-32 of its name, so a rerun writes the same frames."""
    data_dir = Path(cfg["data_dir"])
    cam = cfg["camera"] if isinstance(cfg["camera"], str) else cfg["camera"][0]
    h = int(cfg["image_size"][1])
    for log in list(cfg["train_logs"]) + list(cfg.get("test_logs", [])):
        if not (data_dir / "raw" / log / f"{cam}_resized_{h}_bw").is_dir() and \
           not (data_dir / "raw" / log / cam).is_dir():
            fl.write_synthetic_log(data_dir, log=log, cameras=(cam,),
                                   n_frames=int(cfg.get("synthetic_frames", 60)),
                                   height=h, width=int(cfg["image_size"][2]),
                                   seed=zlib.crc32(log.encode()) % (2 ** 31))


def _fit_vae(cfg, name: str, loaders: dict, mesh=None) -> dict:
    c, h, w = (int(v) for v in cfg["image_size"])
    model = ConvVAE(channels=c, height=h, width=w, z_size=int(cfg.get("z_size", 32)),
                    dtype=_dtype(cfg))
    return _fit(cfg, name, model, vae_loss_fn(float(cfg["alpha"]), float(cfg["beta"])),
                loaders, mesh)


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


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index: an index-less ``cuda`` becomes the caller's
    current card, which worker threads (each starting on card 0) then
    select explicitly (``_selected``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _selected(dev: torch.device):
    """A context that makes ``dev`` the current card of the calling thread."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _seeded_policy(cfg, generator: torch.Generator, **kw) -> PolicyCNN:
    """A ``PolicyCNN`` drawn from ``generator`` alone (flax's initializer):
    built on the meta device, so its constructor draws nothing from torch's
    global generator, which concurrent trials would share."""
    with torch.device("meta"):
        model = PolicyCNN(dtype=_dtype(cfg), **kw)
    return flax_init_(model.to_empty(device="cpu"), generator)


@experiment("hpo")
def hpo(cfg, num_samples: int = 4, max_concurrent: int = 4, **kw):
    """Random search over the BC recipe's ``lr`` (log-uniform 1e-4-1e-2),
    ``epochs`` and ``seed``, ``max_concurrent`` trials at a time on a
    thread pool (``parallel.hpo.tune_run``). Each trial forks the loaders
    (its own shuffle order over the shared device arrays), draws its
    ``PolicyCNN`` from its own generator (seed = the trial's seed), trains
    with Adam and the global-norm clip 0.5 and scores its mean validation
    accuracy. cuDNN runs its deterministic algorithms meanwhile, so a
    trial's result does not depend on what runs beside it: the concurrent
    sweep equals the serial one. Trials land in ``<log_dir>/hpo/trials.json``."""
    from carla_imitation_learning_tpu_torch.parallel.hpo import tune_run

    dev = _indexed(_device(cfg))
    cfg_c = cfg.copy()
    cfg_c["camera"] = "camera"
    _maybe_synthesize(cfg_c, "camera")
    loaders = pipe.sequential_train_val_test_iterator(cfg_c, device=dev)

    def trainable(trial_cfg):
        with _selected(dev):
            trial_seed = int(trial_cfg.get("seed", 0))
            train_ds = loaders["train_dataloader"].fork(1000 + trial_seed)
            val_ds = loaders["val_dataloader"].fork(2000 + trial_seed)
            model = _seeded_policy(cfg, torch.Generator().manual_seed(trial_seed))
            tx = make_optimizer({"LEARNING_RATE": trial_cfg["lr"], "gradient_clip_val": 0.5}, 1)
            state = create_train_state(model, tx, device=dev)
            step = make_train_step(bc_loss_fn)
            for _ in range(int(trial_cfg.get("epochs", 2))):
                for batch in train_ds:
                    state, _ = step(state, batch)
            ev = make_eval_step(bc_loss_fn)
            accs = [float(ev(state, b)["accuracy"]) for b in val_ds]
            return {"mean_accuracy": float(np.mean(accs))}

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        best, trials = tune_run(
            trainable, space={"lr": (1e-4, 1e-2), "epochs": [2], "seed": [0, 1, 2, 3]},
            num_samples=num_samples, metric="mean_accuracy", mode="max",
            max_concurrent=int(max_concurrent), results_dir=str(Path(cfg["log_dir"]) / "hpo"))
    return {"best_config": best.config, "best_metrics": best.metrics,
            "n_trials": len(trials), "n_failed": sum(t.failed for t in trials)}


def _bc_vmap_trainable(cfg, epochs: int):
    """(init_fn, train_fn) of per-trial BC training with the learning rate
    as the vmapped hyperparameter, shared by ``hpo_vmap`` and ``hpo_pbt``.
    The epoch is materialized once as stacked batches (the train split in
    order, the partial batch dropped); ``train_fn(state, lr)`` runs
    ``epochs`` passes over them, each batch one ``torch.func.grad`` step of
    the cross-entropy and one ``adam_update`` at the trial's rate, then
    scores the first 64 validation samples. ``init_fn(generator, lr)``
    draws a ``PolicyCNN`` from ``generator`` → {"params", "opt"}."""
    from torch.func import functional_call, grad

    from carla_imitation_learning_tpu_torch.training.losses import accuracy, cross_entropy
    from carla_imitation_learning_tpu_torch.training.steps import adam_init, adam_update

    dev = _device(cfg)
    cfg_c = cfg.copy()
    cfg_c["camera"] = "camera"
    _maybe_synthesize(cfg_c, "camera")
    loaders = pipe.sequential_train_val_test_iterator(cfg_c, device=dev)
    train_ds, val_ds = loaders["train_dataloader"], loaders["val_dataloader"]
    order = np.arange(train_ds.n_samples)
    b = train_ds.batch_size
    batches = [train_ds.make_batch(order[i * b:(i + 1) * b])
               for i in range(max(1, train_ds.n_samples // b))]
    bx = torch.stack([x for x, _ in batches])                   # (nb, B, H, W, C)
    by = torch.stack([y for _, y in batches])
    vx, vy = val_ds.make_batch(np.arange(min(val_ds.n_samples, 64)))
    shape = {"obs_size": int(cfg["obs_size"]), "n_actions": int(cfg["n_actions"])}
    with torch.device("meta"):
        base = PolicyCNN(dtype=_dtype(cfg), **shape)

    def logits_of(params, x):
        return functional_call(base, params, (x,))

    def loss_of(params, x, y):
        return cross_entropy(logits_of(params, x), y)

    def init_fn(generator, lr):
        model = _seeded_policy(cfg, generator, **shape).to(dev)
        params = {k: v.detach() for k, v in model.named_parameters()}
        return {"params": params, "opt": adam_init(params)}

    def train_fn(state, lr):
        params, opt = state["params"], state["opt"]
        for _ in range(epochs):
            for x, y in zip(bx, by):
                params, opt = adam_update(params, grad(loss_of)(params, x, y), opt, lr)
        val_logits = logits_of(params, vx)
        return {"params": params, "opt": opt}, {
            "mean_accuracy": accuracy(val_logits, vy), "val_loss": cross_entropy(val_logits, vy)}

    return init_fn, train_fn


@experiment("hpo_vmap")
def hpo_vmap(cfg, lrs=(3e-4, 1e-3, 3e-3, 1e-2), epochs: int = 2, **kw):
    """Vectorized HPO: every learning-rate trial of the BC recipe trains in
    one ``torch.func.vmap`` over the trial axis (``parallel.hpo.vmap_sweep``),
    so each operation launches once for all trials; the trials' initial
    weights come from per-trial generators derived from ``seed``."""
    from carla_imitation_learning_tpu_torch.parallel.hpo import vmap_sweep
    from carla_imitation_learning_tpu_torch.sim import prng

    init_fn, train_fn = _bc_vmap_trainable(cfg, epochs)
    lr_arr = torch.tensor(lrs, dtype=torch.float32, device=_device(cfg))
    _, metrics = vmap_sweep(init_fn, train_fn, lr_arr, prng.key(int(cfg.get("seed", 0))))
    accs = metrics["mean_accuracy"].tolist()
    best_i = int(np.argmax(accs))
    return {"lrs": [float(v) for v in lrs], "accuracies": accs,
            "val_losses": metrics["val_loss"].tolist(),
            "best_lr": float(lrs[best_i]), "n_trials": len(lrs),
            "note": "all trials trained in one torch.func.vmap (trial axis)"}


def pbt_initial_lrs(seed: int, population: int, lo: float, hi: float,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """``hpo_pbt``'s starting rates: log-uniform in [lo, hi) from the
    threefry key ``fold_in(key(seed), 1)``, the JAX package's draws."""
    from carla_imitation_learning_tpu_torch.sim import prng

    key = prng.fold_in(prng.key(seed, device), 1)
    return torch.exp(prng.uniform_range(key, (population,), float(np.log(lo)),
                                        float(np.log(hi))))


@experiment("hpo_pbt")
def hpo_pbt(cfg, population: int = 8, generations: int = 4, epochs_per_gen: int = 1,
            lr_range=(1e-4, 3e-2), **kw):
    """Population Based Training of the BC recipe (``parallel.hpo.pbt_run``):
    the population trains vmapped, ``epochs_per_gen`` epochs a generation;
    between generations the worst quarter copies the best quarter's weights
    and perturbed rates on the card. Writes ``<log_dir>/pbt_history.json``
    (scores and rates of every generation)."""
    from carla_imitation_learning_tpu_torch.parallel.hpo import pbt_run
    from carla_imitation_learning_tpu_torch.sim import prng

    init_fn, train_fn = _bc_vmap_trainable(cfg, epochs_per_gen)
    seed = int(cfg.get("seed", 0))
    h0 = pbt_initial_lrs(seed, int(population), float(lr_range[0]), float(lr_range[1]),
                         _device(cfg))
    _, h, hist = pbt_run(init_fn, train_fn, h0, prng.key(seed), metric="mean_accuracy",
                         mode="max", n_generations=int(generations))
    last = hist[-1]
    best_i = int(np.argmax(last["mean_accuracy"]))
    lrs = h.cpu().numpy()
    out = {"population": int(population), "generations": int(generations),
           "best_lr": float(lrs[best_i]),
           "best_accuracy": float(last["mean_accuracy"][best_i]),
           "mean_accuracy_per_gen": [float(g["mean_accuracy"].mean()) for g in hist],
           "final_lrs": [float(v) for v in lrs]}
    path = Path(cfg["log_dir"]) / "pbt_history.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        [{k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in g.items()}
         for g in hist], indent=1))
    out["history_path"] = str(path)
    return out


def _sim_bits(cfg):
    town = make_town_from_cfg(cfg, seed=int(cfg.get("data_seed", 0)))
    return town, SimParams.from_cfg(cfg), RenderConfig.from_cfg(cfg)


def _force_turn_fans(cfg) -> None:
    """The route planner plans over the turn-fan graph: make sure the town
    that ``_sim_bits`` builds next carries the transfer tables."""
    if not _flag(cfg, "sim.town.turn_fans"):
        cfg.set_dotted("sim.town.turn_fans", True)


def _goal_bits(cfg, n_goals: int, n_envs: int):
    """``_sim_bits``, goal-directed when ``n_goals`` > 0 (turn fans forced,
    ``sim.planner.goal_setup`` seeded by ``data_seed``) → (town, params,
    rcfg, round-robin goal ids (B,) or None)."""
    if n_goals > 0:
        _force_turn_fans(cfg)
    town, params, rcfg = _sim_bits(cfg)
    goal_ids = None
    if n_goals > 0:
        town, _, goal_ids = goal_setup(town, n_goals, n_envs,
                                       seed=int(cfg.get("data_seed", 0)))
    return town, params, rcfg, goal_ids


def _control_space(cfg) -> str:
    """The closed loop's control space for the configured policy family."""
    return ("continuous" if str(cfg.get("policy_family", "discrete")) == "continuous"
            else "discrete")


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
    contract (PNG frames and state.csv) and as a packed frame store.
    ``n_goals`` > 0 collects goal-directed runs: the expert drives to goals
    of the route planner, and the commands announce its turns."""
    town, params, rcfg, goal_ids = _goal_bits(cfg, n_goals, n_envs)
    t0 = time.perf_counter()
    store, state_log, _ = cl.collect_dataset(
        params, town, rcfg, _generator(cfg), n_envs=n_envs, n_steps=n_steps,
        frame_skip=int(cfg.get("frame_skip", 4)), noise=_noise_bits(cfg),
        goal_ids=goal_ids, device=_device(cfg))
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


def _surround_cams(cfg) -> tuple:
    """The observation rig: ``surround_cameras`` (rig preset names, the
    first the driving view) or the forward camera alone. The names must be
    ``CAMERA_PRESETS``: the renderer takes the forward pose for any other
    name, so a misspelt rig would train on K copies of the forward view."""
    cams = cfg.get("surround_cameras", None)
    if not cams:
        return ("camera",)
    cams = tuple(str(c) for c in cams)
    unknown = [c for c in cams if c not in CAMERA_PRESETS]
    if unknown:
        raise ValueError(f"unknown camera preset(s) {unknown} in surround_cameras; "
                         f"valid presets: {sorted(CAMERA_PRESETS)}")
    return cams


def _policy_bits(cfg, checkpoint: str | None, height: int, width: int):
    """The policy of ``policy_family`` (flax's initializer from ``seed``,
    then the checkpoint's weights, EMA preferred) → (policy_fn, model):
    ``discrete``, the ConvNet1 shape and its argmax; ``continuous``,
    ``ContinuousPolicyCNN`` and its (steer, accel) controls (run it with
    ``_control_space(cfg)``); ``cil``, ``BranchedCILPolicy`` with
    ``n_commands`` branches and its ``as_policy_fn``, which reads the
    rollout's speed and navigation command. Every family sees
    frame_skip × the rig's views channels (``_surround_cams``)."""
    family = str(cfg.get("policy_family", "discrete"))
    obs_size = int(cfg.get("frame_skip", 4)) * len(_surround_cams(cfg))
    if family == "continuous":
        model = ContinuousPolicyCNN(obs_size=obs_size, dtype=_dtype(cfg),
                                    s2d_stem=_flag(cfg, "s2d_stem"))
    elif family == "cil":
        model = BranchedCILPolicy(obs_size=obs_size, n_actions=int(cfg.get("n_actions", 9)),
                                  n_commands=int(cfg.get("n_commands", 6)), dtype=_dtype(cfg))
    elif family == "discrete":
        model = _discrete_policy_model(cfg, obs_size)
    else:
        raise ValueError(f"unknown policy_family {family!r} "
                         "(want 'discrete', 'continuous' or 'cil')")
    model = flax_init_(model, _generator(cfg)).to(_device(cfg))
    if checkpoint:
        model.load_state_dict(restore_params(checkpoint, model.state_dict()))
    if family == "cil":
        return model.as_policy_fn(), model

    @torch.no_grad()
    def policy_fn(obs):
        out = model(obs)
        return out if family == "continuous" else out.argmax(-1)

    return policy_fn, model


def _eval_policy_fn(cfg, checkpoint: str | None, artifact: str | None,
                    height: int, width: int):
    """(policy_fn, control space) for the eval experiments: an exported
    artifact (``serving/export.py``, loaded on ``cfg.device``) when
    ``artifact`` is given, else ``_policy_bits``' (checkpoint-restored)
    live model. An artifact decides its own control space through
    ``meta.family``: ``policy_family`` in the config only shapes the live
    model."""
    if artifact:
        servable = load_policy(artifact, _device(cfg))
        space = "continuous" if servable.meta.get("family") == "continuous" else "discrete"
        return policy_fn_from_servable(servable), space
    policy_fn, _ = _policy_bits(cfg, checkpoint, height, width)
    return policy_fn, _control_space(cfg)


@experiment("closed_loop_eval")
def closed_loop_eval(cfg, checkpoint: str | None = None, artifact: str | None = None,
                     n_envs: int = 64, n_steps: int = 200, **kw):
    """Driving metrics of a checkpoint's policy, or with ``artifact=`` of an
    exported artifact's (float or int8: the program that ships is the one
    that drives), and of the expert on the same initial fleet.
    ``safety_shield=true`` puts the emergency-brake layer
    (``training/shield.py``) over the policy's rollout, not the expert's,
    and the policy's metrics gain its interventions. The policy drives with
    the ``surround_cameras`` rig, the expert needs none. Under a mesh the
    fleet is sharded over ``data``."""
    dev = _device(cfg)
    mesh, _ = _mesh_bits(cfg, batch_size=n_envs)
    town, params, rcfg = _sim_bits(cfg)
    policy_fn, space = _eval_policy_fn(cfg, checkpoint, artifact, rcfg.height, rcfg.width)
    policy = cl.evaluate_policy(params, town, rcfg, policy_fn, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps,
                                control_space=space, device=dev,
                                shield=shield_from_cfg(cfg), cameras=_surround_cams(cfg),
                                mesh=mesh)
    expert = cl.evaluate_policy(params, town, rcfg, None, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps, device=dev, mesh=mesh)
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
    same fleet start as its ceiling. ``artifact=`` scores an exported
    artifact (see ``closed_loop_eval``); a mesh shards every fleet."""
    names = (list(SCENARIOS) if scenarios in ("all", "", None)
             else [n.strip() for n in str(scenarios).split(",")])
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise ValueError(f"unknown scenarios {unknown}; have {list(SCENARIOS)}")
    dev = _device(cfg)
    policy_fn, space = _eval_policy_fn(cfg, checkpoint, artifact,
                                       int(cfg.get_dotted("render.height", 128)),
                                       int(cfg.get_dotted("render.width", 128)))
    cams = _surround_cams(cfg)
    out, summary = {}, {}
    for name in names:
        scfg = scenario_config(cfg, name)
        mesh, _ = _mesh_bits(scfg, batch_size=n_envs)
        town, params, rcfg = _sim_bits(scfg)
        pm = cl.evaluate_policy(params, town, rcfg, policy_fn, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps,
                                control_space=space, device=dev, cameras=cams, mesh=mesh)
        em = cl.evaluate_policy(params, town, rcfg, None, _generator(cfg),
                                n_envs=n_envs, n_steps=n_steps, device=dev, mesh=mesh)
        out[name] = {"policy": pm, "expert": em}
        summary[name] = {"policy": pm["driving_score"], "expert": em["driving_score"],
                         "policy_arc": pm["driving_score_arc"],
                         "expert_arc": em["driving_score_arc"]}
    return {"scenarios": out, "summary": summary,
            "mean_driving_score": float(np.mean([summary[n]["policy"] for n in names])),
            "mean_driving_score_arc": float(np.mean(
                [summary[n]["policy_arc"] for n in names]))}


def _bounds(n: int) -> dict:
    """Sequential 80/10/10 split of n frames → {"train", "val", "test"}:
    (start, stop)."""
    return {"train": (0, int(0.8 * n)), "val": (int(0.8 * n), int(0.9 * n)),
            "test": (int(0.9 * n), n)}


def _split3(store):
    """Sequential 80/10/10 split of a store → {"train", "val", "test"}."""
    return {k: store.slice(a, b) for k, (a, b) in _bounds(len(store)).items()}


@experiment("bc_cil")
def bc_cil(cfg, n_envs: int = 32, n_steps: int = 300, n_goals: int = 0, **kw):
    """Command-conditioned branched policy (CIL) with a speed head, trained
    on an expert collection on the card.

    ``n_goals`` > 0 makes the collection goal-directed (route planner), so
    the commands announce the planner's turns — what a CIL policy needs to
    drive A→B (score it with ``route_eval``). ``mirror_collection`` runs
    the second half of the budget on the mirrored town (every left turn a
    right, since ``make_town``'s loops all run counterclockwise); each half
    is split 80/10/10 on its own, so both land in every split.
    ``balance_key`` (``command`` or ``action_command``) balances epoch
    sampling by branch. With ``surround_cameras`` the side views ride as
    extra camera-minor channels, split with their half. The result carries
    the command histogram."""
    cams = _surround_cams(cfg)
    town, params, rcfg, goal_ids = _goal_bits(cfg, n_goals, n_envs)
    fs = int(cfg.get("frame_skip", 4))
    dev, gen, noise = _device(cfg), _generator(cfg), _noise_bits(cfg)
    worlds = [town, mirror_town(town)] if _flag(cfg, "mirror_collection") else [town]
    steps = n_steps // len(worlds)
    parts, commands = [], []
    for world in worlds:
        store, _, traj = cl.collect_dataset(params, world, rcfg, gen, n_envs, steps,
                                            noise=noise, goal_ids=goal_ids, cameras=cams,
                                            device=dev)
        extra = cl.extra_view_streams(traj) if len(cams) > 1 else []
        del traj
        commands.append(store.commands)
        parts.append({k: (store.slice(a, b), [e[a:b] for e in extra])
                      for k, (a, b) in _bounds(len(store)).items()})
    splits = {k: (pipe.FrameStore.concat([p[k][0] for p in parts]),
                  [np.concatenate([p[k][1][i] for p in parts]) for i in range(len(cams) - 1)])
              for k in ("train", "val", "test")}
    batch = int(cfg.get("BATCH_SIZE", 64))
    balanced = _flag(cfg, "balanced_sampling")
    mesh, sharding = _mesh_bits(cfg)
    loaders = {f"{k}_dataloader": pipe.DeviceDataset(
        st, batch, frame_skip=fs, shuffle=(k == "train"), cil=True,
        drop_last=(k == "train"), balanced=balanced and k == "train",
        balance_key=str(cfg.get("balance_key", "action")), extra_frames=extra or None,
        sharding=sharding if k == "train" else None, device=dev)
        for k, (st, extra) in splits.items()}
    n_commands = int(cfg.get("n_commands", 6))
    model = BranchedCILPolicy(obs_size=fs * len(cams), n_commands=n_commands,
                              dtype=_dtype(cfg))
    result = _fit(cfg, "bc_cil", model, cil_loss_fn(float(cfg.get("speed_weight", 0.1))),
                  loaders, mesh)
    commands = np.concatenate(commands)
    hist = np.bincount(commands, minlength=n_commands)
    result["command_histogram"] = hist.tolist()
    empty = [c for c in range(n_commands) if hist[c] == 0]
    if empty:
        print(f"bc_cil: commands {empty} have no samples, so their branches never train "
              "(lanes_per_direction > 1, superblocks and lane_change_period give all six)",
              file=sys.stderr)
    return result


@experiment("bc_continuous")
def bc_continuous(cfg, n_envs: int = 32, n_steps: int = 300, eval_envs: int = 64,
                  eval_steps: int = 200, **kw):
    """Continuous-control BC: regress the expert's (steer, accel = throttle
    − brake) from the state log (the clean steer under collection noise),
    split 80/10/10, then drive the closed loop with continuous control
    (with the ``surround_cameras`` rig, its side views as extra channels)."""
    cams = _surround_cams(cfg)
    town, params, rcfg = _sim_bits(cfg)
    fs = int(cfg.get("frame_skip", 4))
    dev, gen = _device(cfg), _generator(cfg)
    store, state_log, traj = cl.collect_dataset(params, town, rcfg, gen, n_envs, n_steps,
                                                frame_skip=fs, noise=_noise_bits(cfg),
                                                cameras=cams, device=dev)
    extra = cl.extra_view_streams(traj) if len(cams) > 1 else []
    del traj
    labels = np.stack([np.asarray(state_log.steer, np.float32),
                       np.asarray(state_log.throttle, np.float32)
                       - np.asarray(state_log.brake, np.float32)], axis=1)
    batch = int(cfg.get("BATCH_SIZE", 64))
    mesh, sharding = _mesh_bits(cfg)
    loaders = {f"{k}_dataloader": pipe.DeviceDataset(
        store.slice(a, b), batch, frame_skip=fs, shuffle=(k == "train"),
        drop_last=(k == "train"), continuous_labels=labels[a:b],
        extra_frames=[e[a:b] for e in extra] or None,
        sharding=sharding if k == "train" else None, device=dev)
        for k, (a, b) in _bounds(len(store)).items()}
    model = ContinuousPolicyCNN(obs_size=fs * len(cams), dtype=_dtype(cfg))
    loss = continuous_bc_loss_fn(float(cfg.get("steer_weight", 1.0)),
                                 float(cfg.get("accel_weight", 0.5)))
    result = _fit(cfg, "bc_continuous", model, loss, loaders, mesh)
    trained = result["state"].model

    @torch.no_grad()
    def policy_fn(obs):
        return trained(obs)

    result["eval"] = cl.evaluate_policy(params, town, rcfg, policy_fn, gen, n_envs=eval_envs,
                                        n_steps=eval_steps, control_space="continuous",
                                        device=dev, cameras=cams)
    result["label_stats"] = {"steer_std": float(labels[:, 0].std()),
                             "accel_mean": float(labels[:, 1].mean())}
    return result


@experiment("route_eval")
def route_eval(cfg, checkpoint: str | None = None, artifact: str | None = None,
               n_envs: int = 64, n_steps: int = 600, n_goals: int = 8, **kw):
    """A→B evaluation: ``n_goals`` goals sampled on the town's shared lane
    stretches, shortest-path tables baked on the host once
    (``sim.planner``), each env driving to its goal → arrival rate, steps to
    arrival and infractions per km of the expert and, with a checkpoint, of
    the policy (``policy_family=cil`` for a ``bc_cil`` checkpoint, which
    then follows the planner's commands; ``artifact=`` for an exported
    artifact, a CIL one taking the commands through its second and third
    inputs), from the same fleet start. The town gets turn fans, the
    planner's graph. A mesh shards the fleet."""
    dev = _device(cfg)
    mesh, _ = _mesh_bits(cfg, batch_size=n_envs)
    town, params, rcfg, goal_ids = _goal_bits(cfg, n_goals, n_envs)
    expert = cl.evaluate_routes(params, town, rcfg, None, _generator(cfg), n_envs=n_envs,
                                n_steps=n_steps, goal_ids=goal_ids, device=dev, mesh=mesh)
    out = {"goals": town.nav_goals.cpu().numpy().tolist(), "expert": expert}
    if checkpoint or artifact:
        policy_fn, space = _eval_policy_fn(cfg, checkpoint, artifact, rcfg.height, rcfg.width)
        out["policy"] = cl.evaluate_routes(params, town, rcfg, policy_fn, _generator(cfg),
                                           n_envs=n_envs, n_steps=n_steps,
                                           control_space=space,
                                           goal_ids=goal_ids, device=dev,
                                           cameras=_surround_cams(cfg), mesh=mesh)
    return out


def _dagger_kw(cfg) -> dict:
    """What ``run_dagger`` / ``run_dagger_online`` read from the config."""
    return dict(batch_size=int(cfg.get("BATCH_SIZE", 64)),
                policy_family=str(cfg.get("policy_family", "discrete")),
                n_commands=int(cfg.get("n_commands", 6)),
                goal_seed=int(cfg.get("data_seed", 0)), tx=make_optimizer(cfg, 1),
                dtype=_dtype(cfg), device=_device(cfg))


@experiment("dagger")
def dagger(cfg, rounds: int = 3, n_envs: int = 16, n_steps: int = 200,
           epochs_per_round: int = 3, n_goals: int = 0, **kw):
    """DAgger: an expert collection, then rounds in which the policy drives
    and the expert labels, each followed by training on every round's data
    (``training.dagger.run_dagger``), in the configured policy family;
    goal-directed with ``n_goals`` > 0, the final policy then also scored on
    the routes. Under a mesh the training batches are sharded and the
    eval fleet too when it divides the world (re-validated at its size)."""
    if n_goals > 0:
        _force_turn_fans(cfg)
    mesh, _ = _mesh_bits(cfg)
    eval_mesh = _mesh_bits(cfg, batch_size=min(n_envs, 32))[0] if mesh is not None else None
    town, params, rcfg = _sim_bits(cfg)
    return run_dagger(params, town, rcfg, _generator(cfg), rounds=rounds, n_envs=n_envs,
                      mesh=mesh, eval_mesh=eval_mesh,
                      n_steps=n_steps, epochs_per_round=epochs_per_round, n_goals=n_goals,
                      noise=_noise_bits(cfg), balanced=_flag(cfg, "balanced_sampling"),
                      speed_weight=float(cfg.get("speed_weight", 0.1)),
                      steer_weight=float(cfg.get("steer_weight", 1.0)),
                      accel_weight=float(cfg.get("accel_weight", 0.5)), **_dagger_kw(cfg))


@experiment("dagger_online")
def dagger_online(cfg, rounds: int = 3, n_envs: int = 16, n_steps: int = 200,
                  train_steps_per_round: int = 200, eval_steps: int = 100,
                  n_goals: int = 0, **kw):
    """Online DAgger with the aggregation buffer on the card
    (``training.dagger.run_dagger_online``): β-mixed rounds, β_r =
    ``beta``**r; ``policy_family=cil`` runs it on commands, and ``n_goals``
    > 0 makes every round goal-directed. Under a mesh the fleet, the buffer
    and every training batch are sharded (``n_envs`` must divide the
    world), and the final evaluation too when its fleet divides it."""
    if n_goals > 0:
        _force_turn_fans(cfg)
    mesh, _ = _mesh_bits(cfg, batch_size=n_envs)
    eval_mesh = _mesh_bits(cfg, batch_size=min(n_envs, 32))[0] if mesh is not None else None
    town, params, rcfg = _sim_bits(cfg)
    return run_dagger_online(params, town, rcfg, _generator(cfg), rounds=rounds,
                             mesh=mesh, eval_mesh=eval_mesh,
                             n_envs=n_envs, n_steps=n_steps,
                             train_steps_per_round=train_steps_per_round,
                             eval_steps=eval_steps, n_goals=n_goals,
                             beta=float(cfg.get("beta", 0.0)),
                             speed_weight=float(cfg.get("speed_weight", 0.1)),
                             **_dagger_kw(cfg))


@experiment("dagger_uncertain")
def dagger_uncertain(cfg, rounds: int = 3, n_envs: int = 16, n_steps: int = 200,
                     epochs_per_round: int = 3, ensemble: int = 4, tau: float = 0.25, **kw):
    """Uncertainty-gated DAgger (``training.dagger.run_dagger_uncertain``): a
    K-member ensemble drives by majority vote, the expert labels, and only
    the states the ensemble disagreed on (disagreement ≥ ``tau``) train."""
    town, params, rcfg = _sim_bits(cfg)
    return run_dagger_uncertain(params, town, rcfg, _generator(cfg), rounds=rounds,
                                n_envs=n_envs, n_steps=n_steps,
                                epochs_per_round=epochs_per_round, ensemble=ensemble,
                                tau=tau, batch_size=int(cfg.get("BATCH_SIZE", 64)),
                                tx=make_optimizer(cfg, 1), dtype=_dtype(cfg),
                                device=_device(cfg))


def _ppo_config(cfg) -> PPOConfig:
    """``PPOConfig`` with the config's ``rl_*`` overrides."""
    d = PPOConfig()
    return PPOConfig(
        w_progress=float(cfg.get("rl_w_progress", d.w_progress)),
        w_collision=float(cfg.get("rl_w_collision", d.w_collision)),
        w_red=float(cfg.get("rl_w_red", d.w_red)),
        w_offroad=float(cfg.get("rl_w_offroad", d.w_offroad)),
        gamma=float(cfg.get("rl_gamma", d.gamma)),
        gae_lambda=float(cfg.get("rl_gae_lambda", d.gae_lambda)),
        clip_eps=float(cfg.get("rl_clip_eps", d.clip_eps)),
        entropy_coef=float(cfg.get("rl_entropy_coef", d.entropy_coef)),
        update_epochs=int(cfg.get("rl_update_epochs", d.update_epochs)),
        num_minibatches=int(cfg.get("rl_num_minibatches", d.num_minibatches)),
        learning_rate=float(cfg.get("rl_lr", d.learning_rate)),
        max_grad_norm=float(cfg.get("rl_max_grad_norm", d.max_grad_norm)))


@experiment("rl_finetune")
def rl_finetune(cfg, checkpoint: str | None = None, n_envs: int = 256,
                rollout_steps: int = 128, iterations: int = 20, eval_envs: int = 64,
                eval_steps: int = 300, **kw):
    """PPO fine-tuning on the driving objective (``training/rl.py``),
    warm-started from a BC checkpoint (``checkpoint=``, through
    ``_policy_bits``' restore) or from scratch; ``policy_family=continuous``
    is the Gaussian actor (from a ``bc_continuous`` checkpoint). Reports the
    deterministic actor's driving metrics before and after (the same
    ``eval_envs`` × ``eval_steps`` fleet), the per-iteration PPO metrics and
    ``score_delta``, and writes the actor as a ``PolicyCNN``-shaped
    checkpoint under ``<log_dir>/rl_finetune/actor_params`` (rank 0 writes
    it). Under a mesh the PPO fleet and both evaluations are sharded
    (``n_envs`` and ``eval_envs`` must divide the world)."""
    if len(cfg.get("surround_cameras") or ()) > 1:
        raise ValueError(
            "rl_finetune runs single-view PPO rollouts — surround_cameras "
            "checkpoints can't warm-start it; re-train the rig policy with "
            "bc/dagger surfaces or drop surround_cameras")
    town, params, rcfg = _sim_bits(cfg)
    dev = _device(cfg)
    frame_skip = int(cfg.get("frame_skip", 4))
    family = _control_space(cfg)
    continuous = family == "continuous"
    model = ActorCriticCNN(obs_size=frame_skip, n_actions=int(cfg.get("n_actions", 9)),
                           dtype=_dtype(cfg), s2d_stem=_flag(cfg, "s2d_stem"),
                           continuous=continuous)
    model = flax_init_(model, _generator(cfg)).to(dev)
    if checkpoint:
        _, bc = _policy_bits(cfg, checkpoint, rcfg.height, rcfg.width)
        warm_start_from_policy(model, bc)
    pcfg = _ppo_config(cfg)
    state = create_train_state(model, AdamConfig(schedule=lambda count: pcfg.learning_rate,
                                                 clip=pcfg.max_grad_norm), device=dev)
    mesh, _ = _mesh_bits(cfg, batch_size=n_envs)

    @torch.no_grad()
    def deterministic(obs):
        out, _ = model(obs)
        return out[0] if continuous else out.argmax(-1)

    def evaluate():
        return cl.evaluate_policy(params, town, rcfg, deterministic,
                                  torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 101),
                                  n_envs=eval_envs, n_steps=eval_steps, control_space=family,
                                  device=dev, mesh=mesh)

    def report(i, m):
        if mesh is not None and not mesh.is_writer:
            return
        print(f"  ppo iter {i}: reward/step {m['reward_per_step']:+.4f} "
              f"progress {m['progress_m_per_step']:.3f} m kl {m['approx_kl']:.4f} "
              f"entropy {m['entropy']:.3f}", file=sys.stderr)

    before = evaluate()
    _, history = ppo_train(params, town, rcfg, state, _generator(cfg), n_envs=n_envs,
                           rollout_steps=rollout_steps, iterations=iterations, cfg=pcfg,
                           frame_skip=frame_skip, on_iteration=report, device=dev, mesh=mesh)
    after = evaluate()
    out = Path(cfg["log_dir"]) / "rl_finetune" / "actor_params"
    if mesh is None or mesh.is_writer:
        save_pytree(out, {"params": actor_policy_params_from(model)})
    if mesh is not None:
        mesh.barrier()   # the checkpoint is on disk for every rank
    return {"before": before, "after": after, "history": history,
            "actor_checkpoint": str(out),
            "score_delta": float(after["driving_score"] - before["driving_score"])}


def _sequence_loader(cfg, store, batch: int, seq_len: int, episode_len: int | None,
                     shuffle: bool, seed: int = 0, continuous: bool = False, sharding=None):
    return pipe.SequenceDataset(store, batch, seq_len=seq_len, episode_len=episode_len,
                                shuffle=shuffle, seed=seed, continuous_actions=continuous,
                                device=_device(cfg), sharding=sharding)


@experiment("bc_rnn")
def bc_rnn(cfg, n_envs: int = 32, n_steps: int = 300, seq_len: int = 8,
           eval_envs: int = 64, eval_steps: int = 200, **kw):
    """Recurrent BC: a ConvTrunk → GRU policy (``RecurrentPolicy``, hidden
    ``rnn_hidden``) trained by backpropagation through time on
    episode-safe sequences of an expert collection split 80/10/10, then
    driven in the closed loop with its hidden state in the rollout's
    policy carry (zeroed on every auto-reset), seeing the newest frame of
    the window. → the fit's result with ``closed_loop`` metrics. A mesh
    shards the training batches, and the eval fleet when it divides."""
    dev = _device(cfg)
    town, params, rcfg = _sim_bits(cfg)
    store, _, _ = cl.collect_dataset(params, town, rcfg, _generator(cfg), n_envs, n_steps,
                                     noise=_noise_bits(cfg), device=dev)
    batch = int(cfg.get("BATCH_SIZE", 64))
    mesh, sharding = _mesh_bits(cfg)
    loaders = {f"{k}_dataloader": _sequence_loader(
        cfg, v, batch, seq_len, n_steps if k == "train" else None, shuffle=(k == "train"),
        sharding=sharding if k == "train" else None)
        for k, v in _split3(store).items()}
    model = RecurrentPolicy(obs_size=1, hidden=int(cfg.get("rnn_hidden", 128)),
                            n_actions=int(cfg.get("n_actions", 9)), dtype=_dtype(cfg))
    result = _fit(cfg, "bc_rnn", model, rnn_bc_loss_fn, loaders, mesh)
    net = result.pop("state").model

    @torch.no_grad()
    def policy_fn(obs, h):
        h, logits = net.step(h, obs[..., -1:])
        return logits.argmax(-1), h

    result["closed_loop"] = cl.evaluate_policy(
        params, town, rcfg, policy_fn, torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 7),
        n_envs=eval_envs, n_steps=eval_steps, device=dev,
        policy_carry_init=lambda b: net.initial_state(b, dev),
        mesh=_mesh_bits(cfg, batch_size=eval_envs)[0])
    return result


def _world_model_loaders(cfg, store, n_envs: int, n_steps: int, seq_len: int,
                         continuous: bool = False, sharding=None) -> dict:
    """The last env's stream for validation (env-major collections), so
    the split and the episode boundaries agree; sequences never cross an
    env's ``n_steps`` boundary."""
    n = len(store)
    split = (n_envs - 1) * n_steps if n_envs > 1 else int(0.9 * n)
    batch, seed = int(cfg.get("wm_batch", 16)), int(cfg.get("seed", 0))
    return {"train_dataloader": _sequence_loader(cfg, store.slice(0, split), batch, seq_len,
                                                 n_steps, True, seed, continuous, sharding),
            "val_dataloader": _sequence_loader(cfg, store.slice(split, n), batch, seq_len,
                                               n_steps, False, seed, continuous)}


@experiment("world_model")
def world_model(cfg, n_envs: int = 16, n_steps: int = 128, seq_len: int = 8,
                z_size: int = 64, rnn: str = "lstm", image_loss: str = "mse", **kw):
    """The latent world model (encoder → ``wm_rnn`` LSTM or GRU → decoder)
    on an expert collection; ``wm_z_size``, ``wm_image_loss`` (``mse`` or
    ``ms_ssim``), ``wm_seq_len`` and ``wm_batch`` override. The result
    carries the resolved architecture as ``wm_config``. A mesh shards the
    ``wm_batch`` batches."""
    mesh, sharding = _mesh_bits(cfg, batch_size=int(cfg.get("wm_batch", 16)))
    z_size = int(cfg.get("wm_z_size", z_size))
    rnn = str(cfg.get("wm_rnn", rnn))
    image_loss = str(cfg.get("wm_image_loss", image_loss))
    seq_len = int(cfg.get("wm_seq_len", seq_len))
    town, params, rcfg = _sim_bits(cfg)
    store, _, _ = cl.collect_dataset(params, town, rcfg, _generator(cfg), n_envs, n_steps,
                                     device=_device(cfg))
    model = LatentWorldModel(z_size=int(kw.get("wm_z_size", z_size)), rnn=rnn,
                             n_actions=int(cfg.get("n_actions", 9)), height=rcfg.height,
                             width=rcfg.width, dtype=_dtype(cfg))
    result = _fit(cfg, f"world_model_{rnn}_{z_size}_{image_loss}", model,
                  world_model_loss_fn(image_loss=image_loss),
                  _world_model_loaders(cfg, store, n_envs, n_steps, seq_len,
                                       sharding=sharding), mesh)
    result["wm_config"] = {"z_size": model.z_size, "rnn": model.rnn,
                           "n_actions": model.n_actions, "height": model.height,
                           "width": model.width, "image_loss": image_loss, "seq_len": seq_len}
    return result


@experiment("world_model_sweep")
def world_model_sweep(cfg, n_envs: int = 16, n_steps: int = 128, z_sizes=(64, 128, 512),
                      rnns=("lstm", "gru"), losses=("mse", "ms_ssim"),
                      max_concurrent: int = 4, **kw):
    """The latent size × RNN × image loss grid of the reference's plan (12
    trials), ``max_concurrent`` at a time: each trial is a whole
    ``world_model`` run (its own collection, model, logger and checkpoint
    directory ``world_model_{rnn}_{z}_{loss}``), scored by its last
    validation loss; the config's ``wm_*`` keys override the grid's values
    as they override ``world_model``'s arguments. A failing trial is
    recorded and the grid goes on. Trials land in
    ``<log_dir>/wm_sweep/trials.json``; ``table`` lists each finished
    trial's config and metrics."""
    from carla_imitation_learning_tpu_torch.parallel.hpo import grid_space, tune_run

    dev = _indexed(_device(cfg))

    def trainable(trial):
        with _selected(dev):
            r = world_model(cfg, n_envs=n_envs, n_steps=n_steps, z_size=trial["z"],
                            rnn=trial["rnn"], image_loss=trial["loss"])
        h = r["history"][-1]
        return {"val_loss": h.get("val_loss", float("inf")),
                "val_recon_loss": h.get("val_recon_loss", float("inf"))}

    space = {"z": list(z_sizes), "rnn": list(rnns), "loss": list(losses)}
    best, trials = tune_run(trainable, trial_configs=grid_space(space), metric="val_loss",
                            mode="min", max_concurrent=int(max_concurrent),
                            results_dir=str(Path(cfg["log_dir"]) / "wm_sweep"))
    return {"best_config": best.config, "best_metrics": best.metrics,
            "n_trials": len(trials), "n_failed": sum(t.failed for t in trials),
            "table": [{**t.config, **t.metrics} for t in trials if not t.failed]}


@experiment("world_model_imagine")
def world_model_imagine(cfg, horizon: int = 8, n_envs: int = 16, n_steps: int = 128,
                        eval_envs: int = 8, **kw):
    """Train ``world_model``, then encode one real frame of each of
    ``eval_envs`` fresh expert streams, imagine ``horizon`` steps open-loop
    under the logged actions, and score the decoded frames against the real
    future per step (MSE and SSIM); writes ``imagination_strip.png`` (env
    0, real above imagined) to ``log_dir``."""
    from PIL import Image

    r = world_model(cfg, n_envs=n_envs, n_steps=n_steps, **kw)
    model = r.pop("state").model
    dev = _device(cfg)
    town, params, rcfg = _sim_bits(cfg)
    store, _, _ = cl.collect_dataset(
        params, town, rcfg, torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 999),
        n_envs=eval_envs, n_steps=horizon + 1, device=dev)
    frames = (store.frames.reshape(eval_envs, horizon + 1, rcfg.height, rcfg.width, 1)
              .astype(np.float32) / 255.0)
    actions = store.actions.reshape(eval_envs, horizon + 1)
    with torch.no_grad():
        _, imagined = model.imagine_frames(
            torch.from_numpy(frames[:, 0]).to(dev),
            torch.from_numpy(actions[:, :horizon].astype(np.int64)).to(dev))
        real = torch.from_numpy(frames[:, 1:horizon + 1]).to(dev)
        mse_h = ((imagined - real) ** 2).mean(dim=(0, 2, 3, 4)).cpu()
        ssim_h = [float(ssim(imagined[:, t], real[:, t])[0]) for t in range(horizon)]
    strip = np.concatenate([
        np.concatenate(list(real[0, ..., 0].cpu().numpy()), axis=1),
        np.concatenate(list(imagined[0, ..., 0].cpu().numpy()), axis=1)], axis=0)
    path = Path(cfg["log_dir"]) / "imagination_strip.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.clip(strip * 255, 0, 255).astype(np.uint8)).save(path)
    return {"horizon": int(horizon), "mse_per_step": [float(v) for v in mse_h],
            "ssim_per_step": ssim_h, "train_val_loss": r["best_metric"],
            "strip_path": str(path)}


@experiment("dream_policy")
def dream_policy(cfg, n_envs: int = 16, n_steps: int = 200, seq_len: int = 8,
                 horizon: int = 15, imag_updates: int = 300, imag_batch: int = 128,
                 reward_steps: int = 300, eval_envs: int = 32, eval_steps: int = 150, **kw):
    """A policy trained in the world model's imagination: collect, fit the
    world model (``wm_rnn`` GRU by default), fit ``reward_ensemble`` reward
    heads on the recorded driving reward (``training.rl.reward_from_traj``),
    train a latent-BC policy on the expert's actions (the warm start,
    ``imag_warm_start``, and the anchor, ``imag_bc_anchor``), train the
    latent policy in imagination (``imag_*`` knobs), then drive it, the
    latent-BC policy and the expert in the real sim from one fleet start.
    ``policy_family=continuous`` conditions the whole chain on the expert's
    (steer, accel) and drives with continuous control."""
    dev, seed = _device(cfg), int(cfg.get("seed", 0))
    town, params, rcfg = _sim_bits(cfg)
    store, _, traj = cl.collect_dataset(params, town, rcfg, _generator(cfg), n_envs, n_steps,
                                        device=dev)
    # per-frame reward, env-major like the store's frames
    rewards = reward_from_traj(traj, PPOConfig()).transpose(0, 1).reshape(-1)
    del traj
    family = _control_space(cfg)
    continuous = family == "continuous"
    model = LatentWorldModel(z_size=int(cfg.get("wm_z_size", 64)),
                             rnn=str(cfg.get("wm_rnn", "gru")),
                             n_actions=int(cfg.get("n_actions", 9)), action_space=family,
                             height=rcfg.height, width=rcfg.width, dtype=_dtype(cfg))
    wm_fit = _fit(cfg, "dream_policy_wm", model, world_model_loss_fn(),
                  _world_model_loaders(cfg, store, n_envs, n_steps, seq_len, continuous))
    wm = wm_fit["state"].model
    frames = torch.from_numpy(store.frames).to(dev).to(torch.float32)[..., None] * (1.0 / 255.0)
    zs = imag.encode_frames(wm, frames)
    del frames
    draws = torch.Generator(device=dev).manual_seed(seed)
    inits = torch.Generator().manual_seed(seed + 1)
    ensemble = int(cfg.get("reward_ensemble", 5))
    head, rh_hist = imag.train_reward_head(zs, rewards, draws, inits, steps=reward_steps,
                                           ensemble=ensemble)
    anchor_coef = float(cfg.get("imag_bc_anchor", 0.3))
    warm_start = _flag(cfg, "imag_warm_start", True)
    bc_policy, bc_hist = None, None
    if anchor_coef > 0.0 or warm_start:
        if continuous:
            bc_policy = imag.ContinuousLatentPolicy(model.z_size)
            targets = torch.from_numpy(store.controls.astype(np.float32)).to(dev)
        else:
            bc_policy = imag.LatentPolicy(model.z_size, n_actions=model.n_actions)
            targets = torch.from_numpy(store.actions.astype(np.int64)).to(dev)
        bc_policy, bc_hist = imag.train_latent_bc(
            bc_policy, zs, targets, draws, inits, steps=int(cfg.get("latent_bc_steps", 400)),
            continuous=continuous)
        bc_policy.requires_grad_(False)
    policy, hist = imag.imagination_train(
        wm, head, zs, draws, inits, updates=imag_updates, batch=imag_batch,
        horizon=int(cfg.get("imag_horizon", horizon)),
        gamma=float(cfg.get("imag_gamma", 0.98)), lr=float(cfg.get("imag_lr", 3e-4)),
        entropy_coef=float(cfg.get("imag_entropy", 3e-3)),
        explore_std=float(cfg.get("imag_explore_std", 0.1)),
        disagree_coef=float(cfg.get("imag_disagree", 1.0)),
        anchor=bc_policy if anchor_coef > 0.0 else None, anchor_coef=anchor_coef,
        init=bc_policy if warm_start else None,
        uncertainty_stop=float(cfg.get("imag_uncertainty_stop", 0.0)))

    def evaluate(policy_fn, space: str = "discrete") -> dict:
        return cl.evaluate_policy(params, town, rcfg, policy_fn,
                                  torch.Generator().manual_seed(seed + 5), n_envs=eval_envs,
                                  n_steps=eval_steps, control_space=space, device=dev)

    out = {
        "wm_val_loss": wm_fit["history"][-1].get("val_loss"),
        "reward_head_mse": rh_hist,
        "imagination": hist,
        "imagined_return_first": hist[0]["imagined_return"],
        "imagined_return_last": hist[-1]["imagined_return"],
        "eval": evaluate(imag.latent_policy_fn(wm, policy), family),
        "expert": evaluate(None),
        "mitigations": {
            "reward_ensemble": ensemble,
            "imag_disagree": float(cfg.get("imag_disagree", 1.0)),
            "imag_bc_anchor": anchor_coef,
            "imag_warm_start": warm_start,
            "imag_uncertainty_stop": float(cfg.get("imag_uncertainty_stop", 0.0)),
        },
    }
    if bc_hist is not None:
        out["latent_bc_loss"] = bc_hist
        out["latent_bc_eval"] = evaluate(imag.latent_policy_fn(wm, bc_policy), family)
    return out


@experiment("bc_surround")
def bc_surround(cfg, n_envs: int = 8, n_steps: int = 200, eval_envs: int = 64,
                eval_steps: int = 200, **kw):
    """Surround-view BC: the policy sees every view of a camera rig, not the
    forward view alone. One expert trajectory renders from each view
    (``collect_multicamera``, kernel A); the streams stack as a trailing
    camera axis (``DeviceDataset(extra_frames=...)``), so a window is
    frame_skip·K channels, time-major and camera-minor, the rollout's own
    layout; the trained policy then drives the closed loop with the same
    rig (``make_rollout(cameras=...)``, kernel B once a view each step).
    ``surround_cameras`` picks the rig (default forward, FL and FR);
    ``policy_arch=vit`` works here too. A mesh shards the training batches."""
    cams = _surround_cams(cfg)
    if len(cams) < 2:
        cams = ("camera", "FL", "FR")
    town, params, rcfg = _sim_bits(cfg)
    dev, gen = _device(cfg), _generator(cfg)
    frames, state_log, starts = cl.collect_multicamera(params, town, rcfg, gen, cameras=cams,
                                                       n_envs=n_envs, n_steps=n_steps,
                                                       device=dev)
    fs = int(cfg.get("frame_skip", 4))
    base = pipe.FrameStore.from_arrays(frames[cams[0]], state_log, starts=starts)
    batch = int(cfg.get("BATCH_SIZE", 64))
    mesh, sharding = _mesh_bits(cfg)
    loaders = {f"{k}_dataloader": pipe.DeviceDataset(
        base.slice(a, b), batch, frame_skip=fs, shuffle=(k == "train"),
        drop_last=(k == "train"), extra_frames=[frames[c][a:b] for c in cams[1:]],
        sharding=sharding if k == "train" else None, device=dev)
        for k, (a, b) in _bounds(len(base)).items()}
    del frames
    model = _discrete_policy_model(cfg, fs * len(cams))
    result = _fit(cfg, "bc_surround", model, bc_loss_fn, loaders, mesh)
    trained = result["state"].model

    @torch.no_grad()
    def policy_fn(obs):
        return trained(obs).argmax(-1)

    result["eval"] = cl.evaluate_policy(params, town, rcfg, policy_fn, gen, n_envs=eval_envs,
                                        n_steps=eval_steps, frame_skip=fs, device=dev,
                                        cameras=cams)
    result["cameras"] = list(cams)
    return result


@experiment("collect_multicamera")
def collect_multicamera_data(cfg, n_envs: int = 8, n_steps: int = 128,
                             write_png: bool = True, **kw):
    """A multi-camera raw log in the reference's VAE data contract: one
    expert trajectory seen from the forward camera and FL/FR/SL/SR/RR
    (``cameras=`` another rig), each camera written as PNG frames
    (``write_png=False`` skips them) and as a packed store
    ``<cam>.tpuilfs`` with the episode starts, beside ``state.csv``. The
    result's ``seconds`` time the collection, the PNG and the packed
    writes apart."""
    cameras = tuple(kw.get("cameras", ("camera", "FL", "FR", "SL", "SR", "RR")))
    town, params, rcfg = _sim_bits(cfg)
    t0 = time.perf_counter()
    frames, state_log, starts = cl.collect_multicamera(
        params, town, rcfg, _generator(cfg), cameras=cameras, n_envs=n_envs,
        n_steps=n_steps, device=_device(cfg))
    seconds = {"collect": time.perf_counter() - t0, "png_write": 0.0, "packed_write": 0.0}
    data_dir = Path(cfg["data_dir"])
    root = data_dir / "raw" / kw.get("log_name", "SimLog1")
    packed = {}
    for cam, arr in frames.items():
        t0 = time.perf_counter()
        if write_png:
            fl.save_frames(root / cam, arr)
        t1 = time.perf_counter()
        store = pipe.FrameStore.from_arrays(arr, state_log, starts=starts)
        packed[cam] = str(save_framestore(root / f"{cam}.tpuilfs", store))
        seconds["png_write"] += t1 - t0
        seconds["packed_write"] += time.perf_counter() - t1
    fl.save_state_csv(root / "state.csv", state_log)
    fl.save_state_csv(data_dir / "raw" / "state.csv", state_log)
    return {"cameras": list(frames), "frames_per_camera": len(state_log), "log": str(root),
            "framestores": packed, "seconds": seconds}


@experiment("replay")
def replay(cfg, record: str | None = None, checkpoint: str | None = None, n_envs: int = 16,
           n_steps: int = 120, env_index: int = -1, out_height: int = 128,
           out_width: int = 128, make_gif: bool = True, **kw):
    """Record and replay an episode (CARLA's recorder): a record is the
    fleet's initial state and executed controls, a few KB, and the replay
    steps the simulator bit for bit (``training/replay.py``).

    Without ``record=`` the expert, or ``checkpoint=``'s policy, drives
    ``n_envs`` × ``n_steps`` and the record goes to ``log_dir/episode.npz``.
    Either way the whole fleet's dynamics replay, ``env_index`` (−1: the
    most eventful env, most collisions, then most distance) replays alone
    and must match (``replay_speed_max_abs_diff``), and, with ``make_gif``,
    it is re-rendered at ``out_height`` × ``out_width`` in RGB beside its
    class plane (the exact branch, kernel A) into a GIF."""
    from PIL import Image

    dev = _device(cfg)
    log_dir = Path(cfg["log_dir"])
    log_dir.mkdir(parents=True, exist_ok=True)
    if record:
        rec, rec_path = rp.load_record(record), str(record)
    else:
        town, params, rcfg = _sim_bits(cfg)
        policy_fn, space = None, "discrete"
        if checkpoint:
            policy_fn, _ = _policy_bits(cfg, checkpoint, rcfg.height, rcfg.width)
            space = _control_space(cfg)
        init_fn, rollout_fn = cl.make_rollout(params, town, rcfg, policy_fn,
                                              frame_skip=int(cfg.get("frame_skip", 4)),
                                              control_space=space, device=dev)
        carry = init_fn(_generator(cfg), n_envs)
        _, traj = rollout_fn(carry, n_steps)
        rec = rp.record_from_rollout(
            carry[0], traj, params=params,
            town_kwargs=town_kwargs_from_cfg(cfg, seed=int(cfg.get("data_seed", 0))),
            rcfg=rcfg, meta={"driver": "checkpoint" if checkpoint else "expert",
                             "seed": int(cfg.get("seed", 0))})
        del traj
        rec_path = rp.save_record(log_dir / "episode.npz", rec)

    dyn = rp.replay_record(rec, render=False, device=dev)
    collisions = dyn["collision"].sum(0).cpu().numpy()
    speed = dyn["speed"].cpu().numpy()
    km = speed.sum(axis=0)
    idx = env_index if env_index >= 0 else int(np.lexsort((-km, -collisions))[0])
    alone = rp.replay_record(rp.select_envs(rec, idx), render=False, device=dev)
    exact = float(np.abs(alone["speed"][:, 0].cpu().numpy() - speed[:, idx]).max())
    out = {"record": rec_path, "n_envs": rec.n_envs, "n_steps": rec.n_steps,
           "env_index": idx, "env_collisions": int(collisions[idx]),
           "replay_speed_max_abs_diff": exact,
           "record_bytes": Path(rec_path).stat().st_size}
    if make_gif:
        frames = rp.replay_record(
            rp.select_envs(rec, idx), device=dev,
            render_override={"height": out_height, "width": out_width, "rgb": True,
                             "semantic": True, "backend": "jax", "fast": False})
        rgb, sem = ((frames[k][:, 0].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
                    for k in ("rgb", "semantic_rgb"))
        imgs = [Image.fromarray(np.concatenate([a, b], axis=1)) for a, b in zip(rgb, sem)]
        gif = log_dir / f"replay_env{idx}.gif"
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=int(1000 * float(rec.sim.get("dt", 0.05))), loop=0)
        out["gif"] = str(gif)
    return out


@experiment("export_policy")
def export_policy_exp(cfg, checkpoint: str | None = None, artifact_dir: str | None = None,
                      height: int = 256, width: int = 256, verify_batches: tuple = (1, 7),
                      **kw):
    """Export a (checkpoint-restored) policy of ``policy_family`` and
    ``policy_arch`` as a ``torch.export`` artifact (``serving/export.py``;
    ``quantize=int8`` for the int8 program; surround checkpoints at their
    rig's width), then hold the loaded artifact against the live model of
    the same kind (the int8 copy for int8) at ``verify_batches``, warm the
    bucketed engine (``serve_max_batch``) and run one request. The artifact
    goes to ``artifact_dir`` (default ``<log_dir>/policy_artifact``)."""
    dev = _device(cfg)
    _, model = _policy_bits(cfg, checkpoint, height, width)
    model.eval()
    obs_size = int(cfg.get("frame_skip", 4)) * len(_surround_cams(cfg))
    family = "cil" if str(cfg.get("policy_family", "discrete")) == "cil" else _control_space(cfg)
    out = Path(artifact_dir or (Path(cfg["log_dir"]) / "policy_artifact"))
    quantize = str(cfg.get("quantize")) if cfg.get("quantize") else None
    t0 = time.perf_counter()
    (export_cil_policy if family == "cil" else export_policy)(
        model, out, height=height, width=width, obs_size=obs_size, quantize=quantize,
        device=dev, extra_meta={"n_actions": int(cfg.get("n_actions", 9)), "family": family,
                                "checkpoint": checkpoint or ""})
    export_s = time.perf_counter() - t0
    servable = load_policy(out, dev)
    live = quantize_params(model) if quantize else model

    def logits(m, obs, extras):
        out = m(obs, *extras)
        return (out[0] if family == "cil" else out).float()

    rng = np.random.default_rng(0)
    n_cmd = int(cfg.get("n_commands", 6))
    err, float_err = 0.0, 0.0
    with torch.no_grad():
        for b in verify_batches:
            x = torch.from_numpy(rng.integers(0, 256, (int(b), height, width, obs_size),
                                              dtype=np.uint8)).to(dev)
            extras = ()
            if family == "cil":
                extras = (torch.from_numpy(rng.uniform(0, 12, (int(b),)).astype(np.float32)).to(dev),
                          torch.from_numpy(rng.integers(0, n_cmd, (int(b),), dtype=np.int32)).to(dev))
            got = servable.call(x, *extras).float()
            obs = x.to(torch.float32) * (1.0 / 255.0)
            err = max(err, float((got - logits(live, obs, extras)).abs().max()))
            if quantize:
                float_err = max(float_err,
                                float((got - logits(model, obs, extras)).abs().max()))
    eng = InferenceEngine(servable, max_batch=int(cfg.get("serve_max_batch", 64)), device=dev)
    eng.warmup(height, width, obs_size,
               extra_specs=[((), np.float32), ((), np.int32)] if family == "cil" else [])
    smoke = rng.integers(0, 256, (3, height, width, obs_size), dtype=np.uint8)
    smoke_extras = (np.zeros(3, np.float32), np.zeros(3, np.int32)) if family == "cil" else ()
    # discrete and CIL artifacts serve actions; continuous ones their controls
    (eng.infer_logits if family == "continuous" else eng.infer)(smoke, *smoke_extras)
    result = {"artifact": str(out), "blob_bytes": int((out / "policy.pt2").stat().st_size),
              "platforms": list(servable.platforms), "roundtrip_max_abs_err": err,
              "export_seconds": export_s, "engine": eng.stats()}
    if quantize:
        result["vs_float_max_abs_err"] = float_err
    return result
