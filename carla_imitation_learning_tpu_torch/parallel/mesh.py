"""Device mesh and data parallelism over ``torch.distributed`` (the JAX
package's ``parallel/mesh.py``).

JAX runs one controller over every device and lets XLA insert the
collectives from the arrays' shardings. The torch idiom is SPMD over
processes, one rank per device (``torchrun --nproc-per-node N``):

- ``make_mesh`` names the axes of the world, ``("data",)`` or ``("data",
  "model")`` with ``model`` replicated, through ``init_device_mesh``;
- each rank owns its rows of every ``data``-sharded batch or fleet
  (``shard_batch``, ``Mesh.rows``) and holds the parameters and the data
  store whole (``shard_train_state`` broadcasts rank 0's);
- explicit collectives take the place of XLA's: the train step sums its
  gradients in one flat bucket, metrics and rollout counts are summed over
  ``data``. They use only ``all_reduce`` and ``broadcast``, the two that
  gloo runs on CUDA tensors as well as NCCL does.

Without a process group (one process, ``mesh.enabled`` set) the mesh has
one rank and every collective is the identity, so a mesh of one equals the
unsharded run. A rank's device is ``cuda:{LOCAL_RANK % device_count}``; the
backend is ``nccl`` for CUDA and ``gloo`` for the CPU unless the caller
names one (two ranks on one card need gloo: NCCL refuses them).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from carla_imitation_learning_tpu_torch.device import map_tensors, resolve_device

DATA = "data"
_ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for CUDA,
    the CPU otherwise."""
    if torch.device(device_type).type != "cuda":
        return torch.device("cpu")
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", global_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis names to sizes in order (``{"data": n, "model":
    1}``); ``device`` is this rank's device; ``device_mesh`` is torch's
    ``DeviceMesh`` over the process group, None for a mesh of one without
    a process group (every collective is then the identity)."""

    shape: dict
    device: torch.device
    device_mesh: object = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def size(self, axis: str = DATA) -> int:
        return int(self.shape[axis])

    def rank(self, axis: str = DATA) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    @property
    def is_writer(self) -> bool:
        """Rank 0 of the world: the one rank that writes logs and checkpoints."""
        return self.device_mesh is None or global_rank() == 0

    def rows(self, n: int, axis: str = DATA) -> slice:
        """This rank's rows of a leading dim of ``n`` sharded over ``axis``."""
        k = self.size(axis)
        if n % k:
            raise ValueError(f"{n} rows do not divide the mesh's {axis!r} axis of {k}")
        b = n // k
        r = self.rank(axis)
        return slice(r * b, (r + 1) * b)

    def all_reduce_(self, t: torch.Tensor, axis: str = DATA) -> torch.Tensor:
        """Sum ``t`` (contiguous) over ``axis`` in place; → ``t``."""
        if self.device_mesh is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.device_mesh.get_group(axis))
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's value of ``t`` on every rank, in place (a tensor off this
        rank's device travels through a copy on it); → ``t``."""
        if self.device_mesh is None:
            return t
        buf = t if t.device == self.device and t.is_contiguous() else t.to(self.device).contiguous()
        dist.broadcast(buf, src=0)
        if buf is not t:
            t.copy_(buf)
        return t

    def abort(self) -> None:
        """Take the default process group down after a failure that left
        the ranks out of step: every other rank's pending or next
        collective then raises instead of waiting (nothing to do for a
        mesh of one)."""
        if self.device_mesh is not None and dist.is_initialized():
            dist.destroy_process_group()

    def barrier(self) -> None:
        """Every rank waits for the others (an all-reduce of one element)."""
        self.all_reduce_(torch.zeros(1, device=self.device))

    def mean_grads_(self, grads: list, axis: str = DATA, mean: bool = True) -> None:
        """Average ``grads`` over ``axis`` in place through one flat bucket a
        dtype: its bytes are the gradients' bytes. ``mean=False`` leaves the
        sum, for a loss whose terms were already divided by a global count."""
        if self.device_mesh is None or not grads:
            return
        by_dtype: dict = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            self.all_reduce_(flat, axis)
            if mean:
                flat /= self.size(axis)
            torch._foreach_copy_(group, [f.view_as(g) for f, g in
                                         zip(flat.split([g.numel() for g in group]), group)])

    def mean_metrics(self, metrics: dict, axis: str = DATA) -> dict:
        """The means over ``axis`` of a dict of 0-d metric tensors, in one
        all-reduce; each keeps its dtype."""
        if self.device_mesh is None or not metrics:
            return metrics
        keys = list(metrics)
        wide = torch.float64 if any(metrics[k].dtype == torch.float64 for k in keys) \
            else torch.float32
        flat = torch.stack([metrics[k].detach().to(wide) for k in keys])
        self.all_reduce_(flat, axis)
        flat /= self.size(axis)
        return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


@dataclasses.dataclass(frozen=True, eq=False)
class BatchSharding:
    """A leading (batch or env) dim sharded over ``axis`` of ``mesh``; the
    other dims replicated."""

    mesh: Mesh
    axis: str = DATA

    def rows(self, n: int) -> slice:
        return self.mesh.rows(n, self.axis)


@dataclasses.dataclass(frozen=True, eq=False)
class Replicated:
    """Every rank holds the whole array."""

    mesh: Mesh


def _axis_sizes(cfg, axis_sizes: dict | None, world: int) -> dict:
    """The axes with the ``-1`` wildcard resolved against ``world`` ranks;
    raises when they ask for more ranks than the world has."""
    if axis_sizes is None:
        axes = cfg.get_dotted("mesh.axes", {DATA: -1}) if cfg is not None else {DATA: -1}
        axis_sizes = dict(axes or {DATA: -1})
    sizes = {str(k): int(v) for k, v in axis_sizes.items()}
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("only one mesh axis may be -1")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wild:
        sizes[wild[0]] = max(1, world // fixed)
    total = math.prod(sizes.values())
    if total > world:
        raise ValueError(f"mesh axes {sizes} ask for more ranks than the world has ({world})")
    if total < world:
        raise ValueError(f"mesh axes {sizes} leave ranks of the world ({world}) out")
    return sizes


def make_mesh(cfg=None, devices=None, axis_sizes: dict | None = None) -> Mesh:
    """A mesh over every rank of the world from ``axis_sizes`` or the
    config's ``mesh.axes`` (``-1`` = the ranks the other axes leave).
    ``devices`` is this rank's device (default the config's ``device``, else
    "cuda"; a bare "cuda" is ``rank_device()``): under SPMD the JAX
    package's device list is one device a rank. Raises
    ``ValueError`` when the axes ask for more ranks than the world has."""
    world = world_size()
    sizes = _axis_sizes(cfg, axis_sizes, world)
    if devices is None:
        devices = cfg.get("device", "cuda") if cfg is not None else "cuda"
    device = torch.device(devices)
    device = rank_device() if device.type == "cuda" and device.index is None \
        else resolve_device(device)
    device_mesh = None
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device.type, tuple(sizes.values()),
                                       mesh_dim_names=tuple(sizes))
    return Mesh(shape=sizes, device=device, device_mesh=device_mesh)


def batch_sharding(mesh: Mesh, axis: str = DATA, ndim_leading: int = 1) -> BatchSharding:
    """Shard the leading (batch/env) dim on ``axis``; the rest replicated."""
    return BatchSharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(mesh: Mesh, batch, axis: str = DATA):
    """This rank's rows of the leading dim of every tensor or array of
    ``batch`` (nested tuples, lists, dicts and tensor dataclasses)."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return batch[mesh.rows(batch.shape[0], axis)]
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v, axis) for v in batch)
    if dataclasses.is_dataclass(batch):
        return map_tensors(batch, lambda t: t[mesh.rows(t.shape[0], axis)])
    return batch


def shard_train_state(mesh: Mesh, state):
    """Replicate a ``TrainState`` over the mesh: rank 0's parameters,
    buffers, EMA shadow and optimizer state on every rank. The state then
    averages its gradients over ``data`` (``TrainState.apply_gradients``),
    and its models draw in-step noise at the global batch and keep their
    rows (``draw_shard``). → ``state``."""
    tensors = list(state.model.state_dict().values())
    if state.ema is not None:
        tensors += list(state.ema.state_dict().values())
    for per_param in state.optimizer.state.values():
        tensors += [v for v in per_param.values() if isinstance(v, torch.Tensor)]
    for t in tensors:
        mesh.broadcast_(t)
    state.mesh = mesh
    for model in (state.model, state.ema):
        if model is not None:
            model.draw_shard = (mesh.rank(), mesh.size())
    return state


def maybe_mesh(cfg=None, batch_size: int | None = None) -> Mesh | None:
    """A mesh when the world has more than one rank and ``batch_size``
    divides across it, or when the config sets ``mesh.enabled``; else None
    (a run of one rank skips sharding). The config's axes are checked
    against the world first: asking for more ranks raises ``ValueError``."""
    n = world_size()
    _axis_sizes(cfg, None, n)
    forced = False
    if cfg is not None:
        v = cfg.get_dotted("mesh.enabled", False)
        forced = v.strip().lower() not in ("0", "false", "no", "off", "") \
            if isinstance(v, str) else bool(v)
    if n <= 1 and not forced:
        return None
    if batch_size is not None and batch_size % n != 0 and not forced:
        return None
    return make_mesh(cfg)


def multihost_initialize(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, backend: str | None = None,
                         device: str | None = None, **kwargs) -> bool:
    """Join the process group of a multi-process run. → True when the world
    (now) has more than one rank.

    Reads torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``MASTER_ADDR`` (with ``MASTER_PORT``), or takes an explicit
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``. With none of them set it returns False and touches
    nothing. ``device`` ("cuda", the default when a card is present, or
    "cpu") picks the backend, ``nccl`` or ``gloo``, unless ``backend``
    names one; for CUDA the rank's card (``rank_device``) becomes the
    current device first. A failed initialization raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None
    if not explicit and not any(os.environ.get(k) for k in _ENV_KEYS):
        return False
    dev_type = torch.device(device if device is not None
                            else "cuda" if torch.cuda.is_available() else "cpu").type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id), **kwargs)
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    return dist.get_world_size() > 1
