"""Policy export: a trained policy as a self-contained ``torch.export``
artifact that serves without the model's source (the JAX package's
``serving/export.py``, with ``torch.export`` in place of StableHLO).

- the weights are baked into the program (``policy.pt2``, one file);
- the batch dimension is a ``torch.export.Dim``: one artifact serves any
  request size;
- the input is the transport format, the raw uint8 NHWC frame window as the
  rollout's frame buffer holds it; the /255 is inside the program.

Artifact layout (a directory):
    policy.pt2   — ``torch.export.save`` of the exported program
    meta.json    — the JAX package's fields: ``format_version``,
                   ``platforms``, ``inputs`` (the batch dim named ``"b"``),
                   ``outputs``, ``kind``, ``model``, ``height``, ``width``,
                   ``obs_size``, ``quantize``, and the caller's (``family``,
                   ``n_actions``, ``n_commands``, ``checkpoint``), with
                   ``torch_version`` where JAX has ``jax_version``

``load_policy`` needs only torch: no model class, no state dict. The
program runs on the card unless the caller asks for the CPU; it moves there
with ``torch.export.passes.move_to_device_pass``. ``platforms`` names the
device type the program was exported and checked on.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Sequence

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.serving.quant import FramesPolicy, quantize_params

FORMAT_VERSION = 1
_BLOB = "policy.pt2"
_JAX_BLOB = "policy.stablehlo"
_META = "meta.json"
_EXAMPLE_BATCH = 3   # torch.export specializes sizes 0 and 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _spec_to_json(shape, dtype) -> dict:
    return {"shape": [str(d) for d in shape], "dtype": _dtype_name(dtype)}


def export_fn(
    fn: nn.Module,
    example_specs: Sequence[tuple],
    path: str | Path,
    *,
    device: str | torch.device | None = None,
    meta: dict | None = None,
) -> Path:
    """Export ``fn(*args)`` (an ``nn.Module``; its weights are baked in) to
    directory ``path``. ``example_specs`` are ``(shape, dtype)`` pairs; a dim
    given as a string (``"b"``) is one ``torch.export.Dim`` shared by every
    input that names it, so the program takes any size there. The program is
    traced on ``device`` (default: where ``fn``'s first parameter or buffer
    lies, else the card)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if device is None:
        first = next(iter(list(fn.parameters()) + list(fn.buffers())), None)
        device = first.device if first is not None else "cuda"
    dev = resolve_device(device)
    dims: dict[str, torch.export.Dim] = {}
    args, dynamic = [], []
    for shape, dtype in example_specs:
        sizes, dyn = [], {}
        for i, d in enumerate(shape):
            if isinstance(d, str):
                dyn[i] = dims.setdefault(d, torch.export.Dim(d, min=1))
                sizes.append(_EXAMPLE_BATCH)
            else:
                sizes.append(int(d))
        args.append(torch.zeros(sizes, dtype=dtype, device=dev))
        dynamic.append(dyn or None)
    fn = fn.to(dev).eval()
    with torch.no_grad():
        program = torch.export.export(fn, tuple(args), dynamic_shapes=tuple(dynamic))
        outs = fn(*args)
    program.example_inputs = None   # the all-zero example batch
    for node in program.graph.nodes:   # source lines of the exporting machine
        node.meta.pop("stack_trace", None)
    torch.export.save(program, path / _BLOB)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    batch = next(iter(dims), None)   # every output leads with the batch
    info = {
        "format_version": FORMAT_VERSION,
        "platforms": [dev.type],
        "inputs": [_spec_to_json(s, dt) for s, dt in example_specs],
        "outputs": [_spec_to_json([batch or o.shape[0], *o.shape[1:]], o.dtype) for o in outs],
        "torch_version": torch.__version__,
    }
    info.update(meta or {})
    (path / _META).write_text(json.dumps(info, indent=1))
    return path


def export_policy(
    model: nn.Module,
    path: str | Path,
    *,
    height: int,
    width: int,
    obs_size: int = 4,
    device: str | torch.device | None = None,
    quantize: str | None = None,
    extra_meta: dict | None = None,
) -> Path:
    """Export a frames → output policy (``PolicyCNN``, ``ContinuousPolicyCNN``,
    ``ViTPolicy``) as a servable: uint8 NHWC ``(b, height, width, obs_size)``
    in, the model's float32 output ``(b, n)`` out (argmax is the engine's
    job). ``quantize="int8"`` exports the int8 program of
    ``serving/quant.py``, whose int8 weights are baked in."""
    if quantize == "int8":
        model = quantize_params(model)
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    meta = {"kind": "policy", "model": type(model).__name__,
            "height": height, "width": width, "obs_size": obs_size,
            "quantize": quantize or "none"}
    meta.update(extra_meta or {})
    return export_fn(FramesPolicy(model), [(("b", height, width, obs_size), torch.uint8)],
                     path, device=device, meta=meta)


class CILServable(nn.Module):
    """``(frames_u8, speed, command) -> action logits`` of a
    ``BranchedCILPolicy``: the command clipped into the head's branches,
    the speed head dropped."""

    def __init__(self, model: nn.Module, n_commands: int):
        super().__init__()
        self.model, self.n_commands = model, n_commands

    def forward(self, frames_u8, speed, command):
        obs = frames_u8.to(torch.float32) * (1.0 / 255.0)
        cmd = torch.clamp(command, 0, self.n_commands - 1)
        logits, _ = self.model(obs, speed.to(torch.float32), cmd)
        return logits


def export_cil_policy(
    model: nn.Module,
    path: str | Path,
    *,
    height: int,
    width: int,
    obs_size: int = 4,
    device: str | torch.device | None = None,
    quantize: str | None = None,
    extra_meta: dict | None = None,
) -> Path:
    """Export a ``BranchedCILPolicy`` as a three-input servable: ``(frames_u8
    (b, H, W, C), speed float32 (b,), command int32 (b,)) → logits (b,
    n_actions)``, one batch dim for all three. The command clip is inside
    the program; the speed head (a training-time auxiliary) is not
    exported. ``quantize="int8"`` runs the convs and linears in int8; the
    branch products stay float."""
    n_commands = int(getattr(model, "n_commands", 0)) or 1
    name = type(model).__name__
    if quantize == "int8":
        model = quantize_params(model)
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    specs = [(("b", height, width, obs_size), torch.uint8), (("b",), torch.float32),
             (("b",), torch.int32)]
    meta = {"kind": "policy", "model": name,
            "height": height, "width": width, "obs_size": obs_size,
            "family": "cil", "n_commands": n_commands,
            "quantize": quantize or "none"}
    meta.update(extra_meta or {})
    return export_fn(CILServable(model, n_commands), specs, path, device=device, meta=meta)


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    return (a if isinstance(a, torch.Tensor) else torch.as_tensor(a)).to(device)


class LoadedPolicy:
    """A loaded servable: ``call(*arrays)`` runs the exported program on
    ``device`` (numpy arrays and tensors elsewhere are moved there first)
    and returns a tensor on it. Wrap it in ``serving.engine.InferenceEngine``
    for padding, batching and latency stats."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self._module = program.module()
        self.meta = meta
        self.device = device

    @property
    def platforms(self) -> tuple:
        return tuple(self.meta.get("platforms", ()))

    def call(self, *args) -> torch.Tensor:
        with torch.no_grad():
            return self._module(*(_as_tensor(a, self.device) for a in args))

    def __call__(self, *args) -> torch.Tensor:
        return self.call(*args)


def load_policy(path: str | Path, device: str | torch.device | None = None) -> LoadedPolicy:
    """The servable in directory ``path`` on ``device`` (default the card).
    A JAX package artifact (``policy.stablehlo``) raises ``ValueError``."""
    path = Path(path)
    if (path / _JAX_BLOB).exists():
        raise ValueError(
            f"{path} is a JAX package artifact (StableHLO, {_JAX_BLOB}); this "
            f"package serves torch.export artifacts ({_BLOB}): export the "
            "checkpoint with this package's export_policy")
    if not (path / _BLOB).exists() or not (path / _META).exists():
        raise ValueError(f"{path} is no policy artifact: it lacks {_BLOB} or {_META}")
    meta = json.loads((path / _META).read_text())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"artifact format {meta.get('format_version')} != {FORMAT_VERSION}")
    dev = resolve_device("cuda" if device is None else device)
    program = torch.export.load(path / _BLOB)
    program = move_to_device_pass(program, dev)
    return LoadedPolicy(program, meta, dev)


def policy_fn_from_servable(servable: LoadedPolicy) -> Callable:
    """The closed loop's ``policy_fn`` from a loaded artifact, so the program
    that ships is the one scored. The rollout hands the policy float obs =
    framebuf / 255; ``round(obs · 255)`` gives the uint8 window back exactly.
    ``meta.family`` decides the output: ``continuous`` artifacts emit
    (steer, accel), passed through (run them with
    ``control_space="continuous"``); ``cil`` artifacts take the rollout's
    speed and command (the clip is inside the program); the others' logits
    are argmaxed."""
    family = servable.meta.get("family")

    def frames_of(obs):
        return torch.clamp(torch.round(obs * 255.0), 0, 255).to(torch.uint8)

    if family == "cil":
        def policy_fn(obs, extras):
            logits = servable.call(frames_of(obs), extras["speed"].to(torch.float32),
                                   extras["command"].to(torch.int32))
            return logits.argmax(-1)
        return policy_fn

    def policy_fn(obs):
        out = servable.call(frames_of(obs))
        return out.to(torch.float32) if family == "continuous" else out.argmax(-1)

    return policy_fn
