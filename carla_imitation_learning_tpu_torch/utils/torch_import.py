"""Import the reference system's trained PyTorch (Lightning) checkpoints
(the JAX package's ``utils/torch_import.py``).

A reference ``.ckpt`` is a Lightning pickle of ``Imitation(net=ConvNet1)``
whose state dict holds ``cnn_base.{0,3,6,9}`` convs and ``fc.{0,2,4}``
linears, under a ``net.`` prefix or bare. Both are torch layouts already,
so they map onto this package's state-dict names unchanged:

- ``ConvNet1`` → ``PolicyCNN`` (channels 16, 32, 64, 128; head 64, 32);
- ``ConvNetRawSegment`` → ``DualStreamCNN`` (32, 64, 128, 256; 200, 48);
  the checkpoint's widths decide which model the result fits.
- ``CNNAutoEncoder`` is not importable: the reference class cannot run a
  forward pass, so no checkpoint of it exists.

At the reference's 256² input the trunk's last map is 1 × 1, so its NCHW
flatten and this package's NHWC flatten give the same features and the
first linear needs no permutation. The result is saved in this package's
checkpoint format, which every ``--checkpoint`` consumer restores
(``closed_loop_eval``, ``export_policy``, ``rl_finetune``, ``test_eval``).
"""

from __future__ import annotations

from pathlib import Path

import torch

# reference module layout: Sequential indices of the layers with weights
_CONV_IDX = (0, 3, 6, 9)   # cnn_base.{i}: Conv2d between ReLU/MaxPool
_FC_IDX = (0, 2, 4)        # fc.{i}: Linear between ReLUs


def _state_dict(path_or_sd) -> dict:
    """A checkpoint file's state dict (``state_dict`` of a Lightning pickle,
    else the file's dict itself), or a given state dict, as CPU tensors.
    The file is unpickled in full, as a Lightning checkpoint needs: load only
    checkpoints you trust."""
    if isinstance(path_or_sd, (str, Path)):
        blob = torch.load(str(path_or_sd), map_location="cpu", weights_only=False)
        path_or_sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: torch.as_tensor(v.detach().cpu() if hasattr(v, "detach") else v)
            for k, v in path_or_sd.items()}


def _strip_prefix(sd: dict) -> dict:
    """Lightning saves the wrapped net under its attribute name
    (``net.cnn_base.0.weight``); a bare module's state dict has no prefix.
    Strip any single leading component that all keys share and that is not
    the architecture's own (``cnn_base``, ``fc``)."""
    while True:
        heads = {k.split(".", 1)[0] for k in sd}
        if heads <= {"cnn_base", "fc"}:
            return sd
        if len(heads) != 1 or any("." not in k for k in sd):
            raise ValueError(
                f"unrecognized checkpoint layout; top-level keys {sorted(heads)}"
                " (expected cnn_base.*/fc.* under at most one wrapper prefix)")
        sd = {k.split(".", 1)[1]: v for k, v in sd.items()}


def import_reference_policy(path_or_sd) -> dict:
    """Reference ConvNet1 / ConvNetRawSegment weights → the state dict of
    this package's ``PolicyCNN`` / ``DualStreamCNN`` (float32 tensors)."""
    sd = _strip_prefix(_state_dict(path_or_sd))
    missing = [k for i in _CONV_IDX for k in
               (f"cnn_base.{i}.weight", f"cnn_base.{i}.bias") if k not in sd] + \
              [k for i in _FC_IDX for k in
               (f"fc.{i}.weight", f"fc.{i}.bias") if k not in sd]
    if missing:
        raise ValueError(f"checkpoint lacks reference-policy keys: {missing}")
    out = {}
    for j, i in enumerate(_CONV_IDX):
        for leaf in ("weight", "bias"):
            out[f"trunk.convs.{j}.{leaf}"] = sd[f"cnn_base.{i}.{leaf}"].float().clone()
    for j, i in enumerate(_FC_IDX):
        for leaf in ("weight", "bias"):
            out[f"head.layers.{j}.{leaf}"] = sd[f"fc.{i}.{leaf}"].float().clone()
    return out


def import_and_save(ckpt_path, out_dir) -> str:
    """Convert a reference checkpoint and save it as ``{"params": state
    dict}`` in directory ``out_dir`` (``utils.checkpoint.save_pytree``)."""
    from carla_imitation_learning_tpu_torch.utils.checkpoint import save_pytree

    save_pytree(out_dir, {"params": import_reference_policy(ckpt_path)})
    return str(out_dir)
