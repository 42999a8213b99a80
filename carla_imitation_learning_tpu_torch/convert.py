"""Convert the JAX package's pytrees into this package's objects.

Everything here reads its input through ``np.asarray`` on named fields, so
it takes the JAX package's objects (flax params, ``TownMap``, ``WorldState``,
packed spawn pool, ``TriangleSetup``, ``PrimSetup``, rollout carry, train
state) without importing JAX. The port can then run on exactly what the JAX
package computed.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from carla_imitation_learning_tpu_torch.models.aux import AuxNet
from carla_imitation_learning_tpu_torch.models.cil import BranchedCILPolicy
from carla_imitation_learning_tpu_torch.models.cnn import (
    ContinuousPolicyCNN, DualStreamCNN, PolicyCNN,
)
from carla_imitation_learning_tpu_torch.models.rnn_policy import RecurrentPolicy
from carla_imitation_learning_tpu_torch.models.vae import ConvVAE
from carla_imitation_learning_tpu_torch.models.vit import ViTPolicy
from carla_imitation_learning_tpu_torch.models.world_model import LatentWorldModel
from carla_imitation_learning_tpu_torch.ops.raster_fast import PrimSetup
from carla_imitation_learning_tpu_torch.render.camera import TriangleSetup
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import WorldState
from carla_imitation_learning_tpu_torch.training.imagination import (
    ContinuousLatentPolicy, HeadEnsemble, LatentPolicy, RewardHead,
)
from carla_imitation_learning_tpu_torch.training.rl import ActorCriticCNN
from carla_imitation_learning_tpu_torch.training.steps import (
    AdamConfig, TrainState, create_train_state,
)

_STATE_INTS = ("ego_route", "agents_route", "peds_crossing", "t", "goal", "rng")


def _tensor(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)


def _dense(dense) -> tuple[torch.Tensor, torch.Tensor]:
    """Flax Dense params → (Linear weight (out, in), bias)."""
    return (_tensor(np.asarray(dense["kernel"], np.float32).T),
            _tensor(np.asarray(dense["bias"], np.float32)))


def _conv(conv) -> tuple[torch.Tensor, torch.Tensor]:
    """Flax Conv params → (Conv2d weight OIHW, bias)."""
    return (_tensor(np.transpose(np.asarray(conv["kernel"], np.float32), (3, 2, 0, 1))),
            _tensor(np.asarray(conv["bias"], np.float32)))


def _conv_transpose(conv) -> tuple[torch.Tensor, torch.Tensor]:
    """Flax ConvTranspose params → (ConvTranspose2d weight (in, out, kh,
    kw), bias): flax correlates with its (kh, kw, in, out) kernel as
    stored, torch with the weight flipped in both spatial axes, so the
    kernel is flipped, then transposed."""
    k = np.flip(np.asarray(conv["kernel"], np.float32), axis=(0, 1))
    return (_tensor(np.transpose(k, (2, 3, 0, 1))),
            _tensor(np.asarray(conv["bias"], np.float32)))


def _put(sd: dict, name: str, pair) -> None:
    sd[f"{name}.weight"], sd[f"{name}.bias"] = pair


def _trunk_state_dict(trunk) -> dict:
    sd = {}
    for i in range(len(trunk)):
        _put(sd, f"trunk.convs.{i}", _conv(trunk[f"Conv_{i}"]))
    return sd


def _head_state_dict(head, prefix: str) -> dict:
    return {k: v for i in range(len(head)) for k, v in zip(
        (f"{prefix}.layers.{i}.weight", f"{prefix}.layers.{i}.bias"), _dense(head[f"Dense_{i}"]))}


def policy_state_dict(params) -> dict:
    """Flax ``PolicyCNN`` (or ``ContinuousPolicyCNN``, the same tree with a
    2-way head, or ``DualStreamCNN``, the same tree with a wider trunk and
    head) params → ``models.cnn`` state_dict: conv kernels HWIO → OIHW,
    Dense kernels (in, out) → Linear (out, in)."""
    return {**_trunk_state_dict(params["ConvTrunk_0"]),
            **_head_state_dict(params["MLPHead_0"], "head")}


def actor_critic_state_dict(params) -> dict:
    """Flax ``ActorCriticCNN`` params → ``training.rl.ActorCriticCNN``
    state_dict: the actor as ``policy_state_dict`` (``ConvTrunk_0``,
    ``MLPHead_0``), the critic (``MLPHead_1``) as ``critic.*``, and
    ``log_std`` for the Gaussian actor."""
    sd = {**policy_state_dict(params), **_head_state_dict(params["MLPHead_1"], "critic")}
    if "log_std" in params:
        sd["log_std"] = _tensor(np.asarray(params["log_std"], np.float32))
    return sd


def dual_stream_state_dict(params) -> dict:
    """Flax ``DualStreamCNN`` params → ``models.cnn.DualStreamCNN``
    state_dict (``policy_state_dict``'s names)."""
    return policy_state_dict(params)


def _decoder_state_dict(dec, prefix: str) -> dict:
    sd = {}
    _put(sd, f"{prefix}.seed", _dense(dec["Dense_0"]))
    for i in range(len(dec) - 1):
        _put(sd, f"{prefix}.deconvs.{i}", _conv_transpose(dec[f"ConvTranspose_{i}"]))
    return sd


def aux_state_dict(params) -> dict:
    """Flax ``AuxNet`` params → ``models.aux.AuxNet`` state_dict: the trunk,
    the sensor MLP and fusion layer (flax's ``Dense_0..2``), the traffic and
    action heads (``MLPHead_0``, ``MLPHead_1``), the recon decoder
    (``ReconDecoder_0``) and the seg decoder (``ReconDecoder_1``) when
    present."""
    sd = _trunk_state_dict(params["ConvTrunk_0"])
    for name, dense in (("sensor_fc1", "Dense_0"), ("sensor_fc2", "Dense_1"),
                        ("fuse_fc", "Dense_2")):
        _put(sd, name, _dense(params[dense]))
    sd.update(_head_state_dict(params["MLPHead_0"], "traffic_head"))
    sd.update(_head_state_dict(params["MLPHead_1"], "action_head"))
    sd.update(_decoder_state_dict(params["ReconDecoder_0"], "recon"))
    if "ReconDecoder_1" in params:
        sd.update(_decoder_state_dict(params["ReconDecoder_1"], "seg"))
    return sd


def vae_state_dict(params) -> dict:
    """Flax ``ConvVAE`` params → ``models.vae.ConvVAE`` state_dict."""
    sd = {}
    n_enc = sum(k.startswith("enc_") for k in params)
    n_dec = sum(k.startswith("dec_") for k in params)
    for i in range(n_enc):
        _put(sd, f"encoder.{i}", _conv(params[f"enc_{i}"]))
    for name in ("to_mu", "to_log_var", "z_to_hidden"):
        _put(sd, name, _dense(params[name]))
    for i in range(n_dec):
        _put(sd, f"decoder.{i}", _conv_transpose(params[f"dec_{i}"]))
    return sd


def cil_state_dict(params) -> dict:
    """Flax ``BranchedCILPolicy`` params → ``models.cil`` state_dict: the
    trunk and the three Dense layers (speed 32, fused 128, speed head 1, in
    flax's creation order) as for ``policy_state_dict``; the branch tensors
    copied in their (K, F, H) / (K, H, A) layouts."""
    sd = _trunk_state_dict(params["ConvTrunk_0"])
    for name, dense in (("speed_fc", "Dense_0"), ("fuse_fc", "Dense_1"),
                        ("speed_head", "Dense_2")):
        _put(sd, name, _dense(params[dense]))
    for name in ("branch_w1", "branch_b1", "branch_w2", "branch_b2"):
        sd[name] = _tensor(np.asarray(params[name], np.float32))
    return sd


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _cell_state_dict(cell, prefix: str) -> dict:
    """Flax ``OptimizedLSTMCell`` or ``GRUCell`` params → ``models.rnn``'s
    (in, out) kernels with the gates side by side."""
    cat = np.concatenate
    if "hi" in cell:
        gates = ("i", "f", "g", "o")
        return {f"{prefix}.w_i": _tensor(cat([_np(cell[f"i{g}"]["kernel"]) for g in gates], -1)),
                f"{prefix}.w_h": _tensor(cat([_np(cell[f"h{g}"]["kernel"]) for g in gates], -1)),
                f"{prefix}.b_h": _tensor(cat([_np(cell[f"h{g}"]["bias"]) for g in gates], -1))}
    gates = ("r", "z", "n")
    return {f"{prefix}.w_i": _tensor(cat([_np(cell[f"i{g}"]["kernel"]) for g in gates], -1)),
            f"{prefix}.b_i": _tensor(cat([_np(cell[f"i{g}"]["bias"]) for g in gates], -1)),
            f"{prefix}.w_h": _tensor(cat([_np(cell[f"h{g}"]["kernel"]) for g in gates], -1)),
            f"{prefix}.b_hn": _tensor(_np(cell["hn"]["bias"]))}


def rnn_policy_state_dict(params) -> dict:
    """Flax ``RecurrentPolicy`` params (``trunk``, ``cell``, ``head``) →
    ``models.rnn_policy.RecurrentPolicy`` state_dict."""
    return {**_trunk_state_dict(params["trunk"]), **_cell_state_dict(params["cell"], "cell"),
            **_head_state_dict(params["head"], "head")}


def frame_encoder_state_dict(enc, prefix: str = "") -> dict:
    """Flax ``FrameEncoder`` params → ``models.world_model.FrameEncoder``'s."""
    sd = {}
    for i in range(4):
        _put(sd, f"{prefix}convs.{i}", _conv(enc[f"Conv_{i}"]))
    _put(sd, f"{prefix}dense", _dense(enc["Dense_0"]))
    return sd


def frame_decoder_state_dict(dec, prefix: str = "") -> dict:
    """Flax ``FrameDecoder`` params → ``models.world_model.FrameDecoder``'s
    (transposed-conv kernels flipped)."""
    sd = {}
    for i in range(4):
        _put(sd, f"{prefix}deconvs.{i}", _conv_transpose(dec[f"ConvTranspose_{i}"]))
    _put(sd, f"{prefix}seed", _dense(dec["Dense_0"]))
    return sd


def world_model_state_dict(params) -> dict:
    """Flax ``LatentWorldModel`` params → ``models.world_model`` state_dict:
    the encoder, the decoder, the LSTM or GRU cell and ``to_z``."""
    sd = {**frame_encoder_state_dict(params["encoder"], "encoder."),
          **frame_decoder_state_dict(params["decoder"], "decoder."),
          **_cell_state_dict(params["rnn_layer"]["cell"], "cell")}
    _put(sd, "to_z", _dense(params["to_z"]))
    return sd


def vit_state_dict(params) -> dict:
    """Flax ``ViTPolicy`` params → ``models.vit.ViTPolicy`` state_dict: the
    attention kernels (dim, heads, head_dim) and (heads, head_dim, dim)
    flattened over (heads, head_dim), LayerNorm ``scale`` as ``weight``."""
    sd = {"pos_emb": _tensor(_np(params["pos_emb"]))}
    _put(sd, "patch_embed", _conv(params["Conv_0"]))
    _put(sd, "head", _dense(params["Dense_0"]))

    def norm(name, ln):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _tensor(_np(ln["scale"])), _tensor(_np(ln["bias"]))

    norm("norm", params["LayerNorm_0"])
    for i in range(sum(k.startswith("TransformerBlock_") for k in params)):
        blk, pre = params[f"TransformerBlock_{i}"], f"blocks.{i}"
        norm(f"{pre}.ln1", blk["LayerNorm_0"])
        norm(f"{pre}.ln2", blk["LayerNorm_1"])
        _put(sd, f"{pre}.fc1", _dense(blk["Dense_0"]))
        _put(sd, f"{pre}.fc2", _dense(blk["Dense_1"]))
        att = blk["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            k = _np(att[name]["kernel"])
            sd[f"{pre}.{name}.weight"] = _tensor(k.reshape(k.shape[0], -1).T)
            sd[f"{pre}.{name}.bias"] = _tensor(_np(att[name]["bias"]).reshape(-1))
        k = _np(att["out"]["kernel"])
        sd[f"{pre}.out.weight"] = _tensor(k.reshape(-1, k.shape[-1]).T)
        sd[f"{pre}.out.bias"] = _tensor(_np(att["out"]["bias"]))
    return sd


def latent_mlp_state_dict(params) -> dict:
    """Flax ``RewardHead``, ``LatentPolicy`` or ``ContinuousLatentPolicy``
    params (``Dense_0``, ``Dense_1``) → ``fc1``/``fc2``; a stacked reward
    head (a leading ensemble axis, ``jax.vmap`` of its init) →
    ``HeadEnsemble``'s ``weight1``/``bias1``/``weight2``/``bias2``."""
    if np.ndim(params["Dense_0"]["kernel"]) == 2:
        sd = {}
        _put(sd, "fc1", _dense(params["Dense_0"]))
        _put(sd, "fc2", _dense(params["Dense_1"]))
        return sd
    return {f"{w}{i}": _tensor(np.swapaxes(_np(params[f"Dense_{i - 1}"][k]), -1, -2)
                                if k == "kernel" else _np(params[f"Dense_{i - 1}"][k]))
            for i in (1, 2) for w, k in (("weight", "kernel"), ("bias", "bias"))}


def _family(params) -> str:
    """Which model a flax params tree belongs to, from its names and shapes:
    an ``AuxNet`` also has an ``MLPHead_1``, so the actor-critic (a second
    head and no decoder) is told apart after it."""
    if "rnn_layer" in params:
        return "world_model"
    if "cell" in params:
        return "rnn_policy"
    if "pos_emb" in params:
        return "vit"
    if set(params) == {"Dense_0", "Dense_1"}:
        return "latent_mlp"
    if "enc_0" in params:
        return "vae"
    if "ReconDecoder_0" in params:
        return "aux"
    if "branch_w1" in params:
        return "cil"
    if "MLPHead_1" in params:
        return "actor_critic"
    if np.asarray(params["ConvTrunk_0"]["Conv_0"]["kernel"]).shape[3] == 32:
        return "dual_stream"
    return "policy"


def _stem(params) -> tuple[int, bool]:
    """(obs_size, s2d_stem) of a tree's trunk: a space-to-depth stem's first
    kernel is (3, 3, 9·obs, out), a standard one (7, 7, obs, out); told
    apart by the input channels, which a standard stem of 9·obs frames
    would share only with a 3×3 kernel."""
    k = np.asarray(params["ConvTrunk_0"]["Conv_0"]["kernel"]).shape
    s2d = k[:2] == (3, 3) and k[2] % 9 == 0
    return (k[2] // 9 if s2d else k[2]), s2d


def params_state_dict(params) -> dict:
    """The state dict of whichever model the tree belongs to: ``ConvVAE``,
    ``AuxNet``, ``BranchedCILPolicy``, ``ActorCriticCNN``, ``DualStreamCNN``,
    ``LatentWorldModel``, ``RecurrentPolicy``, ``ViTPolicy``, a latent MLP
    (reward head, stacked or not, or latent policy) or the ``PolicyCNN``
    shape."""
    return {"vae": vae_state_dict, "aux": aux_state_dict, "cil": cil_state_dict,
            "world_model": world_model_state_dict, "rnn_policy": rnn_policy_state_dict,
            "vit": vit_state_dict, "latent_mlp": latent_mlp_state_dict,
            "actor_critic": actor_critic_state_dict,
            "dual_stream": dual_stream_state_dict,
            "policy": policy_state_dict}[_family(params)](params)


def model_for_params(params, dtype: torch.dtype = torch.bfloat16,
                     continuous: bool = False) -> nn.Module:
    """The port's module for a flax params tree, its shapes read from the
    tree: ``ConvVAE`` (by its ``enc_*`` layers; the input size from the
    first Dense layer's width, 2048 meaning the 224² chain), ``AuxNet``
    (a ``ReconDecoder``), ``BranchedCILPolicy`` (branch tensors),
    ``ActorCriticCNN`` (a second head; Gaussian with a ``log_std``),
    ``DualStreamCNN`` (a 32-channel first conv), else
    ``ContinuousPolicyCNN`` (``continuous``) or ``PolicyCNN``; the
    policies and the actor-critic with the space-to-depth stem when the
    tree's first kernel is one (``_stem``); ``LatentWorldModel``,
    ``RecurrentPolicy``, ``ViTPolicy`` and the imagination's reward heads
    and latent policies as ``_sequence_family_for_params`` reads them."""
    family = _family(params)
    if family == "vae":
        return _vae_for_params(params, dtype)
    if family in ("world_model", "rnn_policy", "vit", "latent_mlp"):
        return _sequence_family_for_params(family, params, dtype, continuous)
    obs_size, s2d = _stem(params)
    if family == "aux":
        n_ups = sum(k.startswith("ConvTranspose_") for k in params["ReconDecoder_0"])
        seg = params.get("ReconDecoder_1")
        seg_classes = 0 if seg is None else np.asarray(
            seg[f"ConvTranspose_{n_ups - 1}"]["kernel"]).shape[3]
        traffic, action = params["MLPHead_0"], params["MLPHead_1"]
        return AuxNet(obs_size=obs_size,
                      n_actions=np.asarray(action[f"Dense_{len(action) - 1}"]["kernel"]).shape[1],
                      n_traffic_classes=np.asarray(
                          traffic[f"Dense_{len(traffic) - 1}"]["kernel"]).shape[1],
                      sensor_dim=np.asarray(params["Dense_0"]["kernel"]).shape[0],
                      image_hw=4 * 2 ** n_ups, seg_classes=seg_classes, dtype=dtype)
    if family == "dual_stream":
        head = params["MLPHead_0"]
        return DualStreamCNN(obs_size=obs_size, n_actions=np.asarray(
            head[f"Dense_{len(head) - 1}"]["kernel"]).shape[1], dtype=dtype)
    if family == "cil":
        k, _, hidden = np.asarray(params["branch_w1"]).shape
        n_actions = np.asarray(params["branch_w2"]).shape[2]
        return BranchedCILPolicy(obs_size=obs_size, n_actions=n_actions, n_commands=k,
                                 branch_hidden=hidden, dtype=dtype)
    if continuous and family == "policy":
        return ContinuousPolicyCNN(obs_size=obs_size, dtype=dtype, s2d_stem=s2d)
    head = params["MLPHead_0"]
    n_actions = np.asarray(head[f"Dense_{len(head) - 1}"]["kernel"]).shape[1]
    if family == "actor_critic":
        return ActorCriticCNN(obs_size=obs_size, n_actions=n_actions, dtype=dtype,
                              s2d_stem=s2d, continuous="log_std" in params)
    return PolicyCNN(obs_size=obs_size, n_actions=n_actions, dtype=dtype, s2d_stem=s2d)


def _sequence_family_for_params(family: str, params, dtype: torch.dtype, continuous: bool):
    """``model_for_params`` of the world-model, recurrent, ViT and latent
    trees. A world model's frames are taken square (its Dense widths give
    (H/16)·(W/16) only) and its actions continuous when ``continuous`` or
    the cell's input is 2 wider than the latent; a latent MLP with one
    output is a ``RewardHead`` (stacked: a ``HeadEnsemble``), with two and
    ``continuous`` a ``ContinuousLatentPolicy``, else a ``LatentPolicy``."""
    if family == "world_model":
        cell, z_size = params["rnn_layer"]["cell"], np.shape(params["to_z"]["kernel"])[1]
        lstm = "hi" in cell
        hidden = np.shape(cell["hi" if lstm else "hn"]["kernel"])[0]
        width = np.shape(cell["ii" if lstm else "ir"]["kernel"])[0] - z_size
        enc = params["encoder"]
        side = 16 * int(round((np.shape(enc["Dense_0"]["kernel"])[0] / 128) ** 0.5))
        space = "continuous" if continuous or width == 2 else "discrete"
        return LatentWorldModel(z_size=z_size, rnn="lstm" if lstm else "gru",
                                n_actions=width if space == "discrete" else 9,
                                height=side, width=side,
                                channels=np.shape(enc["Conv_0"]["kernel"])[2],
                                hidden_size=hidden, dtype=dtype, action_space=space)
    if family == "rnn_policy":
        head = params["head"]
        return RecurrentPolicy(obs_size=np.shape(params["trunk"]["Conv_0"]["kernel"])[2],
                               hidden=np.shape(params["cell"]["hn"]["kernel"])[0],
                               n_actions=np.shape(head[f"Dense_{len(head) - 1}"]["kernel"])[1],
                               dtype=dtype)
    if family == "vit":
        k = np.shape(params["Conv_0"]["kernel"])
        blk = params["TransformerBlock_0"]
        return ViTPolicy(obs_size=k[2], n_actions=np.shape(params["Dense_0"]["kernel"])[1],
                         patch=k[0], dim=k[3],
                         depth=sum(n.startswith("TransformerBlock_") for n in params),
                         heads=np.shape(blk["MultiHeadDotProductAttention_0"]["query"]["kernel"])[1],
                         mlp_ratio=np.shape(blk["Dense_0"]["kernel"])[1] // k[3],
                         pos_grid=np.shape(params["pos_emb"])[0], dtype=dtype)
    k1, k2 = np.shape(params["Dense_0"]["kernel"]), np.shape(params["Dense_1"]["kernel"])
    if len(k1) == 3:
        return HeadEnsemble([RewardHead(k1[1], k1[2]) for _ in range(k1[0])])
    if k2[1] == 1:
        return RewardHead(k1[0], k1[1])
    if k2[1] == 2 and continuous:
        return ContinuousLatentPolicy(k1[0], k1[1])
    return LatentPolicy(k1[0], k2[1], k1[1])


def _vae_for_params(params, dtype: torch.dtype) -> ConvVAE:
    """``ConvVAE`` of a flax tree: the 224² chain when the first encoder
    kernel is the chain's (4×4) and the last decoder layer's is 4×4 after
    four 6×6 ones; else the square pyramid whose hidden size the tree's
    ``to_mu`` gives (hidden = (H/16)² · 128)."""
    channels = np.asarray(params["enc_0"]["kernel"]).shape[2]
    z_size = np.asarray(params["to_mu"]["kernel"]).shape[1]
    hidden = np.asarray(params["to_mu"]["kernel"]).shape[0]
    if np.asarray(params["dec_0"]["kernel"]).shape[0] == 6:
        return ConvVAE(channels=channels, z_size=z_size, dtype=dtype)
    side = 16 * int(round((hidden / np.asarray(params["enc_3"]["kernel"]).shape[3]) ** 0.5))
    return ConvVAE(channels=channels, height=side, width=side, z_size=z_size, dtype=dtype)


_TOWN_DTYPES = {"transfer_route": torch.int64, "transfer_s": torch.float32,
                "transfer_valid": torch.bool, "nav_slot": torch.int64,
                "nav_dist": torch.float32, "nav_goals": torch.float32}


def town_from_jax(town) -> TownMap:
    """JAX ``TownMap`` → port ``TownMap`` (CPU tensors), with its turn-fan
    and navigation tables when it has them."""
    fields = {}
    for f in dataclasses.fields(TownMap):
        a = getattr(town, f.name)
        if f.name in ("lanes", "lane_width") or a is None:
            continue
        fields[f.name] = _tensor(a, _TOWN_DTYPES.get(f.name, torch.float32))
    return TownMap(**fields, lanes=int(town.lanes), lane_width=float(town.lane_width))


def world_state_from_jax(state) -> WorldState:
    """JAX ``WorldState`` (batched over envs, or a single env) → port
    ``WorldState`` with a leading env axis. Integer leaves become int64; the
    uint32 ``rng`` key pair keeps its values in int64."""
    single = np.asarray(state.ego_yaw).ndim == 0
    fields = {}
    for f in dataclasses.fields(WorldState):
        a = np.asarray(getattr(state, f.name))
        if single:
            a = a[None]
        dtype = torch.int64 if f.name in _STATE_INTS else torch.float32
        fields[f.name] = _tensor(a.astype(np.int64) if dtype == torch.int64 else a, dtype)
    return WorldState(**fields)


def spawn_pool_from_jax(pool) -> torch.Tensor:
    """The packed pool of ``rollout_spawn_pool``/``pack_spawn_pool`` (the
    (packed, metas, treedef) tuple or the packed matrix alone) → (size, D)
    float32 tensor; both packages use the same layout."""
    packed = pool[0] if isinstance(pool, tuple) else pool
    return _tensor(packed, torch.float32)


def _batched_getter(obj):
    """``get(name, dtype)`` reading field ``name`` of a JAX pytree with a
    leading env axis (added for a single env); None stays None."""
    single = np.asarray(obj.valid).ndim == 1

    def get(name, dtype):
        a = getattr(obj, name)
        if a is None:
            return None
        a = np.asarray(a)
        return _tensor(a[None] if single else a, dtype)

    return get


def setup_from_jax(setup) -> TriangleSetup:
    """JAX ``TriangleSetup`` (batched or a single env) → port
    ``TriangleSetup`` with a leading env axis, optional rows included."""
    get = _batched_getter(setup)
    return TriangleSetup(
        edges=get("edges", torch.float32), znum=get("znum", torch.float32),
        colors=get("colors", torch.float32), classes=get("classes", torch.int64),
        valid=get("valid", torch.bool), bbox=get("bbox", torch.float32),
        zmin=get("zmin", torch.float32), unum=get("unum", torch.float32),
        vnum=get("vnum", torch.float32), zinv=get("zinv", torch.float32),
        pair_ok=get("pair_ok", torch.bool))


def prims_from_jax(prims) -> PrimSetup:
    """JAX ``PrimSetup`` (``fuse_prims``' output, batched or a single env)
    → port ``PrimSetup`` with a leading env axis."""
    get = _batched_getter(prims)
    return PrimSetup(
        edges=get("edges", torch.float32), zinv=get("zinv", torch.float32),
        luma=get("luma", torch.float32), valid=get("valid", torch.bool),
        bbox=get("bbox", torch.float32), zmin=get("zmin", torch.float32))


def carry_from_jax(carry):
    """JAX rollout carry (states, framebuf, just_reset) → port carry."""
    states, framebuf, just_reset = carry[:3]
    return (world_state_from_jax(states), _tensor(framebuf, torch.uint8),
            _tensor(just_reset, torch.bool))


def _field(node, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _adam_state(node):
    """The first node of an optax state tree that carries Adam's ``count``,
    ``mu`` and ``nu`` (``ScaleByAdamState`` inside any chain, or its dict
    form in a checkpoint restored without a template)."""
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            return node
        return None
    if all(hasattr(node, k) for k in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, tx: AdamConfig, dtype: torch.dtype = torch.float32,
                         device: str | torch.device = "cpu",
                         continuous: bool = False) -> TrainState:
    """JAX ``TrainState`` of a ``PolicyCNN``, ``ContinuousPolicyCNN``
    (``continuous``), ``BranchedCILPolicy``, ``DualStreamCNN``, ``AuxNet``,
    ``ActorCriticCNN``, ``ConvVAE``, ``LatentWorldModel``,
    ``RecurrentPolicy`` or ``ViTPolicy`` (optax Adam, optionally behind a
    clip) → port ``TrainState`` on ``device``: the params, Adam's ``mu``
    and ``nu`` through the same conversion as the params, its ``count`` as
    each parameter's Adam step and as the schedule's step, and the EMA
    shadow. ``tx`` is the port's optimizer config for the same run, so a
    step taken from here continues the JAX run."""
    model = model_for_params(state.params, dtype, continuous)
    model.load_state_dict(params_state_dict(state.params))
    out = create_train_state(model, tx, ema_decay=float(state.ema_decay), device=device)
    adam = _adam_state(state.opt_state)
    count = int(np.asarray(_field(adam, "count")))
    mu, nu = params_state_dict(_field(adam, "mu")), params_state_dict(_field(adam, "nu"))
    opt = out.optimizer.state_dict()
    opt["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
                    for i, (name, _) in enumerate(model.named_parameters())}
    out.optimizer.load_state_dict(opt)
    out.step = count
    if state.ema_params is not None:
        out.ema.load_state_dict(params_state_dict(state.ema_params))
    return out


def checkpoint_from_jax(payload: dict) -> dict:
    """A JAX checkpoint of any model ``model_for_params`` knows
    (``ContinuousPolicyCNN`` has the state dict of a 2-way ``PolicyCNN``),
    restored as numpy arrays
    (``{"params", "opt_state", "step"[, "ema_params"]}``, e.g. Orbax's
    templateless restore), → this package's checkpoint payload
    (``TrainState.payload()``: state_dicts of the model, Adam and the EMA
    shadow, and the step), for ``utils.checkpoint.save_pytree``. Adam's
    moments and count come through ``train_state_from_jax``; the learning
    rate is set from the schedule at every step, so the one stored here is
    a placeholder."""
    ema = payload.get("ema_params")
    jstate = SimpleNamespace(params=payload["params"], opt_state=payload["opt_state"],
                             ema_params=ema, ema_decay=0.5 if ema is not None else 0.0)
    state = train_state_from_jax(jstate, AdamConfig(schedule=lambda count: 1e-3))
    out = state.payload()
    out["step"] = int(np.asarray(payload["step"]))
    return out
