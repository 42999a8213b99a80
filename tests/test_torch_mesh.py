"""The port's mesh (``parallel/mesh.py``) on two gloo ranks on the CPU
against the port unsharded and the JAX package's data=2 mesh: the
counterparts of tests/test_parallel.py (wildcard, sharded BC step),
tests/test_sharded_rollout.py (``maybe_mesh`` divisibility) and
tests/test_sharded_families.py (every family's sharded step).

One group of two ranks (tests/torch_mesh_ranks.py, which imports the port
and not JAX) runs every rank-side check of the file once; the JAX side runs
here on the harness's 8-device platform with ``make_mesh(axis_sizes=
{"data": 2})``. Tolerances are the JAX tests': the sharded BC step against
the unsharded one at loss rtol 1e-5 and parameters rtol 1e-4 / atol 1e-6;
each family's sharded metrics against the port's unsharded step and
against JAX's data=2 step at rtol 2e-5, with the parameters equal across
ranks. The collective audit: a train step all-reduces the parameters'
bytes in one bucket plus one vector of its metric scalars; a rollout step
all-reduces nothing, and a noisy rollout with its metrics all-reduces twice
(the noise seed, the metric sums).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from carla_imitation_learning_tpu.models import (
    AuxNet, BranchedCILPolicy, ConvVAE, DualStreamCNN, PolicyCNN, ViTPolicy,
)
from carla_imitation_learning_tpu.parallel.mesh import (
    batch_sharding as j_batch_sharding, make_mesh as j_make_mesh,
    shard_train_state as j_shard_train_state,
)
from carla_imitation_learning_tpu.training import (
    aux_loss_fn, bc_loss_fn, cil_loss_fn, dual_stream_loss_fn, make_optimizer,
    make_train_step, vae_loss_fn,
)
from carla_imitation_learning_tpu.training.steps import TrainState as JTrainState
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data.pipeline import FrameStore
from carla_imitation_learning_tpu_torch.models import PolicyCNN as PPolicyCNN
from carla_imitation_learning_tpu_torch.models import vae as p_vae
from carla_imitation_learning_tpu_torch.parallel import mesh as p_mesh
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.town import make_town
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import steps as p_steps
from carla_imitation_learning_tpu_torch.training.closed_loop import NoiseConfig

B, HW = 8, 32
FAMILY_TX = {"LEARNING_RATE": 1e-3, "gradient_clip_val": 0.5}


def _numpy_params(model, example, seed):
    """A flax params tree of ``model``'s shapes drawn with numpy (flax's
    eager init compiles op by op): kernels at std 1/sqrt(fan-in), LayerNorm
    scales near 1, other vectors near 0."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *example))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if len(s.shape) >= 2:
            std = 1.0 / math.sqrt(math.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.01 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _families():
    """name → (JAX model, init example, port loss (name, args), JAX loss,
    numpy batch), the JAX test's tiny fixtures with numpy inputs."""
    rng = np.random.default_rng(0)
    x = rng.random((B, HW, HW, 4), np.float32)
    y = (np.arange(B) % 9).astype(np.int32)
    sensor = rng.random((B, 3), np.float32)
    speed = rng.random(B).astype(np.float32)
    cmd = (np.arange(B) % 4).astype(np.int32)
    f32 = jnp.float32
    return {
        "bc": (PolicyCNN(dtype=f32), (x[:1],), ("bc_loss_fn", None), bc_loss_fn, (x, y)),
        "vit": (ViTPolicy(patch=8, dim=32, depth=2, heads=2, pos_grid=4, dtype=f32), (x[:1],),
                ("bc_loss_fn", None), bc_loss_fn, (x, y)),
        "vae": (ConvVAE(channels=1, height=HW, width=HW, z_size=8, dtype=f32),
                (x[:1, ..., :1], jax.random.PRNGKey(0)), ("vae_loss_fn", (0.75, 0.1)),
                vae_loss_fn(0.75, 0.1), (x[..., :1],)),
        "aux": (AuxNet(n_traffic_classes=2, image_hw=HW, dtype=f32), ((x[:1], sensor[:1]),),
                ("aux_loss_fn", (0.1, 0.1, 1.0)), aux_loss_fn(0.1, 0.1, 1.0),
                ((x, sensor), np.stack([y % 2, y], -1))),
        "dual": (DualStreamCNN(dtype=f32), (x[:1], x[:1]), ("dual_stream_loss_fn", None),
                 dual_stream_loss_fn, (x, x, y)),
        "cil": (BranchedCILPolicy(n_commands=4, dtype=f32), (x[:1], speed[:1], cmd[:1]),
                ("cil_loss_fn", (0.1,)), cil_loss_fn(0.1), (x, speed, cmd, y)),
    }


def _to_torch(batch):
    if isinstance(batch, tuple):
        return tuple(_to_torch(b) for b in batch)
    return torch.from_numpy(np.ascontiguousarray(batch))


def _port_step(model, loss_spec, batch, tx_cfg, eps=None):
    """The port's unsharded step → (metrics, state dict)."""
    state = p_steps.create_train_state(copy.deepcopy(model), p_steps.make_optimizer(tx_cfg, 1),
                                       device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        if eps is not None:
            mp.setattr(p_vae, "draw_noise", lambda gen, shape, device, dtype: eps)
        _, m = p_steps.make_train_step(ranks.loss_from_spec(loss_spec))(
            state, batch, torch.Generator().manual_seed(0))
    return {k: v.item() for k, v in m.items()}, state.model.state_dict()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every check of the file: the JAX data=2 steps and the port's
    unsharded ones here, the port's sharded ones on two ranks."""
    step_rng = jax.random.PRNGKey(1)
    jmesh = j_make_mesh(axis_sizes={"data": 2})
    sh = j_batch_sharding(jmesh)
    families, jax_metrics, plain = {}, {}, {}
    for seed, (name, (jmodel, example, loss_spec, j_loss, batch)) in enumerate(
            _families().items()):
        params = _numpy_params(jmodel, example, seed)
        pmodel = convert.model_for_params(params, torch.float32)
        pmodel.load_state_dict(convert.params_state_dict(params))
        tx = make_optimizer(FAMILY_TX, 1)
        jstate = j_shard_train_state(jmesh, JTrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
            apply_fn=jmodel.apply, tx=tx))
        jbatch = jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), batch)
        _, jm = make_train_step(j_loss, donate=False)(jstate, jbatch, step_rng)
        jax_metrics[name] = {k: float(v) for k, v in jm.items()}
        eps = None
        if name == "vae":   # the JAX step's draw for the global batch
            eps = torch.from_numpy(np.array(jax.random.normal(step_rng, (B, 8), jnp.float32)))
        tb = _to_torch(batch)
        families[name] = {"model": pmodel, "loss": loss_spec, "batch": tb, "eps": eps}
        plain[name] = _port_step(pmodel, loss_spec, tb, FAMILY_TX, eps)

    gen = torch.Generator().manual_seed(0)
    bc_model = p_steps.flax_init_(PPolicyCNN(dtype=torch.float32), gen)
    bc_batch = (torch.rand((16, 64, 64, 4), generator=gen), torch.arange(16) % 9)
    bc = {"model": bc_model, "loss": ("bc_loss_fn", None), "batch": bc_batch,
          "tx": {"LEARNING_RATE": 1e-3}}
    rollout = {"params": SimParams(n_agents=2),
               "town": make_town(blocks=2, n_buildings=4, n_lights=2),
               "rcfg": RenderConfig(32, 32, max_triangles=256), "n_envs": 4,
               "noise": NoiseConfig(prob=0.2, duration=3, magnitude=0.5, seed=3)}
    rng = np.random.default_rng(4)
    store = FrameStore(frames=rng.integers(0, 256, (47, 8, 8), dtype=np.uint8),
                       actions=rng.integers(0, 9, 47).astype(np.int32),
                       traffic=np.zeros(47, np.int32),
                       sensors=rng.random((47, 3)).astype(np.float32))
    out = ranks.spawn("mesh_checks", {"families": families, "family_tx": FAMILY_TX,
                                      "bc_step": bc, "rollout": rollout, "store": store},
                      tmp_path_factory.mktemp("mesh"))
    return {"ranks": out, "jax": jax_metrics, "plain": plain,
            "loaders": ranks.loader_batches(store),
            "bc_plain": _port_step(bc_model, bc["loss"], bc_batch, bc["tx"]),
            "bc_model": bc_model}


def test_make_mesh_wildcard(run):
    for r, out in enumerate(run["ranks"]):
        assert out["wildcard"] == {"data": 2, "model": 1}
        assert out["fixed"] == {"data": 2}
        assert "more ranks than the world has (2)" in out["too_large"]
        assert out["rows"] == (r, slice(8 * r, 8 * r + 8), slice(4 * r, 4 * r + 4), True)
    # one process, no process group: the wildcard takes the one rank
    mesh = p_mesh.make_mesh(axis_sizes={"data": -1, "model": 1}, devices="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    with pytest.raises(ValueError, match="more ranks than the world has"):
        p_mesh.make_mesh(axis_sizes={"data": 2}, devices="cpu")
    with pytest.raises(ValueError, match="only one mesh axis"):
        p_mesh.make_mesh(axis_sizes={"data": -1, "model": -1}, devices="cpu")


def test_maybe_mesh_divisibility(run):
    for out in run["ranks"]:
        assert out["maybe"] == [True, True, True]   # 16 % 2 == 0; 15 % 2 != 0; no batch
    cfg = ranks.Cfg(device="cpu")
    assert p_mesh.maybe_mesh(cfg, batch_size=16) is None   # one rank, not forced
    cfg["mesh.enabled"] = True
    assert p_mesh.maybe_mesh(cfg, batch_size=15).shape == {"data": 1}   # forced


def test_sharded_bc_step_matches_unsharded(run):
    (m0, p0), (m1, p1) = (out["bc_step"] for out in run["ranks"])
    m_plain, p_plain = run["bc_plain"]
    assert math.isfinite(m0["loss"]) and m0 == m1
    np.testing.assert_allclose(m0["loss"], m_plain["loss"], rtol=1e-5)
    for k in p_plain:
        assert torch.equal(p0[k], p1[k]), k           # replicated after the update
        np.testing.assert_allclose(p0[k].numpy(), p_plain[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert any(not torch.equal(p0[k], v) for k, v in run["bc_model"].state_dict().items())


@pytest.mark.parametrize("family", ["bc", "vit", "vae", "aux", "dual", "cil"])
def test_sharded_family_step_matches(run, family):
    (m0, p0), (m1, p1) = (out["families"][family] for out in run["ranks"])
    assert m0 == m1
    assert set(m0) == set(run["jax"][family]) == set(run["plain"][family][0])
    for k in m0:
        np.testing.assert_allclose(m0[k], run["plain"][family][0][k], rtol=2e-5,
                                   err_msg=f"{family}:{k} vs port unsharded")
        np.testing.assert_allclose(m0[k], run["jax"][family][k], rtol=2e-5,
                                   err_msg=f"{family}:{k} vs JAX data=2")
    for k in p0:
        assert torch.equal(p0[k], p1[k]), f"{family}:{k}"


@pytest.mark.parametrize("family", ["bc", "vit", "vae", "aux", "dual", "cil"])
def test_train_step_collective_audit(run, family):
    """One all-reduce of the parameters' bytes, one of the metric scalars."""
    model = run["ranks"][0]["families"][family][1]
    n_metrics = len(run["plain"][family][0])
    param_bytes = sum(v.numel() * v.element_size() for v in model.values())
    for out in run["ranks"]:
        assert out["audit"][family] == [("all_reduce", param_bytes),
                                        ("all_reduce", 4 * n_metrics)]


def test_rollout_collective_audit(run):
    for out in run["ranks"]:
        audit = out["rollout_audit"]
        assert audit["step"] == []
        assert [name for name, _ in audit["rollout"]] == ["all_reduce", "all_reduce"]
        assert audit["rollout"][0][1] == 8           # the int64 noise-seed sum
        assert audit["env_steps"] == 4 * 3


def _leaves(batch):
    if isinstance(batch, (tuple, list)):
        return [t for b in batch for t in _leaves(b)]
    return [batch]


@pytest.mark.parametrize("loader", ["bc", "seq", "img"])
def test_sharded_loaders_yield_rank_rows(run, loader):
    """Every rank draws the whole epoch's order and batches its half of each
    global batch; the BC loader's last batch of 5 does not divide the mesh
    and stays whole on both ranks (the VAE loader drops it)."""
    whole = run["loaders"][loader]
    got = [out["loaders"][loader] for out in run["ranks"]]
    n = len(whole) - (loader == "img" and len(_leaves(whole[-1])[0]) % 2)
    assert len(got[0]) == len(got[1]) == n
    for i in range(n):
        for w, g0, g1 in zip(_leaves(whole[i]), _leaves(got[0][i]), _leaves(got[1][i])):
            if w.shape[0] % 2:
                assert torch.equal(g0, w) and torch.equal(g1, w)
            else:
                assert torch.equal(torch.cat([g0, g1]), w)
    if loader == "bc":
        assert _leaves(whole[-1])[0].shape[0] == 5
