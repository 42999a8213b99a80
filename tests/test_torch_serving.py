"""Serving of the PyTorch port (``serving/export.py``, ``engine.py``, the
evals' ``artifact=``) against the JAX package's.

The same uint8 frames, drawn with numpy, go through the JAX package's
StableHLO artifact and the port's ``torch.export`` artifact of the same
weights (``convert``). Tolerances: float32 logits of the two artifacts
within the ``PolicyCNN`` forward tolerance (atol 1e-4,
``test_torch_policy.py``); the port's artifact against its live model
within 1e-6; the engine's bookkeeping equal; closed-loop metrics of an
artifact and its live policy within 1e-9 (JAX ``test_serving.py``).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.models import BranchedCILPolicy as JCIL
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicy
from carla_imitation_learning_tpu.serving import InferenceEngine as JEngine
from carla_imitation_learning_tpu.serving import export as jexport
from carla_imitation_learning_tpu_torch import cli, convert
from carla_imitation_learning_tpu_torch.models import (
    BranchedCILPolicy, ContinuousPolicyCNN, PolicyCNN, ViTPolicy,
)
from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.serving import (
    InferenceEngine, export_cil_policy, export_fn, export_policy, load_policy,
    policy_fn_from_servable,
)
from carla_imitation_learning_tpu_torch.sim.town import make_town
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as cl
from carla_imitation_learning_tpu_torch.training.steps import flax_init_
from carla_imitation_learning_tpu_torch.utils.checkpoint import save_pytree

H = W = 32
TINY = ["sim.n_agents=2", "sim.town.blocks=2", "sim.town.n_buildings=4",
        f"render.height={H}", f"render.width={W}", "render.max_triangles=256"]


def _frames(b, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, H, W, 4), dtype=np.uint8)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One PolicyCNN's weights in both packages, exported by both."""
    root = tmp_path_factory.mktemp("serving")
    jm = JPolicy(dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, H, W, 4)))["params"]
    tm = PolicyCNN(dtype=torch.float32)
    tm.load_state_dict(convert.policy_state_dict(params))
    tm.eval()
    jart = jexport.export_policy(jm, params, root / "jax", height=H, width=W,
                                 platforms=("cpu",), extra_meta={"n_actions": 9})
    tart = export_policy(tm, root / "port", height=H, width=W, device="cpu",
                         extra_meta={"n_actions": 9})
    return SimpleNamespace(jm=jm, params=params, tm=tm, jart=jart, tart=tart,
                           jservable=jexport.load_policy(jart),
                           servable=load_policy(tart, "cpu"))


@pytest.mark.parametrize("batch", [1, 7, 33])
def test_port_artifact_matches_jax_artifact(pair, batch):
    x = _frames(batch, seed=batch)
    want = np.asarray(pair.jservable.call(x))
    got = pair.servable.call(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_port_artifact_matches_live_model(pair):
    for b in (1, 3, 16):
        x = torch.as_tensor(_frames(b, seed=10 + b))
        with torch.no_grad():
            want = pair.tm(x.float() * (1.0 / 255.0))
        torch.testing.assert_close(pair.servable.call(x), want, rtol=0, atol=1e-6)


def test_meta_matches_jax(pair):
    jmeta = json.loads((pair.jart / "meta.json").read_text())
    meta = json.loads((pair.tart / "meta.json").read_text())
    versions = {"platforms", "jax_version", "torch_version"}
    assert set(meta) - versions == set(jmeta) - versions
    for k in set(jmeta) - versions:
        assert meta[k] == jmeta[k], k
    assert meta["platforms"] == ["cpu"] and meta["inputs"][0]["shape"] == ["b", "32", "32", "4"]
    assert (pair.tart / "policy.pt2").stat().st_size > 10_000


def test_engine_matches_jax_engine(pair):
    """Buckets, padding, chunking above the top bucket and the empty request
    as the JAX package's engine does them; the same logits within 1e-4."""
    eng, jeng = InferenceEngine(pair.servable, max_batch=8), JEngine(pair.jservable, max_batch=8)
    assert eng.buckets == jeng.buckets == (1, 2, 4, 8)
    assert eng.device == torch.device("cpu")
    for n in (0, 1, 5, 8, 13, 20):
        x = _frames(n, seed=20 + n)
        got, want = eng.infer_logits(x), jeng.infer_logits(x)
        assert got.shape == want.shape == (n, 9) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(eng.infer(x), np.argmax(got, -1).astype(np.int32))
        jeng.infer(x)
    assert list(eng._padded_frac) == list(jeng._padded_frac)
    s, js = eng.stats(), jeng.stats()
    assert s.keys() == js.keys() and s["count"] == js["count"] == 12
    assert s["pad_waste_frac"] == js["pad_waste_frac"]


def test_engine_stats_warmup_and_errors(pair):
    eng = InferenceEngine(pair.servable, max_batch=4)
    eng.warmup(H, W)
    assert eng.stats() == {"count": 0}
    eng.infer(_frames(3))
    s = eng.stats()
    assert s["count"] == 1 and s["latency_ms_p50"] > 0
    assert s["pad_waste_frac"] == pytest.approx(0.25)
    with pytest.raises(ValueError, match="B,H,W,C"):
        eng.infer(np.zeros((H, W, 4), np.uint8))
    with pytest.raises(ValueError, match="rows"):
        eng.infer(_frames(3), np.zeros(2, np.float32))
    # a mesh of one rank (no process group): the same ladder and logits;
    # rank 0 serves and never follows
    one = make_mesh(axis_sizes={"data": 1}, devices="cpu")
    sharded = InferenceEngine(pair.servable, max_batch=4, mesh=one)
    assert sharded.buckets == eng.buckets
    np.testing.assert_array_equal(sharded.infer_logits(_frames(3)), eng.infer_logits(_frames(3)))
    with pytest.raises(RuntimeError, match="ranks other than 0"):
        sharded.follow()
    sharded.stop()
    live = InferenceEngine(lambda f: pair.tm(f.float() / 255), buckets=(2, 4), device="cpu")
    assert live.infer(_frames(3)).shape == (3,)


def test_jax_artifact_raises(pair, tmp_path):
    with pytest.raises(ValueError, match="JAX package artifact"):
        load_policy(pair.jart, "cpu")
    with pytest.raises(ValueError, match="no policy artifact"):
        load_policy(tmp_path, "cpu")


def test_cil_artifact_matches_jax(tmp_path):
    """Three inputs on one batch dim; an out-of-range command is clipped
    inside both programs; the engine pads the side inputs with the frames."""
    jm = JCIL(n_commands=4, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(2), *jm.example_input(1, H, W))["params"]
    tm = BranchedCILPolicy(n_commands=4, dtype=torch.float32)
    tm.load_state_dict(convert.cil_state_dict(params))
    jart = jexport.export_cil_policy(jm, params, tmp_path / "jax", height=H, width=W,
                                     platforms=("cpu",))
    servable = load_policy(export_cil_policy(tm.eval(), tmp_path / "port", height=H, width=W,
                                             device="cpu"), "cpu")
    assert servable.meta["family"] == "cil" and servable.meta["n_commands"] == 4
    assert len(servable.meta["inputs"]) == 3
    rng = np.random.default_rng(1)
    f = _frames(6, seed=3)
    s = rng.uniform(0, 12, 6).astype(np.float32)
    c = np.array([0, 1, 2, 3, 9, -2], np.int32)
    want = np.asarray(jexport.load_policy(jart).call(f, s, c))
    got = servable.call(f, s, c).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with torch.no_grad():
        live = tm(torch.as_tensor(f).float() / 255, torch.as_tensor(s),
                  torch.as_tensor(np.clip(c, 0, 3)))[0].numpy()
    np.testing.assert_allclose(got, live, rtol=0, atol=1e-6)
    eng = InferenceEngine(servable, max_batch=4)
    eng.warmup(H, W, 4, extra_specs=[((), np.float32), ((), np.int32)])
    np.testing.assert_array_equal(eng.infer(f, s, c), np.argmax(got, -1))


def test_continuous_and_vit_artifacts(tmp_path):
    """A continuous artifact serves its (steer, accel) through
    ``policy_fn_from_servable`` untouched; a float ViT exports too."""
    gen = torch.Generator().manual_seed(0)
    cm = flax_init_(ContinuousPolicyCNN(dtype=torch.float32), gen).eval()
    servable = load_policy(export_policy(cm, tmp_path / "c", height=H, width=W, device="cpu",
                                         extra_meta={"family": "continuous"}), "cpu")
    obs = torch.as_tensor(_frames(5, seed=4)).float() / 255
    with torch.no_grad():
        want = cm(obs)
    got = policy_fn_from_servable(servable)(obs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    vit = flax_init_(ViTPolicy(patch=8, dim=32, depth=1, heads=2, dtype=torch.float32), gen)
    vs = load_policy(export_policy(vit.eval(), tmp_path / "v", height=H, width=W,
                                   device="cpu"), "cpu")
    with torch.no_grad():
        torch.testing.assert_close(vs.call(obs.mul(255).round().to(torch.uint8)), vit(obs),
                                   rtol=0, atol=1e-6)


def test_export_fn_takes_any_module(tmp_path):
    class Sum(torch.nn.Module):
        def forward(self, frames, speed):
            return frames.float().mean(dim=(1, 2)) + speed[:, None]

    art = export_fn(Sum(), [(("b", H, W, 4), torch.uint8), (("b",), torch.float32)],
                    tmp_path / "sum", device="cpu", meta={"kind": "sum"})
    s = load_policy(art, "cpu")
    assert s.meta["outputs"] == [{"shape": ["b", "4"], "dtype": "float32"}]
    f, sp = _frames(2), np.array([1.0, 2.0], np.float32)
    torch.testing.assert_close(s.call(f, sp), Sum()(torch.as_tensor(f), torch.as_tensor(sp)))


def _world(turn_fans=False):
    town = make_town(blocks=2, n_buildings=4, n_lights=2, turn_fans=turn_fans)
    return SimParams(n_agents=2), town, RenderConfig(H, W, max_triangles=256)


def _same_metrics(live, shipped):
    for k in ("driving_score", "route_completion", "mean_speed", "km_driven"):
        assert live[k] == pytest.approx(shipped[k], abs=1e-9), k


def test_servable_drives_closed_loop(pair):
    params, town, rcfg = _world()

    def live_policy(obs):
        return pair.tm(obs).argmax(-1)

    kw = dict(n_envs=4, n_steps=10, device="cpu")
    with torch.no_grad():
        live = cl.evaluate_policy(params, town, rcfg, live_policy,
                                  torch.Generator().manual_seed(5), **kw)
    shipped = cl.evaluate_policy(params, town, rcfg, policy_fn_from_servable(pair.servable),
                                 torch.Generator().manual_seed(5), **kw)
    _same_metrics(live, shipped)


def test_cil_servable_drives_closed_loop(tmp_path):
    model = flax_init_(BranchedCILPolicy(n_commands=6, dtype=torch.float32),
                       torch.Generator().manual_seed(4)).eval()
    servable = load_policy(export_cil_policy(model, tmp_path / "cil", height=H, width=W,
                                             device="cpu"), "cpu")
    params, town, rcfg = _world(turn_fans=True)
    kw = dict(n_envs=4, n_steps=30, device="cpu")
    live = cl.evaluate_policy(params, town, rcfg, model.as_policy_fn(),
                              torch.Generator().manual_seed(5), **kw)
    shipped = cl.evaluate_policy(params, town, rcfg, policy_fn_from_servable(servable),
                                 torch.Generator().manual_seed(5), **kw)
    _same_metrics(live, shipped)


def _run(capsys, *args):
    argv = ["run", *args, "-o", "device=cpu", "--json"]
    for o in TINY:
        argv += ["-o", o]
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_export_policy_float_and_int8(tmp_path, capsys):
    base = ["-o", "height=32", "-o", "width=32", "-o", "serve_max_batch=4",
            "-o", f"log_dir={tmp_path}/logs", "-o", "compute_dtype=float32"]
    res = _run(capsys, "export_policy", *base)
    assert res["roundtrip_max_abs_err"] < 1e-4 and res["blob_bytes"] > 10_000
    assert res["platforms"] == ["cpu"] and res["engine"]["count"] == 1
    assert (tmp_path / "logs" / "policy_artifact" / "meta.json").exists()
    q = _run(capsys, "export_policy", *base, "-o", "quantize=int8",
             "-o", f"artifact_dir={tmp_path}/q")
    assert q["roundtrip_max_abs_err"] == 0.0 and q["blob_bytes"] < res["blob_bytes"]
    assert 0 < q["vs_float_max_abs_err"] < 0.1
    assert json.loads((tmp_path / "q" / "meta.json").read_text())["quantize"] == "int8"


def test_evals_take_an_artifact(tmp_path, capsys):
    """``closed_loop_eval``, ``scenario_eval`` and ``route_eval`` score an
    artifact exported from a checkpoint exactly as they score the
    checkpoint; a continuous artifact brings its control space along."""
    model = flax_init_(PolicyCNN(dtype=torch.float32), torch.Generator().manual_seed(2))
    save_pytree(tmp_path / "ckpt", {"params": model.state_dict()})
    ck = ["--checkpoint", str(tmp_path / "ckpt")]
    fp32 = ["-o", "compute_dtype=float32", "-o", f"log_dir={tmp_path}/logs"]
    res = _run(capsys, "export_policy", *ck, *fp32, "-o", f"height={H}", "-o", f"width={W}",
               "-o", f"artifact_dir={tmp_path}/art", "-o", "serve_max_batch=2")
    art = ["-o", f"artifact={res['artifact']}"]
    small = ["-o", "n_envs=2", "-o", "n_steps=6"]
    for name, extra in (("closed_loop_eval", []), ("scenario_eval", ["-o", "scenarios=clear"]),
                        ("route_eval", ["-o", "n_goals=2"])):
        a = _run(capsys, name, *art, *fp32, *small, *extra)
        b = _run(capsys, name, *ck, *fp32, *small, *extra)
        assert a == b, name
    cont = flax_init_(ContinuousPolicyCNN(dtype=torch.float32), torch.Generator().manual_seed(3))
    save_pytree(tmp_path / "cont", {"params": cont.state_dict()})
    fam = ["-o", "policy_family=continuous"]
    res = _run(capsys, "export_policy", "--checkpoint", str(tmp_path / "cont"), *fam, *fp32,
               "-o", f"height={H}", "-o", f"width={W}", "-o", f"artifact_dir={tmp_path}/cont_art",
               "-o", "serve_max_batch=2")
    a = _run(capsys, "closed_loop_eval", "-o", f"artifact={res['artifact']}", *fp32, *small)
    b = _run(capsys, "closed_loop_eval", "--checkpoint", str(tmp_path / "cont"), *fam, *fp32,
             *small)
    assert a == b


@pytest.mark.parametrize("family", ["surround", "vit", "cil_int8"])
def test_cli_export_policy_families(tmp_path, capsys, family):
    """``export_policy`` builds what ``_policy_bits`` builds: a surround
    checkpoint at its rig's width (frame_skip × views channels), the ViT
    (float; its int8 raises), the CIL policy with its side inputs, in int8."""
    extra = {"surround": ["-o", "surround_cameras=['camera', 'FL']"],
             "vit": ["-o", "policy_arch=vit", "-o", "vit_patch=8", "-o", "vit_dim=32",
                     "-o", "vit_depth=1", "-o", "vit_heads=2"],
             "cil_int8": ["-o", "policy_family=cil", "-o", "quantize=int8"]}[family]
    res = _run(capsys, "export_policy", "-o", f"height={H}", "-o", f"width={W}",
               "-o", "serve_max_batch=2", "-o", f"log_dir={tmp_path}", *extra)
    assert res["roundtrip_max_abs_err"] < 1e-4 and res["engine"]["count"] == 1
    meta = json.loads((tmp_path / "policy_artifact" / "meta.json").read_text())
    channels = 8 if family == "surround" else 4
    assert meta["inputs"][0]["shape"] == ["b", str(H), str(W), str(channels)]
    assert meta["model"] == {"surround": "PolicyCNN", "vit": "ViTPolicy",
                             "cil_int8": "BranchedCILPolicy"}[family]
    if family == "cil_int8":
        assert meta["family"] == "cil" and meta["quantize"] == "int8"
        assert [i["dtype"] for i in meta["inputs"]] == ["uint8", "float32", "int32"]
    if family == "vit":
        with pytest.raises(ValueError, match="ViTPolicy has no int8 path"):
            _run(capsys, "export_policy", "-o", f"height={H}", "-o", f"width={W}",
                 "-o", f"log_dir={tmp_path}/q", "-o", "quantize=int8", *extra)
