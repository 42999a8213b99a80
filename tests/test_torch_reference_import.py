"""The PyTorch port's importer of the reference system's checkpoints
(``utils/torch_import.py``) against the reference net and against the JAX
package's importer.

The reference ``ConvNet1`` and ``ConvNetRawSegment`` layouts are written
inline as torch modules, as the JAX package's test does. Tolerances: the
imported policy's logits within 1e-5 of the reference net's largest logit
at 256²; the imported state dict equal to ``convert.policy_state_dict`` of
the JAX package's import, exactly.
"""

import json

import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.utils import torch_import as jimport
from carla_imitation_learning_tpu_torch import cli, convert
from carla_imitation_learning_tpu_torch.models import DualStreamCNN, PolicyCNN
from carla_imitation_learning_tpu_torch.utils.checkpoint import restore_params
from carla_imitation_learning_tpu_torch.utils.torch_import import (
    import_and_save, import_reference_policy,
)


def _convnet1(obs_size=4, n_actions=9, widths=(16, 32, 64, 128), fc=(64, 32)):
    """The reference cnn_base / fc Sequential layout (nets.py:17-33)."""
    nn = torch.nn
    c = widths
    net = nn.Module()
    net.cnn_base = nn.Sequential(
        nn.Conv2d(obs_size, c[0], kernel_size=7, stride=3), nn.ReLU(), nn.MaxPool2d(3),
        nn.Conv2d(c[0], c[1], kernel_size=5, stride=1), nn.ReLU(), nn.MaxPool2d(2),
        nn.Conv2d(c[1], c[2], kernel_size=4, stride=1), nn.ReLU(), nn.MaxPool2d(2),
        nn.Conv2d(c[2], c[3], kernel_size=3, stride=1), nn.ReLU(), nn.MaxPool2d(2))
    net.fc = nn.Sequential(nn.Linear(c[3], fc[0]), nn.ReLU(), nn.Linear(fc[0], fc[1]),
                           nn.ReLU(), nn.Linear(fc[1], n_actions))
    return net


def _lightning_ckpt(net, path):
    torch.save({"state_dict": {f"net.{k}": v for k, v in net.state_dict().items()},
                "hyper_parameters": {"lr": 1e-3}}, path)
    return path


def _x(seed, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, 4, 256, 256)).astype(np.float32)


def test_imported_convnet1_matches_reference_logits(tmp_path):
    torch.manual_seed(0)
    net = _convnet1()
    sd = import_reference_policy(_lightning_ckpt(net, tmp_path / "imitation.ckpt"))
    model = PolicyCNN(dtype=torch.float32)
    model.load_state_dict(sd)
    x = torch.as_tensor(_x(1))
    with torch.no_grad():
        want = net.fc(torch.flatten(net.cnn_base(x), 1))
        got = model(x.permute(0, 2, 3, 1))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_imported_rawsegment_matches_reference_logits():
    torch.manual_seed(1)
    net = _convnet1(widths=(32, 64, 128, 256), fc=(200, 48))
    sd = import_reference_policy({k: v.numpy() for k, v in net.state_dict().items()})
    model = DualStreamCNN(dtype=torch.float32)
    model.load_state_dict(sd)
    x, xs = torch.as_tensor(_x(2)), torch.as_tensor(_x(3))
    with torch.no_grad():
        want = net.fc(torch.flatten(net.cnn_base(x), 1) + torch.flatten(net.cnn_base(xs), 1))
        got = model(x.permute(0, 2, 3, 1), xs.permute(0, 2, 3, 1))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("layout", ["lightning", "bare"])
def test_state_dict_equals_jax_import(tmp_path, layout):
    torch.manual_seed(2)
    net = _convnet1()
    src = (_lightning_ckpt(net, tmp_path / "ref.ckpt") if layout == "lightning"
           else {k: v.numpy() for k, v in net.state_dict().items()})
    got = import_reference_policy(src)
    want = convert.policy_state_dict(jimport.import_reference_policy(src))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def test_cli_import_torch_feeds_checkpoint_consumers(tmp_path, capsys):
    torch.manual_seed(3)
    net = _convnet1()
    ckpt = _lightning_ckpt(net, tmp_path / "ref.ckpt")
    assert cli.main(["import_torch", str(ckpt), "--out", str(tmp_path / "imported")]) == 0
    model = PolicyCNN(dtype=torch.float32)
    model.load_state_dict(restore_params(tmp_path / "imported", model.state_dict()))
    torch.testing.assert_close(model.trunk.convs[0].weight,
                               net.state_dict()["cnn_base.0.weight"], rtol=0, atol=0)
    capsys.readouterr()
    argv = ["run", "closed_loop_eval", "--checkpoint", str(tmp_path / "imported"), "--json"]
    for o in ("device=cpu", "compute_dtype=float32", "n_envs=2", "n_steps=4",
              "sim.n_agents=2", "sim.town.blocks=2", "sim.town.n_buildings=4",
              "render.height=32", "render.width=32", "render.max_triangles=256"):
        argv += ["-o", o]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["policy"]["env_steps"] == 8
    assert import_and_save(ckpt, tmp_path / "again") == str(tmp_path / "again")


def test_bad_layouts_raise():
    with pytest.raises(ValueError, match="unrecognized checkpoint layout"):
        import_reference_policy({"something.weird": np.zeros(3)})
    sd = {f"net.{k}": v for k, v in _convnet1().state_dict().items() if k != "fc.4.bias"}
    with pytest.raises(ValueError, match="lacks reference-policy keys.*fc.4.bias"):
        import_reference_policy(sd)
