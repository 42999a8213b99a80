"""The PyTorch port's HTTP policy server (``serving/server.py``) against the
JAX package's: every endpoint and body form on port 0, the CIL side inputs,
continuous controls, the coalescing counters and the error codes.

Both servers serve artifacts of the same weights (``convert``); their
logits for the same frames agree within the ``PolicyCNN`` forward
tolerance (atol 1e-4, ``test_torch_policy.py``), and the port's equal its
engine's exactly.
"""

import base64
import concurrent.futures
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.models import PolicyCNN as JPolicy
from carla_imitation_learning_tpu.serving import PolicyServer as JServer
from carla_imitation_learning_tpu.serving import export_policy as jexport_policy
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import (
    BranchedCILPolicy, ContinuousPolicyCNN, PolicyCNN,
)
from carla_imitation_learning_tpu_torch.serving import (
    PolicyServer, export_cil_policy, export_policy, load_policy,
)
from carla_imitation_learning_tpu_torch.training.steps import flax_init_

H = W = 32


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    jm = JPolicy(dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, H, W, 4)))["params"]
    tm = PolicyCNN(dtype=torch.float32)
    tm.load_state_dict(convert.policy_state_dict(params))
    jart = jexport_policy(jm, params, root / "jax", height=H, width=W, platforms=("cpu",),
                          extra_meta={"n_actions": 9})
    art = export_policy(tm.eval(), root / "port", height=H, width=W, device="cpu",
                        extra_meta={"n_actions": 9})
    with PolicyServer(art, window_ms=20.0, device="cpu") as srv, \
            JServer(jart, window_ms=20.0) as jsrv:
        yield srv, jsrv


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url, data, headers):
    req = urllib.request.Request(url, data=data, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _octet(frames, **extra):
    return {"Content-Type": "application/octet-stream",
            "X-Shape": ",".join(map(str, frames.shape)), **extra}


def _frames(b, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, H, W, 4), dtype=np.uint8)


def _status(url, data, headers):
    try:
        _post(url, data, headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    return 200, ""


def test_health_and_metadata(servers):
    srv, _ = servers
    assert _get(srv.url + "/healthz") == {"status": "ok"}
    md = _get(srv.url + "/v1/metadata")
    assert md["meta"]["model"] == "PolicyCNN" and md["meta"]["n_actions"] == 9
    assert md["buckets"] == [1, 2, 4, 8, 16, 32, 64] and md["expected_hwc"] == [H, W, 4]


@pytest.mark.parametrize("form", ["octet", "base64", "list"])
def test_logits_match_jax_server(servers, form):
    srv, jsrv = servers
    x = _frames(3, seed={"octet": 1, "base64": 2, "list": 3}[form])
    if form == "octet":
        body, hdr = x.tobytes(), _octet(x)
    else:
        frames = (base64.b64encode(x.tobytes()).decode() if form == "base64"
                  else x.tolist())
        body = json.dumps({"frames": frames, "shape": list(x.shape)}).encode()
        hdr = {"Content-Type": "application/json"}
    got = np.asarray(_post(srv.url + "/v1/logits", body, hdr)["logits"])
    want = np.asarray(_post(jsrv.url + "/v1/logits", body, hdr)["logits"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, srv.engine.infer_logits(x), rtol=0, atol=0)
    acts = _post(srv.url + "/v1/infer", body, hdr)["actions"]
    assert acts == np.argmax(got, -1).tolist()


def test_microbatch_coalesces_concurrent_requests(servers):
    srv, _ = servers
    b = srv._batcher
    before = (b.requests_total, b.batches_total, b.rows_total)
    frames = [_frames(1, seed=10 + i) for i in range(16)]

    def one(x):
        return _post(srv.url + "/v1/infer", x.tobytes(), _octet(x))["actions"]

    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
        got = list(ex.map(one, frames))
    for x, a in zip(frames, got):
        assert a == srv.engine.infer(x).tolist()
    reqs = b.requests_total - before[0]
    batches = b.batches_total - before[1]
    assert reqs == 16 and b.rows_total - before[2] == 16
    assert batches < reqs   # at least one engine call served several requests
    st = _get(srv.url + "/v1/stats")
    assert st["requests_total"] == b.requests_total and st["batches_total"] == b.batches_total
    assert st["mean_coalesced_rows"] == pytest.approx(b.rows_total / b.batches_total)
    assert st["engine"]["count"] >= 1


def test_bad_requests(servers):
    srv, _ = servers
    url = srv.url + "/v1/infer"
    x = _frames(2)
    assert _status(url, x.tobytes(), {"Content-Type": "application/octet-stream"})[0] == 400
    assert _status(url, x.tobytes()[:-1], _octet(x))[0] == 400
    wrong = np.zeros((1, 16, 16, 4), np.uint8)
    code, msg = _status(url, wrong.tobytes(), _octet(wrong))
    assert code == 400 and "artifact input" in msg
    js = {"Content-Type": "application/json"}
    assert _status(url, b"{not json", js)[0] == 400
    assert _status(url, json.dumps({"nope": 1}).encode(), js)[0] == 400
    assert _status(url, json.dumps({"frames": "AAAA"}).encode(), js)[0] == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.url + "/v1/nothing")
    assert e.value.code == 404
    assert _status(srv.url + "/v1/nothing", b"", js)[0] == 404


def test_engine_failure_is_500():
    def broken(frames):
        raise RuntimeError("device lost")

    with PolicyServer(broken, window_ms=0.0, device="cpu") as srv:
        x = _frames(1)
        code, msg = _status(srv.url + "/v1/infer", x.tobytes(), _octet(x))
    assert code == 500 and "device lost" in msg


def test_continuous_artifact_serves_controls(tmp_path):
    model = flax_init_(ContinuousPolicyCNN(dtype=torch.float32),
                       torch.Generator().manual_seed(1)).eval()
    art = export_policy(model, tmp_path / "c", height=H, width=W, device="cpu",
                        extra_meta={"family": "continuous"})
    x = _frames(2, seed=4)
    with PolicyServer(art, window_ms=0.0, device="cpu") as srv:
        ctl = np.asarray(_post(srv.url + "/v1/infer", x.tobytes(), _octet(x))["controls"])
    want = load_policy(art, "cpu").call(x).numpy()
    assert ctl.shape == (2, 2)
    np.testing.assert_allclose(ctl, want, rtol=0, atol=1e-7)


def test_cil_artifact_serves_with_side_inputs(tmp_path):
    model = flax_init_(BranchedCILPolicy(n_commands=4, dtype=torch.float32),
                       torch.Generator().manual_seed(2)).eval()
    art = export_cil_policy(model, tmp_path / "cil", height=H, width=W, device="cpu")
    servable = load_policy(art, "cpu")
    x = _frames(3, seed=5)
    speed = np.array([1.0, 5.0, 9.0], np.float32)
    command = np.array([0, 3, 7], np.int32)
    want = servable.call(x, speed, command).numpy()
    js = {"Content-Type": "application/json"}
    with PolicyServer(art, window_ms=0.0, device="cpu") as srv:
        url = srv.url + "/v1/logits"
        body = {"frames": x.tolist(), "speed": speed.tolist(), "command": command.tolist()}
        got = np.asarray(_post(url, json.dumps(body).encode(), js)["logits"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        hdr = _octet(x, **{"X-Speed": "1.0,5.0,9.0", "X-Command": "0,3,7"})
        got = np.asarray(_post(url, x.tobytes(), hdr)["logits"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        # scalars broadcast over the rows
        body = {"frames": x.tolist(), "speed": 5.0, "command": 3}
        got = np.asarray(_post(url, json.dumps(body).encode(), js)["logits"])
        np.testing.assert_allclose(got, servable.call(x, np.full(3, 5.0, np.float32),
                                                      np.full(3, 3, np.int32)).numpy(),
                                   rtol=0, atol=1e-7)
        assert _status(url, x.tobytes(), _octet(x))[0] == 400          # no X-Speed
        body = {"frames": x.tolist(), "speed": [1.0, 2.0], "command": 0}
        assert _status(url, json.dumps(body).encode(), js)[0] == 400   # rows differ
