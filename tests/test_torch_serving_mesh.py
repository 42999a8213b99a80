"""Sharded serving over a ``data`` mesh of two gloo ranks on the CPU
(``InferenceEngine(mesh=)``, ``PolicyServer(mesh=)``): the counterparts of
``tests/test_sharded_serving.py``'s four cases.

One group of two ranks (tests/torch_mesh_ranks.py, the port alone) loads
one exported ``PolicyCNN`` artifact (fp32, 32²) on each rank; rank 0
serves, rank 1 follows. Here:

- the ladders equal the JAX engine's for a mesh of 2 (max_batch 64, and
  the explicit ladder (3, 20) rounded up to (4, 20));
- the sharded logits of requests of 1, 8, 13 and 32 frames equal the
  unsharded engine's within rtol 1e-6 / atol 1e-6 (a bucket's rows run
  two at a time there and whole here, so the CPU's kernels may round the
  last bit apart), with the argmax equal;
- each rank's forward sees half of each bucket (1, 4, 8 and 16 rows);
- an HTTP request of 5 frames to rank 0's server, after a warm-up of
  every bucket through the header protocol, answers the unsharded actions.

And what a sharded server does with bad input and failures:

- a CIL artifact served over the mesh with commands out of range (7 and
  -1 of 4) answers what one process answers (the servable clamps them),
  within the tolerance above, and the next request is served as well;
- a policy that raises on rank 1's rows of a request takes the mesh down
  instead of leaving the ranks out of step: rank 1's ``follow()`` raises
  the policy's error, rank 0 answers that request and the next one 503,
  ``/healthz`` answers 503, and both ranks return (the spawn ends).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_mesh_ranks as ranks
from carla_imitation_learning_tpu.serving import InferenceEngine as JEngine
from carla_imitation_learning_tpu_torch.models import BranchedCILPolicy, PolicyCNN
from carla_imitation_learning_tpu_torch.serving import (
    InferenceEngine, export_cil_policy, export_policy, load_policy,
)
from carla_imitation_learning_tpu_torch.training.steps import flax_init_

H = W = 32
SIZES = (1, 8, 13, 32)
CIL_SPEED = np.array([1.0, 5.0, 9.0, 0.5], np.float32)
CIL_COMMANDS = ([0, 3, 7, -1], [0, 1, 2, 3])    # n_commands = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_mesh")
    model = flax_init_(PolicyCNN(dtype=torch.float32), torch.Generator().manual_seed(11))
    art = export_policy(model.eval(), root / "policy", height=H, width=W, device="cpu")
    rng = np.random.default_rng(0)
    frames = {b: rng.integers(0, 256, (b, H, W, 4), dtype=np.uint8) for b in SIZES}
    http = rng.integers(0, 256, (5, H, W, 4), dtype=np.uint8)
    cil = flax_init_(BranchedCILPolicy(n_commands=4, dtype=torch.float32),
                     torch.Generator().manual_seed(12)).eval()
    cil_art = export_cil_policy(cil, root / "cil", height=H, width=W, device="cpu")
    cil_frames = rng.integers(0, 256, (4, H, W, 4), dtype=np.uint8)
    two = ranks.spawn("serving_checks", {
        "artifact": str(art), "frames": frames, "http_frames": http,
        "cil_artifact": str(cil_art), "cil_frames": cil_frames,
        "cil_speed": CIL_SPEED.tolist(), "cil_commands": CIL_COMMANDS}, root / "job")
    plain = InferenceEngine(load_policy(art, "cpu"), max_batch=32)
    cil_plain = InferenceEngine(load_policy(cil_art, "cpu"), max_batch=8)
    return {"two": two, "frames": frames, "http": http, "plain": plain,
            "cil_plain": cil_plain, "cil_frames": cil_frames}


def test_bucket_ladder_matches_jax(run, eight_devices):
    mesh = Mesh(np.array(eight_devices[:2]), ("data",))
    want = [JEngine(lambda x: x, max_batch=64, mesh=mesh).buckets,
            JEngine(lambda x: x, buckets=(3, 20), mesh=mesh).buckets]
    assert [tuple(b) for b in run["two"][0]["ladders"]] == want
    assert want[1] == (4, 20)


def test_sharded_matches_unsharded(run):
    for b, f in run["frames"].items():
        got, want = run["two"][0]["logits"][b], run["plain"].infer_logits(f)
        assert got.shape == want.shape == (b, 9)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=str(b))
        np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def test_each_rank_runs_half_a_bucket(run):
    for r in run["two"]:
        assert r["rows"][:len(SIZES)] == [1, 4, 8, 16]


def test_http_server_over_mesh(run):
    assert run["two"][0]["http"]["actions"] == run["plain"].infer(run["http"]).tolist()
    assert tuple(run["two"][0]["server_buckets"]) == (2, 4, 8, 16)
    # rank 1 followed the warm-up of every bucket, then the request's bucket of 8
    assert run["two"][1]["rows"][len(SIZES):] == [1, 2, 4, 8, 4]


def test_bad_command_over_mesh(run):
    for (code, answer), cmd in zip(run["two"][0]["cil"], CIL_COMMANDS):
        assert code == 200, answer
        want = run["cil_plain"].infer_logits(run["cil_frames"], CIL_SPEED,
                                             np.asarray(cmd, np.int32))
        np.testing.assert_allclose(np.asarray(answer["logits"]), want, rtol=1e-6, atol=1e-6,
                                   err_msg=str(cmd))


def test_failure_in_a_chunk_takes_the_mesh_down(run):
    r0, r1 = run["two"]
    assert r1["follow_error"] == "a poisoned row"
    assert r0["poisoned"] == [503, 503] and r0["healthz"] == 503
    assert r0["engine_failed"].startswith("RuntimeError")
