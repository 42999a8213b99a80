"""The port's compile check and multi-device dry run
(``carla_imitation_learning_tpu_torch/graft_entry.py``) against the JAX
package's root ``__graft_entry__.py`` on the CPU:

- ``entry()``: the port's forward with JAX ``entry()``'s parameters carried
  across by ``convert`` equals JAX's, on JAX's zero input and on a numpy
  frame stack, at ``tests/test_torch_policy.py``'s bf16 tolerance (atol
  5e-2 on logits of order 1; both models compute in bf16). JAX's side is
  ``entry()``'s model, input and function, with its parameters drawn by
  numpy (``tests/test_torch_aux.py`` ``numpy_params``, biases non-zero so
  that the zero input gives non-zero logits): flax's init of
  ``PolicyCNN`` takes 12–17 s to compile on one core, jitted or not;
- ``dryrun_multichip(2, device="cpu")``: two gloo ranks run every family,
  rank 0 prints the JAX line's keys with finite losses, each rank steps 2
  of the 4 envs, and the counts are the global fleet's.

The imagination update over two ranks, which the dry run ends with, is
held against one process in ``tests/test_torch_imagination_mesh.py``.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu_torch import convert, graft_entry
from test_torch_aux import numpy_params

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_entry_matches_jax():
    j_model = JPolicyCNN()
    j_x = jnp.zeros((8, 256, 256, 4), jnp.float32)
    params = numpy_params(j_model, (j_x,), seed=0)

    def j_fn(params, x):       # __graft_entry__.py:19-20
        return j_model.apply({"params": params}, x)

    fn, (model, x) = graft_entry.entry(device="cpu")
    assert x.shape == j_x.shape and x.dtype == torch.float32 and not x.any()
    model.load_state_dict(convert.policy_state_dict(params), strict=True)
    frames = (np.random.default_rng(0).integers(0, 256, (8, 256, 256, 4)) / 255.0
              ).astype(np.float32)
    for inp in (np.asarray(j_x), frames):
        want = np.asarray(jax.jit(j_fn)(params, inp))
        got = fn(model, torch.from_numpy(np.array(inp)))
        assert got.shape == (8, 9) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2)


def _jax_line_keys() -> list:
    """The keys of the JAX dry run's closing line, in order."""
    src = (ROOT / "__graft_entry__.py").read_text()
    line = src[src.index('print(f"dryrun_multichip('):]
    return re.findall(r"(\w+)=\{", line[:line.index("\n\n")])


def test_dryrun_multichip_two_ranks_on_the_cpu(capfd):
    res = graft_entry.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("dryrun_multichip(2) ok: "))
    pairs = dict(kv.split("=", 1) for kv in line.split(" ok: ", 1)[1].split(", ", 9))
    assert list(pairs) == _jax_line_keys()
    for key in ("bc_loss", "vae_loss", "fused_epoch_loss", "ppo_loss", "dagger_online_loss",
                "wm_loss", "imag_loss"):
        assert math.isfinite(float(pairs[key])), key
        assert res[key] == pytest.approx(float(pairs[key]), abs=1e-4)
    assert res["rollout_steps"] == res["goal_rollout_steps"] == 2 * 4   # 2 steps × 4 envs
    assert res["backend"] == "gloo" and len(res["ranks"]) == 2
    for r in res["ranks"]:
        assert r["local_envs"] == 2
        assert {k: r[k] for k in pairs if k != "mesh"} == {k: res[k] for k in pairs
                                                         if k != "mesh"}
