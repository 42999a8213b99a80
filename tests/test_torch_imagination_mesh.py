"""``make_imagination_update(mesh=)`` (the imagination update that the
multi-device dry run ends with) on two gloo ranks on the CPU
(``tests/torch_mesh_ranks.py`` ``imagination_checks``, the port alone)
against one process over the whole batch (``imagination_run`` without a
mesh): the policy after Adam rtol 1e-5 / atol 1e-6 and equal on both
ranks, the loss rtol 1e-6, every other metric rtol 1e-6 / atol 1e-7. Two
cases: Gumbel actions with one reward head, and normal exploration noise
with a 3-head ensemble under the disagreement penalty, the uncertainty
stop (which cuts some rows) and the anchor. A rank that drew its own
rows' noise, took its means over its own rows, or averaged the gradients
fails both. The update without a mesh is held against JAX's in
``tests/test_torch_imagination.py``.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks

CASES = ("discrete", "continuous")


@pytest.fixture(scope="module")
def imagination(tmp_path_factory):
    """The update on two gloo ranks, and in this process over the whole batch."""
    sharded = ranks.spawn("imagination_checks", {"cases": list(CASES)},
                          tmp_path_factory.mktemp("imagination"))
    return sharded, {case: ranks.imagination_run(case) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_imagination_update_on_two_ranks_equals_one_process(imagination, case):
    sharded, whole = imagination
    want = whole[case]
    for r in sharded:
        got = r[case]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            tol = dict(rtol=1e-6) if k == "loss" else dict(rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **tol)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            assert torch.equal(got["params"][k], sharded[0][case]["params"][k]), k
    if case == "continuous":
        assert 0.0 < want["metrics"]["alive_frac"] < 1.0   # the stop cut some rows
