"""Env-axis sharding of the port's fleet rollouts over two gloo ranks on
the CPU: the counterparts of tests/test_sharded_rollout.py.

One group of two ranks (tests/torch_mesh_ranks.py, the port alone) runs:
the sharded expert rollout of 16 envs × 6 steps at 32² (256 triangles)
from a seed, and from the JAX package's initial carry; ``evaluate_policy``
with a mesh; and ``cli run bc`` on both ranks. Here: the port's unsharded
rollout from the same seed, JAX's rollout on ``make_mesh(axis_sizes=
{"data": 2})`` of the harness's 8-device platform, and the one-rank
``run bc``. Tolerances: speed rtol 1e-5 and actions exact against both (the
expert's actions do not read the frames, which the two renderers round
differently); ``env_steps == 80`` and ``action_agreement == 1.0``; the
two-rank history against the one-rank one at rtol 1e-5 (the gradient is
summed over two halves of each batch), ``train_loss > 0``, and only rank
0's log directory written.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from carla_imitation_learning_tpu.parallel.mesh import make_mesh as j_make_mesh
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.training.closed_loop import make_rollout as j_make_rollout
from carla_imitation_learning_tpu.training.closed_loop import rollout_spawn_pool
from carla_imitation_learning_tpu_torch import cli, convert
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as p_cl

N_ENVS, N_STEPS = 16, 6
TOWN = make_town(blocks=2, n_buildings=6, n_lights=4)
J_PARAMS, P_PARAMS = JParams(n_agents=3, episode_len=1000), SimParams(n_agents=3, episode_len=1000)
J_RCFG = JRenderConfig(32, 32, max_triangles=256, backend="jax")
P_RCFG = RenderConfig(32, 32, max_triangles=256)
BC = ["run", "bc", "--json", "-o", "device=cpu", "-o", "NUM_EPOCHS=1", "-o", "BATCH_SIZE=8",
      "-o", "synthetic_frames=60", "-o", "image_height=64", "-o", "image_width=64",
      "-o", "compute_dtype=float32", "-o", "trainer.num_sanity_val_steps=0",
      "-o", "bc_cameras=['camera']"]


def _run_bc(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return json.loads(out.getvalue())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX data=2 rollout here, the ranks' checks, then the port's
    unsharded rollout and the one-rank ``run bc``."""
    init_fn, rollout_fn = j_make_rollout(J_PARAMS, TOWN, J_RCFG, None,
                                         mesh=j_make_mesh(axis_sizes={"data": 2}))
    carry = init_fn(jax.random.PRNGKey(0), N_ENVS)
    _, j_traj = rollout_fn(carry, N_STEPS)
    town = convert.town_from_jax(TOWN)
    pool = convert.spawn_pool_from_jax(rollout_spawn_pool(J_PARAMS, TOWN))
    root = tmp_path_factory.mktemp("sharded")
    bc_argv = BC + ["-o", f"data_dir={root}/data"]
    job = {"rollout": {"params": P_PARAMS, "town": town, "rcfg": P_RCFG, "pool": pool,
                       "n_envs": N_ENVS, "n_steps": N_STEPS,
                       "carry": convert.carry_from_jax(carry)},
           "bc_argv": bc_argv, "log_root": str(root / "logs")}
    out = ranks.spawn("rollout_checks", job, root / "job")
    p_init, p_roll = p_cl.make_rollout(P_PARAMS, town, P_RCFG, None, spawn_pool=pool,
                                       device="cpu")
    _, p_traj = p_roll(p_init(torch.Generator().manual_seed(0), N_ENVS), N_STEPS)
    one_rank = _run_bc(bc_argv + ["-o", f"log_dir={root}/logs/one"])
    return {"ranks": out, "jax": {k: np.asarray(j_traj[k]) for k in ("speed", "action")},
            "plain": p_traj, "one_rank": one_rank, "root": root}


def _joined(run, key, field):
    return torch.cat([out[key][field] for out in run["ranks"]], dim=1).numpy()


def test_sharded_rollout_matches_unsharded(run):
    for out in run["ranks"]:
        assert out["seeded"]["speed"].shape == (N_STEPS, N_ENVS // 2)
    np.testing.assert_allclose(_joined(run, "seeded", "speed"), run["plain"]["speed"].numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(_joined(run, "seeded", "action"),
                                  run["plain"]["action"].numpy())


def test_sharded_rollout_matches_jax_mesh(run):
    np.testing.assert_allclose(_joined(run, "from_carry", "speed"), run["jax"]["speed"],
                               rtol=1e-5)
    np.testing.assert_array_equal(_joined(run, "from_carry", "action"),
                                  run["jax"]["action"].astype(np.int64))


def test_evaluate_policy_with_mesh(run):
    for out in run["ranks"]:
        assert out["eval"]["env_steps"] == 80
        assert out["eval"]["action_agreement"] == 1.0
    assert run["ranks"][0]["eval"] == run["ranks"][1]["eval"]


def test_run_bc_on_two_ranks(run):
    two, one = run["ranks"][0]["bc"]["camera"], run["one_rank"]["camera"]
    assert run["ranks"][1]["bc"] is None            # rank 0 prints the result
    assert two["history"][-1]["train_loss"] > 0
    assert len(two["history"]) == len(one["history"])
    for row2, row1 in zip(two["history"], one["history"]):
        assert set(row2) == set(row1)
        for k in row1:
            np.testing.assert_allclose(row2[k], row1[k], rtol=1e-5, err_msg=k)
    logs = run["root"] / "logs"
    assert (logs / "rank0" / "imitation_camera" / "ckpt" / "index.json").exists()
    assert not (logs / "rank1").exists()
