"""The uncertainty-gated DAgger ensemble (``training/dagger.py``) against
the JAX package's ``dagger_uncertain`` experiment, on the CPU.

- The vote: JAX's ``ensemble_policy_from`` closure is taken from a
  one-round ``dagger_uncertain`` run (its collection replaced by a
  synthetic store, its evaluation by a hook that keeps the policy it is
  given) and run on K members whose votes split; the port's
  ``ensemble_policy_from`` over the same members, converted, must give
  equal actions and disagreements.
- The step: one K-member ``Ensemble.train_step`` equals K single-member
  train steps from the same weights on the same batch, with the
  global-norm clip per member (triggered for some members and not for
  others). Parameters rtol 1e-4 / atol 1e-5 (``tests/test_torch_training.py``).
- A tiny ``run_dagger_uncertain`` on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carla_imitation_learning_tpu.training.closed_loop as j_cl
from carla_imitation_learning_tpu import compose
from carla_imitation_learning_tpu.data.pipeline import FrameStore as JStore
from carla_imitation_learning_tpu.experiments import dagger_uncertain
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import dagger, losses, steps

HW, K = 32, 4


@pytest.fixture(scope="module")
def jax_vote(tmp_path_factory):
    """JAX's ensemble policy after one round of ``dagger_uncertain`` (K
    members, float32), and its members' params (stacked on K)."""
    tmp = tmp_path_factory.mktemp("dagger_uncertain")
    cfg = compose(overrides=[
        "model=imitation", f"log_dir={tmp}", f"data_dir={tmp}/data",
        f"render.height={HW}", f"render.width={HW}", "BATCH_SIZE=16",
        "compute_dtype=float32", "sim.town.blocks=2", "sim.town.n_buildings=8",
        "sim.n_lights=4", "sim.n_agents=4", "sim.n_envs=4"])
    caught = []

    def evaluate_policy(params, town, rcfg, policy_fn, rng, **kw):
        caught.append(policy_fn)
        return {}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_cl, "collect_dataset", lambda *a, **kw: (
            JStore.synthetic(n=80, height=HW, width=HW, seed=1), None, None))
        mp.setattr(j_cl, "evaluate_policy", evaluate_policy)
        dagger_uncertain(cfg, rounds=1, n_envs=4, n_steps=20, epochs_per_round=1,
                         ensemble=K, tau=0.25)
    (policy_fn,) = caught
    free = dict(zip(policy_fn.__code__.co_freevars, policy_fn.__closure__))
    return policy_fn, free["member_params"].cell_contents


def _port_ensemble(member_params, tx=None, dtype=torch.float32):
    members = []
    for i in range(K):
        m = PolicyCNN(dtype=dtype)
        m.load_state_dict(convert.policy_state_dict(
            jax.tree_util.tree_map(lambda a: a[i], member_params)))
        members.append(m)
    return dagger.Ensemble(members, tx or steps.make_optimizer({"LEARNING_RATE": 1e-3}),
                           device="cpu")


def _centred_members(member_params, obs):
    """K members drawn with numpy (kernels std sqrt(1 / fan_in), biases std
    0.02), each last bias shifted by minus its mean logits over ``obs`` so
    that its argmax varies with the input (a random network's is nearly
    constant). → the stacked JAX params."""
    rng = np.random.default_rng(7)

    def draw(a):
        a = np.asarray(a)
        scale = 0.02 if a.ndim == 2 else 1 / np.sqrt(np.prod(a.shape[1:-1]))
        return (rng.normal(size=a.shape[1:]) * scale).astype(np.float32)

    members = []
    for _ in range(K):
        p = jax.tree_util.tree_map(draw, member_params)
        m = PolicyCNN(dtype=torch.float32)
        m.load_state_dict(convert.policy_state_dict(p))
        with torch.no_grad():
            mean = m(torch.from_numpy(obs)).mean(0).numpy()
        p["MLPHead_0"]["Dense_2"]["bias"] = p["MLPHead_0"]["Dense_2"]["bias"] - mean
        members.append(p)
    return jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *members)


def test_vote_and_disagreement_match_jax(jax_vote):
    """JAX's closure reads its members from its enclosing cell; the test
    puts members there whose votes split (0.25 to 0.75 disagreement)."""
    policy_fn, member_params = jax_vote
    rng = np.random.default_rng(0)
    obs = (rng.integers(0, 256, (96, HW, HW, 4)) * rng.uniform(0, 1, (96, 1, 1, 1))
           / 255).astype(np.float32)
    members = _centred_members(member_params, obs)
    cell = dict(zip(policy_fn.__code__.co_freevars, policy_fn.__closure__))["member_params"]
    trained, cell.cell_contents = cell.cell_contents, members
    try:
        j_action, j_dis = (np.asarray(a) for a in policy_fn(jnp.asarray(obs)))
    finally:
        cell.cell_contents = trained
    p_action, p_dis = dagger.ensemble_policy_from(_port_ensemble(members))(
        torch.from_numpy(obs))
    assert len(np.unique(j_dis)) >= 3 and len(np.unique(j_action)) >= 3
    np.testing.assert_array_equal(p_action.numpy(), j_action)
    np.testing.assert_array_equal(p_dis.numpy(), j_dis)
    assert p_dis.dtype == torch.float32 and p_action.shape == (96,)
    assert float(p_dis.min()) >= 0.0 and float(p_dis.max()) <= 1.0 - 1.0 / K


def test_vote_breaks_ties_to_the_lowest_action():
    """Hand-set logits: a 2-2 tie, a 1-1-1-1 split, and a clear majority."""
    ens = dagger.Ensemble([PolicyCNN(dtype=torch.float32) for _ in range(K)],
                          steps.make_optimizer({}), device="cpu")
    votes = torch.tensor([[5, 3, 7], [3, 1, 7], [5, 0, 7], [3, 8, 2]])     # (K, B)
    ens.logits = lambda obs: torch.nn.functional.one_hot(votes, 9).float()
    action, dis = dagger.ensemble_policy_from(ens)(torch.zeros(3, HW, HW, 4))
    assert action.tolist() == [3, 0, 7]
    torch.testing.assert_close(dis, torch.tensor([0.5, 0.75, 0.25]))


def _batch(seed=0, n=24):
    store = JStore.synthetic(n=n + 8, height=HW, width=HW, seed=seed)
    ds = DeviceDataset(FrameStore(store.frames, store.actions, store.traffic, store.sensors),
                       n, device="cpu")
    return next(iter(ds))


def test_ensemble_step_equals_member_steps(jax_vote):
    _, member_params = jax_vote
    batch = _batch()
    # the clip between the members' gradient norms: it triggers for some only
    norms, ens = [], _port_ensemble(member_params)
    for i in range(K):
        single = steps.create_train_state(
            PolicyCNN(dtype=torch.float32), steps.make_optimizer({}), device="cpu")
        single.model.load_state_dict(ens.member(i))
        loss, _ = losses.bc_loss_fn(single.model, batch)
        loss.backward()
        norms.append(float(torch.sqrt(sum((p.grad ** 2).sum()
                                          for p in single.model.parameters()))))
    clip = float(np.median(norms))
    assert min(norms) < clip < max(norms)
    tx = steps.make_optimizer({"LEARNING_RATE": 1e-3, "gradient_clip_val": clip})
    ens = _port_ensemble(member_params, tx)
    singles = []
    for i in range(K):
        s = steps.create_train_state(PolicyCNN(dtype=torch.float32), tx, device="cpu")
        s.model.load_state_dict(ens.member(i))
        singles.append(s)
    step = steps.make_train_step(losses.bc_loss_fn)
    for seed in (0, 1):
        b = _batch(seed)
        metrics = ens.train_step(b)
        for i, s in enumerate(singles):
            _, m = step(s, b)
            np.testing.assert_allclose(float(metrics["loss"][i]), float(m["loss"]), rtol=1e-5)
    assert ens.step == 2
    for i, s in enumerate(singles):
        got = ens.member(i)
        for k, v in s.model.state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"member {i} {k}")


def test_run_dagger_uncertain_tiny():
    town = convert.town_from_jax(make_town(blocks=2, n_buildings=6, n_lights=2))
    out = dagger.run_dagger_uncertain(
        SimParams(n_agents=3, episode_len=20), town, RenderConfig(HW, HW, max_triangles=256),
        torch.Generator().manual_seed(0), rounds=2, n_envs=3, n_steps=24,
        epochs_per_round=1, ensemble=3, tau=0.2, batch_size=16, device="cpu")
    r0, r1 = out["rounds"]
    assert np.isnan(r0["mean_disagreement"]) and 0.0 <= r1["mean_disagreement"] <= 2 / 3
    assert r1["dataset_frames"] == 2 * 3 * 24 and r1["ensemble"] == 3
    assert 0 < r1["trained_windows"] <= r1["dataset_frames"]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["driving_score"]) for r in (r0, r1))
