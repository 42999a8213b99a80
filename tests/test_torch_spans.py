"""The port's layer spans (``utils/profiling.py`` ``span``) on a tiny fleet
and a fused BC epoch, under a CPU ``torch.profiler``.

- Spans off (the default): neither the rollout nor the epoch enters any of
  the port's spans.
- Spans on (``spans_on()``): each span appears once a fleet step or train
  step, ``rollout`` and ``train_step`` once a call or step; ``raster``
  lies inside ``render``; ``expert``, ``policy``, ``sim`` and ``render``
  lie inside ``rollout`` and apart from each other, as ``forward``,
  ``backward`` and ``optimizer`` do inside ``train_step``, and ``gather``
  lies apart from ``train_step``.
- ``trace_profiler`` turns spans on for its block only.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.town import make_town
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import bc_loss_fn
from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
from carla_imitation_learning_tpu_torch.training.steps import (
    create_train_state, make_fused_epoch, make_optimizer,
)
from carla_imitation_learning_tpu_torch.utils import profiling

ROLLOUT_SPANS = ("rollout", "expert", "policy", "sim", "render", "raster")
TRAIN_SPANS = ("gather", "train_step", "forward", "backward", "optimizer")
H = W = 64
N_ENVS, N_STEPS, N_BATCHES = 3, 3, 2


@pytest.fixture(scope="module")
def fleet():
    model = PolicyCNN(dtype=torch.float32).eval()
    init_fn, rollout_fn = make_rollout(
        SimParams(n_agents=3), make_town(blocks=2, n_buildings=6, n_lights=2),
        RenderConfig(H, W, max_triangles=128), lambda obs: model(obs).argmax(-1),
        device="cpu")
    return init_fn(torch.Generator().manual_seed(0), N_ENVS), rollout_fn


@pytest.fixture(scope="module")
def epoch():
    rng = np.random.default_rng(0)
    n = 40
    store = FrameStore(frames=rng.integers(0, 256, (n, H, W), dtype=np.uint8),
                       actions=rng.integers(0, 9, n).astype(np.int32),
                       traffic=np.zeros(n, np.int32), sensors=np.zeros((n, 3), np.float32))
    ds = DeviceDataset(store, batch_size=4, frame_skip=4, dtype="float32", device="cpu")
    state = create_train_state(PolicyCNN(dtype=torch.float32),
                               make_optimizer({"LEARNING_RATE": 1e-3}, 1),
                               generator=torch.Generator().manual_seed(0), device="cpu")
    order = torch.randint(0, ds.n_samples, (N_BATCHES, 4),
                          generator=torch.Generator().manual_seed(1))
    return make_fused_epoch(bc_loss_fn, ds.pure_batch), state, order


def _spans(work, names):
    """The (name, start, end) of every recorded user range named in
    ``names``, in start order, from a CPU profile of ``work()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name() in names), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _apart(spans):
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1], (a, b)


@pytest.mark.parametrize("path", ["rollout", "epoch"])
def test_spans_off_record_nothing(path, fleet, epoch):
    if path == "rollout":
        carry, rollout_fn = fleet
        assert _spans(lambda: rollout_fn(carry, N_STEPS), ROLLOUT_SPANS) == []
    else:
        run, state, order = epoch
        assert _spans(lambda: run(state, order), TRAIN_SPANS) == []


def test_rollout_spans_once_a_step(fleet):
    carry, rollout_fn = fleet
    with profiling.spans_on():
        spans = _spans(lambda: rollout_fn(carry, N_STEPS), ROLLOUT_SPANS)
    by = {n: [s for s in spans if s[0] == n] for n in ROLLOUT_SPANS}
    assert len(by["rollout"]) == 1
    assert all(len(by[n]) == N_STEPS for n in ROLLOUT_SPANS[1:]), spans
    outer = by["rollout"][0]
    layers = [s for s in spans if s[0] in ("expert", "policy", "sim", "render")]
    assert all(_inside(s, outer) for s in layers)
    _apart(layers)
    for raster, render in zip(by["raster"], by["render"]):
        assert _inside(raster, render)
    # each step in the loop's order: the frame, the expert, the policy, the sim
    assert [s[0] for s in layers] == ["render", "expert", "policy", "sim"] * N_STEPS


def test_train_spans_once_a_step(epoch):
    run, state, order = epoch
    with profiling.spans_on():
        spans = _spans(lambda: run(state, order), TRAIN_SPANS)
    by = {n: [s for s in spans if s[0] == n] for n in TRAIN_SPANS}
    assert all(len(by[n]) == N_BATCHES for n in TRAIN_SPANS), spans
    _apart(sorted(by["gather"] + by["train_step"], key=lambda s: s[1]))
    for step in by["train_step"]:
        inner = [s for s in spans if s[0] in ("forward", "backward", "optimizer")
                 and _inside(s, step)]
        assert [s[0] for s in inner] == ["forward", "backward", "optimizer"]
        _apart(inner)


def test_trace_profiler_turns_spans_on(tmp_path):
    assert profiling.span("x") is profiling.span("y")
    with profiling.trace_profiler(str(tmp_path)):
        assert isinstance(profiling.span("x"), torch.profiler.record_function)
    assert profiling.span("x") is profiling.span("y")
    with profiling.trace_profiler(str(tmp_path / "off"), enabled=False):
        assert profiling.span("x") is profiling.span("y")
