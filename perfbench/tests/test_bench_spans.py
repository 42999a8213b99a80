"""The span pass's reduction (``perfbench/spans.py``) on synthetic events,
its readers, and the pass itself on the CPU.

The synthetic trace (times in ns): on the main thread (1) ``rollout``
0–1000 holds ``render`` 100–300, which holds ``raster`` 150–250, and
``sim`` 400–600; thread 7 enters no span. Launches: 2 at 110 (render), 1
at 160 (raster), 3 at 450 from thread 7 (the main thread's ``sim``), 4 and
6 at 700 and 720 (the loop's own), 5 at 1100 (outside every span). On the
card: 2 120–170, 1 180–260, 3 470–520, 4 720–760, a copy 6 760–780, 99
800–850 with no recorded launch, 5 1120–1150. The gaps begin at 170 (in
``raster``: 10), 260 (``render``: 210), 520 (``sim``: 200), 780 and 850
(``rollout``: 20 + 270); the window of 1200 leaves 170 more before the
first and after the last activity (``outside``).
"""

import pytest
import torch

from perfbench import harness, spans
from perfbench.spans import OUTSIDE, UNATTRIBUTED

SPANS = [("rollout", 0, 1000, 1), ("render", 100, 300, 1), ("raster", 150, 250, 1),
         ("sim", 400, 600, 1), ("policy", 650, 650, 1)]
LAUNCHES = {2: (110, 1), 1: (160, 1), 3: (450, 7), 4: (700, 1), 6: (720, 1), 5: (1100, 1)}
DEVICE = [("k2", 120, 170, 2, 0), ("k1", 180, 260, 1, 0), ("k3", 470, 520, 3, 0),
          ("k4", 720, 760, 4, 0), ("Memcpy DtoD", 760, 780, 6, 0),
          ("k99", 800, 850, 99, 0), ("k5", 1120, 1150, 5, 0)]


@pytest.fixture
def reduced():
    return spans.reduce(SPANS, LAUNCHES, DEVICE, window_ns=1200)


def _got(reduced, key):
    return {k: round(v[key] * 1e9) for k, v in reduced["layers"].items()}


def test_device_time_to_the_innermost_span_at_launch(reduced):
    assert _got(reduced, "device_s") == {
        "rollout": 60, "render": 50, "raster": 80, "sim": 50, "policy": 0,
        OUTSIDE: 30, UNATTRIBUTED: 50}
    assert {k: v["launches"] for k, v in reduced["layers"].items()} == {
        "rollout": 1, "render": 1, "raster": 1, "sim": 1, "policy": 0,
        OUTSIDE: 1, UNATTRIBUTED: 1}


def test_idle_by_the_span_open_when_each_gap_began(reduced):
    assert _got(reduced, "idle_s") == {
        "rollout": 290, "render": 210, "raster": 10, "sim": 200, "policy": 0, OUTSIDE: 170,
        UNATTRIBUTED: 0}
    idle = sum(v["idle_s"] for v in reduced["layers"].values())
    assert reduced["window_s"] - reduced["busy_s"] == pytest.approx(idle)
    assert round(reduced["busy_s"] * 1e9) == 320


def test_exclusive_host_time_and_entries(reduced):
    assert _got(reduced, "host_s") == {
        "rollout": 600, "render": 100, "raster": 100, "sim": 200, "policy": 0,
        OUTSIDE: 0, UNATTRIBUTED: 0}
    assert {k: v["entries"] for k, v in reduced["layers"].items()}["render"] == 1


def test_a_thread_with_its_own_spans_keeps_them():
    own = spans.reduce(SPANS + [("backward", 440, 460, 7)], LAUNCHES, DEVICE, window_ns=1200)
    assert _got(own, "device_s")["backward"] == 50
    assert "sim" in own["layers"] and own["layers"]["sim"]["device_s"] == 0


@pytest.mark.parametrize("metric, value, extra", [
    ("device_ms.loop", 60e-9 * 1e3 / 4, ("launches_per_step", 0.25)),
    ("device_ms.raster", 80e-9 * 1e3 / 4, ("launches_per_step", 0.25)),
    ("idle_ms.sim", 200e-9 * 1e3 / 4, ("host_ms_per_step", 200e-9 * 1e3 / 4)),
    ("idle_ms.loop", 290e-9 * 1e3 / 4, ("host_ms_per_step", 600e-9 * 1e3 / 4)),
])
def test_readers(reduced, metric, value, extra):
    read = harness.metric_reader(metric)
    ctx = {"spans": {**reduced, "calls": 2}, "facts": {"steps_per_call": 2}}
    got = read(ctx)
    assert got["value"] == pytest.approx(value) and got[extra[0]] == pytest.approx(extra[1])
    assert read({**ctx, "spans": {**ctx["spans"], "busy_s": 0.0}}) is None
    assert read({"facts": ctx["facts"]}) is None   # a traced run without the pass


def test_events_of_keeps_layer_spans_and_launches():
    class E:
        def __init__(self, name, dev, ann, corr, linked=0, tid=1):
            self.args = name, dev, ann, corr, linked, tid

        def name(self):
            return self.args[0]

        def device_type(self):
            return self.args[1]

        def is_user_annotation(self):
            return self.args[2]

        def correlation_id(self):
            return self.args[3]

        def linked_correlation_id(self):
            return self.args[4]

        def start_thread_id(self):
            return self.args[5]

        def start_ns(self):
            return 10

        def end_ns(self):
            return 20

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    got = spans.events_of([
        E("sim", cpu, True, 1), E("Optimizer.step#Adam.step", cpu, True, 2),
        E("cudaLaunchKernel", cpu, False, 40), E("overhead", cpu, False, 0),
        E("kernel", cuda, False, 40, 40), E("sim", cuda, True, 41)])
    assert got == ([("sim", 10, 20, 1)], {40: (10, 1)}, [("kernel", 10, 20, 40, 40)])


def test_span_pass_on_the_cpu():
    from carla_imitation_learning_tpu_torch.utils.profiling import span

    def call():
        with span("rollout"):
            with span("sim"):
                torch.ones(64, 64) @ torch.ones(64, 64)

    got = spans.span_pass(call, 3, lambda: None, cuda=False)
    assert got["calls"] == 3 and got["busy_s"] == 0.0
    assert got["layers"]["sim"]["entries"] == got["layers"]["rollout"]["entries"] == 3
    assert got["layers"]["sim"]["host_s"] > 0.0
    assert span("sim") is span("x")   # off again after the pass
    assert harness.metric_reader("device_ms.sim")(
        {"spans": got, "facts": {"steps_per_call": 1}}) is None
