"""A configuration, a traffic mix, limits and a per-layer metric added as
new files (and entries of BENCHMARK.json) in a copy of the benchmark are
found by their names, with no edit to the harness."""

import json
import shutil

from perfbench import harness
from perfbench.tests import tiny


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    bench = tmp_path / "perfbench"

    cfg = json.loads((bench / "configs" / "convnet1.json").read_text())
    (bench / "configs" / "convnet1_copy.json").write_text(json.dumps({**cfg, "name": "c2"}))
    traffic = json.loads((bench / "traffic" / "fleet_8192.json").read_text())
    (bench / "traffic" / "fleet_small.json").write_text(json.dumps({**traffic, "n_envs": 8}))
    (bench / "limits" / "c2.small.json").write_text(
        (bench / "limits" / "convnet1.rollout.json").read_text())
    (bench / "metrics" / "calls_traced.py").write_text(
        '"""Timed calls in the traced window."""\n\n\ndef read(ctx):\n    return ctx["calls"]\n')
    spec["configs"].append({"name": "c2", "source": "https://example.org/c2",
                            "file": "perfbench/configs/convnet1_copy.json", "reduced": [],
                            "why": "a copy"})
    spec["workloads"].append({"name": "c2.small", "config": "c2", "traffic": "fleet_small",
                              "chips": 1, "why": "a copy at 8 envs"})
    spec["end_to_end"][0]["workloads"].append("c2.small")
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "closed loop",
                              "moves": "env_steps_per_s", "workloads": ["c2.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    loaded = harness.load_cell("c2.small", tmp_path)
    assert loaded["traffic"]["n_envs"] == 8 and loaded["config"]["name"] == "c2"
    assert [m["name"] for m in loaded["per_layer"]] == ["calls_traced"]
    result = tiny.run("c2.small", root=tmp_path, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"] == {"calls_traced": {"value": 2, "unit": "calls"}}


def test_metrics_of_one_definition_share_a_reader():
    """``<name>.py`` where it exists, else the file of the name's part
    before its first dot."""
    for name in ("idle_share.rollout", "idle_share.train", "mfu.train", "kernel_b_roofline"):
        reader = harness.metric_reader(name)
        assert reader.__code__.co_filename.endswith(f"/metrics/{name.split('.')[0]}.py")
    ctx = {"trace": {"busy_s": 3.0}, "window_s": 4.0}
    assert harness.metric_reader("idle_share.train")(ctx) == 25.0
