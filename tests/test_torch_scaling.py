"""The weak-scaling harness (``benchmarks_torch/scaling.py``) at a toy size
on the CPU: 1 and 2 gloo ranks (a core a rank), 4 envs and a batch of 4 a
rank at 32², through the script as a user runs it. The report has the
fields the card's run writes: the layout, backend and device of every
record, the fleet and batch that grow with the ranks, positive rates, the
ratios to one rank, and the note that a curve on one device is no scaling
curve. A CPU run refuses to write under ``reports/``."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "benchmarks_torch" / "scaling.py"
TOY = ["--device", "cpu", "--tiny", "--ranks", "1", "2"]


def _run(*argv):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    return subprocess.run([sys.executable, str(SCRIPT), *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_scaling_report_at_toy_size(tmp_path):
    out = tmp_path / "scaling.json"
    res = _run(*TOY, "--out", str(out))
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(out.read_text())
    assert "not scaling" in report["note"] and report["smi"] is None
    assert report["config"]["envs_per_rank"] == 4 and report["config"]["triangles"] == 512
    recs = report["records"]
    assert [r["ranks"] for r in recs] == [1, 2]
    for r in recs:
        assert r["layout"] == "gloo ranks on the CPU" and r["backend"] == "gloo"
        assert r["device"] == "cpu" and len(r["per_rank"]) == r["ranks"]
        assert r["n_envs"] == 4 * r["ranks"] and r["bc_batch"] == 4 * r["ranks"]
        for k in ("rollout_ms_per_fleet_step", "rollout_env_steps_per_sec", "bc_ms_per_step",
                  "bc_images_per_sec", "wall_s_with_start"):
            assert r[k] > 0, k
    assert recs[0]["rollout_ms_vs_1_rank"] == recs[0]["bc_ms_vs_1_rank"] == 1.0
    assert recs[1]["rollout_ms_vs_1_rank"] > 0


def test_cpu_run_refuses_reports_dir():
    res = _run(*TOY, "--ranks", "1", "--out", str(ROOT / "reports" / "x.json"))
    assert res.returncode != 0 and "reports/" in res.stderr
    assert not (ROOT / "reports" / "x.json").exists()
