"""The command refuses to run, and prints no result line, without the
cards its cell asks for, and in a directory that holds only
BENCHMARK.json and the benchmark's own files."""

import shutil
import subprocess
import sys

import pytest

from perfbench import harness

ARGS = ["--workload", "convnet1.rollout", "--seed", "3000000000", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(harness.REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
