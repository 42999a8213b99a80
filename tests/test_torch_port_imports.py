"""The PyTorch port, chip_smoke.py, benchmarks_torch/, the demo GIF's
script (docs/make_demo_gif_torch.py) and the rank side of the
data-parallel tests (tests/torch_mesh_ranks.py) import neither JAX,
flax nor the JAX package, and read no file of the JAX package (its ``configs/``, its
``native/framestore.cpp``): the machine with the card has none of them, and
the port keeps its own copies."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "carla_imitation_learning_tpu_torch"
FORBIDDEN = ("jax", "flax", "carla_imitation_learning_tpu")
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "benchmarks_torch").glob("*.py"))
           + [ROOT / "docs" / "make_demo_gif_torch.py", ROOT / "tests" / "torch_mesh_ranks.py"])


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    assert not (_imported_roots(path) & set(FORBIDDEN)), path


def test_modules_leave_jax_unloaded():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


# a path component or path into the JAX package; a ``file.py:line`` reference
# (the "replaces" field of chip_smoke's kernel table) names code, reads nothing
_JAX_PATH = re.compile(r"^(carla_imitation_learning_tpu|native)(/|$)|native/framestore\.cpp")
_REFERENCE = re.compile(r"^carla_imitation_learning_tpu/[\w/]+\.py:\d+$")


def _path_constants(path: pathlib.Path) -> list:
    """String constants of ``path``'s code (docstrings excluded) that name a
    path into the JAX package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings and _JAX_PATH.search(node.value)
            and not _REFERENCE.match(node.value)]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_reads_no_jax_package_file(path):
    assert not _path_constants(path), path


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.c*")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_include_no_jax_package_file(path):
    includes = re.findall(r'#include\s*[<"]([^>"]+)', path.read_text())
    assert not [i for i in includes if _JAX_PATH.search(i) or ".." in i], path


def test_path_check_catches_a_jax_path(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('"""Reads native/framestore.cpp of the JAX package."""\n'
                   'from pathlib import Path\n'
                   'SRC = Path(__file__).parents[2] / "native" / "framestore.cpp"\n'
                   'CFG = ROOT / "carla_imitation_learning_tpu" / "configs"\n'
                   'REF = "carla_imitation_learning_tpu/ops/raster.py:120"\n')
    assert _path_constants(bad) == ["native", "carla_imitation_learning_tpu"]


def test_serving_sources_are_checked():
    """The serving tier, the reference importer and their benchmarks are
    among the sources every check above walks."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"carla_imitation_learning_tpu_torch/serving/{m}.py"
            for m in ("__init__", "quant", "export", "engine", "server")} <= names
    assert {"carla_imitation_learning_tpu_torch/utils/torch_import.py",
            "benchmarks_torch/inference.py", "benchmarks_torch/serving_http.py",
            "benchmarks_torch/serving_phase.py"} <= names


def test_hpo_sources_are_checked():
    """The hyperparameter search, its experiments and the A/B harness are
    among the sources every check above walks."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"carla_imitation_learning_tpu_torch/parallel/__init__.py",
            "carla_imitation_learning_tpu_torch/parallel/hpo.py",
            "carla_imitation_learning_tpu_torch/experiments.py",
            "benchmarks_torch/continuous_ab.py", "benchmarks_torch/hpo_phase.py"} <= names


def test_mesh_sources_are_checked():
    """The mesh, the modules it shards and the ranks' side of its tests are
    among the sources every check above walks."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"carla_imitation_learning_tpu_torch/parallel/mesh.py",
            "carla_imitation_learning_tpu_torch/training/steps.py",
            "carla_imitation_learning_tpu_torch/training/closed_loop.py",
            "carla_imitation_learning_tpu_torch/data/vae_data.py",
            "tests/torch_mesh_ranks.py"} <= names


def test_mesh_module_leaves_jax_unloaded():
    """A rank imports the mesh and the rank-side test module without
    loading JAX: the ranks run the port alone."""
    code = ("import sys\n"
            "import carla_imitation_learning_tpu_torch.parallel.mesh\n"
            "import torch_mesh_ranks\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), str(ROOT / "tests"), os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_tooling_sources_are_checked():
    """The sharded online DAgger, PPO and serving, the doctor, the trace
    profiler, the callbacks and the scaling harness are among the sources
    every check above walks."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"carla_imitation_learning_tpu_torch/{m}.py"
            for m in ("training/online_dagger", "training/rl", "serving/engine",
                      "serving/server", "utils/doctor", "utils/profiling",
                      "callbacks/callbacks", "callbacks/__init__", "cli")} <= names
    assert "benchmarks_torch/scaling.py" in names


@pytest.mark.parametrize("name", ["torch_import", "device_compute", "compile_smoke",
                                  "cpu_mesh", "cuda_kernels"])
def test_doctor_probes_import_no_jax(name):
    """The doctor's probes are code in strings, run in subprocesses, which
    the import scan above cannot see: each (with the snippet it starts,
    for the CPU mesh) imports torch and never JAX or the JAX package."""
    from carla_imitation_learning_tpu_torch.utils import doctor

    code = doctor.PROBES[name]
    snippets = [code] + [n.value for n in ast.walk(ast.parse(code))
                         if isinstance(n, ast.Constant) and isinstance(n.value, str)
                         and "import" in n.value]
    for snippet in snippets:
        roots = set()
        for node in ast.walk(ast.parse(snippet)):
            if isinstance(node, ast.Import):
                roots |= {alias.name.split(".")[0] for alias in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert "torch" in roots or "subprocess" in roots, name
        assert not roots & set(FORBIDDEN), (name, roots)
        assert not re.search(r"\bjax\b|carla_imitation_learning_tpu\b(?!_torch)", snippet), name


def test_harness_sources_are_checked():
    """The seven diagnostic and ViT harnesses are among the sources every
    check above walks."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"benchmarks_torch/{m}.py"
            for m in ("rollout_breakdown", "sim_ablation", "expert_envelope",
                      "crash_forensics", "reference_control", "vit_ab",
                      "vit_crossover")} <= names


def test_entry_point_sources_are_checked():
    """The headline benchmark, the dry run and the demo GIF's script are
    among the sources every check above walks."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"carla_imitation_learning_tpu_torch/bench.py",
            "carla_imitation_learning_tpu_torch/graft_entry.py",
            "docs/make_demo_gif_torch.py"} <= names


def test_demo_script_leaves_jax_unloaded():
    """The demo GIF's script, imported as its command runs it, loads no
    JAX: it puts its checkout's root on the path and imports the port."""
    code = ("import runpy, sys\n"
            f"runpy.run_path({str(ROOT / 'docs' / 'make_demo_gif_torch.py')!r}, "
            "run_name='demo')\n"
            "import carla_imitation_learning_tpu_torch.bench\n"
            "import carla_imitation_learning_tpu_torch.graft_entry\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "docs",
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
