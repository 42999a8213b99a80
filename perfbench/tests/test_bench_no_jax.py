"""Nothing the benchmark runs loads JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
plain reference loads nothing of the port."""

import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests import tiny

PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
from perfbench.tests import tiny
from perfbench import harness
tiny.run({cell!r})
print(json.dumps(harness.forbidden_modules()))
"""


@pytest.mark.parametrize("cell", tiny.cells())
def test_cell_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(harness.REPO), cell=cell)],
                         capture_output=True, text=True, timeout=600, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole():
    names = ["carla_imitation_learning_tpu_torch.sim", "jaxtyping", "flax.linen", "numpy"]
    assert harness.forbidden_modules(names) == ["flax"]
    assert harness.forbidden_modules(["carla_imitation_learning_tpu.bench"]) == [
        "carla_imitation_learning_tpu"]


def test_reference_loads_nothing_of_the_port():
    probe = (f"import sys; sys.path.insert(0, {str(harness.REPO)!r});"
             "import perfbench.reference.closed_loop, perfbench.reference.models,"
             " perfbench.reference.train;"
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"carla_imitation_learning_tpu_torch", "carla_imitation_learning_tpu",
                      "jax", "jaxlib", "flax"}
