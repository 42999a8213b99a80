"""The port's trace profiler and its remaining callbacks against the JAX
package's on the same calls.

- ``run bc -o trainer.profiler=trace`` (CPU, 64², one epoch of 5 batches)
  writes one ``torch.profiler`` trace under ``<log_dir>/imitation_camera/
  trace``, whose events hold one ``train_step`` span a train step, its
  ``forward``, ``backward`` and ``optimizer`` layer spans, and the
  convolutions inside them; ``trainer.trace_dir`` moves it; the run's
  history equals the untraced run's. ``trace_profiler(enabled=False)``
  traces nothing.
- ``ExampleCallback`` prints JAX's lines; ``UnfreezeModelCallback`` flips
  ``frozen`` at the same epoch for every ``wait_epochs`` of 0 to 3;
  ``SaveCodeSnapshot`` zips the same members as JAX's from one source
  tree, and by default the port's own package; ``UploadCheckpointsToWandb``
  does nothing in either without a wandb run.
"""

import contextlib
import io
import json
import zipfile

import pytest

import carla_imitation_learning_tpu.callbacks as j_cb
import carla_imitation_learning_tpu_torch.callbacks as p_cb
import carla_imitation_learning_tpu_torch.utils.profiling as p_prof
from carla_imitation_learning_tpu_torch import cli

BC = ["run", "bc", "--json", "-o", "device=cpu", "-o", "NUM_EPOCHS=1", "-o", "BATCH_SIZE=8",
      "-o", "synthetic_frames=60", "-o", "image_height=64", "-o", "image_width=64",
      "-o", "compute_dtype=float32", "-o", "trainer.num_sanity_val_steps=0",
      "-o", "trainer.limit_train_batches=5", "-o", "bc_cameras=['camera']"]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return json.loads(out.getvalue())["camera"]


def _trace_events(trace_dir):
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_run_bc_writes_a_trace(tmp_path):
    data = ["-o", f"data_dir={tmp_path}/data"]
    traced = _run(BC + data + ["-o", f"log_dir={tmp_path}/t", "-o", "trainer.profiler=trace"])
    events = _trace_events(tmp_path / "t" / "imitation_camera" / "trace")
    for span in ("train_step", "forward", "backward", "optimizer"):
        steps = [e for e in events if e.get("name") == span
                 and e.get("cat") == "user_annotation"]
        assert len(steps) == 5 and all(e["dur"] > 0 for e in steps), span
    assert any("conv" in e.get("name", "") for e in events)
    moved = _run(BC + data + ["-o", f"log_dir={tmp_path}/m", "-o", "trainer.profiler=trace",
                              "-o", f"trainer.trace_dir={tmp_path}/elsewhere"])
    assert _trace_events(tmp_path / "elsewhere")
    assert not (tmp_path / "m" / "imitation_camera" / "trace").exists()
    plain = _run(BC + data + ["-o", f"log_dir={tmp_path}/p"])
    assert traced["history"] == plain["history"] == moved["history"]


def test_trace_profiler_disabled_and_tensorboard(tmp_path):
    with p_prof.trace_profiler(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()


def _printed(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def test_example_and_unfreeze_callbacks_match_jax():
    for pkg in (p_cb, j_cb):
        assert isinstance(pkg.ExampleCallback(), pkg.Callback)
    made = [_printed(lambda m=m: m.ExampleCallback()) for m in (p_cb, j_cb)]
    assert made[0] == made[1] == "Callback initialized.\n"
    cbs = [m.ExampleCallback() for m in (p_cb, j_cb)]
    for hook, kw in (("on_fit_start", {}), ("on_fit_end", {"history": []})):
        said = [_printed(lambda c=c: getattr(c, hook)(None, None, **kw)) for c in cbs]
        assert said[0] == said[1] != ""
    for wait in range(4):
        flags = []
        for m in (p_cb, j_cb):
            cb = m.UnfreezeModelCallback(wait_epochs=wait)
            seen = [cb.frozen]
            for epoch in range(4):
                cb.on_epoch_end(None, None, epoch, {}, None)
                seen.append(cb.frozen)
            flags.append(seen)
        assert flags[0] == flags[1], wait


def test_code_snapshot_and_upload_match_jax(tmp_path):
    src = tmp_path / "src" / "pkg"
    (src / "sub").mkdir(parents=True)
    for rel in ("__init__.py", "a.py", "sub/b.py", "notes.txt"):
        (src / rel).write_text(f"# {rel}\n")
    names = []
    for tag, m in (("p", p_cb), ("j", j_cb)):
        m.SaveCodeSnapshot(str(tmp_path / tag), code_dir=str(src)).on_fit_start(None, None)
        with zipfile.ZipFile(tmp_path / tag / "code_snapshot.zip") as z:
            names.append(z.namelist())
    assert names[0] == names[1] == ["pkg/__init__.py", "pkg/a.py", "pkg/sub/b.py"]
    p_cb.SaveCodeSnapshot(str(tmp_path / "own")).on_fit_start(None, None)
    with zipfile.ZipFile(tmp_path / "own" / "code_snapshot.zip") as z:
        own = z.namelist()
    assert "carla_imitation_learning_tpu_torch/callbacks/callbacks.py" in own
    assert all(n.startswith("carla_imitation_learning_tpu_torch/") for n in own)
    for m in (p_cb, j_cb):
        assert m.UploadCheckpointsToWandb(str(tmp_path)).on_fit_end(None, None, []) is None


@pytest.mark.parametrize("name", ["ExampleCallback", "UnfreezeModelCallback",
                                  "SaveCodeSnapshot", "UploadCheckpointsToWandb",
                                  "SaveMetricsHeatmap", "SaveConfusionMatrix",
                                  "SaveBestMetricScores", "Callback"])
def test_callbacks_exported_as_in_jax(name):
    assert hasattr(j_cb, name) and issubclass(getattr(p_cb, name), p_cb.Callback)
