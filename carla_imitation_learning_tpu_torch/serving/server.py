"""HTTP policy server: an exported artifact behind an endpoint (the JAX
package's ``serving/server.py``).

The micro-batcher drains concurrent requests into one engine call (grouped
by frame shape), bounded by a short coalescing window: lone batch-1
requests each waste most of a padded bucket and a device call, coalesced
they share both. Standard library only (``http.server``, ``threading``).

Surface:
  GET  /healthz      -> {"status": "ok"}
  GET  /v1/metadata  -> artifact meta + bucket ladder + expected (H, W, C)
  GET  /v1/stats     -> engine latency percentiles + coalescing counters
  POST /v1/infer     -> {"actions": [...]}  (argmax ints; continuous-family
                        artifacts return {"controls": [[steer, accel], ...]})
  POST /v1/logits    -> {"logits": [[...]]} (float rows)

POST bodies, either:
  application/octet-stream with header  X-Shape: B,H,W,C  (raw uint8 bytes)
  application/json {"frames": <base64 uint8 bytes>, "shape": [B,H,W,C]}
  application/json {"frames": <nested list>}

CIL (command-conditioned) artifacts also take per-row side inputs: JSON
fields "speed" (floats) and "command" (ints), or X-Speed/X-Command
comma-separated headers on octet-stream bodies; scalars broadcast. Bad
input answers 400, an engine failure 500.

Over a mesh (``mesh=``, rank 0's server; see ``serving/engine.py``) the
micro-batcher's thread is the one thread that issues collectives: the
engine's chunks, ``warmup()`` (handed to that thread) and, when the server
stops, the engine's ``stop()`` that ends the other ranks' ``follow()``.
A failure inside a sharded chunk takes the mesh down (``engine.failed``):
that request and every later one answer 503, and so does ``/healthz``.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.serving.engine import InferenceEngine
from carla_imitation_learning_tpu_torch.serving.export import LoadedPolicy, load_policy


class _Request:
    """One in-flight inference request parked on the batcher queue, or a
    ``job`` (a callable) for the batcher's thread to run."""

    __slots__ = ("frames", "extras", "logits", "error", "done", "job")

    def __init__(self, frames: np.ndarray | None, extras: tuple = (), job=None):
        self.frames = frames
        self.extras = extras  # per-row side inputs (e.g. CIL speed, command)
        self.job = job
        self.logits: np.ndarray | None = None
        self.error: Exception | None = None
        self.done = threading.Event()

    @property
    def rows(self) -> int:
        return 0 if self.frames is None else self.frames.shape[0]


class _MicroBatcher:
    """Coalesce concurrent requests into single engine calls.

    Blocks for the first queued request, then keeps draining until either
    ``window_ms`` elapses or ``max_rows`` frames are gathered, groups the
    drained requests by frame shape (H,W,C), and runs ONE
    ``engine.infer_logits`` per group. Results are scattered back by row
    count; per-request failures never poison batch-mates (shape/dtype
    validation happens before enqueue, so a batch either runs or fails as
    one engine error reported to every member).
    """

    def __init__(self, engine: InferenceEngine, *, window_ms: float = 2.0,
                 max_rows: int | None = None):
        self._engine = engine
        self._window_s = window_ms / 1e3
        self._max_rows = max_rows or engine.max_batch
        self._queue: list[_Request] = []
        self._lock = threading.Condition()
        self._stop = False
        # coalescing telemetry (served by /v1/stats)
        self.requests_total = 0
        self.batches_total = 0
        self.rows_total = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="policy-microbatcher")
        self._thread.start()

    def submit(self, frames: np.ndarray | None, extras: tuple = (), job=None) -> _Request:
        req = _Request(frames, extras, job)
        with self._lock:
            self._queue.append(req)
            self._lock.notify()
        return req

    def run_job(self, job) -> None:
        """Run ``job()`` on the batcher's thread and wait; its error raises."""
        req = self.submit(None, job=job)
        req.done.wait()
        if req.error is not None:
            raise req.error

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._thread.join(timeout=5)

    def _drain(self) -> list[_Request]:
        with self._lock:
            while not self._queue and not self._stop:
                self._lock.wait()
            if self._stop and not self._queue:
                return []
            batch = [self._queue.pop(0)]
        deadline = time.perf_counter() + self._window_s
        rows = batch[0].rows
        while rows < self._max_rows:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            with self._lock:
                if not self._queue:
                    self._lock.wait(timeout=remaining)
                if not self._queue:
                    break
                batch.append(self._queue.pop(0))
                rows += batch[-1].rows
        return batch

    def _loop(self) -> None:
        # inference mode and the current card are per thread: this thread
        # enters them itself (the engine also launches on its own device)
        if self._engine.device.type == "cuda":
            torch.cuda.set_device(self._engine.device)
        with torch.inference_mode():
            while True:
                batch = self._drain()
                if not batch:
                    self._engine.stop()   # a sharded engine's followers return
                    return  # stopped and drained
                groups: dict[tuple, list[_Request]] = {}
                for req in batch:
                    if req.job is not None:
                        self._run_job(req)
                    else:
                        groups.setdefault(req.frames.shape[1:], []).append(req)
                for reqs in groups.values():
                    self._run_group(reqs)

    @staticmethod
    def _run_job(req: _Request) -> None:
        try:
            req.job()
        except Exception as e:  # reported to the caller waiting on it
            req.error = e
        finally:
            req.done.set()

    def _run_group(self, reqs: list[_Request]) -> None:
        try:
            frames = (reqs[0].frames if len(reqs) == 1
                      else np.concatenate([r.frames for r in reqs], axis=0))
            extras = (reqs[0].extras if len(reqs) == 1 else tuple(
                np.concatenate([r.extras[i] for r in reqs], axis=0)
                for i in range(len(reqs[0].extras))))
            logits = self._engine.infer_logits(frames, *extras)
            self.batches_total += 1
            self.requests_total += len(reqs)
            self.rows_total += frames.shape[0]
            off = 0
            for r in reqs:
                n = r.frames.shape[0]
                r.logits = logits[off:off + n]
                off += n
        except Exception as e:  # engine failure: report to every member
            for r in reqs:
                r.error = e
        finally:
            for r in reqs:
                r.done.set()


def _parse_frames(headers, body: bytes) -> np.ndarray:
    ctype = (headers.get("Content-Type") or "").split(";")[0].strip()
    if ctype == "application/octet-stream":
        shape_hdr = headers.get("X-Shape")
        if not shape_hdr:
            raise ValueError("octet-stream body needs an X-Shape: B,H,W,C header")
        shape = tuple(int(s) for s in shape_hdr.split(","))
        frames = np.frombuffer(body, np.uint8)
        if frames.size != int(np.prod(shape)):
            raise ValueError(
                f"body has {frames.size} bytes, X-Shape {shape} wants "
                f"{int(np.prod(shape))}")
        return frames.reshape(shape)
    payload = json.loads(body.decode())
    raw = payload.get("frames")
    if raw is None:
        raise ValueError("JSON body needs a 'frames' field")
    if isinstance(raw, str):
        shape = payload.get("shape")
        if not shape:
            raise ValueError("base64 'frames' needs a 'shape' field")
        frames = np.frombuffer(base64.b64decode(raw), np.uint8)
        return frames.reshape(tuple(int(s) for s in shape))
    return np.asarray(raw, np.uint8)


def _parse_cil_extras(headers, body: bytes, n_rows: int) -> tuple:
    """(speed f32 (B,), command i32 (B,)) for CIL artifacts: JSON fields
    ``speed``/``command`` (number lists), or ``X-Speed``/``X-Command``
    comma-separated headers on octet-stream bodies. Scalars broadcast."""
    ctype = (headers.get("Content-Type") or "").split(";")[0].strip()
    if ctype == "application/octet-stream":
        sp_hdr, cm_hdr = headers.get("X-Speed"), headers.get("X-Command")
        if not sp_hdr or not cm_hdr:
            raise ValueError("CIL artifacts need X-Speed and X-Command "
                             "headers (comma-separated, one per row) on "
                             "octet-stream bodies")
        speed = np.array([float(s) for s in sp_hdr.split(",")], np.float32)
        command = np.array([int(s) for s in cm_hdr.split(",")], np.int32)
    else:
        payload = json.loads(body.decode())
        if "speed" not in payload or "command" not in payload:
            raise ValueError("CIL artifacts need 'speed' and 'command' "
                             "fields (one per frame row)")
        speed = np.asarray(payload["speed"], np.float32)
        command = np.asarray(payload["command"], np.int32)
    if speed.ndim == 0:
        speed = np.full((n_rows,), float(speed), np.float32)
    if command.ndim == 0:
        command = np.full((n_rows,), int(command), np.int32)
    if speed.shape != (n_rows,) or command.shape != (n_rows,):
        raise ValueError(f"speed {speed.shape} / command {command.shape} "
                         f"must be ({n_rows},) — one per frame row")
    return speed, command


class PolicyServer:
    """Serve a policy over HTTP with bucketed micro-batched inference.

    ``policy`` is an artifact directory (str/Path, loaded on ``device``, the
    card by default), a LoadedPolicy, or any ``fn(frames_u8) -> logits`` on
    tensors (run on ``device``). ``port=0`` binds an ephemeral port
    (``server.port`` holds the real one after ``start()``). Use as a context
    manager or call ``start()``/``stop()``. ``mesh`` shards every bucket
    (``InferenceEngine(mesh=)``): the server runs on rank 0, every other
    rank runs ``InferenceEngine(policy, mesh=mesh).follow()``, which returns
    when this server stops.
    """

    def __init__(self, policy, *, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 64, buckets=None, window_ms: float = 2.0,
                 quiet: bool = True, mesh=None, device=None):
        if isinstance(policy, (str, Path)):
            policy = load_policy(policy, device)
        self.meta = dict(policy.meta) if isinstance(policy, LoadedPolicy) else {}
        self.engine = InferenceEngine(policy, max_batch=max_batch,
                                      buckets=buckets, mesh=mesh, device=device)
        self._batcher = _MicroBatcher(self.engine, window_ms=window_ms)
        self._host, self._requested_port = host, port
        self._quiet = quiet
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._expect_hwc = None
        inputs = self.meta.get("inputs") or []
        if inputs and len(inputs[0].get("shape", [])) == 4:
            dims = inputs[0]["shape"][1:]
            if all(str(d).isdigit() for d in dims):
                self._expect_hwc = tuple(int(d) for d in dims)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "PolicyServer":
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((self._host, self._requested_port),
                                          handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="policy-server")
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._batcher.shutdown()

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def serve_forever(self) -> None:
        """Blocking serve (the CLI entry point's mode)."""
        if self._httpd is None:
            self.start()
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()

    def warmup(self) -> None:
        """Run every bucket once (needs a static input shape in the meta)."""
        if self._expect_hwc is None:
            raise RuntimeError("warmup needs artifact input-shape metadata")
        h, w, c = self._expect_hwc
        specs = ([((), np.float32), ((), np.int32)]
                 if self.meta.get("family") == "cil" else [])
        self._batcher.run_job(lambda: self.engine.warmup(h, w, c, extra_specs=specs))

    # -- request handling --------------------------------------------------
    def _stats(self) -> dict:
        b = self._batcher
        out = {"engine": self.engine.stats(),
               "requests_total": b.requests_total,
               "batches_total": b.batches_total,
               "mean_coalesced_rows": (b.rows_total / b.batches_total
                                       if b.batches_total else 0.0)}
        return out

    def _infer(self, frames: np.ndarray, extras: tuple = ()) -> np.ndarray:
        if frames.ndim != 4:
            raise ValueError(f"expected (B,H,W,C) frames, got {frames.shape}")
        if self._expect_hwc and frames.shape[1:] != self._expect_hwc:
            raise ValueError(
                f"frame shape {frames.shape[1:]} != artifact input "
                f"{self._expect_hwc}")
        req = self._batcher.submit(frames, extras)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.logits

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802
                if not server._quiet:
                    BaseHTTPRequestHandler.log_message(self, fmt, *args)

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    if server.engine.failed is None:
                        self._json(200, {"status": "ok"})
                    else:
                        self._json(503, {"status": "failed", "error": repr(server.engine.failed)})
                elif self.path == "/v1/metadata":
                    self._json(200, {"meta": server.meta,
                                     "buckets": list(server.engine.buckets),
                                     "expected_hwc": server._expect_hwc})
                elif self.path == "/v1/stats":
                    self._json(200, server._stats())
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path not in ("/v1/infer", "/v1/logits"):
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    frames = _parse_frames(self.headers, body)
                    extras = (_parse_cil_extras(self.headers, body,
                                                frames.shape[0])
                              if server.meta.get("family") == "cil" else ())
                except (ValueError, KeyError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                try:
                    logits = server._infer(frames, extras)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:  # engine/device failure; 503 once a mesh is down
                    self._json(500 if server.engine.failed is None else 503,
                               {"error": f"{type(e).__name__}: {e}"})
                    return
                if self.path == "/v1/infer":
                    if server.meta.get("family") == "continuous":
                        # continuous artifacts serve the (steer, accel)
                        # floats themselves — argmax has no meaning
                        self._json(200, {"controls": np.asarray(
                            logits, np.float64).tolist()})
                    else:
                        actions = np.argmax(logits, axis=-1).astype(int)
                        self._json(200, {"actions": actions.tolist()})
                else:
                    self._json(200, {"logits": np.asarray(
                        logits, np.float64).tolist()})

        return Handler
