"""Command line: ``python -m carla_imitation_learning_tpu_torch.cli run
<experiment> [-o K=V ...]``, ``... list``, ``... serve <artifact>``,
``... import_torch <ckpt> --out <dir>``, ``... doctor [--cpu]
[--timeout S] [--json]`` and ``... bench [--device cuda]`` (the JAX
package's ``tpuil`` commands of those names; ``bench`` runs ``bench.main``,
whose last stdout line is the headline's JSON). Runs on the card; ``-o
device=cpu`` (``--device cpu`` for ``serve`` and ``bench``) asks for the
CPU.

``run`` joins a multi-process run first (``parallel.mesh.multihost_initialize``
reads torchrun's environment): ``torchrun --nproc-per-node N -m
carla_imitation_learning_tpu_torch.cli run bc ...`` trains data-parallel
over N cards, one rank a card, and rank 0 prints the result."""

from __future__ import annotations

import argparse
import json
import sys


def _scrub(x):
    """The result without its train states, with 0-d tensors as numbers."""
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if k != "state"}
    if isinstance(x, (list, tuple)):
        return [_scrub(v) for v in x]
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    return x


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m carla_imitation_learning_tpu_torch.cli",
        description="Driving simulation and imitation learning on an NVIDIA GPU")
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="run a named experiment")
    run_p.add_argument("experiment", nargs="?", default=None,
                       help="experiment name (see 'list'); may instead come from "
                            "a preset: -o experiment=<preset>")
    run_p.add_argument("--config", default="config", help="root config name")
    run_p.add_argument("--override", "-o", action="append", default=[],
                       metavar="K=V", help="config override (group or dotted value)")
    run_p.add_argument("--checkpoint", default=None, help="checkpoint to restore")
    run_p.add_argument("--json", action="store_true", help="print the result on one line")
    sub.add_parser("list", help="list experiments")
    imp_p = sub.add_parser(
        "import_torch",
        help="convert a reference PyTorch/Lightning policy checkpoint "
             "(ConvNet1/ConvNetRawSegment .ckpt) into this package's checkpoint")
    imp_p.add_argument("ckpt", help="path to the torch .ckpt/.pt file")
    imp_p.add_argument("--out", required=True, help="output checkpoint dir (for --checkpoint)")
    doc_p = sub.add_parser(
        "doctor", help="environment and device diagnostics (every device probe runs in "
                       "a subprocess bounded by the timeout)")
    doc_p.add_argument("--timeout", type=float, default=90.0, help="per-probe timeout seconds")
    doc_p.add_argument("--cpu", action="store_true",
                       help="pin the device probes to the CPU (and skip the kernel build)")
    doc_p.add_argument("--json", action="store_true")
    serve_p = sub.add_parser("serve", help="serve an exported policy artifact over HTTP")
    serve_p.add_argument("artifact", help="artifact dir (see export_policy)")
    serve_p.add_argument("--host", default="127.0.0.1")
    serve_p.add_argument("--port", type=int, default=8471)
    serve_p.add_argument("--max-batch", type=int, default=64)
    serve_p.add_argument("--window-ms", type=float, default=2.0,
                         help="micro-batch coalescing window")
    serve_p.add_argument("--device", default="cuda", help="device the artifact runs on")
    serve_p.add_argument("--verbose", action="store_true", help="log every request")
    bench_p = sub.add_parser(
        "bench", help="headline benchmark: the kernel parity gate, BC images/s and "
                      "closed-loop env-steps/s; the last stdout line is its JSON")
    bench_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.command == "bench":
        from carla_imitation_learning_tpu_torch import bench

        return bench.main(["--device", args.device])

    if args.command == "import_torch":
        from carla_imitation_learning_tpu_torch.utils.torch_import import import_and_save

        out = import_and_save(args.ckpt, args.out)
        print(f"imported {args.ckpt} -> {out} (use with --checkpoint {out})", file=sys.stderr)
        return 0

    if args.command == "doctor":
        from carla_imitation_learning_tpu_torch.utils.doctor import print_report, run_doctor

        report = run_doctor(timeout=args.timeout, force_cpu=args.cpu)
        if args.json:
            print(json.dumps(report))
        else:
            print_report(report)
        return 0 if report["ok"] else 1

    if args.command == "serve":
        from carla_imitation_learning_tpu_torch.serving import PolicyServer

        server = PolicyServer(args.artifact, host=args.host, port=args.port,
                              max_batch=args.max_batch, window_ms=args.window_ms,
                              quiet=not args.verbose, device=args.device)
        try:
            server.warmup()  # every bucket, before the first request
        except RuntimeError:
            pass  # no static input shape in the meta: the first requests warm up
        server.start()
        print(f"serving {args.artifact} at {server.url} "
              f"(buckets {list(server.engine.buckets)})", file=sys.stderr, flush=True)
        server.serve_forever()
        return 0

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.experiments import EXPERIMENTS

    if args.command == "list":
        for name, fn in sorted(EXPERIMENTS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:<20} {doc}")
        return 0

    name = args.experiment
    if name is None:
        name = compose(args.config, overrides=list(args.override)).get("experiment_name")
        if not name:
            print("no experiment given: pass a name or -o experiment=<preset>",
                  file=sys.stderr)
            return 2
    if name not in EXPERIMENTS:
        print(f"unknown experiment {name!r}; available: {', '.join(sorted(EXPERIMENTS))}",
              file=sys.stderr)
        return 2
    overrides = list(args.override)
    # the policy experiments default to the imitation model group
    if name.startswith(("bc", "test", "hpo", "closed", "collect", "scenario", "dagger")) \
            and not any(o.startswith("model=") for o in overrides):
        overrides.insert(0, "model=imitation")
    cfg = compose(args.config, overrides=overrides)
    import torch.distributed as dist

    from carla_imitation_learning_tpu_torch.parallel.mesh import (
        global_rank, multihost_initialize,
    )

    joined = not dist.is_initialized()   # this call starts the group, so it ends it
    multihost_initialize(device=str(cfg.get("device", "cuda")))
    joined = joined and dist.is_initialized()
    try:
        print(f"running experiment {name}", file=sys.stderr)
        kw = {"checkpoint": args.checkpoint} if args.checkpoint else {}
        result = _scrub(EXPERIMENTS[name](cfg, **kw))
        if global_rank() == 0:
            print(json.dumps(result, default=str, indent=None if args.json else 1))
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
