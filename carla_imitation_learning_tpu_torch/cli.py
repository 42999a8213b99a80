"""Command line: ``python -m carla_imitation_learning_tpu_torch.cli run
<experiment> [-o K=V ...]`` and ``... list`` (the JAX package's ``tpuil``
``run`` and ``list``). Runs on the card; ``-o device=cpu`` asks for the
CPU."""

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
    args = parser.parse_args(argv)

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
    if name.startswith(("bc", "test", "closed", "collect", "scenario", "dagger")) \
            and not any(o.startswith("model=") for o in overrides):
        overrides.insert(0, "model=imitation")
    cfg = compose(args.config, overrides=overrides)
    print(f"running experiment {name}", file=sys.stderr)
    kw = {"checkpoint": args.checkpoint} if args.checkpoint else {}
    result = _scrub(EXPERIMENTS[name](cfg, **kw))
    print(json.dumps(result, default=str, indent=None if args.json else 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
