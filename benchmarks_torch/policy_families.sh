#!/bin/bash
# The policy-family experiments through the port's command line, each
# result as one JSON line in OUT_DIR/<name>.json (its stderr beside it),
# with its exit code and wall seconds on standard output:
#   bc_cil (goal-directed, 8 goals, 2 epochs) -> route_eval of its checkpoint
#   bc_continuous (2 epochs) -> closed_loop_eval of its checkpoint
#   scenario_eval of the CIL checkpoint on clear, multilane and turns
#   dagger (cil with 8 goals; continuous), dagger_online (cil with 8 goals)
# Usage: bash benchmarks_torch/policy_families.sh OUT_DIR [-o K=V ...]
# (the card by default; -o device=cpu and small sizes run it on the CPU).
set -u
OUT=$1; shift
mkdir -p "$OUT"
W="$OUT/work"; rm -rf "$W"; mkdir -p "$W"
CLI="python3 -m carla_imitation_learning_tpu_torch.cli run"
BASE="-o data_dir=$W/data -o log_dir=$W/logs $*"
best() {
    python3 -c "import json,sys; print(json.loads(open(sys.argv[1]).read().strip().splitlines()[-1])['best_path'])" "$1"
}
run() {
    name=$1; shift
    t0=$(date +%s.%N)
    $CLI "$@" $BASE --json > "$OUT/$name.json" 2> "$OUT/$name.err"
    rc=$?
    echo "$name rc=$rc seconds=$(python3 -c "print(round($(date +%s.%N) - $t0, 1))")"
}
run bc_cil bc_cil -o experiment=bc_cil -o n_goals=8 -o NUM_EPOCHS=2
CIL=$(best "$OUT/bc_cil.json")
run route_eval route_eval -o experiment=route_eval --checkpoint "$CIL" -o policy_family=cil \
    -o n_envs=64 -o n_steps=600
run bc_continuous bc_continuous -o experiment=bc_continuous -o NUM_EPOCHS=2
CONT=$(best "$OUT/bc_continuous.json")
run closed_loop_continuous closed_loop_eval --checkpoint "$CONT" -o policy_family=continuous \
    -o n_envs=256 -o n_steps=100
run scenario_cil scenario_eval --checkpoint "$CIL" -o policy_family=cil -o n_envs=256 \
    -o n_steps=100 -o scenarios=clear,multilane,turns
run dagger_cil dagger -o policy_family=cil -o n_goals=8
run dagger_continuous dagger -o policy_family=continuous
run dagger_online_cil dagger_online -o experiment=dagger_online -o policy_family=cil -o n_goals=8
