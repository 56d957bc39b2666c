#!/bin/sh
# The bound's measurement of one cell: two sets of runs over the same
# seeds, then traced runs on further seeds; each run's output kept as
# chiprun_out/sets/<workload>.<set>.<seed>.{out,err}:
#   tools/sets.sh <workload> <seconds> "<seeds>" "<traced seeds>"
w=$1; s=$2; seeds=$3; traced=$4
mkdir -p chiprun_out/sets
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # set seed trace
  t0=$(date +%s)
  python3 perfbench/run.py --workload "$w" --seed "$2" --seconds "$s" --trace "$3" \
    > "chiprun_out/sets/$w.$1.$2.out" 2> "chiprun_out/sets/$w.$1.$2.err"
  echo "== $w set $1 seed $2 trace $3 rc $? wall $(( $(date +%s) - t0 )) s"
  tail -n 1 "chiprun_out/sets/$w.$1.$2.out" | cut -c1-600
  tail -n 4 "chiprun_out/sets/$w.$1.$2.err"
}
for set in A B; do for seed in $seeds; do run $set $seed 0; done; done
for seed in $traced; do run T $seed 1; done
