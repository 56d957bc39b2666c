"""Readings the check's limits are set from, on the card, in one process.

    python3 perfbench/tools/calibrate.py --workload <name> --seconds <s> \
        --seeds <n>... [--control-seeds <n>...]

For every seed, a run of the cell at its own load (set-up, a window of
``--seconds``, the same sample of finished requests a run checks) and the
program's widest logit gap against the reference. For each control seed
also the control's: the reference computed with float8 e4m3 linear inputs
in the program's place, at the same positions. One JSON line a seed, on
standard output and in ``chiprun_out/calibrate.<workload>.jsonl``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import check, harness, manifest
    conf = manifest.cell(ROOT, manifest.load(ROOT), args.workload)["config"]
    out = ROOT / "chiprun_out" / f"calibrate.{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in list(args.seeds) + [s for s in args.control_seeds
                                    if s not in args.seeds]:
        t0 = time.perf_counter()
        m = harness.measure(ROOT, args.workload, seed, args.seconds, False,
                            t_start=t0, device=args.device)
        line = {"seed": seed, "metrics": {k: v["value"] for k, v in
                                          m.result["metrics"].items()},
                "requests": len(m.rids),
                "tokens": sum(len(v) for v in m.outputs.values())}
        t1 = time.perf_counter()
        if seed in args.control_seeds:
            prog, ctrl = check.control_gaps(conf, seed, m.rids, m.outputs,
                                            m.prompts, args.device)
            line.update(program=prog, control=ctrl)
        else:
            line["program"] = check.served_gaps(
                conf, seed, m.rids, m.outputs, m.prompts, args.device)
        line["check_s"] = time.perf_counter() - t1
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
