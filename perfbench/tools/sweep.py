"""The open loop's knee, found once on the card: one window at each
offered rate, in one process.

    python3 perfbench/tools/sweep.py --workload <name> --seconds <s> \
        --seed <n> --rates <r>...

For each rate: the cell's end-to-end metrics, completed requests/s, the
TTFT 95th percentile over the requests due in the window and its median
over those due in each half, and the requests waiting at the window's
open and close.
A rate is sustained when the queue does not grow and the second half's
TTFT median stays within twice the first half's.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness, stats
    for rate in args.rates:
        m = harness.measure(ROOT, args.workload, args.seed, args.seconds,
                            False, mix_overrides={"rate": rate},
                            device=args.device)
        w = m.window
        mid = w.t_open + w.seconds / 2
        waits = w.ttfts()
        halves = [[], []]
        for rid, wait in waits.items():
            halves[w.reqs[rid].due >= mid].append(wait)
        done = sum(1 for r in w.reqs.values() if r.finished is not None
                   and w.t_open < r.finished <= w.t_close)
        line = {"rate": rate,
                "metrics": {k: v["value"]
                            for k, v in m.result["metrics"].items()},
                "done_per_s": done / w.seconds,
                "ttft_p95_ms": (1e3 * stats.percentile(list(waits.values()),
                                                       95) if waits else None),
                "ttft_med_halves_ms": [1e3 * statistics.median(h)
                                       if h else None for h in halves],
                "queued_open_close": list(m.queued),
                "late_max_s": max(m.late) if m.late else 0.0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
