"""Each end-to-end metric's spread in the two sets of a cell's runs
(`tools/sets.sh`): (Q3 - Q1) / median per set, the run of a set's first
call left out of ``setup_s``, and the bound five times the widest spread.

    python3 perfbench/tools/spread.py chiprun_out/sets <workload>...
"""
import json
import statistics
import sys
from pathlib import Path


def last_json(path: Path):
    lines = [ln for ln in path.read_text().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def main(argv):
    d = Path(argv[0])
    for w in argv[1:]:
        sets = {}
        for p in sorted(d.glob(f"{w}.[AB].*.out"), key=lambda p: p.stat().st_mtime):
            res = last_json(p)
            if res is None:
                print(w, p.name, "no result")
                continue
            sets.setdefault(p.name.split(".")[-3], []).append(res)
        print(f"== {w}")
        names = sorted({k for rs in sets.values() for r in rs
                        for k in r["metrics"]})
        for name in names:
            row = []
            for key in sorted(sets):
                vals = [r["metrics"][name]["value"] for r in sets[key]
                        if name in r["metrics"]]
                if name == "setup_s" and key == "A":
                    vals = vals[1:]         # the first run builds
                q1, med, q3 = statistics.quantiles(vals, n=4)
                trim = list(vals)
                trim.remove(max(vals, key=lambda v: abs(v - med)))
                if len(trim) >= 3:
                    t1, tm, t3 = statistics.quantiles(trim, n=4)
                    tight = (t3 - t1) / tm
                else:
                    tight = float("nan")
                row.append((key, (q3 - q1) / med, med, min(vals), max(vals),
                            tight))
            print(f"  {name}: " + "; ".join(
                f"set {k} spread {sp:.4f} (farthest out {tr:.4f}) median "
                f"{m:.4f} [{lo:.4f}, {hi:.4f}]"
                for k, sp, m, lo, hi, tr in row))
        for key, rs in sorted(sets.items()):
            print(f"  set {key}: correct {[r['correct'] for r in rs]}, checks "
                  + str([{k: round(v['value'], 5) for k, v in r['checks'].items()}
                         for r in rs]))


if __name__ == "__main__":
    main(sys.argv[1:])
