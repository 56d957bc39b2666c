"""Run one benchmark cell once and print its result as the last line of
standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``src`` is put on the path here). Exits
non-zero, printing no result, without enough CUDA cards for the cell, or
if a module of JAX or of the JAX package is loaded once the window has
closed. Every build and kernel cache of the program lies inside the
checkout (the port builds its CUDA libraries under ``build/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench import harness, manifest
    chips = manifest.load(ROOT)
    chips = next(w["chips"] for w in chips["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result, err = harness.run_cell(ROOT, args.workload, args.seed,
                                   args.seconds, bool(args.trace),
                                   t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in err:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
