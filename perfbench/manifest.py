"""Reading ``BENCHMARK.json`` and the files it names, by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness finds the configuration's file through ``configs``, the
mix at ``perfbench/traffic/<traffic>.json``, the limits its correctness
check holds at ``perfbench/checks/<workload>.json`` and each metric's
reader at ``perfbench/metrics/<metric>.py``. Adding a cell, a mix, a
configuration or a metric therefore adds files and entries and edits
none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(root: Path, manifest: dict, workload: str) -> dict:
    """The cell's entry, its configuration, mix and check limits."""
    w = _named(manifest["workloads"], workload, "workload")
    c = _named(manifest["configs"], w["config"], "config")
    return {
        "workload": w,
        "config": json.loads((root / c["file"]).read_text()),
        "mix": json.loads((root / "perfbench" / "traffic"
                           / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((root / "perfbench" / "checks"
                              / f"{workload}.json").read_text()),
    }


def metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced. A metric with ``workloads``
    runs in those cells; a per-layer metric without runs in every cell
    that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(root: Path, name: str):
    """The ``read(run)`` function of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
