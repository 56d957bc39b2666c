"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file: configurations, mixes, check limits and readers."""
import json
import re

import pytest

from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"proj|head_dim|ffn|kv_channels|experts_per|expansion")


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["command"][:2] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert len(json.dumps(MAN)) <= 64 * 1024
    cells = len(MAN["workloads"])
    assert 2 + 14 * 24 * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and cells <= 24


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in MAN[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in MAN[k]]
        assert len(ns) == len(set(ns))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in [w["why"] for w in MAN["workloads"]] + \
            [c["why"] for c in MAN["configs"]] + \
            [m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_cells_find_their_files():
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json")\
            .exists()
        lim = json.loads((ROOT / "perfbench" / "checks"
                          / f"{w['name']}.json").read_text())
        assert lim["mean_logit_gap"]["limit"] > 0
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= \
        max(1, len(MAN["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MAN["workloads"]}
    for w in cells:
        names = [m["name"] for m in MAN["end_to_end"]
                 if w in m.get("workloads", [w])]
        assert "setup_s" in names and len(names) >= 2
        assert any(w in m.get("workloads", []) for m in MAN["per_layer"])
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in \
                m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers) >= 5


@pytest.mark.parametrize("name", [m["name"] for m in MAN["end_to_end"]
                                  + MAN["per_layer"]])
def test_every_metric_has_a_reader(name):
    src = (ROOT / "perfbench" / "metrics" / f"{name}.py").read_text()
    assert "def read(run)" in src
