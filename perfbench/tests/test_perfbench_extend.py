"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files and entries, editing none: here a
throwaway configuration, mix and reader under a temporary root."""
import json

from conftest import TINY_MIXES, TINY_PORT
from perfbench import harness, manifest


def test_new_config_mix_cell_and_metric_by_files_alone(tiny_root):
    pb = tiny_root / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = dict(TINY_PORT, name="tiny_wide", d_model=192, d_ff=384)
    (pb / "configs" / "tiny_wide.json").write_text(json.dumps({
        "name": "tiny_wide", "family": "dense_gqa", "port": cfg,
        "quant": {"method": "rtn", "bits": 4, "group_size": 64,
                  "kv": "int8"}}))
    mix = dict(TINY_MIXES["tiny_closed"], clients=3)
    (pb / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (pb / "checks" / "tiny_wide.throwaway.json").write_text(json.dumps({
        "sample": {"tokens": 10, "max_requests": 3, "min_tokens": 5},
        "mean_logit_gap": {"limit": 0.01}}))
    (pb / "metrics" / "throwaway_steps.py").write_text(
        "def read(run):\n"
        "    return float(len(run.window.steps)) or None\n")
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_wide", "source": "test",
                           "file": "perfbench/configs/tiny_wide.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny_wide.throwaway",
                             "config": "tiny_wide", "traffic": "throwaway",
                             "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "output_tok_s":
            m["workloads"].append("tiny_wide.throwaway")
    man["per_layer"].append({"name": "throwaway_steps", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine step", "moves": "output_tok_s",
                             "workloads": ["tiny_wide.throwaway"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))

    assert [m["name"] for m in manifest.metrics(
        man, "tiny_wide.throwaway", True)] == ["throwaway_steps"]
    res, err = harness.run_cell(tiny_root, "tiny_wide.throwaway", 9, 2.0,
                                True, device="cpu")
    assert res["correct"], err
    assert res["metrics"]["throwaway_steps"]["value"] > 0
    res, _ = harness.run_cell(tiny_root, "tiny_wide.throwaway", 9, 0.5,
                              False, device="cpu")
    assert {"output_tok_s", "setup_s"} <= set(res["metrics"])
    # no file that was there before changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_per_layer_metric_without_workloads_follows_its_moves(tiny_root):
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "weights_s", "unit": "s",
                             "better": "lower", "source": "program_span",
                             "layer": "set-up", "moves": "itl_p95_ms"})
    man["per_layer"] = man["per_layer"][-1:]
    assert [m["name"] for m in manifest.metrics(man, "tiny.tiny_open",
                                                True)] == ["weights_s"]
    assert manifest.metrics(man, "tiny.tiny_closed", True) == []
