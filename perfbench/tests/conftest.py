"""Fixtures of the benchmark's own tests: a throwaway checkout root that
holds a copy of the benchmark's readers beside a tiny configuration and
tiny mixes, so the harness runs end to end on the CPU."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_PORT = {
    "name": "tiny", "family": "dense", "num_layers": 2, "d_model": 128,
    "num_heads": 4, "num_kv_heads": 2, "head_dim": 64, "d_ff": 256,
    "vocab_size": 512, "act": "silu", "mlp_type": "glu",
    "norm_type": "rmsnorm", "norm_eps": 1e-6, "qkv_bias": True,
    "tie_embeddings": False, "rope_theta": 10000.0, "rope_fraction": 0.5,
    "max_seq_len": 512}
TINY_ENGINE = {"num_slots": 4, "prefill_chunk": 8, "max_seq": 64,
               "page_size": 16, "kv_quant": "int8"}
TINY_MIXES = {
    "tiny_closed": {"loop": "closed", "clients": 4, "block": 8,
                    "prompt": {"dist": "lognormal", "median": 20,
                               "sigma": 0.5, "min": 8, "max": 40},
                    "output": {"dist": "uniform", "min": 3, "max": 10},
                    "engine": TINY_ENGINE, "trace_steps": 2},
    "tiny_open": {"loop": "open", "rate": 40.0, "arrival_seed": 0,
                  "warmup_s": 0.2, "block": 8,
                  "prompt": {"dist": "uniform", "min": 8, "max": 40},
                  "output": {"dist": "uniform", "min": 2, "max": 6},
                  "engine": TINY_ENGINE, "trace_steps": 2},
}


def tiny_manifest() -> dict:
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"] = [{"name": "tiny", "source": "test",
                       "file": "perfbench/configs/tiny.json", "reduced": [],
                       "why": "test"}]
    man["workloads"] = [
        {"name": f"tiny.{m}", "config": "tiny", "traffic": m, "chips": 1,
         "why": "test"} for m in TINY_MIXES]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            open_loop = any(w.endswith(".rag") for w in m["workloads"])
            m["workloads"] = ["tiny.tiny_open" if open_loop
                              else "tiny.tiny_closed"]
            if m["name"].startswith(("weights_s", "warmup_s")):
                m["workloads"] = ["tiny.tiny_open", "tiny.tiny_closed"]
    return man


def make_tiny_root(tmp_path: Path) -> Path:
    """A checkout root with BENCHMARK.json naming two tiny cells."""
    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench" / "metrics", pb / "metrics")
    (pb / "configs").mkdir()
    (pb / "traffic").mkdir()
    (pb / "checks").mkdir()
    (pb / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "family": "dense_gqa", "port": TINY_PORT,
        "quant": {"method": "rtn", "bits": 4, "group_size": 64,
                  "kv": "int8"}}))
    for name, mix in TINY_MIXES.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        (pb / "checks" / f"tiny.{name}.json").write_text(json.dumps({
            "sample": {"tokens": 12, "max_requests": 3, "min_tokens": 6},
            "mean_logit_gap": {"limit": 0.01}}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(tiny_manifest()))
    return tmp_path


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
