"""The check fails a run whose timed path is broken underneath: a run
driven as the benchmark drives it (the look for a card skipped, the plain
CPU path at a tiny size) sees ``correct`` come out false for each fault a
serving cell can have, and a run without a card or without the program
prints no result."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from perfbench import harness
from repro_torch.models import attention
from repro_torch.serving.engine import GenerationEngine


@pytest.mark.parametrize("cell", ["tiny.tiny_closed", "tiny.tiny_open"])
def test_token_altered_where_it_is_produced(tiny_root, cell, monkeypatch):
    orig = GenerationEngine._sample_rows

    def altered(self, logits, temps, topks):
        return (orig(self, logits, temps, topks) + 1) % logits.shape[-1]
    monkeypatch.setattr(GenerationEngine, "_sample_rows", altered)
    res, err = harness.run_cell(tiny_root, cell, 21, 2.0, False,
                                device="cpu")
    assert not res["correct"]
    assert res["checks"]["mean_logit_gap"]["value"] > \
        res["checks"]["mean_logit_gap"]["limit"], err


def test_step_that_leaves_the_cache_unchanged(tiny_root, monkeypatch):
    orig = attention._chunk_write

    def stale(p, pool, *a, **kw):
        keep = {k: v.clone() for k, v in pool.items()}
        q = orig(p, pool, *a, **kw)
        for k, v in keep.items():
            pool[k].copy_(v)
        return q
    monkeypatch.setattr(attention, "_chunk_write", stale)
    res, err = harness.run_cell(tiny_root, "tiny.tiny_closed", 22, 2.0,
                                False, device="cpu")
    assert not res["correct"], err


def test_sound_run_is_correct_on_the_same_seeds(tiny_root):
    for seed in (21, 22):
        res, err = harness.run_cell(tiny_root, "tiny.tiny_closed", seed, 2.0,
                                    False, device="cpu")
        assert res["correct"], err


def _run_py(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen25-05b.chat256", "--seed", str(2**31 + 99), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True, env=env,
        timeout=300)


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
