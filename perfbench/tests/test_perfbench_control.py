"""On the card: each cell's control (the reference with float8 e4m3
linear inputs put in the program's place) comes out not correct under the
cell's limit, while the program, on the same requests, comes out correct.
The cell's configuration, traffic and load, with a 20-second window.
Run on the machine with the card:

    python -m pytest -q -m cuda perfbench/tests/test_perfbench_control.py
"""
import json

import pytest
import torch

from conftest import ROOT
from perfbench import check, harness, manifest

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json")
                                       .read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels run only there")
    c = manifest.cell(ROOT, manifest.load(ROOT), cell)
    seed = 2**31 + 4242
    m = harness.measure(ROOT, cell, seed, 20.0, False)
    assert m.rids
    prog, ctrl = check.control_gaps(c["config"], seed, m.rids, m.outputs,
                                    m.prompts, "cuda")
    limit = c["limits"]["mean_logit_gap"]["limit"]
    assert prog["mean"] <= limit < ctrl["mean"]
