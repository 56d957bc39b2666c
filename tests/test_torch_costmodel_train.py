"""Port parity: the shape-cell registry and the cost model's train cells.

`repro_torch.configs` carries the reference's `SHAPES`, `cells_for`,
`skipped_cells`, `list_archs` and `ASSIGNED_ARCHS`; `roofline.costmodel`
prices a train step (38 B a weight, ×3 on attention scores, the SSD's
terms and the head, logits twice, remat's 4/3) and turns a cell into
seconds (`analytic_terms`). Every arch's FLOPs and bytes equal the
reference's at rtol 1e-12 (the same formula, term for term; the sums run
in the same order), and the seconds equal under the reference's TPU
constants, which the test monkeypatches into the port's module (the port
prices at the card's own peaks).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.roofline import analysis as janalysis
from repro.roofline import costmodel as jcost
import repro_torch.configs as tconfigs
from repro_torch.roofline import costmodel as tcost

ARCHS = list(jconfigs.list_archs())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers share
    the machine's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_registry_equals_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert len(tconfigs.list_archs()) == 11
    assert {n: dataclasses.astuple(c) for n, c in tconfigs.SHAPES.items()} \
        == {n: dataclasses.astuple(c) for n, c in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_skips_equal_reference(arch):
    assert tconfigs.cells_for(arch) == jconfigs.cells_for(arch)
    assert tconfigs.skipped_cells(arch) == jconfigs.skipped_cells(arch)


def _costs_close(c, a):
    got = dataclasses.asdict(c)
    want = {k: getattr(a, k) for k in got}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=0, err_msg=k)
    np.testing.assert_allclose(c.total_bytes, a.total_bytes, rtol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cells_equal_reference(arch):
    """`train_4k` at the published dims and a small ad-hoc train cell at
    the smoke dims, float and quantized weights."""
    for get_j, get_t, cell in (
            (jconfigs.get_config, tconfigs.get_config, "train_4k"),
            (jconfigs.get_smoke_config, tconfigs.get_smoke_config,
             ("train", 64, 2))):
        jcfg, tcfg = get_j(arch), get_t(arch)
        if isinstance(cell, str):
            jcell, tcell = jconfigs.SHAPES[cell], tconfigs.SHAPES[cell]
        else:
            jcell = jcost.serving_cell(*cell)
            tcell = tcost.serving_cell(*cell)
        for quant in (False, True):
            _costs_close(tcost.cell_costs(tcfg, tcell, quant),
                         jcost.cell_costs(jcfg, jcell, quant))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_equal_reference_under_its_constants(monkeypatch,
                                                            arch):
    """Every cell the reference runs for the arch, on 1 and 4 chips: the
    same FLOPs, bytes and (under the reference's constants) seconds. An
    ad-hoc `ShapeCell` prices as its named twin."""
    monkeypatch.setattr(tcost, "PEAK_FLOPS", janalysis.PEAK_FLOPS)
    monkeypatch.setattr(tcost, "HBM_BW", janalysis.HBM_BW)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for cell in jconfigs.cells_for(arch):
        for chips, quant in ((1, False), (4, True)):
            got = tcost.analytic_terms(tcfg, cell, chips, quant)
            want = jcost.analytic_terms(jcfg, cell, chips, quant)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                           err_msg=(cell, k))
            assert tcost.analytic_terms(tcfg, tconfigs.SHAPES[cell], chips,
                                        quant) == got


def test_analytic_terms_use_the_cards_peaks():
    """Unpatched, the seconds are the card's: dense bf16 tensor cores and
    HBM bandwidth of one H100 SXM."""
    cfg = tconfigs.get_config("qwen25-05b")
    t = tcost.analytic_terms(cfg, "train_4k", 1, False)
    assert t["analytic_compute_s"] == t["analytic_flops_global"] / 989e12
    assert t["analytic_memory_s"] == t["analytic_bytes_global"] / 3.35e12
