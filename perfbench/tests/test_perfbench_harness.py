"""The harness end to end on the CPU at a tiny size: both loops, the
readers, the result line and the check against the reference."""
import pytest

from perfbench import harness


@pytest.mark.parametrize("cell", ["tiny.tiny_closed", "tiny.tiny_open"])
def test_cell_runs_and_is_correct(tiny_root, cell):
    res, err = harness.run_cell(tiny_root, cell, 2**31 + 7, 2.5, False,
                                device="cpu")
    assert res["correct"], err
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    assert "setup_s" in names
    if cell.endswith("open"):
        assert "itl_p95_ms" in names
    else:
        assert "output_tok_s" in names
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert err[-2].startswith("check mean_logit_gap")


@pytest.mark.parametrize("cell", ["tiny.tiny_closed", "tiny.tiny_open"])
def test_traced_run_reports_cpu_readable_layers(tiny_root, cell):
    res, err = harness.run_cell(tiny_root, cell, 5, 2.5, True, device="cpu")
    assert res["correct"], err
    names = set(res["metrics"])
    # the profile runs, but without a card the device readers read nothing
    if cell.endswith("open"):
        assert {"weights_s", "warmup_s", "padding_waste_pct.rag",
                "traced_prefill_share.rag"} <= names
        # the profiled steps start at an arrival: the first carries a prompt
        assert res["metrics"]["traced_prefill_share.rag"]["value"] > 0
    else:
        assert {"weights_s", "warmup_s", "padding_waste_pct.tput",
                "step_ms.tput"} <= names
    assert not any(n.startswith(("qlinear_roofline", "paged_attn_roofline",
                                 "device_idle_pct")) for n in names)
    assert "busy_s" not in res["device"] and "breakdown" not in res
