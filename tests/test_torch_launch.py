"""Port launcher vs the JAX package's: `repro_torch.launch.serve.main` on
the smoke config (CPU, plain paths) runs the classic AWQ path —
calibration forward, AWQ search + pack, `generate()` — and reports what
`repro.launch.serve.main` reports on the same flags.

The port's report lists one path per layer where the reference lists one
per scan-stacked parameter, so its counts are the reference's times the
number of layers and its paths collapse onto the reference's. Sizes are
exact integers and must be equal; the compression ratio too.
"""
import re

import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.core import pipeline as jpipe
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.launch import serve as tserve

FLAGS = ["--smoke", "--batch", "2", "--prompt-len", "16", "--max-new", "4"]


def _layerless(path):
    parts = path.split("/")
    return "/".join(parts[:2] + parts[3:])


def _numbers(line):
    return re.sub(r"\d+\.\d+s", "<t>", line)


@pytest.fixture(scope="module")
def jax_awq():
    """JAX launcher run with --quant awq; its PTQ report is caught on the
    way through (the launcher returns only throughput and shape)."""
    caught = {}

    def catch(*a, **kw):
        caught["params"], caught["report"] = jpipe.quantize_params(*a, **kw)
        return caught["params"], caught["report"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jserve, "quantize_params", catch)
    try:
        out = jserve.main(FLAGS + ["--quant", "awq"])
    finally:
        mp.undo()
    return out, caught


def test_awq_launch_matches_jax(jax_awq, capsys):
    jout, caught = jax_awq
    capsys.readouterr()
    out = tserve.main(FLAGS + ["--quant", "awq", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    jrep, rep = caught["report"], out["report"]
    n_layers = tcfgs.smoke_config().num_layers
    assert out["shape"] == jout["shape"] == [2, 4]
    for attr in ("quantized", "calibrated", "skipped"):
        tl, jl = getattr(rep, attr), getattr(jrep, attr)
        assert len(tl) == n_layers * len(jl), attr
        assert sorted(set(map(_layerless, tl))) == sorted(jl), attr
    assert rep.calibrated == rep.quantized        # every linear calibrated
    assert rep.compression_ratio == jrep.compression_ratio
    assert rep.packed_bytes == jrep.packed_bytes
    assert out["macro_bytes"] == jpipe.model_size_bytes(caught["params"],
                                                        quantized=True)
    assert out["calib_s"] > 0 and out["awq_s"] > 0
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    # the same prints, with the port's per-layer counts
    assert lines[0] == "[serve] qwen25-05b-smoke: fp16-serialized size 0.72 MB"
    assert _numbers(lines[1]) == (
        f"[serve] AWQ PTQ in <t>: {len(rep.quantized)} linears quantized "
        f"({len(rep.calibrated)} calibrated), {len(rep.skipped)} kept FP")
    assert lines[2] == (f"[serve] AWQ_MACRO-serialized size "
                        f"{out['macro_bytes'] / 1e6:.2f} MB")
    assert lines[3].startswith("[serve] generated (2, 4) tokens in ")
    assert lines[4].startswith("[serve] sample: [")
    # the CPU run takes the plain versions: no kernel launched
    assert out["launches"] == {
        "calibrate": {"flash_attention": 0, "awq_matmul": 0},
        "generate": {"flash_attention": 0, "awq_matmul": 0}}


def test_float_launch_matches_jax(capsys):
    jout = jserve.main(FLAGS + ["--quant", "none"])
    out = tserve.main(FLAGS + ["--quant", "none", "--device", "cpu"])
    assert out["shape"] == jout["shape"] == [2, 4]
    assert out["report"] is None and "calibrate" not in out["launches"]
    assert out["tokens"].dtype == np.int32


def test_launch_is_deterministic_under_sampling():
    """--temperature draws from an explicit generator seeded by --seed."""
    runs = [tserve.main(FLAGS + ["--quant", "none", "--device", "cpu",
                                 "--temperature", "0.8", "--seed", "3"])
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])


@pytest.mark.parametrize("flag", [["--replicas", "2"], ["--mesh-axis", "2"],
                                  ["--disagg"], ["--drain-timeout", "5"]])
def test_fleet_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="fleet"):
        tserve.main(FLAGS + ["--device", "cpu"] + flag)


def test_launch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(FLAGS + ["--quant", "none"])
