"""Port launcher vs the JAX package's: `repro_torch.launch.serve.main` on
the smoke config (CPU, plain paths) runs the classic AWQ path —
calibration forward, AWQ search + pack, `generate()` — and reports what
`repro.launch.serve.main` reports on the same flags.

The port's report lists one path per layer where the reference lists one
per scan-stacked parameter, so its counts are the reference's times the
number of layers and its paths collapse onto the reference's. Sizes are
exact integers and must be equal; the compression ratio too.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.core import pipeline as jpipe
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.launch import serve as tserve


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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
    zero = {"flash_attention": 0, "awq_matmul": 0, "awq_gateup": 0,
            "paged_attention_chunk": 0}
    assert out["launches"] == {"calibrate": zero, "generate": zero}


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


# a fleet needs max_seq = prompt + new to be a multiple of its 8-token pages
FLEET = ["--smoke", "--batch", "2", "--prompt-len", "20", "--max-new", "4"]


@pytest.mark.parametrize("flag", [
    ["--arch", "glm4-9b", "--replicas", "2", "--mesh-axis", "2"],
    ["--replicas", "2", "--disagg"], ["--mesh-axis", "2"],
    ["--replicas", "2"], ["--replicas", "2", "--mesh-axis", "2"]])
def test_fleet_flags_raise(flag):
    """--replicas with tensor-parallel replicas (--mesh-axis 2: two
    shards sharing the CPU) serves the fleet where the model's kv heads
    divide the axis (glm4-9b's smoke config has two) and raises the
    reference's error where they do not (qwen25-05b's has one); without
    --replicas the fleet flags are ignored and the classic path runs, as
    the reference does; --replicas alone serves the fleet, and with
    --disagg a fleet of prefill/decode pairs."""
    argv = FLEET + ["--quant", "none", "--device", "cpu"] + flag
    if "--mesh-axis" in flag and "glm4-9b" not in flag \
            and "--replicas" in flag:
        with pytest.raises(ValueError, match="num_kv_heads=1 is not "
                                             "divisible"):
            tserve.main(argv)
        return
    out = tserve.main(argv)
    if "--replicas" in flag:
        assert out["replicas"] == 2 and out["requests"] == 4
        assert "shape" not in out
        assert all(t.shape == (4,) for t in out["streams"])
    else:
        assert out["shape"] == [2, 4] and "replicas" not in out


def test_awq_fleet_matches_jax(capsys):
    """The fleet path on the smoke model: AWQ calibrate + pack, two
    replicas behind the Router, pinned cluster prefixes, a clustered
    burst. Requests, skipped prefill tokens, placements and affinity hits
    are integers of the schedule alone and must equal the reference's."""
    argv = FLEET + ["--quant", "awq", "--replicas", "2"]
    jout = jserve.main(argv)
    jlines = capsys.readouterr().out.splitlines()
    out = tserve.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    placed = re.compile(r"\[serve\] placement: (\d+) scored, (\d+) affinity "
                        r"hits, (\d+) session hits, (\d+) prefill tokens")
    (jm,) = [placed.match(ln) for ln in jlines if placed.match(ln)]
    (tm,) = [placed.match(ln) for ln in lines if placed.match(ln)]
    assert tm.groups() == jm.groups()
    assert [int(v) for v in jm.groups()] == [
        out["placements"], out["affinity_hits"], out["session_hits"],
        out["prefill_tokens_skipped"]]
    for key in ("requests", "prefill_tokens_skipped", "replicas"):
        assert out[key] == jout[key], key
    assert out["prefill_tokens_skipped"] > 0 and out["affinity_hits"] > 0
    assert len(out["streams"]) == out["requests"] == 4
    for toks in out["streams"]:
        assert toks.shape == (4,) and ((toks >= 0) & (toks < 512)).all()
    assert len(out["report"].calibrated) == len(out["report"].quantized)
    # the CPU run takes the plain versions: no kernel launched
    assert set(out["launches"]) == {"calibrate", "fleet"}
    assert not any(v for step in out["launches"].values()
                   for v in step.values())


def test_launch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(FLAGS + ["--quant", "none"])


def _chip_smoke():
    """chip_smoke.py as a module (its phases run only under ``main``)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_fleet_integers_equal_reference(capsys):
    """The integers chip_smoke.py gates its full-width fleet on are the
    reference launcher's, and the port's, at the same flags on the smoke
    model: the schedule does not depend on widths or token values."""
    smoke = _chip_smoke()
    argv = smoke.FLEET_ARGS + ["--smoke"]
    want = smoke.FLEET_WANT[False]
    jserve.main(argv)
    jlines = capsys.readouterr().out.splitlines()
    out = tserve.main(argv + ["--device", "cpu"])
    placed = re.compile(r"\[serve\] placement: (\d+) scored, (\d+) affinity "
                        r"hits, (\d+) session hits, (\d+) prefill tokens")
    (jm,) = [placed.match(ln) for ln in jlines if placed.match(ln)]
    keys = ("placements", "affinity_hits", "session_hits",
            "prefill_tokens_skipped")
    assert dict(zip(keys, map(int, jm.groups()))) == want
    assert {k: out[k] for k in keys} == want
    assert out["requests"] == 8
    assert all(t.shape == (32,) for t in out["streams"])
