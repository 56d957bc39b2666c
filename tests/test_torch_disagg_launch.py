"""The launcher's disaggregated fleet (``--replicas 2 --disagg``) in the
port, held against the JAX package's launcher: the placement integers
and the report's keys at small flags, and the integers `chip_smoke.py`
gates its full-width ``--disagg`` fleet on, at its flags on the smoke
model.
"""
import importlib.util
import pathlib
import re

import pytest
import torch

import repro.launch.serve as jserve
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


def test_disagg_fleet_launch_matches_jax(capsys):
    """``--replicas 2 --disagg`` on the smoke model: the placement
    integers and the report's keys equal `repro.launch.serve`'s."""
    argv = ["--smoke", "--batch", "2", "--prompt-len", "20", "--max-new",
            "4", "--quant", "none", "--replicas", "2", "--disagg"]
    jout = jserve.main(argv)
    jlines = capsys.readouterr().out.splitlines()
    out = tserve.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    placed = re.compile(r"\[serve\] placement: (\d+) scored, (\d+) affinity "
                        r"hits, (\d+) session hits, (\d+) prefill tokens")
    (jm,) = [placed.match(ln) for ln in jlines if placed.match(ln)]
    (tm,) = [placed.match(ln) for ln in lines if placed.match(ln)]
    assert tm.groups() == jm.groups()
    assert [int(v) for v in tm.groups()] == [
        out["placements"], out["affinity_hits"], out["session_hits"],
        out["prefill_tokens_skipped"]]
    for key in ("requests", "prefill_tokens_skipped", "replicas"):
        assert out[key] == jout[key], key
    assert out["affinity_hits"] > 0
    assert len(out["streams"]) == out["requests"] == 4
    assert all(t.shape == (4,) for t in out["streams"])
    assert "disagg=True" in next(ln for ln in lines if "fleet:" in ln)


def _chip_smoke():
    """chip_smoke.py as a module (its phases run only under ``main``)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_disagg_fleet_integers_equal_reference(capsys):
    """The integers chip_smoke.py gates its full-width ``--disagg`` fleet
    on are the reference launcher's, and the port's, at the same flags on
    the smoke model (a pair reports no skipped prefill tokens)."""
    smoke = _chip_smoke()
    argv = smoke.FLEET_ARGS + ["--disagg"] + ["--smoke"]
    want = smoke.FLEET_WANT[True]
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
