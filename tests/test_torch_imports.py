"""Import hygiene of the port: no JAX, nothing of the reference package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    assert len(mods) > 15
    assert {"repro_torch.core.awq", "repro_torch.core.calibration",
            "repro_torch.data.pipeline", "repro_torch.launch.serve",
            "repro_torch.kernels.flash_attention",
            "repro_torch.launch.specs", "repro_torch.serving.router",
            "repro_torch.kernels.awq_matmul",
            "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_names_no_jax_or_reference_package(path):
    hit = FORBIDDEN.search((ROOT / path).read_text())
    assert hit is None, hit.group(0)


def test_pattern_catches_reference_imports():
    for bad in ("import jax", "from jax import numpy", "import repro.core",
                "from repro.models import x", "from repro import y",
                "  import jax.numpy as jnp"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import x",
               "# jax is the reference", "import jaxlib_free"):
        assert not FORBIDDEN.search(ok), ok
