"""The port's kernel build: a library is named by a hash of its source,
of every shared header under ``csrc/`` and of the flags, so an edited
header rebuilds every source that may include it. `_target` only hashes,
so no nvcc is needed."""
import re

import pytest
import torch

from repro_torch.kernels import build


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\nint f() { return 1; }\n')
    (csrc / "common.cuh").write_text("// shared v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return csrc


@pytest.mark.parametrize("edit", ["header", "source", "new_header", "flags"])
def test_target_changes_with_what_the_build_reads(tree, monkeypatch, edit):
    first = build._target("k")
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk-")
    assert build._target("k") == first            # nothing changed
    if edit == "header":
        (tree / "common.cuh").write_text("// shared v2\n")
    elif edit == "source":
        (tree / "k.cu").write_text('#include "common.cuh"\n')
    elif edit == "new_header":
        (tree / "other.cuh").write_text("// another\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._target("k") != first


def test_target_ignores_files_the_build_does_not_read(tree):
    first = build._target("k")
    (tree / "notes.txt").write_text("not a header\n")
    (tree / "other.cu").write_text("int g() { return 2; }\n")
    assert build._target("k") == first


def test_every_included_header_is_hashed():
    """The sources include only headers from ``csrc/`` (which `_target`
    hashes), and K1 and K3 share the AWQ header."""
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert "awq_common.cuh" in headers
    for name in build.SIGNATURES:
        src = (build.CSRC / f"{name}.cu").read_text()
        local = re.findall(r'#include\s+"([^"]+)"', src)
        assert set(local) <= headers, (name, local)
        if name in ("awq_matmul", "awq_gateup"):
            assert "awq_common.cuh" in local
