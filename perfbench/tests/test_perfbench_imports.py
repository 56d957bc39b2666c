"""Nothing the benchmark's command runs loads JAX or the JAX package, and
the reference loads nothing of the program. Modules are compared by their
top-level name whole: the port's name begins with the JAX package's."""
import ast
import json
import subprocess
import sys

from conftest import ROOT

PB = ROOT / "perfbench"


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_under_perfbench_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_imports(path) & {"jax", "jaxlib", "flax", "repro"}, \
            path


def test_reference_sources_import_nothing_of_the_program():
    for path in list((PB / "reference").glob("*.py")) + [PB / "check.py",
                                                         PB / "models" /
                                                         "dense_gqa.py"]:
        assert "repro_torch" not in _top_imports(path), path


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_whole_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (f"import sys; sys.path.insert(0, {str(PB / 'tests')!r})\n"
            "from pathlib import Path\n"
            "import conftest\n"
            "from perfbench import harness\n"
            f"root = conftest.make_tiny_root(Path({str(tmp_path)!r}))\n"
            "res, err = harness.run_cell(root, 'tiny.tiny_closed', 3, 0.5,"
            " True, device='cpu')\n"
            "assert not harness.forbidden_modules()\n")
    top = _loaded_after(code)
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded_after(
        "import torch\n"
        "from perfbench import check\n"
        "from perfbench.reference import dense_gqa\n"
        "cfg = dict(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1,"
        " head_dim=32, d_ff=128, vocab_size=64, qkv_bias=True,"
        " tie_embeddings=True, rope_theta=1e4, norm_eps=1e-6)\n"
        "q = {'group_size': 32}\n"
        "check.reference_class('dense_gqa')(cfg, q, 1, 'cpu').logits("
        "[torch.arange(5)], [0])\n")
    assert "perfbench" in top
    assert not top & {"repro_torch", "jax", "jaxlib", "flax", "repro"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from perfbench import harness
    for name in [m for m in sys.modules if m.split(".")[0] == "repro"]:
        monkeypatch.delitem(sys.modules, name)
    base = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    monkeypatch.setitem(sys.modules, "jaxon.sub", sys)
    assert harness.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "repro.x", sys)
    assert "repro" in harness.forbidden_modules()
