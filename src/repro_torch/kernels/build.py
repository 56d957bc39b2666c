"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``), which takes seconds where a source that
includes PyTorch's headers takes minutes. Libraries go to
``build/repro_torch/`` at the checkout's root (git-ignored), named by a
hash of their source, so an edited source rebuilds and an unchanged one
loads as built. Nothing is built when a module is imported: the first
launch builds what it needs, and `build_all` builds every source at
once, one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong

# C entry point of each source: (function name, argtypes). Every pointer
# and the stream are c_void_p; each function returns cudaGetLastError().
SIGNATURES: dict[str, tuple[str, list]] = {
    "awq_matmul": ("awq_matmul_bf16", [_P] * 5 + [_I] * 5 + [_P]),
    "awq_gateup": ("awq_gateup_f32", [_P] * 10 + [_I] * 7 + [_P]),
    "paged_attention": ("paged_attention_chunk_f32",
                        [_P] * 12 + [_I] * 9 + [_F, _I, _P]),
    "flash_attention": ("flash_attention_fwd",
                        [_P] * 4 + [_L] * 12 + [_I] * 8 + [_F, _I, _P]),
}


@dataclasses.dataclass
class Built:
    path: Path
    seconds: float
    log: str          # nvcc's output (ptxas register / spill report)


_LOADED: dict[str, ctypes.CDLL] = {}
BUILT: dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda)")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source: (target, process, start time, temporary
    output); process and output are None when the target exists."""
    out = _target(name)
    if out.exists():
        return out, None, time.perf_counter(), None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, time.perf_counter(), tmp


def build_all(names=None) -> dict[str, Built]:
    """Compile every source in parallel (one nvcc each); raises with
    nvcc's log when one fails. Returns per-source build records."""
    names = list(SIGNATURES) if names is None else list(names)
    started = {n: _start(n) for n in names}
    failed = []
    for n, (out, proc, t0, tmp) in started.items():
        if proc is None:
            BUILT.setdefault(n, Built(out, 0.0, "(cached)"))
            continue
        log, _ = proc.communicate()       # wait for every nvcc, even failed
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"csrc/{n}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        BUILT[n] = Built(out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: BUILT[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    its entry point's argtypes and restype declared."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name].path
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


@dataclasses.dataclass
class LaunchCounter:
    """Kernel launches made by one wrapper (the count a run reads to show
    its main path went through the kernel)."""
    count: int = 0
