"""PyTorch + CUDA port of the on-device Qwen2.5 reproduction.

Mirrors the reference package's layout (`configs/`, `core/`, `kernels/`,
`models/`, `serving/`) and imports none of it. Hand-written Hopper
kernels live under `csrc/`, are compiled with ``nvcc`` at first use
(`kernels/build.py`), and are launched only for CUDA tensors; CPU
tensors take each kernel's plain PyTorch version.
"""
