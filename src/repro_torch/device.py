"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Entry points run on ``cuda`` unless the caller asks for another
    device; asking for CUDA where there is none raises (no silent CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch paths")
    return dev


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """'bfloat16' / 'float32' (config strings) → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
