"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and resolves it
here.  There is no fallback: asking for CUDA on a machine without a
card raises, and the CPU is used only when the caller names it.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev
