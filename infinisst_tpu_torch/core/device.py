"""Device selection for the port's entry points.

Entry points default to ``cuda``.  The CPU is used only when the caller
asks for it; asking for CUDA on a machine without a card raises instead of
carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions"
        )
    return dev
