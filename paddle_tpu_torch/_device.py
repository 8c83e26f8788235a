"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`. A CUDA device with no card present
    raises: the port never moves to the CPU unless the caller asks."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev
