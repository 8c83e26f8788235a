"""Random state, the port of `paddle_tpu/core/random.py`'s `seed` and
`next_key`.

`seed(n)` starts every device over: the next `generator(device)` on a
device is a fresh `torch.Generator` there, seeded with n (0 before any
`seed`, as JAX's default key). Dropout draws its masks from the
generator of its tensor's device, so the same seed gives the same masks
on a device, run after run. The streams are torch's, not JAX's: no
parity test depends on them.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

_seed = 0
_generators = {}


def seed(s: int):
    """paddle.seed: every device's generator restarts from `s`."""
    global _seed
    _seed = int(s)
    _generators.clear()


def generator(device="cuda") -> torch.Generator:
    """The generator of `device` (JAX's `next_key` source), made from
    the last seed at first use."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _generators:
        _generators[dev] = torch.Generator(device=dev).manual_seed(_seed)
    return _generators[dev]
