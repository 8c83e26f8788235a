"""AMP, the port of `paddle_tpu/amp/auto_cast.py`: `decorate` at level
O2 casts every floating parameter and buffer of the models to the low
precision dtype, as JAX's `Layer._cast_all` does; the optimizers keep
their fp32 accumulators and update from the cast values (no master
copy, as in JAX).

O1 — `auto_cast`, which in JAX casts a matmul's fp32 operands at op
dispatch (`ops/linalg.py:_amp_cast2`) — has no counterpart yet
(ROADMAP Queue 1 item 5) and raises; so does `GradScaler`, which bf16
does not need.
"""
from __future__ import annotations

import contextlib

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp: unknown dtype {dtype!r}")
    return _DTYPES[dtype]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """O1 casts at op dispatch, which the port does not do yet: raises
    NotImplementedError when enabled at O1. At O2 the models are cast
    by `decorate` and this context does nothing, as in JAX."""
    if enable and level == "O1":
        raise NotImplementedError("amp.auto_cast(level='O1') is not ported "
                                  "(ROADMAP Queue 1 item 5); use "
                                  "decorate(level='O2')")
    yield


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    """O2: cast every floating parameter and buffer of `models` (a
    module or a list of them) to `dtype` in place, keeping each
    parameter object (so optimizers built on them stay valid). Returns
    the models, and the optimizers with them when given. O1 raises (see
    `auto_cast`)."""
    if level == "O1":
        raise NotImplementedError("amp.decorate(level='O1') is not ported "
                                  "(ROADMAP Queue 1 item 5)")
    if level != "O2":
        raise ValueError(f"amp.decorate: level must be 'O1' or 'O2', got "
                         f"{level!r}")
    dt = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        with torch.no_grad():
            for t in (*m.parameters(), *m.buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(dt)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)
