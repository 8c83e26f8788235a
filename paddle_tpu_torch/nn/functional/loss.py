"""`cross_entropy` over hard labels, the port of
`paddle_tpu/nn/functional/loss.py:cross_entropy`."""
from __future__ import annotations

import torch.nn.functional as tF


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """Softmax cross entropy of logits `input` (taken in fp32), whose
    classes lie along `axis` (the last by default, as in paddle),
    against int labels of `input`'s shape without that axis (or with it
    at size 1). Labels equal to `ignore_index` add nothing, and the mean
    is over the others (0 when there are none, as in JAX, where torch's
    own mean would give NaN). `reduction="none"` gives the labels'
    shape."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    axis = axis % input.dim()
    if label.dim() == input.dim():
        label = label.squeeze(axis)
    label = label.long()
    classes = input.shape[axis]
    logits = input.float().movedim(axis, -1).reshape(-1, classes)
    loss = tF.cross_entropy(logits, label.reshape(-1),
                            ignore_index=ignore_index,
                            reduction="none").reshape(label.shape)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / (label != ignore_index).sum().clamp_min(1)
