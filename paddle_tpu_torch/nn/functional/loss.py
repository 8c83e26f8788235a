"""`cross_entropy` over hard labels, the port of
`paddle_tpu/nn/functional/loss.py:cross_entropy` as BERT calls it."""
from __future__ import annotations

import torch.nn.functional as tF


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross entropy of fp32 logits `input` [N, C] against int
    labels [N] (or [N, 1]). Labels equal to `ignore_index` add nothing,
    and the mean is over the others (0 when there are none, as in JAX,
    where torch's own mean would give NaN)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    label = label.long()
    loss = tF.cross_entropy(input.float(), label, ignore_index=ignore_index,
                            reduction="none")
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / (label != ignore_index).sum().clamp_min(1)
