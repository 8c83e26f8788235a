"""Concrete optimizers, the port of `paddle_tpu/optimizer/optimizers.py`:
`Lamb`, BERT's. Each rule runs once over the flat parameter set (see
`optimizer.Optimizer`)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer


class Lamb(Optimizer):
    """LAMB, JAX's `Lamb._single_update` for every parameter at once:
    fp32 moments m and v, the bias-corrected step r = m^ / (sqrt(v^) +
    eps) + wd * w, and w - lr * trust * r with trust = ||w|| / ||r||
    per parameter (1 where either norm is 0), in fp32 from the
    parameter's value and stored in its dtype. The bias corrections
    take the step count t = step + 1. A parameter for which
    `exclude_from_weight_decay_fn(p)` holds takes weight decay 0."""

    _accumulator_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _weight_decay_of(self, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return super()._weight_decay_of(p)

    def _update(self, w, g, seg, lr, t):
        b1, b2 = self._beta1, self._beta2
        m, v = seg.acc["moment1"], seg.acc["moment2"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        r = (v / (1 - b2 ** t)).sqrt_().add_(self._epsilon)
        r = torch.div(m / (1 - b1 ** t), r, out=r)
        if seg.wd is not None:
            seg.addcmul_(r, w, seg.wd)                  # + wd * w
        w_norm, r_norm = seg.norms(w), seg.norms(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return w.sub_(seg.scale_(r, seg.lr_mult * lr * trust))
