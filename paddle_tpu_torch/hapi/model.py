"""paddle.Model, the port of `paddle_tpu/hapi/model.py`: `prepare`,
`train_batch`, `eval_batch`, `predict_batch` and `parameters`.

`train_batch` is the step JAX compiles (`jit/trainer.py`
`CompiledTrainStep`), run eagerly: the network in train mode, its
outputs, the loss `loss(*outputs, *labels)` in fp32, the backward, and
the optimizer's update (its clip, per-parameter weight decay and
learning-rate multipliers, then the step count) — one update over the
whole parameter set (`optimizer.Optimizer`). As in that step, a
trainable parameter that the loss does not reach is updated with a zero
gradient. JAX falls back to eager execution when its compiled step
fails; the port has one path, and a failure raises.

`fit`, `evaluate`, `predict`, callbacks, metrics and `save`/`load` are
not ported yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch

from .._device import resolve_device


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    """A network with the optimizer and loss of `prepare`, on `device`
    (default "cuda"): the network's parameters and every batch move
    there."""

    def __init__(self, network, *, device="cuda"):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._optimizer = None
        self._loss = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """`amp_configs`: None, "O2" or {"level": "O2", "dtype": ...}
        casts the network as `amp.decorate(level="O2")`; O1 raises, as
        do `metrics` (not ported yet)."""
        if metrics:
            raise NotImplementedError("Model.prepare: metrics are not "
                                      "ported yet (ROADMAP Queue 1 item 5)")
        self._optimizer = optimizer
        self._loss = loss
        if amp_configs:
            from .. import amp
            if isinstance(amp_configs, str):
                amp_configs = {"level": amp_configs}
            amp.decorate(self.network, level=amp_configs.get("level", "O1"),
                         dtype=amp_configs.get("dtype", "bfloat16"))
        return self

    def _batch(self, xs):
        return [torch.as_tensor(x, device=self.device) for x in _to_list(xs)]

    def _loss_of(self, outs, labels):
        outs = _to_list(outs)
        loss = self._loss(*outs, *labels) if self._loss else outs[0]
        return loss.float()

    def train_batch(self, inputs, labels=None, update=True):
        """One step; returns [loss] as numpy. With `update=False` the
        gradients are kept (and summed into by the next call) and the
        parameters are left as they are."""
        self.network.train()
        outs = self.network(*self._batch(inputs))
        loss = self._loss_of(outs, self._batch(labels))
        loss.backward()
        if update:
            for p in self._optimizer._parameter_list:
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [loss.detach().cpu().numpy()]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """The loss in eval mode, [loss] as numpy ([] without a loss)."""
        self.network.eval()
        outs = self.network(*self._batch(inputs))
        if self._loss is None:
            return []
        return [self._loss_of(outs, self._batch(labels)).cpu().numpy()]

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs in eval mode, as numpy."""
        self.network.eval()
        outs = self.network(*self._batch(inputs))
        return [(o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()
                for o in _to_list(outs)]

    def parameters(self):
        return list(self.network.parameters())
