"""The optimizer base, the port of `paddle_tpu/optimizer/optimizer.py`.

As in JAX, `step()` is one update over the whole parameter set with the
clip folded in, not a loop of launches per parameter (JAX jits one
fused step). Here the set is flat: the gradients and the parameters are
concatenated into one fp32 vector each (a cast per call, not per
parameter), the optimizer's fp32 accumulators live in one flat buffer
per kind, and the subclass's rule (`_update`) runs once over the flat
vectors. What each parameter has of its own (its norms, weight decay
and learning-rate multiplier) comes from `_Segments`: the norms from
`torch._foreach_norm` over views of the flat vector, a per-parameter
scalar applied to a block of same-sized parameters at once. The result
is written back in each parameter's own dtype by `torch._foreach_copy_`
(under AMP O2 the parameters are bf16 and there is no master copy, as
in JAX). A few dozen launches a step, whatever the parameter count, and
no host synchronisation.

Per-parameter settings: a parameter group's "learning_rate" (a
multiplier) and "weight_decay", as JAX's `optimize_attr`; the port's
parameters carry no `ParamAttr` regularizer. `state_dict()` names each
accumulator `"{index}_{kind}"` by the parameter's place in the list
(JAX uses `p.name` where the parameter has one).
"""
from __future__ import annotations

import torch

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .lr import LRScheduler


class Optimizer:
    #: the accumulators (fp32, one a parameter element) a subclass keeps
    _accumulator_names = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        self._param_attrs = {}      # parameter -> its group's settings
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                flat = []
                for group in parameters:
                    for p in group["params"]:
                        attrs = self._param_attrs.setdefault(p, {})
                        if "learning_rate" in group:
                            attrs["learning_rate"] = \
                                float(group["learning_rate"])
                        if "weight_decay" in group:
                            attrs["weight_decay"] = \
                                float(group["weight_decay"] or 0.0)
                        flat.append(p)
                parameters = flat
        self._parameter_list = parameters
        self._learning_rate = learning_rate
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._accumulators = {}     # parameter -> {kind: fp32 tensor}
        self._step_count = 0
        self._layout = None

    # ------------------------------------------------------------- lr
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # ---------------------------------------------------- per-opt hooks
    def _weight_decay_of(self, p):
        return self._param_attrs.get(p, {}).get("weight_decay",
                                                self._weight_decay)

    def _update(self, w, g, seg, lr, t):
        """The rule over flat fp32 vectors: parameters `w` (free to
        overwrite) and gradients `g`, the accumulators `seg.acc` ({kind:
        flat buffer}, updated in place), per-parameter learning-rate
        multipliers and weight decays and norms from `seg`
        (`_Segments`), the learning rate `lr` and the step `t` (from 1);
        returns the new parameters."""
        raise NotImplementedError

    # ------------------------------------------------------------ step
    def _params_with_grad(self):
        if self._parameter_list is None:
            raise ValueError("optimizer built without a parameter list; "
                             "pass parameters=model.parameters()")
        return [p for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    def _get_accums(self, p):
        if p not in self._accumulators:
            self._accumulators[p] = {
                kind: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for kind in self._accumulator_names}
        return self._accumulators[p]

    def _segments(self, params):
        """The flat layout of `params`, rebuilt when the set of
        parameters with gradients changes: each accumulator moves into
        one flat buffer, and the parameter's accumulators become views
        of it."""
        lay = self._layout
        if lay is not None and lay.key == tuple(params):
            return lay
        lay = _Segments(params)
        lay.acc = {kind: torch.cat([
            self._get_accums(p)[kind].reshape(-1) for p in lay.params])
            for kind in self._accumulator_names}
        for p, views in zip(lay.params, lay.split_all(lay.acc)):
            self._accumulators[p] = views
        self._layout = lay
        return lay

    def _clip(self, g, seg, dtype):
        """The grad clip over the flat fp32 gradients `g` of `dtype`, as
        JAX's fused step applies it: each scale (or bound) rounded to
        that dtype, the product kept in fp32 (XLA folds
        `(g * s).astype(g.dtype)` into the fp32 update that reads it)."""
        clip = self._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            norm = torch.linalg.vector_norm(g)
            scale = (clip.clip_norm / (norm + 1e-6)).clamp(max=1.0)
            return g * scale.to(dtype).float()
        if isinstance(clip, ClipGradByNorm):
            scale = (clip.clip_norm / (seg.norms(g) + 1e-6)).clamp(max=1.0)
            return seg.scale_(g, scale.to(dtype).float())
        if isinstance(clip, ClipGradByValue):         # bounds in `dtype`
            return g.clamp(*(torch.tensor(b, dtype=dtype).item()
                             for b in (clip.min, clip.max)))
        if clip is not None:
            raise NotImplementedError(f"grad_clip {type(clip).__name__}")
        return g

    @torch.no_grad()
    def step(self):
        params = self._params_with_grad()
        if not params:
            return
        seg = self._segments(params)
        params = seg.params
        seg.set_rates(
            [self._param_attrs.get(p, {}).get("learning_rate", 1.0)
             for p in params], [self._weight_decay_of(p) for p in params])
        g = torch.cat([p.grad.reshape(-1) for p in params])
        g = self._clip(g.float(), seg, g.dtype)
        w = torch.cat([p.reshape(-1) for p in params]).float()
        new = self._update(w, g, seg, self.get_lr(),
                           float(self._step_count + 1))
        for dtype, group in seg.by_dtype.items():
            views = seg.split(new.to(dtype))
            torch._foreach_copy_([params[i] for i in group],
                                 [views[i] for i in group])
        self._step_count += 1

    def clear_grad(self):
        for p in self._parameter_list or ():
            p.grad = None

    # ----------------------------------------------------------- state
    def state_dict(self):
        state = {"step_count": self._step_count}
        for i, p in enumerate(self._parameter_list or ()):
            for kind, a in self._accumulators.get(p, {}).items():
                state[f"{i}_{kind}"] = a.detach().clone()
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state):
        self._step_count = int(state.get("step_count", 0))
        if isinstance(self._learning_rate, LRScheduler) and \
                "LR_Scheduler" in state:
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        with torch.no_grad():
            for i, p in enumerate(self._parameter_list or ()):
                for kind in self._accumulator_names:
                    if f"{i}_{kind}" in state:
                        self._get_accums(p)[kind].copy_(torch.as_tensor(
                            state[f"{i}_{kind}"]).reshape(p.shape))


class _Segments:
    """A flat layout of parameters, ordered by size so that parameters
    of one size lie side by side: each such group is one [count, size]
    block of a flat vector, and a per-parameter scalar reaches its
    elements by broadcasting over the block (a launch a group: BERT-base
    has 9 sizes among its 206 parameters)."""

    def __init__(self, params):
        self.key = tuple(params)
        self.params = tuple(sorted(params, key=lambda p: p.numel()))
        self.shapes = [p.shape for p in self.params]
        self.sizes = [p.numel() for p in self.params]
        self.groups = []            # (first element, first parameter, count)
        start = 0
        for i, n in enumerate(self.sizes):
            if self.groups and self.sizes[self.groups[-1][1]] == n:
                first, j, count = self.groups[-1]
                self.groups[-1] = (first, j, count + 1)
            else:
                self.groups.append((start, i, 1))
            start += n
        self.by_dtype = {}
        for i, p in enumerate(self.params):
            self.by_dtype.setdefault(p.dtype, []).append(i)
        self.acc = {}
        self._rates = None

    def split(self, flat):
        """Per-parameter views of a flat vector, in their shapes."""
        return [v.view(s) for v, s in zip(flat.split(self.sizes),
                                          self.shapes)]

    def split_all(self, flats):
        """{kind: flat} -> per parameter {kind: view}."""
        views = {kind: self.split(f) for kind, f in flats.items()}
        return [{kind: views[kind][i] for kind in flats}
                for i in range(len(self.sizes))]

    def norms(self, flat):
        """[P] fp32: the 2-norm of each parameter's segment of `flat`."""
        return torch.stack(torch._foreach_norm(flat.split(self.sizes)))

    def _blocks(self, flat, per_param):
        for first, i, count in self.groups:
            n = self.sizes[i]
            yield (flat[first:first + count * n].view(count, n),
                   per_param[i:i + count, None])

    def scale_(self, flat, per_param):
        """Each parameter's segment of `flat` times its value of
        `per_param` ([P]), in place."""
        for block, s in self._blocks(flat, per_param):
            block.mul_(s)
        return flat

    def addcmul_(self, out, flat, per_param):
        """out += per_param * flat, segment by segment, in place."""
        for (o, s), (x, _) in zip(self._blocks(out, per_param),
                                  self._blocks(flat, per_param)):
            o.addcmul_(x, s)
        return out

    def set_rates(self, lr_mults, wds):
        """Per-parameter learning-rate multipliers (`lr_mult`) and
        weight decays (`wd`, None when all are 0), [P] fp32 in the
        layout's order, rebuilt only when they change."""
        key = (tuple(lr_mults), tuple(wds))
        if key == self._rates:
            return
        self._rates = key
        dev = self.params[0].device
        self.lr_mult = torch.tensor(lr_mults, dtype=torch.float32,
                                    device=dev)
        self.wd = None if not any(wds) else torch.tensor(
            wds, dtype=torch.float32, device=dev)

