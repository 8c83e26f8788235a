"""MoE routing and index-based dispatch — the serving subset.

Port of the fixed-shape top-k capacity router of
`paddle_tpu/parallel/moe_utils.py`: softmax gate, top-k, renormalised
gates, per-expert capacity slots in arrival order (token-major,
choice-minor; overflow dropped, the caller's residual carries the
token), the GShard load-balance loss and the router z-loss. Dispatch
and combine are the index-based pair (an `[E, C]` token-index table and
gathers), the path the JAX package takes on a TPU; the one-hot einsum
pair and the expert-parallel all-to-all are not ported. Every shape
depends only on (T, k, E, C), never on the routing.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def expert_capacity(num_tokens, num_experts, top_k, capacity_factor):
    """Per-expert capacity slots C = ceil(factor * T * k / E), floored
    at 1."""
    c = capacity_factor * float(num_tokens) * float(top_k) \
        / float(num_experts)
    return max(1, int(math.ceil(c)))


@dataclasses.dataclass
class DispatchPlan:
    """The routing plan of one token set (index fields; the one-hot
    dispatch/combine masks of the JAX plan are not built).

    e_oh   [T, k, E]  expert one-hot per choice (padding rows 0)
    counts [E] f32    tokens each expert received (after drops)
    dropped  f32      (token, choice) pairs lost to capacity overflow
    gate_idx [T, k]   chosen expert per (token, choice)
    slot   [T, k]     capacity slot within the chosen expert
    in_cap [T, k]     bool: the choice landed inside capacity
    gates  [T, k]     renormalised gate values (the combine weights)
    """
    e_oh: torch.Tensor
    counts: torch.Tensor
    dropped: torch.Tensor
    gate_idx: torch.Tensor
    slot: torch.Tensor
    in_cap: torch.Tensor
    gates: torch.Tensor


def capacity_dispatch(gate_val, gate_idx, num_experts, capacity,
                      valid=None, dtype=None):
    """The plan for already-chosen experts (gate_val/gate_idx [T, k]).
    `valid` [T] bool masks padding tokens: they claim no capacity and
    reach no expert. A choice's slot is its arrival position within its
    expert, counted token-major and choice-minor, so earlier tokens win
    capacity; a choice at slot >= C is dropped."""
    T, k = gate_val.shape
    E, C = int(num_experts), int(capacity)
    dtype = dtype or gate_val.dtype
    oh = F.one_hot(gate_idx.long(), E).int()                    # [T,k,E]
    if valid is not None:
        oh = oh * valid.int()[:, None, None]
    flat_oh = oh.reshape(T * k, E)
    pos = torch.cumsum(flat_oh, dim=0) * flat_oh - 1            # [T*k,E]
    slot = (pos * flat_oh).sum(dim=-1).reshape(T, k)
    routed = oh.sum(dim=-1) > 0
    in_cap = routed & (slot < C)
    # counts summed in fp32 from the int masks: a bf16 compute dtype
    # would round a running sum past ~256 tokens per expert
    kept = (oh.float() * in_cap[..., None].float()).sum(dim=(0, 1))
    dropped = routed.float().sum() - in_cap.float().sum()
    return DispatchPlan(e_oh=oh.to(dtype), counts=kept, dropped=dropped,
                        gate_idx=gate_idx, slot=slot, in_cap=in_cap,
                        gates=gate_val)


def _masked_sums(vals, valid):
    """(sum of `vals` [T, ...] over valid tokens, number of valid
    tokens)."""
    if valid is None:
        return vals.sum(dim=0), torch.tensor(float(vals.shape[0]),
                                             device=vals.device)
    v = valid.to(vals.dtype)
    vals = vals * v.reshape((-1,) + (1,) * (vals.ndim - 1))
    return vals.sum(dim=0), v.float().sum()


def router_balance_loss(probs, e_oh, valid=None):
    """GShard/Switch load-balance loss, top-k generalised:
    aux = E * sum_e mean_t(probs[t, e]) * f_e, with f_e the share of the
    T * k choices routed to e. Uniform routing gives 1."""
    E = probs.shape[-1]
    k = e_oh.shape[1]
    me_s, n = _masked_sums(probs.float(), valid)
    ce_s, _ = _masked_sums(e_oh.float().sum(dim=1), valid)
    n = n.clamp_min(1.0)
    return float(E) * (me_s / n * (ce_s / (n * float(k)))).sum()


def router_z_loss(logits, valid=None):
    """Router z-loss (ST-MoE): mean_t logsumexp(logits[t])^2."""
    z = torch.logsumexp(logits.float(), dim=-1) ** 2
    s, n = _masked_sums(z, valid)
    return s / n.clamp_min(1.0)


@dataclasses.dataclass
class RouterOutput:
    plan: DispatchPlan
    gates: torch.Tensor         # [T, k] renormalised top-k gate values
    balance_loss: torch.Tensor  # scalar f32
    logits: torch.Tensor        # [T, E] f32 router logits
    valid: torch.Tensor | None  # [T] bool, or None

    @property
    def z_loss(self):
        """Scalar f32 router z-loss, computed when read (serving does
        not read it, and eager mode would pay its launches every
        layer)."""
        return router_z_loss(self.logits, self.valid)


def top_k_routing(logits, top_k, capacity, valid=None, dtype=None):
    """Softmax gate -> top-k -> renormalise -> capacity dispatch, with
    the balance loss (the z-loss on demand). logits [T, E]."""
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1)
    # the k largest in descending order, ties to the lower expert, as
    # jax.lax.top_k returns them: a stable descending sort (torch.topk
    # leaves the order of ties open). Padding rows are masked out of
    # everything.
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :int(top_k)], topi[:, :int(top_k)]
    gates = topv / topv.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    plan = capacity_dispatch(gates, topi, logits.shape[-1], capacity,
                             valid=valid, dtype=dtype or logits.dtype)
    return RouterOutput(plan=plan, gates=gates,
                        balance_loss=router_balance_loss(probs, plan.e_oh,
                                                         valid),
                        logits=lf, valid=valid)


def dispatch_indices(plan, num_experts, capacity):
    """[E, C] int32 token index per capacity slot (-1 = unclaimed).

    Each in-capacity (token, choice) owns a unique (expert, slot), so the
    scatter has no collisions. Dropped and padding choices are masked
    out: they scatter into a scratch row E that is cut off afterwards
    (a boolean selection would cost a device sync), never clamped into
    a real slot."""
    T, k = plan.slot.shape
    E, C = int(num_experts), int(capacity)
    ok = plan.in_cap.reshape(-1)
    e = torch.where(ok, plan.gate_idx.reshape(-1).long(), E)
    c = torch.where(ok, plan.slot.reshape(-1).long(), 0)
    tok = torch.arange(T, dtype=torch.int32,
                       device=ok.device).repeat_interleave(k)
    tos = torch.full((E + 1, C), -1, dtype=torch.int32, device=ok.device)
    tos.index_put_((e, c), tok)
    return tos[:E]


def dispatch_tokens_indexed(x, plan, num_experts, capacity,
                            indices=None):
    """x [T, d] -> [E, C, d] capacity buffers by gather (unclaimed slots
    zero). `indices`: an [E', C] token-index table to gather by instead
    of the plan's whole one (the expert-parallel path passes its
    resident experts' rows, `local_indices`)."""
    tos = (dispatch_indices(plan, num_experts, capacity)
           if indices is None else indices)
    g = x[tos.clamp_min(0).long()]                       # [E, C, d]
    return g * (tos >= 0).to(x.dtype)[..., None]


def local_indices(tos, ep_rank, num_local):
    """The rows of the [E, C] token-index table of the experts resident
    on ep rank `ep_rank` (experts ep_rank * num_local onwards)."""
    return tos[ep_rank * num_local:(ep_rank + 1) * num_local]


def combine_tokens_indexed(eout, plan, e_offset=0, num_local=None):
    """eout [E_loc, C, d] -> [T, d], the gate-weighted mixture of each
    token's in-capacity choices, by gather; dropped choices give 0.
    `e_offset` / `num_local`: eout holds experts e_offset .. e_offset +
    num_local - 1 only (one ep rank's), and choices of other experts give
    0; the ranks' partial mixtures sum to the whole one."""
    E_loc, C = eout.shape[0], eout.shape[1]
    if num_local is None:
        num_local = E_loc
    e = plan.gate_idx.long()
    ok = plan.in_cap
    if num_local != plan.e_oh.shape[-1]:         # some experts elsewhere
        ok = ok & (e >= e_offset) & (e < e_offset + num_local)
    el = (e - e_offset).clamp(0, E_loc - 1)
    cl = plan.slot.long().clamp(0, C - 1)
    vals = eout[el, cl]                                  # [T, k, d]
    w = plan.gates.to(eout.dtype) * ok.to(eout.dtype)
    return (vals * w[..., None]).sum(dim=1)
