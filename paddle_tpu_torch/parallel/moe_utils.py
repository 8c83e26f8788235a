"""MoE routing, dispatch and the expert-parallel exchange.

Port of the fixed-shape top-k capacity router of
`paddle_tpu/parallel/moe_utils.py`: softmax gate, top-k, renormalised
gates, per-expert capacity slots in arrival order (token-major,
choice-minor; overflow dropped, the caller's residual carries the
token), the GShard load-balance loss and the router z-loss. Every shape
depends only on (T, k, E, C), never on the routing.

The statistics take `group=`, a `torch.distributed` process group (JAX's
`axes=`, the mesh axes the tokens are sharded over): the sums behind the
balance and z losses are all-reduced over it, differentiably, so the
losses and their gradients do not depend on how the tokens are sharded.
`group=None` reduces nothing (pass `torch.distributed.group.WORLD` for
the whole world).

Dispatch and combine come in two pairs that compute the same thing: the
one-hot einsum pair (`dispatch_tokens` / `combine_tokens`, over
`[T, k, C]` masks built from the plan), kept as the parity oracle, and
the index pair (`dispatch_tokens_indexed` / `combine_tokens_indexed`,
an `[E, C]` table of choices and gathers), the path the JAX package
takes on a TPU and the port takes everywhere, serving and training.
Each of the index pair's backwards is the other gather, so a step gives
the same bits on every run: autograd's own backward of an indexing
scatter-adds, in atomic order on the card.

`all_to_all_dispatch` / `all_to_all_combine` move the `[E, C, d]`
buffers to the experts' owners over an expert-parallel group and back,
differentiably.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F


def expert_capacity(num_tokens, num_experts, top_k, capacity_factor):
    """Per-expert capacity slots C = ceil(factor * T * k / E), floored
    at 1."""
    c = capacity_factor * float(num_tokens) * float(top_k) \
        / float(num_experts)
    return max(1, int(math.ceil(c)))


@dataclasses.dataclass
class DispatchPlan:
    """The routing plan of one token set.

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


def _masked_axis_sums(vals, valid, group=None):
    """(sum of `vals` [T, ...] over valid tokens, number of valid
    tokens), each also summed over `group` when one is given: the
    ingredients of a mean over the global token set. The sum's
    all-reduce carries a gradient (its backward all-reduces the
    gradient), as JAX's psum does inside the differentiated step."""
    if valid is None:
        n = torch.tensor(float(vals.shape[0]), device=vals.device)
    else:
        v = valid.to(vals.dtype)
        vals = vals * v.reshape((-1,) + (1,) * (vals.ndim - 1))
        n = v.float().sum()
    s = vals.sum(dim=0)
    if group is not None:
        s = dist_fn.all_reduce(s, group=group)
        dist.all_reduce(n, group=group)
    return s, n


def router_balance_loss(probs, e_oh, valid=None, group=None):
    """GShard/Switch load-balance loss, top-k generalised:
    aux = E * sum_e mean_t(probs[t, e]) * f_e, with f_e the share of the
    T * k choices routed to e. Uniform routing gives 1. With `group`
    both means are over the global token set."""
    E = probs.shape[-1]
    k = e_oh.shape[1]
    me_s, n = _masked_axis_sums(probs.float(), valid, group)
    ce_s, _ = _masked_axis_sums(e_oh.float().sum(dim=1), valid, group)
    n = n.clamp_min(1.0)
    return float(E) * (me_s / n * (ce_s / (n * float(k)))).sum()


def router_z_loss(logits, valid=None, group=None):
    """Router z-loss (ST-MoE): mean_t logsumexp(logits[t])^2, over the
    global token set with `group`."""
    z = torch.logsumexp(logits.float(), dim=-1) ** 2
    s, n = _masked_axis_sums(z, valid, group)
    return s / n.clamp_min(1.0)


@dataclasses.dataclass
class RouterOutput:
    plan: DispatchPlan
    gates: torch.Tensor         # [T, k] renormalised top-k gate values
    balance_loss: torch.Tensor  # scalar f32
    logits: torch.Tensor        # [T, E] f32 router logits
    valid: torch.Tensor | None  # [T] bool, or None
    group: object = None        # the statistics' process group

    @property
    def z_loss(self):
        """Scalar f32 router z-loss, computed when read (serving does
        not read it, and eager mode would pay its launches every
        layer)."""
        return router_z_loss(self.logits, self.valid, self.group)


def top_k_routing(logits, top_k, capacity, valid=None, dtype=None,
                  group=None):
    """Softmax gate -> top-k -> renormalise -> capacity dispatch, with
    the balance loss (the z-loss on demand), both over `group`'s global
    token set when one is given. logits [T, E]."""
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
                        balance_loss=router_balance_loss(
                            probs, plan.e_oh, valid, group),
                        logits=lf, valid=valid, group=group)


def _masks(plan, capacity):
    """The einsum pair's one-hot `[T, k, C]` masks, built from the plan's
    slots in its dtype: the 0/1 dispatch mask and the gate-weighted
    combine mask."""
    C, dtype = int(capacity), plan.e_oh.dtype
    disp = (F.one_hot(plan.slot.clamp(0, C - 1).long(), C).to(dtype)
            * plan.in_cap[..., None].to(dtype))
    return disp, disp * plan.gates.to(dtype)[..., None]


def dispatch_tokens(x, plan, capacity):
    """x [T, d] -> [E, C, d] through the one-hot masks: the JAX package's
    einsum pair, the oracle of the index pair below."""
    disp, _ = _masks(plan, capacity)
    return torch.einsum("tkc,tke,td->ecd", disp, plan.e_oh,
                        x.to(disp.dtype))


def combine_tokens(eout, plan):
    """eout [E, C, d] -> [T, d], the gate-weighted mixture through the
    one-hot masks; dropped (token, choice) pairs give 0."""
    _, comb = _masks(plan, eout.shape[1])
    return torch.einsum("tkc,tke,ecd->td", comb, plan.e_oh,
                        eout.to(comb.dtype))


def _slot_table(plan, num_experts, capacity, values):
    """[E, C] table of `values` [T * k] at each in-capacity choice's
    (expert, slot), -1 where no choice landed. Each in-capacity (token,
    choice) owns a unique (expert, slot), so the scatter has no
    collisions. Dropped and padding choices are masked out: they scatter
    into a scratch row E that is cut off afterwards (a boolean selection
    would cost a device sync), never clamped into a real slot."""
    E, C = int(num_experts), int(capacity)
    ok = plan.in_cap.reshape(-1)
    e = torch.where(ok, plan.gate_idx.reshape(-1).long(), E)
    c = torch.where(ok, plan.slot.reshape(-1).long(), 0)
    table = torch.full((E + 1, C), -1, dtype=values.dtype,
                       device=ok.device)
    table.index_put_((e, c), values)
    return table[:E]


def dispatch_choices(plan, num_experts, capacity):
    """[E, C] int64 flat choice index `t * k + j` per capacity slot (-1 =
    unclaimed): the index pair's table (a slot's token and its gate)."""
    T, k = plan.slot.shape
    ch = torch.arange(T * k, device=plan.slot.device)
    return _slot_table(plan, num_experts, capacity, ch)


def dispatch_indices(plan, num_experts, capacity):
    """[E, C] int32 token index per capacity slot (-1 = unclaimed): the
    tokens of `dispatch_choices`."""
    ch = dispatch_choices(plan, num_experts, capacity)
    k = plan.slot.shape[1]
    return torch.where(ch >= 0, ch // k, -1).to(torch.int32)


def local_indices(table, ep_rank, num_local):
    """The rows of an [E, C] slot table (`dispatch_choices` or
    `dispatch_indices`) of the experts resident on ep rank `ep_rank`
    (experts ep_rank * num_local onwards)."""
    return table[ep_rank * num_local:(ep_rank + 1) * num_local]


def _local_ok(plan, e_offset, num_local):
    """[T, k] bool: the choice landed inside capacity of one of experts
    e_offset .. e_offset + num_local - 1."""
    ok = plan.in_cap
    if num_local != plan.e_oh.shape[-1]:         # some experts elsewhere
        e = plan.gate_idx.long()
        ok = ok & (e >= e_offset) & (e < e_offset + num_local)
    return ok


def _choice_rows(buf, plan, e_offset):
    """buf [E_loc, C, d] (experts e_offset onwards) read at each (token,
    choice)'s slot -> [T, k, d]; a choice elsewhere or dropped reads a
    clamped slot, which the caller masks."""
    E_loc, C = buf.shape[0], buf.shape[1]
    e = (plan.gate_idx.long() - e_offset).clamp(0, E_loc - 1)
    return buf[e, plan.slot.long().clamp(0, C - 1)]


class _DispatchIndexed(torch.autograd.Function):
    """x [T, d] -> [E_loc, C, d] by gather; the backward is the unit-weight
    combine: each token's in-capacity slots gathered and its k choices
    summed in order, where autograd's would scatter-add."""

    @staticmethod
    def forward(ctx, x, choices, plan, e_offset):
        ctx.plan, ctx.e_offset = plan, e_offset
        tos = choices.clamp_min(0) // plan.slot.shape[1]
        return x[tos] * (choices >= 0).to(x.dtype)[..., None]

    @staticmethod
    def backward(ctx, g):
        plan, e_offset = ctx.plan, ctx.e_offset
        ok = _local_ok(plan, e_offset, g.shape[0])
        rows = _choice_rows(g, plan, e_offset)
        return (rows * ok[..., None].to(g.dtype)).sum(dim=1), None, None, \
            None


class _CombineIndexed(torch.autograd.Function):
    """eout [E_loc, C, d], gates [T, k] -> [T, d], the gate-weighted
    mixture by gather; the backward is gathers too: a slot's gradient is
    its owner token's times its gate, a gate's the dot of the token's
    gradient with its slot's output."""

    @staticmethod
    def forward(ctx, eout, gates, plan, e_offset, num_local):
        ctx.plan, ctx.e_offset, ctx.num_local = plan, e_offset, num_local
        ctx.save_for_backward(eout, gates)
        w = gates.to(eout.dtype) \
            * _local_ok(plan, e_offset, num_local).to(eout.dtype)
        return (_choice_rows(eout, plan, e_offset) * w[..., None]).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        eout, gates = ctx.saved_tensors
        plan, e_offset = ctx.plan, ctx.e_offset
        ok = _local_ok(plan, e_offset, ctx.num_local).to(eout.dtype)
        d_eout = d_gates = None
        if ctx.needs_input_grad[0]:
            # eout's rows of the choice table: each slot's owner and gate
            ch = dispatch_choices(plan, plan.e_oh.shape[-1], eout.shape[1])[
                e_offset:e_offset + eout.shape[0]]
            c = ch.clamp_min(0)
            w = (gates.to(eout.dtype) * ok).reshape(-1)[c] \
                * (ch >= 0).to(eout.dtype)
            d_eout = g.to(eout.dtype)[c // plan.slot.shape[1]] * w[..., None]
        if ctx.needs_input_grad[1]:
            rows = _choice_rows(eout, plan, e_offset)
            d_gates = ((rows * g.to(eout.dtype)[:, None, :]).sum(dim=-1)
                       * ok).to(gates.dtype)
        return d_eout, d_gates, None, None, None


def dispatch_tokens_indexed(x, plan, num_experts, capacity, choices=None,
                            e_offset=0):
    """x [T, d] -> [E, C, d] capacity buffers by gather (unclaimed slots
    zero), with a backward in a fixed order. `choices`: an [E', C] slot
    table (`dispatch_choices`) to gather by instead of the plan's whole
    one; the expert-parallel serving path passes its resident experts'
    rows (`local_indices`), the first of them expert `e_offset`."""
    if choices is None:
        choices = dispatch_choices(plan, num_experts, capacity)
    return _DispatchIndexed.apply(x, choices, plan, int(e_offset))


def combine_tokens_indexed(eout, plan, e_offset=0, num_local=None):
    """eout [E_loc, C, d] -> [T, d], the gate-weighted mixture of each
    token's in-capacity choices by gather (gradients to eout and to the
    plan's gates, in a fixed order); dropped choices give 0. `e_offset`
    / `num_local`: eout holds experts e_offset .. e_offset + num_local -
    1 only (one ep rank's), and choices of other experts give 0; the
    ranks' partial mixtures sum to the whole one."""
    if num_local is None:
        num_local = eout.shape[0]
    return _CombineIndexed.apply(eout, plan.gates, plan, int(e_offset),
                                 int(num_local))


# ---------------------------------------------------------------------
# expert-parallel exchange over a process group
# ---------------------------------------------------------------------


def host_staged(tensor, group):
    """True where a collective's CUDA payload goes through host memory:
    under gloo, which stages CUDA tensors itself for some collectives
    and takes only host tensors for others (all-to-all, all-gather).
    Chosen by the group's backend, never by trying."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def _all_to_all(x, group):
    """`dist.all_to_all_single` of equal chunks along dim 0."""
    x = x.contiguous()
    if host_staged(x, group):
        host = x.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """All-to-all of equal chunks along dim 0; its transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all_dispatch(dispatched, group, ep):
    """[E, C, d] per-rank dispatch buffers -> [E_loc, ep * C, d] per-
    expert inputs on the expert's owner (ep rank r holds experts r *
    E_loc onwards): each rank keeps the buckets of its resident experts
    from every rank of `group`, the source's rank indexing the capacity
    axis in blocks of C."""
    E, C, d = dispatched.shape
    E_loc = E // int(ep)
    t = _AllToAll.apply(dispatched.reshape(int(ep), E_loc, C, d), group)
    return t.transpose(0, 1).reshape(E_loc, int(ep) * C, d)


def all_to_all_combine(eout, group, ep):
    """Inverse of `all_to_all_dispatch`: [E_loc, ep * C, d] expert
    outputs -> [E, C, d] back on the tokens' owners."""
    E_loc, epC, d = eout.shape
    C = epC // int(ep)
    t = eout.reshape(E_loc, int(ep), C, d).transpose(0, 1)
    return _AllToAll.apply(t, group).reshape(E_loc * int(ep), C, d)
