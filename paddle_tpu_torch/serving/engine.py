"""ServingEngine — paged-KV continuous batching over the fused GPT stack.

Port of `paddle_tpu/serving/engine.py:ServingEngine` with float, int8 or
fp8 KV pools, dense or MoE decoders (float, int8 or packed-int4
experts), optional speculation, penalized sampling, and one or several
decode ticks per host dispatch. Host loop per `step()`:

    scheduler.plan()  ->  pack_step()  ->  mixed step  ->  sample
    bookkeeping (accept lengths, EOS + length termination, block
    release and rollback)

The mixed step runs one flat `[T]` token axis holding decode tokens and
prefill chunks together; every step takes the same input shapes (`[T]`
tokens, slots and positions, `[S, MB]` block tables, `[S]` sample
index), whatever requests come and go. Each layer writes the new K/V
into the paged pools in place — quantized per token and head on the
way in when `kv_dtype` is "int8" or "fp8_e4m3" — and attends through
`ops.paged_attention` (the Hopper kernels on a CUDA device, their plain
versions on the CPU). A MoE layer routes the valid tokens into fixed
expert-capacity slots (C from T, so routing never changes a shape) and
runs the expert products through
`ops.grouped_matmul.grouped_expert_matmul`; its routing statistics come
back to the host with the sampled tokens, in one copy.

With `draft_k > 0` each decode feeds a verify group — its last token
plus up to draft_k n-gram proposals (`serving.draft`) — through a fixed
`[max_slots, draft_k + 1]` verify region at the front of the token
axis, attended by `verify_paged_attention`; prefill keeps the ragged
entry. Greedy engines accept the longest draft prefix the model agrees
with; sampling engines accept by the rejection rule against the
filtered target distribution. Either emits 1..draft_k+1 tokens a step
and rolls back the KV blocks the rejected tail had claimed, and greedy
output stays token-identical to `draft_k=0`.

Penalties (`SamplingConfig.repetition_penalty`, `presence_penalty`,
`frequency_penalty`) read a `[max_slots, penalty_vocab_bins]` count
histogram of each slot's last `penalty_window` tokens; the verify head
adds each draft position's prior.

With `ticks_per_dispatch=N > 1` (or "auto") a pure-decode dispatch runs
up to N decode ticks without the host (`_run_ticks`): one upload, N
ticks enqueued, one readback. Between ticks the n-gram drafter, the
accept roll, the token rings and the count histogram advance on the
device. JAX's loop stops at the first per-slot event (a finish or a
block overflow); this loop cannot read the device. The host issues no
tick past an exit it can foresee (a horizon or a capacity reached), and
a tick after an event it cannot (an EOS, a run of accepted drafts) runs
as padding that changes no state; the sampling generator is set back to
where the first tick that did not count found it. Output equals the
1-tick engine's.

With `prefix_caching=True` a radix tree (`prefix_cache.py`) shares
the KV blocks of cached prompt heads across requests: admission adopts
them and prefill starts at the first uncached token; a request that
must re-feed a token inside a shared block writes into a private copy
(`PagedKVCache.cow_block`). `close(spill_prefix=path)` writes the tree
and its blocks to a file that `RadixPrefixCache.restore` reads back.

With `sparse_blocks=B` (block-sparse decode) every decode or verify
query scores its slot's blocks by an upper bound of q.k over each
block's channel-wise min/max key summary, and the region attends only
a fixed `[S, Bt]` shortened table (`select_blocks`): the first block,
the last `sparse_recent` blocks and the B best, Bt = 1 + recent + B, with
positions compacted into it. Prefill keeps the full table. With B at or
past a slot's allocated blocks the selection is the identity.

With `max_adapters=K` the engine serves LoRA finetunes beside the base
model (`adapters.py`): `register_adapter` takes an adapter's host
weights, `submit(adapter_id=)` names one, admission pins it into one of
K - 1 device slots (blocking while every slot is pinned, evicting the
least recently used unpinned one otherwise), and every hooked
projection adds each token's delta through one `[T, K]` one-hot a step
(`_lora_delta`). Slot 0 is the null adapter: base-model tokens are those
of an engine without adapters. Adapter requests bypass the prefix cache.

A weight-only model (`GPTForGeneration(weight_only=True)`) keeps its
int8 (and, for MoE experts, packed int4) weights as they are; the
once-only cast to the compute dtype touches float tensors alone, and
each projection runs `_mm` with its scale (K4 at one group on a card).

Tensor- and expert-parallel serving is `distributed.TPServingEngine`,
a subclass that runs this host loop on every rank of a process group
over its shard of the weights and pools. It reaches the step through
three hooks: `_step_cfg` (the rank's heads and groups), `_sync_outputs`
(rank 0's sampled tokens to every rank, each tick) and the clock.

Disaggregated prefill/decode serving: `role="prefill"` parks each
request in the "handoff" state right after its first sampled token;
`extract_request` then exports its KV blocks (scales and summaries
included) into a `distributed.transport.MigrationTicket`, which a
decode-role engine admits mid-stream by `submit_migrated` (the
scheduler imports the blocks at admission instead of prefilling), with
greedy output token-identical to a monolithic engine. While the prompt
prefills, `export_unshipped` hands out the full blocks written so far,
so the destination holds most of the KV before the ticket exists.
`role="decode"` defaults to a decode-sized token budget; any engine's
live decode can be shed to another the same way. The router
(`distributed.router.ReplicaRouter`) drives it.

Observability: while `profiler.metrics._enabled` is on, every step (a
dispatch, on a multi-tick engine) publishes the serving metrics of
`serving.metrics` (TTFT and inter-token histograms, token, step and
request counters, queue, slot and pool gauges, draft and rollback
counters, prefix-cache, sparse, migration and MoE deltas, and on a
multi-tick engine the ticks a dispatch ran, the readback stall and the
early exits). While `serving.tracing._enabled` is on it also records
the request traces' span events and one record a step in the engine's
`StepFlightRecorder` (`self.flight`). Both read only host ints and
floats the step already holds: no hook reads a device tensor or adds
a launch. (A speculative multi-tick dispatch counts its verify groups
by accepted drafts on the device, recording on or off, and takes the
accepted total from that histogram; the histogram feeds the
accept-length metric and the flight record.)
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..profiler import metrics as _pmetrics
from ..profiler.metrics import moe_utilization_entropy
from ..incubate.nn.fused_transformer import (_cast_param, _ffn_dense,
                                             _ffn_moe_tokens, _ln,
                                             _lora_delta,
                                             _maybe_all_reduce, _mm, _qkv,
                                             _quantize_expert_stack)
from ..ops.paged_attention import (MAX_GROUP, ragged_paged_attention,
                                   verify_paged_attention)
from . import metrics as smetrics
from . import tracing as _tracing
from .adapters import AdapterCache
from .batcher import (SamplingConfig, apply_count_penalties,
                      choose_token_budget, filter_logits, needs_history,
                      pack_step, select_token)
from .draft import (accept_length, accept_length_sampled, ngram_propose,
                    ngram_propose_device, ring_chronological)
from .fleet.export import _as_host_tensor
from .kv_cache import FP8_MAX, SUMMARY_INIT, PagedKVCache
from .prefix_cache import RadixPrefixCache
from .scheduler import Scheduler

#: default replica names: the role and a sequence number
_ENGINE_SEQ = itertools.count()

#: `sparse_blocks="auto"`: the JAX engine's default when its tuned-budget
#: cache holds no entry (the port has no such cache yet)
SPARSE_BLOCKS_DEFAULT = 8


def quantize_kv(x, kv_dtype):
    """[T, H, Dh] float -> (quantized values, [T, H] fp32 scales):
    symmetric per-token-per-head amax scaling, to the int8 grid (round
    half to even, clipped to +-127) or onto the fp8 e4m3 finite range
    (clipped to +-448 before the cast, which would turn anything past
    it into NaN) — the JAX step's `quantize`. A pure function of the
    token's own K/V, so it does not depend on append order or
    chunking."""
    xf = x.float()
    if kv_dtype == "fp8_e4m3":
        s = xf.abs().amax(dim=-1) / FP8_MAX
        qv = xf / s.clamp_min(1e-20)[..., None]
        qv = qv.clamp(-FP8_MAX, FP8_MAX)
        return qv.to(torch.float8_e4m3fn), s
    s = xf.abs().amax(dim=-1) / 127.0
    q8 = torch.round(xf / s.clamp_min(1e-20)[..., None])
    return q8.clamp(-127, 127).to(torch.int8), s


def _append_kv(pool, scale_pool, wb, wo, x, kv_dtype):
    """Write x [T, H, Dh] into one layer's pool at (wb, wo), in place
    (the JAX step rebuilt the pools with .at[].set); a quantized pool
    takes the payload's bytes and its scale pool the scales."""
    if scale_pool is None:
        pool[wb, wo] = x.to(pool.dtype)
        return
    qv, s = quantize_kv(x, kv_dtype)
    pool.view(torch.uint8)[wb, wo] = qv.view(torch.uint8)
    scale_pool[wb, wo] = s


def _summary_rows(wb, wo, valid, k_shape):
    """The rows one step's key-summary update touches, the same in every
    layer: the block rows the step's offset-0 writes reset (other tokens
    aim at the NULL row) and each token's block row, broadcast to its
    key's [H, Dh] shape for the scatter."""
    reset = torch.where(valid & (wo == 0), wb, 0).long()
    return reset, wb.long()[:, None, None].expand(k_shape)


def _update_summaries(k_sum_min, k_sum_max, k, rows):
    """Fold one layer's appended keys k [T, H, Dh] into its block
    summaries `[NB, H, Dh]`, in place: the rows of blocks written at
    offset 0 are reset first, then one scatter-min and one scatter-max
    take every appended key in (`rows` from `_summary_rows`; padding
    aims at the NULL block). Well defined when one chunk writes many
    entries of a block, and a freed block taken again never keeps its
    last owner's statistics."""
    reset, idx = rows
    k_sum_min.index_fill_(0, reset, SUMMARY_INIT)
    k_sum_max.index_fill_(0, reset, -SUMMARY_INIT)
    kf = k.float()
    k_sum_min.scatter_reduce_(0, idx, kf, "amin")
    k_sum_max.scatter_reduce_(0, idx, kf, "amax")


def _sparse_plan(pos_r, block_tables, table_width, recent, block_size):
    """The half of `select_blocks` that is the same in every layer of a
    step, from the region's positions pos_r [S, K] and block_tables
    [S', MB] (S' >= S): each slot's candidate blocks (those up to its
    newest query's), the forced ones (the first and the last `recent`),
    and which blocks lie before each query's own."""
    S, K = pos_r.shape
    bt = block_tables[:S].long()
    m_idx = torch.arange(bt.shape[1], device=bt.device)
    pos = pos_r.long()
    n_blk = pos.amax(dim=1) // block_size + 1
    return dict(
        bt=bt, width=int(table_width), block_size=int(block_size),
        offset=pos % block_size,
        valid=m_idx < n_blk[:, None],
        forced=(m_idx == 0) | (m_idx >= (n_blk - recent)[:, None]),
        before=m_idx < (pos // block_size)[:, :, None],      # [S, K, MB]
        lower=m_idx[None, :] < m_idx[:, None])              # [MB, MB]


def _select(q_r, k_sum_min, k_sum_max, plan, group=None):
    """The layer's half of `select_blocks`: scores from this layer's
    queries and summaries, then the shortened tables and compacted
    positions. `group`: under TP each rank holds a slice of the heads,
    and the [S, K, MB] scores are all-reduced over it before the max
    over the group's K queries (max_k(a_k + b_k) is not max_k(a_k) +
    max_k(b_k) where the ranks' maxima fall on different queries), so
    every rank selects the blocks one rank holding every head would."""
    S, K, H, Dh = q_r.shape
    bt, width = plan["bt"], plan["width"]
    MB = bt.shape[1]
    qf = q_r.float().reshape(S, K, H * Dh)
    hi = k_sum_max[bt].reshape(S, MB, H * Dh).transpose(1, 2)
    lo = k_sum_min[bt].reshape(S, MB, H * Dh).transpose(1, 2)
    score = (torch.bmm(qf.clamp_min(0.0), hi)
             + torch.bmm(qf.clamp_max(0.0), lo))             # [S, K, MB]
    if group is not None:
        dist.all_reduce(score, group=group)
    score = score.amax(dim=1)                                 # [S, MB]
    score = torch.where(plan["valid"],
                        torch.where(plan["forced"], float("inf"), score),
                        float("-inf"))
    # a block's place in the descending order, ties to the lower table
    # index as jax.lax.top_k breaks them: the count of blocks ahead of it
    a, b = score[:, :, None], score[:, None, :]
    ahead = ((b > a) | ((b == a) & plan["lower"])).sum(dim=-1)
    keep = (ahead < width) & (score > float("-inf"))
    col = torch.where(keep, keep.cumsum(dim=1) - 1, width)
    short_bt = bt.new_zeros(S, width + 1).scatter_(1, col, bt)
    short_bt = short_bt[:, :width].to(torch.int32)
    before = (keep[:, None, :] & plan["before"]).sum(dim=-1)
    pos_c = (before * plan["block_size"] + plan["offset"]).to(torch.int32)
    return short_bt, pos_c


def select_blocks(q_r, pos_r, block_tables, k_sum_min, k_sum_max,
                  table_width, recent, block_size):
    """The block-sparse decode's selection, on the queries' device: a
    shortened table of `table_width` (Bt) blocks for each slot of the
    region and the region's positions compacted into it.

    q_r [S, K, H, Dh] the region's queries (raw), pos_r [S, K] their
    positions, block_tables [S', MB] (S' >= S), k_sum_min / k_sum_max
    [NB, H, Dh] this layer's summaries. Each of a slot's allocated
    blocks (those up to its newest query's) scores the upper bound of
    q.k over its [min, max] box, sum_d max(q_d min_d, q_d max_d), summed
    over heads and maxed over the group's K queries; the first block
    and the last `recent` allocated blocks are forced in (+inf), blocks
    past the allocated prefix never (-inf). The Bt highest scores are
    kept, ties to the lower table index as `jax.lax.top_k` breaks them,
    in table order, NULL-padded where a slot holds fewer. A position p
    becomes (kept blocks before p's block) x block_size + p %
    block_size, so the kernels' `key <= query` mask stays exact.
    Returns (short_bt [S, Bt] int32, pos_c [S, K] int32). With Bt at or
    past a slot's allocated blocks the selection is the identity. The
    engine computes the layer-independent half (`_sparse_plan`) once a
    step."""
    return _select(q_r, k_sum_min, k_sum_max,
                   _sparse_plan(pos_r, block_tables, table_width, recent,
                                block_size))


def _mixed_layer(cfg, pl, h, k_pool, v_pool, wb, wo, block_tables,
                 slot_ids, pos, k_scale=None, v_scale=None, kv_dtype=None,
                 verify_width=1, region_slots=None, summaries=None,
                 sparse=None, lora_oh=None):
    """One decoder layer of the mixed step on the flat token axis.

    h [T, D]; pl the layer's parameters; k_pool/v_pool this layer's
    `[NB, BS, H, Dh]` pools, with `k_scale`/`v_scale` `[NB, BS, H]` when
    `kv_dtype` is "int8" or "fp8_e4m3"; (wb, wo) [T] the block and
    offset each token's K/V lands at (padding tokens aim at the NULL
    block). With `verify_width` K > 1 the first S*K tokens are the
    verify region: slot s's group attends through the verify entry
    (`region_slots` = arange(S)), the rest through the ragged entry.
    `summaries` (k_sum_min, k_sum_max, rows): this layer's [NB, H, Dh]
    key summaries, updated on append at the step's `_summary_rows`.
    `sparse` (the step's `_sparse_plan`): the region (at K = 1 too)
    attends the shortened tables of `select_blocks`, the rest the full
    ones. `lora_oh` [T, K]: the step's adapter one-hot; the layer's slot
    views in `pl` (`lora_qkv_a`, ...) add each hooked projection's delta.
    Returns (h, the MoE layer's routing stats or None)."""
    T = h.shape[0]
    H, Dh = cfg.num_heads, cfg.head_dim
    hn = _ln(h, pl["ln_s"], pl["ln_b"], cfg.epsilon)
    q, k, v = _qkv(cfg, pl, hn[None], lora_oh)
    q, k, v = q[0], k[0], v[0]                       # [T, H, Dh]
    _append_kv(k_pool, k_scale, wb, wo, k, kv_dtype)
    _append_kv(v_pool, v_scale, wb, wo, v, kv_dtype)
    if summaries is not None:
        k_sum_min, k_sum_max, rows = summaries
        _update_summaries(k_sum_min, k_sum_max, k, rows)
    q = q.contiguous()
    if sparse is not None:
        S, K = region_slots.shape[0], verify_width
        R = S * K
        q_r = q[:R].reshape(S, K, H, Dh)
        short_bt, pos_c = _select(q_r, k_sum_min, k_sum_max, sparse,
                                  cfg.mp_group)
        if K == 1:
            ar = ragged_paged_attention(
                q[:R], k_pool, v_pool, short_bt, slot_ids[:R],
                pos_c[:, 0].contiguous(), k_scale, v_scale,
                kernel_name="paged_sparse")
        else:
            ar = verify_paged_attention(
                q_r, k_pool, v_pool, short_bt, region_slots, pos_c,
                k_scale, v_scale, kernel_name="paged_sparse")
        ap = ragged_paged_attention(q[R:], k_pool, v_pool, block_tables,
                                    slot_ids[R:], pos[R:], k_scale,
                                    v_scale)
        attn = torch.cat([ar.reshape(R, H, Dh), ap])
    elif verify_width == 1:
        attn = ragged_paged_attention(q, k_pool, v_pool, block_tables,
                                      slot_ids, pos, k_scale, v_scale)
    else:
        S, K = region_slots.shape[0], verify_width
        R = S * K
        av = verify_paged_attention(
            q[:R].reshape(S, K, H, Dh), k_pool, v_pool, block_tables,
            region_slots, pos[:R].reshape(S, K), k_scale, v_scale)
        ap = ragged_paged_attention(q[R:], k_pool, v_pool, block_tables,
                                    slot_ids[R:], pos[R:], k_scale,
                                    v_scale)
        attn = torch.cat([av.reshape(R, H, Dh), ap])
    attn = attn.reshape(T, cfg.embed_dim)
    out = _mm(cfg, attn, pl["out_w"], pl.get("out_s"))
    if lora_oh is not None:
        out = out + _lora_delta(attn, pl["lora_out_a"], pl["lora_out_b"],
                                lora_oh)
    # row-parallel under TP: the rank's product (and LoRA delta) covers
    # its heads alone; the sum over the group comes before the bias
    out = _maybe_all_reduce(cfg, out)
    h = h + (out + pl["out_b"].to(out.dtype))
    hn = _ln(h, pl["ffn_ln_s"], pl["ffn_ln_b"], cfg.epsilon)
    if cfg.num_experts:
        f, stats = _ffn_moe_tokens(cfg, pl, hn, slot_ids >= 0)
        return h + f, stats
    return h + _ffn_dense(cfg, pl, hn, lora_oh), None


def _to_host(parts):
    """Copy device tensors to the host in one transfer: numpy arrays in
    float64 (exact for token ids and counts), each in its own shape."""
    flat = torch.cat([p.double().reshape(-1) for p in parts]).cpu().numpy()
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


class ServingEngine:
    def __init__(self, model, *, max_slots=8, block_size=16,
                 num_blocks=None, max_seq_len=None, token_budget=None,
                 sampling=None, eos_token_id=None, cache_dtype=None,
                 kv_dtype=None, moe_weight_dtype=None, seed=0,
                 clock=time.monotonic, draft_k=0, draft_ngram=3,
                 draft_ring=128, sparse_blocks=None, sparse_recent=2,
                 track_summaries=None, prefix_caching=False,
                 ticks_per_dispatch=1, penalty_vocab_bins=None,
                 max_adapters=0, lora_rank=8, lora_alpha=None,
                 role="mixed", name=None, device="cuda"):
        # config validation is loud, as in the JAX engine, and comes
        # before anything is built
        self._ticks_auto = ticks_per_dispatch == "auto"
        tp = 8 if self._ticks_auto else int(ticks_per_dispatch)
        if tp < 1:
            raise ValueError(f"ticks_per_dispatch={ticks_per_dispatch!r} "
                             "must be >= 1 (or 'auto')")
        #: the most ticks a dispatch runs (the staging width; "auto"
        #: sizes each dispatch at or below it)
        self.ticks_per_dispatch = tp
        self._multitick = tp > 1
        # the disaggregated role: "prefill" parks a request in "handoff"
        # at its first sampled token for extraction toward a decode
        # replica; "decode" serves like "mixed" (it re-prefills a
        # preempted migrant) under a decode-sized default budget
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown engine role {role!r}")
        self.role = role
        #: the replica's label (the role and a sequence number by default)
        self.name = (str(name) if name is not None
                     else f"{role}{next(_ENGINE_SEQ)}")
        self.device = resolve_device(device)
        self.sampling = sampling or SamplingConfig()
        self.draft_k = int(draft_k)
        self.draft_ngram = int(draft_ngram)
        self.draft_ring = int(draft_ring)
        if self.draft_k < 0:
            raise ValueError(f"draft_k={draft_k} must be >= 0")
        if self.draft_k > 0 and self.draft_ngram < 1:
            raise ValueError(f"draft_ngram={draft_ngram} must be >= 1 "
                             "with speculation on")
        if self.draft_k > 0 and self.draft_ring < 2:
            raise ValueError(
                f"draft_ring={draft_ring} must be >= 2 with speculation "
                "on (the n-gram scan needs at least one earlier token "
                "besides the tail)")
        if self.device.type == "cuda" and self.draft_k + 1 > MAX_GROUP:
            raise ValueError(
                f"draft_k={draft_k}: the verify kernel holds at most "
                f"{MAX_GROUP} queries a group, so draft_k <= "
                f"{MAX_GROUP - 1} on the card")
        # penalty count-histogram bins: the full vocab (exact) unless
        # asked for fewer (token t counts in bin t % bins)
        self._penalized = needs_history(self.sampling)
        self._penalty_bins = (int(model.vocab_size)
                              if penalty_vocab_bins is None
                              else int(penalty_vocab_bins))
        if self._penalized and self._penalty_bins < 1:
            raise ValueError(f"penalty_vocab_bins={penalty_vocab_bins} "
                             "must be >= 1 with penalized sampling")
        if self._penalized and int(self.sampling.penalty_window) < 1:
            raise ValueError(
                f"penalty_window={self.sampling.penalty_window} must be "
                ">= 1 with penalized sampling")
        #: where drafts come from: "off" (draft_k=0), "host" (the 1-tick
        #: engine's n-gram scan between steps) or "device" (drafted
        #: inside the multi-tick loop)
        self.speculation_mode = ("off" if self.draft_k == 0 else
                                 "device" if self._multitick else "host")
        #: rejection-sampling verify (plain sampling keeps speculation)
        self.spec_sampling = (self.draft_k > 0
                              and self.sampling.strategy != "greedy")
        self.model = model
        dec = model.decoder
        self.cfg = dec._cfg()
        # the pools hold the heads the step runs (a TP rank's share)
        L, H, Dh = dec.num_layers, self._step_cfg().num_heads, dec.head_dim
        maxpos = model.max_position_embeddings
        max_seq_len = min(max_seq_len or maxpos, maxpos)
        self.block_size = int(block_size)
        mbps = -(-max_seq_len // self.block_size)
        if num_blocks is None:
            # full residency for every slot, + the reserved null block
            num_blocks = max_slots * mbps + 1
        # block-sparse decode: the region attends a fixed-width table of
        # the first block, a recency window and the B best-scoring
        # blocks; the window covers every block a verify group's K fed
        # tokens can span, so a group always sees its own writes
        if sparse_blocks == "auto":
            sparse_blocks = SPARSE_BLOCKS_DEFAULT
        #: the B of the selection (None: dense decode attention)
        self.sparse_blocks = (None if sparse_blocks is None
                              else int(sparse_blocks))
        self._sparse = self.sparse_blocks is not None
        #: Bt, the shortened table's width (0 when dense)
        self.sparse_table_width = 0
        self._sparse_recent = 0
        if self._sparse:
            if self.sparse_blocks < 1:
                raise ValueError(
                    f"sparse_blocks={sparse_blocks} must be >= 1 (or None "
                    "for dense decode attention)")
            self._sparse_recent = max(
                int(sparse_recent),
                1 + -(-self.draft_k // self.block_size))
            self.sparse_table_width = min(
                mbps, 1 + self._sparse_recent + self.sparse_blocks)
        # the summaries are kept on append whenever the selection needs
        # them; `track_summaries=True` keeps them on a dense engine too
        self._track_summaries = (self._sparse if track_summaries is None
                                 else bool(track_summaries))
        if self._sparse and not self._track_summaries:
            raise ValueError(
                "sparse_blocks needs the block summaries; don't pass "
                "track_summaries=False on a sparse engine")
        self.token_budget = choose_token_budget(
            max_slots, self.block_size, token_budget,
            verify_width=self.draft_k + 1, role=self.role,
            reserve_region=self._sparse)
        self.kv = PagedKVCache(
            L, H, Dh, num_blocks=num_blocks, block_size=self.block_size,
            max_slots=max_slots, max_blocks_per_slot=mbps,
            dtype=cache_dtype or "bfloat16", kv_dtype=kv_dtype,
            summaries=self._track_summaries, device=self.device)
        #: the radix prefix cache (None unless `prefix_caching`); it is
        #: the KV cache's eviction backstop
        self.prefix_cache = (RadixPrefixCache(self.kv) if prefix_caching
                             else None)
        # multi-LoRA adapter slots in the compute dtype (None without
        # adapter support)
        cdt = getattr(torch, model.compute_dtype)
        self.adapters = (AdapterCache(dec, max_adapters=int(max_adapters),
                                      rank=int(lora_rank), alpha=lora_alpha,
                                      dtype=cdt, device=self.device,
                                      clock=clock)
                         if int(max_adapters) else None)

        def windowed_draft(tokens, k=self.draft_k, ngram=self.draft_ngram,
                           window=self.draft_ring):
            # the proposer scans the trailing window the JAX engine's
            # device ring holds, so both propose identically
            return ngram_propose(tokens[-window:], k, max_ngram=ngram)

        self.scheduler = Scheduler(
            self.kv, max_slots=max_slots, token_budget=self.token_budget,
            clock=clock, draft_k=self.draft_k, draft_fn=windowed_draft,
            device_draft=self.speculation_mode == "device",
            prefix_cache=self.prefix_cache, adapter_cache=self.adapters,
            reserve_region=self._sparse)
        self.scheduler.replica = self.name
        # the verify region's group -> slot map
        self._region_slots = torch.arange(max_slots, dtype=torch.int32,
                                          device=self.device)
        self.eos_token_id = eos_token_id
        self.clock = clock
        #: the clock the multi-tick EMAs time dispatches by (a TP rank's
        #: scheduler clock is rank 0's broadcast time, this one its own)
        self._timer = clock
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # cast float params to the compute dtype ONCE, on the engine's
        # device (a per-step cast would re-read every parameter); the
        # integer weights of a weight-only stack stay integers
        self._cdt = cdt
        self._layers = [{} for _ in range(L)]
        with torch.no_grad():
            self._set_weights(self._engine_weights(
                zip(model.gen_names(), model._gen_tensors())))
        #: the checkpoint version the engine serves (`swap_weights` sets
        #: it; the router's request counters and spans read it)
        self.weights_version = "v0"
        if self.adapters is not None:
            # each layer reads its views of the slot tensors, which
            # adapter loads write in place
            for li, pl in enumerate(self._layers):
                pl.update(self.adapters.layer_tensors(li))
        self.num_experts = self.cfg.num_experts
        # engine-side weight-only experts: the compute-dtype copies in
        # self._layers are quantized in place, and the step's cfg
        # carries the bits
        self.moe_weight_dtype = moe_weight_dtype
        if moe_weight_dtype is not None:
            self._quantize_moe_experts(str(moe_weight_dtype))
        self.steps_run = 0
        #: valid (non-padding) tokens fed through the step so far, and
        #: the prompt tokens among them (a prefix-cache hit feeds fewer)
        self.tokens_fed = 0
        self.prefill_tokens_fed = 0
        # cumulative MoE routing state (host mirrors of the per-step
        # device stats)
        self.moe_expert_counts = np.zeros(max(self.num_experts, 1),
                                          np.float64)
        self.moe_dropped_total = 0.0
        self.moe_last_aux = 0.0
        # cumulative draft economics
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        # block-sparse decode accounting: candidate blocks (a decode's
        # allocated ones) and selected ones (at most the table width) a
        # layer, summed over decodes; host arithmetic on known geometry
        self.sparse_candidate_blocks = 0
        self.sparse_selected_blocks = 0
        # multi-tick dispatch accounting: ticks that counted, ticks
        # enqueued (every one launches the step's kernels), per-slot
        # events that ended a dispatch early, and the EMAs "auto" sizes
        # dispatches from
        self.dispatches_run = 0
        self.device_ticks_run = 0
        self.device_ticks_issued = 0
        self.early_exit_counts = {"finish": 0, "overflow": 0}
        self._tick_ema = None        # seconds per tick
        self._gap_ema = None         # host seconds between dispatches
        self._last_harvest = None
        #: seconds the multi-tick host loop spent on its readbacks
        self.host_stall_total = 0.0
        # the bases of the metrics' deltas: preemptions, imported
        # blocks, prefix hit / miss / evicted tokens, skipped blocks
        self._preempt_seen = 0
        self._imported_seen = 0
        self._prefix_seen = (0, 0, 0)
        self._sparse_skip_seen = 0
        if _pmetrics._enabled:
            # why this replica is or isn't speculating: one mode reads 1
            for m in ("off", "host", "device"):
                smetrics.SERVING_SPECULATION_STATE.labels(m).set(
                    1.0 if m == self.speculation_mode else 0.0)
        #: one host record a step, noted while tracing is on; registered
        #: so the profiler's chrome export and summary() merge it
        self.flight = _tracing.StepFlightRecorder(self.name, self.role)
        _tracing.register_flight_recorder(self.flight)

    def _flight_extra(self):
        """Extra fields of every flight record (the TP engine stamps its
        split)."""
        return {}

    # ------------------------------------------------ weights and swap
    def _engine_weights(self, named):
        """The engine's tensors of checkpoint entries, `named` (name,
        tensor) pairs under the model's `gen_names()`: {name: tensor}
        for the embeddings, `ln_f` and the head, {(name, layer): tensor}
        for the decoder's stacks, each moved to the engine's device and
        cast as `_cast_param` casts (integer weights never). `__init__`
        and `swap_weights` share it, so a swapped engine holds the bits
        an engine built from the new checkpoint holds."""
        out = {}
        for name, t in named:
            t = t.detach().to(self.device)
            if name in self.model.decoder.param_names:
                for li in range(t.shape[0]):
                    out[(name, li)] = _cast_param(name, t[li], self._cdt)
            else:
                out[name] = _cast_param(name, t, self._cdt)
        return out

    def _set_weights(self, flat):
        """Install `_engine_weights`-keyed tensors as the engine's own
        (into the layer dicts in place: adapter views stay)."""
        self._we = flat["word_embeddings"]
        self._pe = flat["position_embeddings"]
        self._lnf = (flat["ln_f.weight"], flat["ln_f.bias"])
        self._head = flat["lm_head.weight"]
        for key, t in flat.items():
            if isinstance(key, tuple):
                self._layers[key[1]][key[0]] = t

    def _weight_slots(self):
        """The engine's weight tensors under `_engine_weights`' keys."""
        slots = {"word_embeddings": self._we,
                 "position_embeddings": self._pe,
                 "ln_f.weight": self._lnf[0], "ln_f.bias": self._lnf[1],
                 "lm_head.weight": self._head}
        for li, pl in enumerate(self._layers):
            for n in self.model.decoder.param_names:
                slots[(n, li)] = pl[n]
        return slots

    def _own_weights(self):
        """Give the engine its own copy of every weight tensor it shares
        with the model (an integer weight, or a float one already in the
        compute dtype on the device), so a swap never writes the model
        that other engines may serve from. Once per engine: later swaps
        copy into the same tensors."""
        model_ptrs = {t.untyped_storage().data_ptr()
                      for t in self.model._gen_tensors()}
        self._set_weights({
            key: (t.clone() if t.untyped_storage().data_ptr() in model_ptrs
                  else t) for key, t in self._weight_slots().items()})

    @torch.no_grad()
    def swap_weights(self, arrays, version):
        """Live weight swap between steps (`serving/fleet/upgrade.py`):
        replace the parameters by a same-architecture checkpoint,
        `arrays` in the model's `_gen_tensors()` order (numpy arrays or
        tensors), through the cast `__init__` applies, so the swapped
        engine equals one built from the new checkpoint bit for bit.
        Each tensor is copied into the engine's own (the paged and
        grouped-matmul kernels read the same buffers after). The cached
        prefix blocks, computed under the old weights, are evicted.
        Refused (nothing changed): an engine-side quantized MoE stack
        (`moe_weight_dtype`), another tensor count, another shape, or a
        float tensor where the engine holds an integer one. The engine
        must be idle (drained)."""
        if self.moe_weight_dtype is not None:
            raise ValueError(
                "live weight swap on an engine-side quantized MoE stack is "
                "unsupported: the quantization transform is not "
                "shape-preserving per tensor - export a new bundle and "
                "boot a fresh replica instead")
        model = self.model._gen_tensors()
        if len(arrays) != len(model):
            raise ValueError(
                f"checkpoint has {len(arrays)} tensors, engine holds "
                f"{len(model)} - not the same architecture")
        new = [_as_host_tensor(a) for a in arrays]
        for t, ref in zip(new, model):
            if t.shape != ref.shape:
                raise ValueError(
                    f"weight shape {tuple(t.shape)} != engine shape "
                    f"{tuple(ref.shape)}: live swap requires an "
                    "architecture-identical checkpoint")
            if t.is_floating_point() != ref.is_floating_point():
                raise ValueError(
                    f"weight dtype {t.dtype} where the engine holds "
                    f"{ref.dtype}: not the same architecture")
        self._own_weights()
        slots = self._weight_slots()
        for name, t in zip(self.model.gen_names(), new):
            for key, v in self._engine_weights([(name, t)]).items():
                slots[key].copy_(v)
        # cached prefix KV was computed under the old weights
        if self.prefix_cache is not None:
            self.prefix_cache.evict_all()
        self.weights_version = str(version)

    def _quantize_moe_experts(self, dtype_str):
        """Quantize every layer's expert FFN weights (int8 with fp32
        scales, or nibble-packed int4 with fp16 scales), once, at build.
        As the JAX engine does, the compute-dtype copy is quantized
        (widened to fp32 first), so the bytes equal the reference's.
        Refused on a dense stack, on an unknown dtype and on experts that
        are already quantized."""
        if dtype_str not in ("int8", "int4"):
            raise ValueError(f"moe_weight_dtype={dtype_str!r} not "
                             "supported; use 'int8' or 'int4'")
        if not self.num_experts:
            raise ValueError("moe_weight_dtype needs a MoE decoder stack")
        if "ffn1_s" in self._layers[0] or "ffn2_s" in self._layers[0]:
            raise ValueError("model experts are already weight-only "
                             "quantized; build the float model and let "
                             "the engine quantize")
        bits = 4 if dtype_str == "int4" else 8
        with torch.no_grad():
            for pl in self._layers:
                for wname in ("ffn1_w", "ffn2_w"):
                    q, s = _quantize_expert_stack(pl[wname].float()[None],
                                                  bits)
                    pl[wname], pl[wname[:-2] + "_s"] = q[0], s[0]
        self.cfg = dataclasses.replace(self.cfg, moe_quant_bits=bits)

    def moe_utilization_entropy(self):
        """Normalised entropy of the cumulative per-expert token counts
        (1.0 = balanced; 0.0 = degenerate or no MoE)."""
        return moe_utilization_entropy(self.moe_expert_counts)

    def _note_moe_stats(self, counts, dropped, aux):
        """Fold one step's routing stats (already on the host) into the
        host mirrors and, while recording, the MoE metrics (per-expert
        token counters, dropped tokens, the aux-loss gauge and the
        cumulative utilization entropy)."""
        counts = np.asarray(counts, np.float64)
        self.moe_expert_counts += counts
        self.moe_dropped_total += float(dropped)
        self.moe_last_aux = float(aux)
        if _pmetrics._enabled:
            _pmetrics.record_moe_stats(
                "serving", counts, float(dropped), self.moe_last_aux,
                utilization=self.moe_utilization_entropy())

    # ------------------------------------------------------- mixed step
    def _step_cfg(self):
        """The decoder config the step runs under: the stack's, with the
        engine's expert bits. The TP engine gives the rank's heads and
        its process groups."""
        return self.cfg

    def _sync_outputs(self, outs):
        """The step's sampled outputs as every host decision reads them:
        here as they are; a TP engine takes rank 0's."""
        return outs

    @torch.no_grad()
    def _mixed_step(self, token_ids, slot_ids, positions, block_tables,
                    sample_index, counts=None, adapter_ids=None):
        """One fixed-shape step: [T] tokens -> (outputs, the MoE routing
        stats or None), with the pools updated in place. Outputs: the
        [S] sampled tokens; with speculation also the verify region's
        [S, K] scores — greedy (tok, tok_v), sampling (tok, tok_v,
        tok_res, acc), see `_verify_head`. `counts` [S, Vb]: the penalty
        histogram (penalized sampling only). `adapter_ids` [T]: each
        token's adapter slot (adapter engines only), one one-hot for
        every layer. Stats: per-expert counts
        and drops summed over the layers (fp32), the balance loss
        averaged over them."""
        cfg, BS = self._step_cfg(), self.block_size
        K = self.draft_k + 1
        T = token_ids.shape[0]
        valid = slot_ids >= 0
        pos = torch.where(valid, positions, 0)
        h = self.model._embed(self._we, self._pe, token_ids, pos)  # [T, D]
        safe_slot = torch.where(valid, slot_ids, 0)
        # padding tokens write into the reserved NULL block
        wb = torch.where(valid, block_tables[safe_slot, pos // BS], 0)
        wo = pos % BS
        moe = None
        kv = self.kv
        # what the summaries and the selection share across layers
        rows = (_summary_rows(wb, wo, valid, (T, kv.num_heads,
                                              kv.head_dim))
                if kv.summaries else None)
        sparse = (_sparse_plan(pos[:kv.max_slots * K].reshape(-1, K),
                               block_tables, self.sparse_table_width,
                               self._sparse_recent, BS)
                  if self._sparse else None)
        lora_oh = None
        if adapter_ids is not None:
            slots = torch.arange(self.adapters.max_adapters,
                                 device=adapter_ids.device)
            lora_oh = (adapter_ids.long()[:, None] == slots).float()
        for li, pl in enumerate(self._layers):
            scales = (kv.k_scale[li], kv.v_scale[li]) if kv.quantized \
                else (None, None)
            summaries = ((kv.k_sum_min[li], kv.k_sum_max[li], rows)
                         if kv.summaries else None)
            h, st = _mixed_layer(cfg, pl, h, kv.k_pool[li], kv.v_pool[li],
                                 wb, wo, block_tables, slot_ids, pos,
                                 *scales, kv.kv_dtype, K, self._region_slots,
                                 summaries, sparse, lora_oh)
            if st is not None:
                moe = st if moe is None else \
                    {k: moe[k] + st[k] for k in moe}
        xf = _ln(h, *self._lnf, cfg.epsilon)
        h_last = xf[sample_index.clamp(0, T - 1)]      # [S, D]
        logits = _mm(cfg, h_last, self._head)
        tok = select_token(logits, self.sampling, self._gen, counts=counts)
        if moe is not None:
            moe["aux"] = moe["aux"] / float(len(self._layers))
        if K == 1:
            return (tok,), moe
        return (tok,) + self._verify_head(xf, token_ids, counts), moe

    def _verify_head(self, xf, token_ids, counts=None):
        """Scores of the [S, K] verify region from the final hidden
        states xf [T, D].

        Greedy: (tok_v,), tok_v[s, j] the model's next token after slot
        s's j-th fed token; the host accepts the longest draft prefix
        matching it. Sampling (the n-gram draft is a point mass): draft
        d at position j is accepted w.p. min(1, p_j(d)), p_j =
        softmax(filter_logits(...)), the distribution non-speculative
        sampling draws from; a rejection emits a sample of p_j with d
        removed (tok_res), and a group whose drafts were all accepted
        emits a bonus sample of the full p at its last position (tok_v).
        Returns (tok_v, tok_res, acc). Draws come from the engine's
        generator, not JAX's stream.

        With penalties, position j is penalized by the count prior of
        the context a 1-token engine would have seen there: `counts`
        (which holds fed token 0 already) plus fed tokens 1..j."""
        S, K = self.kv.max_slots, self.draft_k + 1
        R = S * K
        lv = _mm(self.cfg, xf[:R], self._head).float().reshape(S, K, -1)
        fed = token_ids[:R].reshape(S, K).long()
        if counts is not None:
            Vb = counts.shape[-1]
            inc = torch.zeros((S, K, Vb), dtype=torch.float32,
                              device=lv.device)
            inc[:, 1:].scatter_(2, fed[:, 1:, None] % Vb, 1.0)
            prior = counts.float()[:, None, :] + torch.cumsum(inc, dim=1)
            lv = apply_count_penalties(lv, prior, self.sampling)
        if not self.spec_sampling:
            return (lv.argmax(dim=-1),)
        fl = filter_logits(lv, self.sampling)             # [S, K, V]
        V = fl.shape[-1]
        # fed token j+1 is scored by position j; the last column pads
        # with 0 (the host never reads its verdict)
        nxt = torch.cat([fed[:, 1:], torch.zeros_like(fed[:, :1])], 1)
        probs = torch.softmax(fl, dim=-1)
        p_draft = probs.gather(-1, nxt[..., None])[..., 0]
        acc = torch.rand((S, K), generator=self._gen,
                         device=self.device) < p_draft
        res = torch.softmax(fl.scatter(-1, nxt[..., None], -1e9), dim=-1)
        tok_res = torch.multinomial(res.reshape(R, V), 1,
                                    generator=self._gen).reshape(S, K)
        tok_v = torch.multinomial(probs.reshape(R, V), 1,
                                  generator=self._gen).reshape(S, K)
        return tok_v, tok_res, acc

    # ------------------------------------------------------------ host
    def register_adapter(self, adapter_id, weights):
        """Register a LoRA finetune's host weights (see
        `adapters.AdapterCache.register`); device slots are claimed at
        admission."""
        if self.adapters is None:
            raise ValueError(
                "this engine was built without adapter support "
                "(ServingEngine(max_adapters=...))")
        return self.adapters.register(adapter_id, weights)

    def submit(self, prompt_ids, max_new_tokens=32, deadline=None,
               tenant="default", adapter_id=None, trace_id=None):
        """Queue one request. Returns the scheduler's Request handle
        (read `.output` / `.state` as the engine advances). `adapter_id`
        names a registered LoRA adapter (None: the base model, the tokens
        of an engine without adapters); `tenant` and `trace_id` ride the
        request (the frontend's fairness lane, a fleet trace id)."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        maxpos = self.model.max_position_embeddings
        if len(prompt) + max_new_tokens > maxpos:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_position_embeddings "
                f"({maxpos})")
        if adapter_id is not None:
            if self.adapters is None:
                raise ValueError(
                    "request names an adapter but this engine was "
                    "built without adapter support (max_adapters=0)")
            if not self.adapters.known(adapter_id):
                raise ValueError(
                    f"adapter {adapter_id!r} is not registered on "
                    "this engine (register_adapter first)")
        req = self.scheduler.submit(prompt, max_new_tokens,
                                    eos_token_id=self.eos_token_id,
                                    deadline=deadline, tenant=tenant,
                                    adapter_id=adapter_id,
                                    trace_id=trace_id)
        if _pmetrics._enabled:
            smetrics.SERVING_QUEUE_DEPTH.set(len(self.scheduler.queue))
        return req

    def cancel(self, req):
        """Abort a request (the frontend's cancellation): its blocks and
        prefix locks are reclaimed at once. False when it had already
        ended."""
        ok = self.scheduler.cancel(req)
        if ok and _pmetrics._enabled:
            smetrics.SERVING_REQUESTS.labels("cancelled").inc()
        return ok

    # -------------------------------------------- migration (disagg)
    def _slot_chunk(self, req, first_block, last_block):
        """`req`'s table blocks [first_block, last_block) as one
        transport chunk (None when the range is empty)."""
        # the distributed package imports this module: import late
        from .distributed.transport import BlockChunk
        ids = self.kv.slot_blocks(req.slot)[first_block:last_block]
        if not ids:
            return None
        return BlockChunk(start=int(first_block), count=len(ids),
                          arrays=self.kv.export_blocks(ids))

    def export_unshipped(self, req):
        """The stream-ahead of a prefill in flight: the FULL blocks
        written since the last call, as a BlockChunk (or None). A full
        block's contents are final (later chunks write later blocks, and
        decode writes land past the prompt), so the decode side holds
        most of the KV before the handoff ticket exists."""
        if req.slot < 0:
            return None
        full = int(self.kv.slot_lens[req.slot]) // self.block_size
        chunk = self._slot_chunk(req, req.shipped_blocks, full)
        if chunk is not None:
            req.shipped_blocks = full
        return chunk

    def extract_request(self, req):
        """Take a resident request out of this engine to migrate it:
        export the blocks not streamed ahead yet (all of them for a
        decode shed), capture the host state, then free the slot.
        Returns the MigrationTicket the destination's `submit_migrated`
        takes. The ticket carries bit-exact KV (scales and summaries
        included) and the whole token history, so the destination goes
        on as this engine would have."""
        if req.slot < 0 or req.state not in ("decode", "handoff"):
            raise ValueError(
                f"request {req.req_id} not extractable "
                f"(state={req.state!r}, slot={req.slot})")
        from .distributed.transport import MigrationTicket
        slot_len = int(self.kv.slot_lens[req.slot])
        total = self.kv.blocks_for(slot_len)
        tail = self._slot_chunk(req, req.shipped_blocks, total)
        ticket = MigrationTicket(
            prompt=list(req.prompt), output=list(req.output),
            max_new_tokens=req.max_new_tokens,
            eos_token_id=req.eos_token_id, deadline=req.deadline,
            tenant=req.tenant, slot_len=slot_len, total_blocks=total,
            kv_meta=self.kv.kv_meta(), chunks=[tail] if tail else [],
            submit_time=req.submit_time,
            first_token_time=req.first_token_time,
            cache_hit_tokens=req.cache_hit_tokens,
            preemptions=req.preemptions, created_at=self.clock(),
            adapter_id=req.adapter_id, trace_id=req.trace_id)
        if _tracing._enabled:
            _tracing.on_extracted(req, ticket, self.name)
        self.scheduler.extract(req)
        if _pmetrics._enabled:
            smetrics.SERVING_REQUESTS.labels("migrated").inc()
        return ticket

    def submit_migrated(self, ticket):
        """Admit a migrated request: its pool geometry must equal this
        engine's, its chunks must cover `total_blocks`, and its adapter
        (if any) must be registered here; then the ticket is queued, and
        the scheduler imports its blocks into a slot at the next plan.
        Returns the Request handle."""
        mine = self.kv.kv_meta()
        theirs = dict(ticket.kv_meta or {})
        if theirs != mine:
            raise ValueError(
                f"migrated KV geometry {theirs} does not match this "
                f"engine's {mine}: disaggregated replicas must share "
                "block_size, kv_dtype and the layer geometry")
        covered = sum(c.count for c in ticket.chunks)
        if covered != ticket.total_blocks:
            raise ValueError(
                f"ticket carries {covered} blocks but declares "
                f"{ticket.total_blocks}: the transport lost a chunk")
        aid = ticket.adapter_id
        if aid is not None and (self.adapters is None
                                or not self.adapters.known(aid)):
            raise ValueError(
                f"migrated request needs adapter {aid!r}, which is not "
                "registered on this engine: register every adapter on "
                "every replica of a migrating fleet "
                "(ReplicaRouter.register_adapter does)")
        req = self.scheduler.submit_migrated(ticket)
        if _pmetrics._enabled:
            smetrics.SERVING_QUEUE_DEPTH.set(len(self.scheduler.queue))
        return req

    def _slot_adapters(self):
        """[max_slots] int32: each resident slot's pinned adapter slot (0
        for a free slot or a base-model request)."""
        slot_ad = np.zeros(self.kv.max_slots, np.int32)
        for s, req in enumerate(self.scheduler.slots):
            if req is not None:
                slot_ad[s] = req.adapter_slot
        return slot_ad

    def _adapter_token_ids(self, sp):
        """[T] int32 adapter slot ids of one packed step: each token takes
        its slot's pinned adapter slot, padding the null slot 0."""
        slot_ad = self._slot_adapters()
        return np.where(sp.slot_ids >= 0,
                        slot_ad[np.clip(sp.slot_ids, 0, None)],
                        0).astype(np.int32)

    def _emit_first(self, req, token, now, trace_on):
        """A completed prefill's first sampled token. On a prefill-role
        engine a request that did not finish at it parks in "handoff",
        every prompt token's K/V written, until the frontend extracts it
        toward a decode replica."""
        if not self._emit(req, [token], now, trace_on) \
                and self.role == "prefill":
            req.state = "handoff"
            if trace_on:
                _tracing.TRACER.event(req.trace_id, "handoff",
                                      replica=self.name, ts=now)

    def _emit(self, req, tokens, now, trace_on, verify=False):
        """Append generated tokens; finish the request at EOS or its
        horizon. Returns True when it finished. Observes the TTFT (the
        first token) or the inter-token gap, and records their span
        twins: the first_token event's ts minus the enqueued event's is
        `now - req.submit_time`, and a decode / verify event carries the
        same `gap`, so every span-derived value is the one the histogram
        observed."""
        if req.state == "prefill":
            req.state = "decode"
        first = req.first_token_time is None
        gap = None
        if first:
            req.first_token_time = now
            if _pmetrics._enabled:
                smetrics.SERVING_TTFT_SECONDS.observe(now - req.submit_time)
        elif req._last_token_time is not None:
            gap = now - req._last_token_time
            if _pmetrics._enabled:
                smetrics.SERVING_INTER_TOKEN_SECONDS.observe(gap)
        req._last_token_time = now
        if trace_on:
            if first:
                _tracing.on_first_token(req, self.name, ts=now)
            else:
                _tracing.on_tokens(req, self.name, ts=now, n=len(tokens),
                                   gap=gap, verify=verify)
        for token in tokens:
            req.output.append(token)
            if len(req.output) >= req.max_new_tokens or (
                    req.eos_token_id is not None
                    and token == req.eos_token_id):
                self.scheduler.finish(req, now)
                if _pmetrics._enabled:
                    smetrics.SERVING_REQUESTS.labels("finished").inc()
                return True
        return False

    def _trace_prefills(self, plan, now):
        """One prefill_chunk span a planned chunk (a slot's resident is
        the chunk's request: admissions happen only inside plan())."""
        for slot, chunk, start, completes in plan.prefills:
            req = self.scheduler.slots[slot]
            if req is not None:
                _tracing.TRACER.event(
                    req.trace_id, "prefill_chunk", replica=self.name,
                    ts=now, start=int(start), tokens=len(chunk),
                    completes=bool(completes))

    def _record_step(self, prefill_tokens, decode_tokens):
        """Publish one step's (or dispatch's) registry metrics: the step
        and token counters, the queue, slot and pool gauges, and the
        sparse decode's skipped blocks and attended share."""
        sch, kv = self.scheduler, self.kv
        smetrics.SERVING_STEPS.inc()
        smetrics.SERVING_TOKENS.labels("prefill").inc(prefill_tokens)
        smetrics.SERVING_TOKENS.labels("decode").inc(decode_tokens)
        smetrics.SERVING_QUEUE_DEPTH.set(len(sch.queue))
        smetrics.SERVING_ACTIVE_SLOTS.set(sch.num_active)
        smetrics.SERVING_KV_BLOCKS_IN_USE.set(kv.blocks_in_use)
        smetrics.SERVING_KV_BLOCK_UTILIZATION.set(kv.utilization)
        smetrics.SERVING_KV_BYTES_PER_TOKEN.set(self._kv_bytes_per_token())
        if self._sparse and self.sparse_candidate_blocks:
            skipped = (self.sparse_candidate_blocks
                       - self.sparse_selected_blocks)
            if skipped > self._sparse_skip_seen:
                smetrics.SERVING_KV_BLOCKS_SKIPPED.inc(
                    skipped - self._sparse_skip_seen)
                self._sparse_skip_seen = skipped
            smetrics.SERVING_SPARSE_ATTENTION_RATIO.set(
                self.sparse_selected_blocks / self.sparse_candidate_blocks)

    def _kv_bytes_per_token(self):
        """The bytes one cached token costs across K+V and every layer
        (the TP engine counts every rank's heads)."""
        return self.kv.kv_bytes_per_token

    def _record_deltas(self, publish):
        """Advance the preemption, imported-block and prefix-cache delta
        bases, publishing each delta when `publish`."""
        sch, kv, pc = self.scheduler, self.kv, self.prefix_cache
        new_p = sch.preemption_count - self._preempt_seen
        if new_p and publish:
            smetrics.SERVING_PREEMPTIONS.inc(new_p)
        new_imp = kv.blocks_imported - self._imported_seen
        if new_imp and publish:
            smetrics.SERVING_KV_BLOCKS_MIGRATED.inc(new_imp)
        self._preempt_seen = sch.preemption_count
        self._imported_seen = kv.blocks_imported
        if pc is not None:
            h0, m0, e0 = self._prefix_seen
            if publish:
                if pc.hit_tokens > h0:
                    smetrics.SERVING_PREFIX_HIT_TOKENS.inc(
                        pc.hit_tokens - h0)
                if pc.miss_tokens > m0:
                    smetrics.SERVING_PREFIX_MISS_TOKENS.inc(
                        pc.miss_tokens - m0)
                if pc.evictions > e0:
                    smetrics.SERVING_PREFIX_EVICTIONS.inc(
                        pc.evictions - e0)
            self._prefix_seen = (pc.hit_tokens, pc.miss_tokens,
                                 pc.evictions)

    def _note_flight(self, t0, prefill_tokens, decode_tokens, spec_accept,
                     spec_groups, **fields):
        """One flight record: host ints and floats the step holds. The
        port has no jit cache, so `compile_cache_size` is -1, the value
        the JAX engine records when its cache probe fails."""
        sch = self.scheduler
        self.flight.note(
            ts=t0, dur=self.clock() - t0,
            prefill_tokens=int(prefill_tokens),
            decode_tokens=int(decode_tokens),
            active_slots=int(sch.num_active), queue_depth=len(sch.queue),
            spec_accept_tokens=spec_accept, spec_groups=spec_groups,
            sparse_skip_ratio=(self.sparse_skip_ratio() if self._sparse
                               else 0.0),
            blocks_imported=int(self.kv.blocks_imported),
            compile_cache_size=-1, **fields, **self._flight_extra())

    def flush_observability(self):
        """Publish observability a dispatch deferred. The port's engines
        publish every step's metrics and flight record at its end (it
        has no asynchronous multi-tick harvest), so this is a no-op, as
        on the JAX package's synchronous engines; the frontend calls it
        when its step loop goes idle."""

    def _penalty_counts(self):
        """[max_slots, penalty_vocab_bins] float32 histogram of each
        resident slot's last `penalty_window` tokens (prompt and
        generated), token t in bin t % bins — the penalties' input,
        built on the host each dispatch."""
        W = int(self.sampling.penalty_window)
        Vb = self._penalty_bins
        cnt = np.zeros((self.kv.max_slots, Vb), np.float32)
        for slot, req in enumerate(self.scheduler.slots):
            if req is None:
                continue
            toks = req.runtime_prompt[-W:]
            if toks:
                np.add.at(cnt[slot], np.asarray(toks, np.int64) % Vb, 1.0)
        return cnt

    def _token_ring(self, width):
        """Each resident slot's last `width` tokens as a ring: [max_slots,
        width] int64 with token i of the sequence at column i % width,
        and the [max_slots] sequence lengths (the layout
        `ring_chronological` reads)."""
        S = self.kv.max_slots
        ring = np.zeros((S, width), np.int64)
        lens = np.zeros(S, np.int64)
        for slot, req in enumerate(self.scheduler.slots):
            if req is None:
                continue
            toks = req.runtime_prompt
            n = len(toks)
            w = min(n, width)
            if w:
                ring[slot, np.arange(n - w, n) % width] = toks[-w:]
            lens[slot] = n
        return ring, lens

    def step(self):
        """One engine iteration (a dispatch of one or more ticks).
        Returns True when any work (tokens or expiries) happened, False
        when the engine is idle/starved."""
        sch = self.scheduler
        # tracing is sampled once a step: a monitor attaching midway
        # leaves this step's records consistent
        trace_on = _tracing._enabled
        t0 = self.clock() if trace_on else None
        plan = sch.plan()
        if _pmetrics._enabled and plan.expired:
            for _ in plan.expired:
                smetrics.SERVING_REQUESTS.labels("expired").inc()
        if plan.empty:
            return bool(plan.expired)
        if self._multitick:
            return self._step_multitick(plan, trace_on, t0)
        sp = pack_step(self.token_budget, self.kv.max_slots, plan.decode,
                       plan.prefills, verify_width=self.draft_k + 1,
                       reserve_region=self._sparse)
        inputs = [torch.from_numpy(a).to(self.device) for a in
                  (sp.token_ids, sp.slot_ids, sp.positions,
                   self.kv.block_tables, sp.sample_index)]
        if self._penalized:
            inputs.append(
                torch.from_numpy(self._penalty_counts()).to(self.device))
        lora = {}
        if self.adapters is not None:
            lora["adapter_ids"] = torch.from_numpy(
                self._adapter_token_ids(sp)).to(self.device)
        outs, moe = self._mixed_step(*inputs, **lora)
        outs = self._sync_outputs(outs)
        # every output (and the MoE stats) rides one copy to the host
        parts = list(outs)
        if moe is not None:
            parts += [moe["counts"], moe["dropped"], moe["aux"]]
        host = _to_host(parts)
        if moe is not None:
            counts, dropped, aux = host[-3:]
            self._note_moe_stats(counts, dropped, aux)
            host = host[:-3]
        tok_np = host[0].astype(np.int64)
        sch.note_fed(plan)
        self.tokens_fed += int((sp.slot_ids >= 0).sum())
        self.prefill_tokens_fed += sp.prefill_tokens
        self.steps_run += 1
        if self._sparse:
            # each decode's group attends min(allocated, Bt) blocks
            for _slot, toks, pos in sp.decode_entries:
                self._note_sparse(pos + len(toks) - 1)
        now = self.clock()
        if trace_on:
            self._trace_prefills(plan, now)
        for slot in sp.prefill_done:
            req = sch.slots[slot]
            if req is not None:
                self._emit_first(req, int(tok_np[slot]), now, trace_on)
        spec_accept = spec_groups = 0
        if self.draft_k:
            spec_accept, spec_groups = self._harvest_verify(sp, host, now,
                                                            trace_on)
        else:
            for slot in sp.decode_slots:
                req = sch.slots[slot]
                if req is not None:
                    self._emit(req, [int(tok_np[slot])], now, trace_on)
        if _pmetrics._enabled:
            self._record_step(sp.prefill_tokens, sp.decode_tokens)
            self._record_deltas(True)
        if trace_on:
            self._note_flight(t0, sp.prefill_tokens, sp.decode_tokens,
                              spec_accept, spec_groups)
        return True

    def _harvest_verify(self, sp, host, now, trace_on):
        """The 1-tick step's verify groups: accept each decode's drafts,
        emit, roll back the blocks rejected drafts had claimed, and
        record the accept lengths and draft counters. Returns (tokens
        emitted, groups)."""
        sch = self.scheduler
        tok_v = host[1].astype(np.int64)
        if self.spec_sampling:
            tok_res, acc = host[2].astype(np.int64), host[3] != 0
        spec_accept = spec_groups = 0
        for slot, toks, pos in sp.decode_entries:
            req = sch.slots[slot]
            if req is None:
                continue
            if self.spec_sampling:
                # accepted drafts re-emit the fed tokens, then the
                # residual resample (rejection at m) or the bonus sample
                # (every draft accepted)
                m = accept_length_sampled(toks, acc[slot])
                emitted = [int(t) for t in toks[1:m + 1]]
                emitted.append(int(tok_v[slot][m]) if m == len(toks) - 1
                               else int(tok_res[slot][m]))
            else:
                m = accept_length(toks, tok_v[slot])
                emitted = [int(t) for t in tok_v[slot][:m + 1]]
            self.spec_proposed_total += len(toks) - 1
            self.spec_accepted_total += m
            if _pmetrics._enabled:
                smetrics.SERVING_ACCEPT_LENGTH.observe(m + 1)
                if len(toks) > 1:
                    smetrics.SERVING_DRAFT_TOKENS.labels("proposed").inc(
                        len(toks) - 1)
                    smetrics.SERVING_DRAFT_TOKENS.labels("accepted").inc(m)
            spec_accept += m + 1
            spec_groups += 1
            if not self._emit(req, emitted, now, trace_on, verify=True):
                # roll back blocks whose only contents were
                # rejected-draft K/V
                freed = sch.note_accept(slot, pos + m + 1)
                if freed and _pmetrics._enabled:
                    smetrics.SERVING_SPEC_ROLLBACKS.inc()
                    smetrics.SERVING_SPEC_ROLLBACK_BLOCKS.inc(freed)
        return spec_accept, spec_groups

    def _note_sparse(self, last):
        """Account one decode query group whose newest position is
        `last`: its allocated blocks are the candidates, at most the
        table width of them selected."""
        n_blk = last // self.block_size + 1
        self.sparse_candidate_blocks += n_blk
        self.sparse_selected_blocks += min(n_blk, self.sparse_table_width)

    def sparse_skip_ratio(self):
        """The share of candidate KV blocks the sparse decode skipped
        (0.0 when dense or before any decode)."""
        if not self.sparse_candidate_blocks:
            return 0.0
        return 1.0 - (self.sparse_selected_blocks
                      / self.sparse_candidate_blocks)

    def close(self, *, spill_prefix=None):
        """Release the engine's cached KV state: drop every cached
        prefix block, after writing the tree and its blocks to
        `spill_prefix` when given (`RadixPrefixCache.spill`; a later
        engine's `prefix_cache.restore` reads it). The engine must be
        drained. Returns the number of blocks spilled."""
        spilled = 0
        if self.prefix_cache is not None:
            if spill_prefix is not None:
                spilled = self.prefix_cache.spill(spill_prefix)
            self.prefix_cache.evict_all()
        return spilled

    # ---------------------------------------------- multi-tick dispatch
    def _auto_ticks(self, n_max):
        """ticks_per_dispatch="auto": the smallest n that keeps the host
        gap between dispatches (EMA h) under a tenth of the ticks' time
        (EMA d a tick), ceil(h / (0.1 d)), at most `n_max`. Cold EMAs
        take n_max (the measurement itself)."""
        d, h = self._tick_ema, self._gap_ema
        if not d or not h:
            return n_max
        return max(1, min(n_max, math.ceil(h / max(0.1 * d, 1e-9))))

    def _step_multitick(self, plan, trace_on, t0):
        """The multi-tick dispatch: preallocate each decode's tick
        capacity, upload the plan once, enqueue the ticks
        (`_run_ticks`), read the control block back in one copy, and
        replay the staged tokens through the same bookkeeping as
        `step()`. Only a pure-decode dispatch runs more than one tick:
        a prefill chunk needs the host packer next step anyway."""
        sch = self.scheduler
        S, K = self.kv.max_slots, self.draft_k + 1
        t_launch = self._timer()
        if self._gap_ema is not None or self._last_harvest is not None:
            gap = max(t_launch - (self._last_harvest or t_launch), 0.0)
            self._gap_ema = (gap if self._gap_ema is None
                             else 0.7 * self._gap_ema + 0.3 * gap)
        sp = pack_step(self.token_budget, S, plan.decode, plan.prefills,
                       verify_width=K, reserve_region=self._sparse)
        n = self.ticks_per_dispatch if not plan.prefills else 1
        if n > 1 and self._ticks_auto:
            n = self._auto_ticks(self.ticks_per_dispatch)
        multi = n > 1
        mapped = n * K > 1           # ticks' capacity mapped ahead
        eos = np.full(S, -1, np.int64)
        remain = np.zeros(S, np.int64)
        cap = np.zeros(S, np.int64)
        for slot, _tok, pos in plan.decode:
            req = sch.slots[slot]
            if req.eos_token_id is not None:
                eos[slot] = int(req.eos_token_id)
            remain[slot] = req.max_new_tokens - len(req.output)
            # free blocks for every token the ticks may write, as JAX's
            # loop maps them (with a prefix cache this may evict idle
            # cached blocks); the block tables are uploaded after this,
            # so later ticks' appends land in mapped blocks
            cap[slot] = (sch.extend_for_ticks(slot, pos, n * K)
                         if mapped else pos + 1)
        # issue no tick past an exit the host can foresee: every tick
        # emits at least one token of a live decode, so a slot finishes
        # within `remain` ticks and passes its capacity within cap - pos
        # (ticks past an exit would run, and change nothing)
        if plan.decode:
            n = min(n, min(min(int(remain[s]), int(cap[s]) - p)
                           for s, _t, p in plan.decode))
        host = dict(token_ids=sp.token_ids, slot_ids=sp.slot_ids,
                    positions=sp.positions,
                    block_tables=self.kv.block_tables,
                    sample_index=sp.sample_index, eos=eos, remain=remain,
                    cap=cap)
        if self._penalized:
            host["counts"] = self._penalty_counts()
            host["pen_ring"], host["pen_len"] = self._token_ring(
                int(self.sampling.penalty_window))
        if K > 1:
            host["ring"], host["ring_len"] = self._token_ring(
                self.draft_ring)
        if self.adapters is not None:
            host["adapter_ids"] = self._adapter_token_ids(sp)
            host["slot_ad"] = self._slot_adapters()
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in host.items()}
        ctl, gen_states = self._run_ticks(dev, n)
        parts = [ctl["staged"], ctl["counts"], ctl["events"], ctl["ticks"],
                 ctl["fed"]]
        if K > 1:
            parts += [ctl["spec_proposed"], ctl["spec_hist"]]
        if self.num_experts:
            parts += [ctl["moe"][k] for k in ("counts", "dropped", "aux")]
        hs0 = self._timer()
        out = _to_host(parts)                       # the one readback
        host_stall = self._timer() - hs0
        self.host_stall_total += host_stall
        staged = out[0].astype(np.int64)
        emitted_n = out[1].astype(np.int64)
        events = out[2].astype(np.int64)
        ticks_run = int(out[3])
        if ticks_run < n and gen_states:
            # the ticks past the exit drew from the generator as well:
            # take it back to where the first of them found it
            self._gen.set_state(gen_states[ticks_run])
        self._last_harvest = self._timer()
        d = (self._last_harvest - t_launch) / ticks_run
        self._tick_ema = (d if self._tick_ema is None
                          else 0.7 * self._tick_ema + 0.3 * d)
        if self._gap_ema is None:
            self._gap_ema = 0.0
        self.tokens_fed += int(out[4])
        self.prefill_tokens_fed += sp.prefill_tokens
        spec_prop = spec_acc = 0
        spec_hist = None
        if K > 1:
            spec_prop = int(out[5])
            # spec_hist[b]: the verify groups that accepted b drafts
            spec_hist = [int(x) for x in out[6]]
            spec_acc = sum(b * c for b, c in enumerate(spec_hist))
            self.spec_proposed_total += spec_prop
            self.spec_accepted_total += spec_acc
        if self.num_experts:
            counts, dropped, aux = out[-3:]
            # counts and drops sum over the ticks that counted; aux is
            # their mean
            self._note_moe_stats(counts, dropped, float(aux) / ticks_run)
        sch.note_fed(plan)
        self.steps_run += 1
        self.dispatches_run += 1
        self.device_ticks_run += ticks_run
        self.device_ticks_issued += n
        if mapped:
            # each decode advances to what the device emitted and gives
            # back the preallocated tail (and any rejected drafts'
            # blocks): block state at every dispatch boundary is the
            # 1-tick engine's
            for slot, _tok, pos in plan.decode:
                freed = sch.note_accept(slot,
                                        pos + max(int(emitted_n[slot]), 1))
                # blocks rejected drafts had claimed: spec rollbacks
                if freed and K > 1 and _pmetrics._enabled:
                    smetrics.SERVING_SPEC_ROLLBACKS.inc()
                    smetrics.SERVING_SPEC_ROLLBACK_BLOCKS.inc(freed)
        if self._sparse:
            # every emitted token's query group, as the JAX loop counts
            for slot, _tok, pos in plan.decode:
                for j in range(max(int(emitted_n[slot]), 1)):
                    self._note_sparse(pos + j)
        now = self.clock()
        if trace_on:
            self._trace_prefills(plan, now)
        for slot in sp.prefill_done:
            req = sch.slots[slot]
            if req is not None:
                self._emit_first(req, int(staged[slot, 0]), now, trace_on)
        decode_emitted = 0
        for slot in sp.decode_slots:
            req = sch.slots[slot]
            if req is not None:
                c = max(int(emitted_n[slot]), 1)
                decode_emitted += c
                self._emit(req, [int(t) for t in staged[slot, :c]], now,
                           trace_on)
        ev_finish = ev_over = 0
        if multi:
            ev_finish = int(((events & 1) > 0).sum())
            ev_over = int(((events & 2) > 0).sum())
            self.early_exit_counts["finish"] += ev_finish
            self.early_exit_counts["overflow"] += ev_over
        if _pmetrics._enabled:
            self._record_step(sp.prefill_tokens, decode_emitted)
            smetrics.SERVING_TICKS_PER_DISPATCH.observe(ticks_run)
            smetrics.SERVING_HOST_STALL_SECONDS.inc(host_stall)
            if ev_finish:
                smetrics.SERVING_EARLY_EXITS.labels("finish").inc(ev_finish)
            if ev_over:
                smetrics.SERVING_EARLY_EXITS.labels("overflow").inc(ev_over)
            if spec_prop:
                smetrics.SERVING_DRAFT_TOKENS.labels("proposed").inc(
                    spec_prop)
                smetrics.SERVING_DRAFT_TOKENS.labels("accepted").inc(
                    spec_acc)
            # one accept-length observation a verify group, m + 1 for a
            # group that accepted m drafts (the 1-tick path's)
            for b, cnt in enumerate(spec_hist or ()):
                for _ in range(cnt):
                    smetrics.SERVING_ACCEPT_LENGTH.observe(b + 1)
        self._record_deltas(_pmetrics._enabled)
        if trace_on:
            groups = sum(spec_hist) if spec_hist else 0
            self._note_flight(
                t0, sp.prefill_tokens, decode_emitted,
                spec_acc + groups if spec_hist else 0, groups,
                ticks=ticks_run, host_stall=host_stall,
                early_exit_finish=ev_finish, early_exit_overflow=ev_over)
        return True

    @torch.no_grad()
    def _run_ticks(self, d, n):
        """Enqueue `n` ticks of one dispatch on the device, with no host
        read between them (nothing here synchronizes). `d` holds the
        dispatch's device tensors: the packed plan (`token_ids`,
        `slot_ids`, `positions`, `block_tables`, `sample_index`), per
        slot `eos` (-1 = none), `remain` (tokens left to its horizon) and
        `cap` (its preallocated capacity), and as the engine needs them
        the penalty `counts` with their window ring (`pen_ring`,
        `pen_len`), the draft ring (`ring`, `ring_len`), and the packed
        plan's adapter slot ids (`adapter_ids`) with each slot's
        (`slot_ad`), which a later tick's rebuilt tokens take.

        Tick 0 takes the packed plan; a later tick rebuilds the pure-
        decode inputs at the pack-time anchors (`sample_index`, or with
        speculation the verify region's s*K columns), as `pack_step`
        lays out the next step. With speculation every tick widens each
        live decode to [last, d_1..d_k] from the draft ring
        (`ngram_propose_device`), k clamped to the horizon and to `cap`
        as the host drafter clamps it, and drafts past k stay padding,
        as `pack_step` leaves them. After each tick the accept roll, the
        EOS cut, the staging buffer, the rings and the penalty window
        advance; a finish (event bit 1: EOS or horizon) or an overflow
        (bit 2: the next tick would pass `cap`) ends the dispatch. Every
        later tick runs with no live slot: its tokens are padding (their
        K/V lands in the null block), and no state, count or MoE
        statistic moves.

        Returns (control, generator states): control holds `staged`
        [S, N*K] (-1 padded), per-slot emitted `counts` and `events`,
        `ticks` (the ticks that counted), `fed` (valid tokens), with
        speculation `spec_proposed` and `spec_hist` [K] (the live verify
        groups that accepted b drafts, at b; the accepted drafts are
        sum(b * spec_hist[b])), and with MoE the
        routing stats summed over the ticks that counted; a sampling
        engine also gets its generator's state before each tick."""
        S, T = self.kv.max_slots, self.token_budget
        K, N = self.draft_k + 1, self.ticks_per_dispatch
        dev = self.device
        i32, i64 = torch.int32, torch.int64
        token_ids, slot_ids, positions = (d["token_ids"], d["slot_ids"],
                                          d["positions"])
        block_tables, anchors = d["block_tables"], d["sample_index"]
        eos, remain, cap = d["eos"], d["remain"], d["cap"]
        adapter_ids, slot_ad = d.get("adapter_ids"), d.get("slot_ad")
        aid = None
        slot_iota = torch.arange(S, device=dev)
        iota_k = torch.arange(K, device=dev)[None, :]
        if K == 1:
            live = anchors >= 0
            dec0 = live
            cur_pos = torch.where(
                live, positions[anchors.clamp(0, T - 1).long()], 0).long()
            prev_tok = torch.zeros(S, dtype=i64, device=dev)
        else:
            # the host packs [last] at column s*K of each decoding slot;
            # prefill completions sample through the token head
            base = slot_iota * K
            dec0 = slot_ids[base] == slot_iota
            live = dec0 | (anchors >= 0)
            cur_pos = torch.where(dec0, positions[base], 0).long()
            prev_tok = token_ids[base].long()
            region = (base[:, None] + iota_k).reshape(-1)       # [S*K]
            ring, ring_len = d["ring"], d["ring_len"]
            Wr = self.draft_ring
            ring = torch.cat([ring, ring.new_zeros(S, 1)], 1)  # + a dump
            spec_prop = torch.zeros((), dtype=i64, device=dev)
            spec_hist = torch.zeros(K, dtype=i64, device=dev)
        if self._penalized:
            cnt, pen_ring, pen_len = d["counts"], d["pen_ring"], d["pen_len"]
            W, Vb = int(self.sampling.penalty_window), self._penalty_bins
        else:
            cnt = None
        staged = torch.full((S, N * K + 1), -1, dtype=i64, device=dev)
        counts = torch.zeros(S, dtype=i64, device=dev)
        events = torch.zeros(S, dtype=i64, device=dev)
        ticks = torch.ones((), dtype=i64, device=dev)
        fed_total = torch.zeros((), dtype=i64, device=dev)
        mstats = None
        gen_states = []
        sampling = self.sampling.strategy != "greedy"

        def scattered(base_vals, at, vals):
            """base_vals [T] with vals written at flat indices `at`
            (index T drops the write)."""
            buf = torch.cat([base_vals, base_vals.new_zeros(1)])
            buf[at] = vals.to(buf.dtype)
            return buf[:T]

        for t in range(n):
            if t:
                # JAX's while_loop condition, as a mask: after the first
                # event no slot is live
                go = (events == 0).all() & live.any()
                live = live & go
                ticks = ticks + go.long()
            live_dec = live & dec0
            if K == 1:
                if t == 0:
                    tid, sid, pid, si = (token_ids, slot_ids, positions,
                                         anchors)
                else:
                    at = torch.where(live, anchors.long(), T)
                    tid = scattered(torch.zeros_like(token_ids), at,
                                    prev_tok)
                    sid = scattered(torch.full_like(slot_ids, -1), at,
                                    slot_iota)
                    pid = scattered(torch.zeros_like(positions), at,
                                    cur_pos)
                    si = torch.where(live, anchors, -1)
                if slot_ad is not None:
                    aid = (adapter_ids if t == 0 else
                           scattered(torch.zeros_like(adapter_ids), at,
                                     slot_ad))
            else:
                drafts = ngram_propose_device(
                    ring_chronological(ring[:, :Wr], ring_len), ring_len,
                    K - 1, max_ngram=self.draft_ngram)
                fed = torch.cat([prev_tok[:, None], drafts], 1)  # [S, K]
                k_eff = torch.clamp(torch.minimum(
                    remain - counts - 1, cap - cur_pos - 1), 0, K - 1)
                on = live_dec[:, None] & (iota_k <= k_eff[:, None])
                at = torch.where(on.reshape(-1), region, T)
                first = t == 0
                tid = scattered(token_ids if first
                                else torch.zeros_like(token_ids), at,
                                fed.reshape(-1))
                sid = scattered(slot_ids if first
                                else torch.full_like(slot_ids, -1), at,
                                slot_iota[:, None].expand(S, K).reshape(-1))
                pid = scattered(positions if first
                                else torch.zeros_like(positions), at,
                                (cur_pos[:, None] + iota_k).reshape(-1))
                si = anchors if first else torch.full_like(anchors, -1)
                if slot_ad is not None:
                    aid = scattered(adapter_ids if first
                                    else torch.zeros_like(adapter_ids), at,
                                    slot_ad[:, None].expand(S, K).reshape(-1))
            if sampling:
                gen_states.append(self._gen.get_state())
            outs, moe = self._mixed_step(tid, sid, pid, block_tables, si,
                                         cnt, aid)
            outs = self._sync_outputs(outs)
            if K == 1:
                tok = outs[0]
                emitted = tok[:, None]
                e = live.long()
            else:
                tok = outs[0]
                kk = k_eff[:, None]
                if self.spec_sampling:
                    _, tok_v, tok_res, acc = outs
                    flags = acc[:, :K - 1] & (iota_k[:, :K - 1] < kk)
                    m = torch.cumprod(flags.long(), 1).sum(1)
                    # accepted drafts re-emit the fed tokens, then the
                    # bonus sample (all k accepted) or the residual one
                    fin = torch.where((m == k_eff)[:, None],
                                      tok_v.gather(1, m[:, None]),
                                      tok_res.gather(1, m[:, None]))
                    emitted = torch.cat([fed[:, 1:], torch.zeros_like(fed[:, :1])],
                                        1)
                    emitted = torch.where(iota_k == m[:, None], fin, emitted)
                else:
                    _, tok_v = outs
                    eq = (fed[:, 1:] == tok_v[:, :K - 1]) & (
                        iota_k[:, :K - 1] < kk)
                    m = torch.cumprod(eq.long(), 1).sum(1)
                    emitted = tok_v
                # a prefill completion emits its one sampled token
                anch = live & ~dec0
                e = torch.where(anch, 1, torch.where(live, m + 1, 0))
                emitted = torch.where(
                    anch[:, None], torch.where(iota_k == 0, tok[:, None], -1),
                    emitted)
            # EOS cut: the first EOS inside the emitted run ends it
            hit = (iota_k < e[:, None]) & (eos[:, None] >= 0) & (
                emitted == eos[:, None])
            any_hit = hit.any(1)
            e = torch.where(any_hit, hit.long().argmax(1) + 1, e)
            took = live[:, None] & (iota_k < e[:, None])         # [S, K]
            staged.scatter_(1, torch.where(took, counts[:, None] + iota_k,
                                           N * K), emitted)
            counts = counts + e
            finish = live & (any_hit | (counts >= remain))
            nxt = cur_pos + torch.where(live_dec, e, 0)
            overflow = live & ~finish & (nxt >= cap)
            events = events | torch.where(finish, 1, 0) | torch.where(
                overflow, 2, 0)
            if cnt is not None:
                # slide each slot's penalty window over its new tokens:
                # token i enters, token i - W leaves (same ring column)
                for j in range(K):
                    ok = took[:, j]
                    at_j = pen_len + j
                    col = (at_j % W)[:, None]
                    old = pen_ring.gather(1, col)[:, 0]
                    gone = (ok & (at_j >= W)).float()
                    cnt.scatter_add_(1, (old % Vb)[:, None], -gone[:, None])
                    new = emitted[:, j]
                    cnt.scatter_add_(1, (new % Vb)[:, None],
                                     ok.float()[:, None])
                    pen_ring.scatter_(1, col,
                                      torch.where(ok, new, old)[:, None])
                pen_len = pen_len + e
            if K == 1:
                prev_tok = emitted[:, 0]
            else:
                prev_tok = torch.where(
                    live_dec, emitted.gather(
                        1, (e - 1).clamp_min(0)[:, None])[:, 0], prev_tok)
                ring.scatter_(1, torch.where(
                    live_dec[:, None] & (iota_k < e[:, None]),
                    (ring_len[:, None] + iota_k) % Wr, Wr), emitted)
                ring_len = ring_len + torch.where(live_dec, e, 0)
                ld = live_dec.long()
                spec_prop = spec_prop + (k_eff * ld).sum()
                # m <= K - 1 (no clamp); the host takes the accepted
                # total from this histogram, one launch a tick
                spec_hist.scatter_add_(0, m, ld)
            live = live & ~finish & ~overflow
            cur_pos = nxt
            fed_total = fed_total + (sid >= 0).sum()
            if moe is not None:
                mstats = moe if t == 0 else {
                    k: mstats[k] + torch.where(go, moe[k], 0)
                    for k in mstats}
        ctl = dict(staged=staged[:, :N * K], counts=counts, events=events,
                   ticks=ticks, fed=fed_total, moe=mstats)
        if K > 1:
            ctl.update(spec_proposed=spec_prop, spec_hist=spec_hist)
        return ctl, gen_states

    def run(self, max_steps=None):
        """Drive until every submitted request reaches a terminal
        state (or max_steps). Returns the number of steps taken."""
        steps = 0
        while self.scheduler.has_work:
            if max_steps is not None and steps >= max_steps:
                break
            if not self.step():
                raise RuntimeError(
                    "serving engine stalled: requests remain but no "
                    "step can be planned — the KV block pool "
                    f"({self.kv.allocator.capacity} blocks of "
                    f"{self.block_size}) cannot cover the resident "
                    "working set; raise num_blocks or lower max_slots")
            steps += 1
        return steps

    def generate_batch(self, prompts, max_new_tokens=32):
        """Submit a batch and drive to completion. Returns one list of
        generated token ids per prompt (stops at EOS inclusive)."""
        reqs = [self.submit(p, max_new_tokens) for p in prompts]
        self.run()
        return [list(r.output) for r in reqs]
