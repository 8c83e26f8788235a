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

Not ported (raises `NotImplementedError`; ROADMAP Queue 1):
block-sparse decode (`sparse_blocks`); adapters, the prefix cache and
disaggregated roles are not arguments yet.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .._device import resolve_device
from ..incubate.nn.fused_transformer import (_ffn_dense, _ffn_moe_tokens,
                                             _ln, _mm, _qkv,
                                             _quantize_expert_stack)
from ..ops.paged_attention import (MAX_GROUP, ragged_paged_attention,
                                   verify_paged_attention)
from .batcher import (SamplingConfig, apply_count_penalties,
                      choose_token_budget, filter_logits, needs_history,
                      pack_step, select_token)
from .draft import (accept_length, accept_length_sampled, ngram_propose,
                    ngram_propose_device, ring_chronological)
from .kv_cache import FP8_MAX, PagedKVCache
from .scheduler import Scheduler


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


def _mixed_layer(cfg, pl, h, k_pool, v_pool, wb, wo, block_tables,
                 slot_ids, pos, k_scale=None, v_scale=None, kv_dtype=None,
                 verify_width=1, region_slots=None):
    """One decoder layer of the mixed step on the flat token axis.

    h [T, D]; pl the layer's parameters; k_pool/v_pool this layer's
    `[NB, BS, H, Dh]` pools, with `k_scale`/`v_scale` `[NB, BS, H]` when
    `kv_dtype` is "int8" or "fp8_e4m3"; (wb, wo) [T] the block and
    offset each token's K/V lands at (padding tokens aim at the NULL
    block). With `verify_width` K > 1 the first S*K tokens are the
    verify region: slot s's group attends through the verify entry
    (`region_slots` = arange(S)), the rest through the ragged entry.
    Returns (h, the MoE layer's routing stats or None)."""
    T = h.shape[0]
    H, Dh = cfg.num_heads, cfg.head_dim
    hn = _ln(h, pl["ln_s"], pl["ln_b"], cfg.epsilon)
    q, k, v = _qkv(cfg, pl, hn[None])
    q, k, v = q[0], k[0], v[0]                       # [T, H, Dh]
    _append_kv(k_pool, k_scale, wb, wo, k, kv_dtype)
    _append_kv(v_pool, v_scale, wb, wo, v, kv_dtype)
    q = q.contiguous()
    if verify_width == 1:
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
    out = _mm(attn.reshape(T, cfg.embed_dim), pl["out_w"])
    h = h + (out + pl["out_b"].to(out.dtype))
    hn = _ln(h, pl["ffn_ln_s"], pl["ffn_ln_b"], cfg.epsilon)
    if cfg.num_experts:
        f, stats = _ffn_moe_tokens(cfg, pl, hn, slot_ids >= 0)
        return h + f, stats
    return h + _ffn_dense(cfg, pl, hn), None


def moe_utilization_entropy(counts):
    """Normalised entropy of a per-expert token-count vector in [0, 1]
    (1 = balanced; 0 = degenerate or no MoE) — the JAX package's
    `profiler.metrics.moe_utilization_entropy`."""
    c = np.asarray(counts, np.float64)
    total = c.sum()
    if total <= 0 or c.size <= 1:
        return 0.0
    p = c / total
    p = p[p > 0]
    return float(-(p * np.log(p)).sum() / np.log(c.size))


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
                 draft_ring=128, sparse_blocks=None, ticks_per_dispatch=1,
                 penalty_vocab_bins=None, device="cuda"):
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
        if sparse_blocks is not None:
            raise NotImplementedError(
                "sparse_blocks: block-sparse decode is not ported yet "
                "(ROADMAP Queue 1: block-sparse KV, select_blocks)")
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
        L, H, Dh = dec.num_layers, dec.num_heads, dec.head_dim
        maxpos = model.max_position_embeddings
        max_seq_len = min(max_seq_len or maxpos, maxpos)
        self.block_size = int(block_size)
        mbps = -(-max_seq_len // self.block_size)
        if num_blocks is None:
            # full residency for every slot, + the reserved null block
            num_blocks = max_slots * mbps + 1
        self.token_budget = choose_token_budget(
            max_slots, self.block_size, token_budget,
            verify_width=self.draft_k + 1)
        self.kv = PagedKVCache(
            L, H, Dh, num_blocks=num_blocks, block_size=self.block_size,
            max_slots=max_slots, max_blocks_per_slot=mbps,
            dtype=cache_dtype or "bfloat16", kv_dtype=kv_dtype,
            device=self.device)

        def windowed_draft(tokens, k=self.draft_k, ngram=self.draft_ngram,
                           window=self.draft_ring):
            # the proposer scans the trailing window the JAX engine's
            # device ring holds, so both propose identically
            return ngram_propose(tokens[-window:], k, max_ngram=ngram)

        self.scheduler = Scheduler(
            self.kv, max_slots=max_slots, token_budget=self.token_budget,
            clock=clock, draft_k=self.draft_k, draft_fn=windowed_draft,
            device_draft=self.speculation_mode == "device")
        # the verify region's group -> slot map
        self._region_slots = torch.arange(max_slots, dtype=torch.int32,
                                          device=self.device)
        self.eos_token_id = eos_token_id
        self.clock = clock
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # cast float params to the compute dtype ONCE, on the engine's
        # device (a per-step cast would re-read every parameter)
        cdt = getattr(torch, model.compute_dtype)
        with torch.no_grad():
            def cast(t):
                return t.detach().to(self.device, cdt)
            self._we = cast(model.word_embeddings.weight)
            self._pe = cast(model.position_embeddings.weight)
            self._layers = [{n: cast(p) for n, p in
                             dec.layer_params(li).items()}
                            for li in range(L)]
            self._lnf = (cast(model.ln_f.weight), cast(model.ln_f.bias))
            self._head = cast(model.lm_head.weight)
        self.num_experts = self.cfg.num_experts
        # engine-side weight-only experts: the compute-dtype copies in
        # self._layers are quantized in place, and the step's cfg
        # carries the bits
        self.moe_weight_dtype = moe_weight_dtype
        if moe_weight_dtype is not None:
            self._quantize_moe_experts(str(moe_weight_dtype))
        self.steps_run = 0
        #: valid (non-padding) tokens fed through the step so far
        self.tokens_fed = 0
        # cumulative MoE routing state (host mirrors of the per-step
        # device stats)
        self.moe_expert_counts = np.zeros(max(self.num_experts, 1),
                                          np.float64)
        self.moe_dropped_total = 0.0
        self.moe_last_aux = 0.0
        # cumulative draft economics
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
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
        """Fold one step's routing stats into the host mirrors."""
        self.moe_expert_counts += np.asarray(counts, np.float64)
        self.moe_dropped_total += float(dropped)
        self.moe_last_aux = float(aux)

    # ------------------------------------------------------- mixed step
    @torch.no_grad()
    def _mixed_step(self, token_ids, slot_ids, positions, block_tables,
                    sample_index, counts=None):
        """One fixed-shape step: [T] tokens -> (outputs, the MoE routing
        stats or None), with the pools updated in place. Outputs: the
        [S] sampled tokens; with speculation also the verify region's
        [S, K] scores — greedy (tok, tok_v), sampling (tok, tok_v,
        tok_res, acc), see `_verify_head`. `counts` [S, Vb]: the penalty
        histogram (penalized sampling only). Stats: per-expert counts
        and drops summed over the layers (fp32), the balance loss
        averaged over them."""
        cfg, BS = self.cfg, self.block_size
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
        for li, pl in enumerate(self._layers):
            scales = (kv.k_scale[li], kv.v_scale[li]) if kv.quantized \
                else (None, None)
            h, st = _mixed_layer(cfg, pl, h, kv.k_pool[li], kv.v_pool[li],
                                 wb, wo, block_tables, slot_ids, pos,
                                 *scales, kv.kv_dtype, K, self._region_slots)
            if st is not None:
                moe = st if moe is None else \
                    {k: moe[k] + st[k] for k in moe}
        xf = _ln(h, *self._lnf, cfg.epsilon)
        h_last = xf[sample_index.clamp(0, T - 1)]      # [S, D]
        logits = _mm(h_last, self._head)
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
        lv = _mm(xf[:R], self._head).float().reshape(S, K, -1)
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
    def submit(self, prompt_ids, max_new_tokens=32, deadline=None):
        """Queue one request. Returns the scheduler's Request handle
        (read `.output` / `.state` as the engine advances)."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        maxpos = self.model.max_position_embeddings
        if len(prompt) + max_new_tokens > maxpos:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_position_embeddings "
                f"({maxpos})")
        return self.scheduler.submit(prompt, max_new_tokens,
                                     eos_token_id=self.eos_token_id,
                                     deadline=deadline)

    def _emit(self, req, tokens, now):
        """Append generated tokens; finish the request at EOS or its
        horizon. Returns True when it finished."""
        if req.state == "prefill":
            req.state = "decode"
        if req.first_token_time is None:
            req.first_token_time = now
        for token in tokens:
            req.output.append(token)
            if len(req.output) >= req.max_new_tokens or (
                    req.eos_token_id is not None
                    and token == req.eos_token_id):
                self.scheduler.finish(req, now)
                return True
        return False

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
        plan = sch.plan()
        if plan.empty:
            return bool(plan.expired)
        if self._multitick:
            return self._step_multitick(plan)
        sp = pack_step(self.token_budget, self.kv.max_slots, plan.decode,
                       plan.prefills, verify_width=self.draft_k + 1)
        inputs = [torch.from_numpy(a).to(self.device) for a in
                  (sp.token_ids, sp.slot_ids, sp.positions,
                   self.kv.block_tables, sp.sample_index)]
        if self._penalized:
            inputs.append(
                torch.from_numpy(self._penalty_counts()).to(self.device))
        outs, moe = self._mixed_step(*inputs)
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
        self.steps_run += 1
        now = self.clock()
        for slot in sp.prefill_done:
            req = sch.slots[slot]
            if req is not None:
                self._emit(req, [int(tok_np[slot])], now)
        if not self.draft_k:
            for slot in sp.decode_slots:
                req = sch.slots[slot]
                if req is not None:
                    self._emit(req, [int(tok_np[slot])], now)
            return True
        tok_v = host[1].astype(np.int64)
        if self.spec_sampling:
            tok_res, acc = host[2].astype(np.int64), host[3] != 0
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
            if not self._emit(req, emitted, now):
                # roll back blocks whose only contents were
                # rejected-draft K/V
                sch.note_accept(slot, pos + m + 1)
        return True

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

    def _step_multitick(self, plan):
        """The multi-tick dispatch: preallocate each decode's tick
        capacity, upload the plan once, enqueue the ticks
        (`_run_ticks`), read the control block back in one copy, and
        replay the staged tokens through the same bookkeeping as
        `step()`. Only a pure-decode dispatch runs more than one tick:
        a prefill chunk needs the host packer next step anyway."""
        sch = self.scheduler
        S, K = self.kv.max_slots, self.draft_k + 1
        t_launch = self.clock()
        if self._gap_ema is not None or self._last_harvest is not None:
            gap = max(t_launch - (self._last_harvest or t_launch), 0.0)
            self._gap_ema = (gap if self._gap_ema is None
                             else 0.7 * self._gap_ema + 0.3 * gap)
        sp = pack_step(self.token_budget, S, plan.decode, plan.prefills,
                       verify_width=K)
        n = self.ticks_per_dispatch if not plan.prefills else 1
        if n > 1 and self._ticks_auto:
            n = self._auto_ticks(self.ticks_per_dispatch)
        multi = n > 1
        eos = np.full(S, -1, np.int64)
        remain = np.zeros(S, np.int64)
        cap = np.zeros(S, np.int64)
        for slot, _tok, _pos in plan.decode:
            req = sch.slots[slot]
            if req.eos_token_id is not None:
                eos[slot] = int(req.eos_token_id)
            remain[slot] = req.max_new_tokens - len(req.output)
        # issue no tick past an exit the host can foresee: every tick
        # emits at least one token of a live decode, so a slot finishes
        # within `remain` ticks and passes its capacity within cap - pos
        # (ticks past an exit would run, and change nothing)
        if plan.decode:
            n = min(n, min(int(remain[s]) for s, _t, _p in plan.decode))
        for slot, _tok, pos in plan.decode:
            # free blocks for every token the ticks may write; the block
            # tables are uploaded after this, so later ticks' appends
            # land in mapped blocks
            cap[slot] = (sch.extend_for_ticks(slot, pos, n * K)
                         if n * K > 1 else pos + 1)
        if plan.decode:
            n = min(n, min(int(cap[s]) - p for s, _t, p in plan.decode))
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
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in host.items()}
        ctl, gen_states = self._run_ticks(dev, n)
        parts = [ctl["staged"], ctl["counts"], ctl["events"], ctl["ticks"],
                 ctl["fed"]]
        if K > 1:
            parts += [ctl["spec_proposed"], ctl["spec_accepted"]]
        if self.num_experts:
            parts += [ctl["moe"][k] for k in ("counts", "dropped", "aux")]
        out = _to_host(parts)                       # the one readback
        staged = out[0].astype(np.int64)
        emitted_n = out[1].astype(np.int64)
        events = out[2].astype(np.int64)
        ticks_run = int(out[3])
        if ticks_run < n and gen_states:
            # the ticks past the exit drew from the generator as well:
            # take it back to where the first of them found it
            self._gen.set_state(gen_states[ticks_run])
        self._last_harvest = self.clock()
        d = (self._last_harvest - t_launch) / ticks_run
        self._tick_ema = (d if self._tick_ema is None
                          else 0.7 * self._tick_ema + 0.3 * d)
        if self._gap_ema is None:
            self._gap_ema = 0.0
        self.tokens_fed += int(out[4])
        if K > 1:
            self.spec_proposed_total += int(out[5])
            self.spec_accepted_total += int(out[6])
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
        if n > 1 or K > 1:
            # each decode advances to what the device emitted and gives
            # back the preallocated tail (and any rejected drafts'
            # blocks): block state at every dispatch boundary is the
            # 1-tick engine's
            for slot, _tok, pos in plan.decode:
                sch.note_accept(slot, pos + max(int(emitted_n[slot]), 1))
        now = self.clock()
        for slot in sp.prefill_done:
            req = sch.slots[slot]
            if req is not None:
                self._emit(req, [int(staged[slot, 0])], now)
        for slot in sp.decode_slots:
            req = sch.slots[slot]
            if req is not None:
                c = max(int(emitted_n[slot]), 1)
                self._emit(req, [int(t) for t in staged[slot, :c]], now)
        if multi:
            self.early_exit_counts["finish"] += int(((events & 1) > 0).sum())
            self.early_exit_counts["overflow"] += int(
                ((events & 2) > 0).sum())
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
        `pen_len`) and the draft ring (`ring`, `ring_len`).

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
        speculation `spec_proposed` / `spec_accepted`, and with MoE the
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
            spec_acc = torch.zeros((), dtype=i64, device=dev)
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
            if sampling:
                gen_states.append(self._gen.get_state())
            outs, moe = self._mixed_step(tid, sid, pid, block_tables, si,
                                         cnt)
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
                spec_acc = spec_acc + (m * ld).sum()
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
            ctl.update(spec_proposed=spec_prop, spec_accepted=spec_acc)
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
