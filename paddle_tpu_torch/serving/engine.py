"""ServingEngine — paged-KV continuous batching over the fused GPT stack.

Port of `paddle_tpu/serving/engine.py:ServingEngine` with float, int8 or
fp8 KV pools, dense or MoE decoders (float, int8 or packed-int4
experts), optional speculation, one tick per dispatch. Host loop per
`step()`:

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

Not ported (each raises `NotImplementedError` when asked for; ROADMAP
Queue 1): penalized sampling, block-sparse decode (`sparse_blocks`),
multi-tick dispatch (`ticks_per_dispatch > 1`); adapters, the prefix
cache and disaggregated roles are not arguments yet.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .._device import resolve_device
from ..incubate.nn.fused_transformer import (_ffn_dense, _ffn_moe_tokens,
                                             _ln, _mm, _qkv,
                                             _quantize_expert_stack)
from ..ops.paged_attention import (MAX_GROUP, ragged_paged_attention,
                                   verify_paged_attention)
from .batcher import (SamplingConfig, choose_token_budget, filter_logits,
                      needs_history, pack_step, select_token)
from .draft import accept_length, accept_length_sampled, ngram_propose
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


class ServingEngine:
    def __init__(self, model, *, max_slots=8, block_size=16,
                 num_blocks=None, max_seq_len=None, token_budget=None,
                 sampling=None, eos_token_id=None, cache_dtype=None,
                 kv_dtype=None, moe_weight_dtype=None, seed=0,
                 clock=time.monotonic, draft_k=0, draft_ngram=3,
                 draft_ring=128, sparse_blocks=None, ticks_per_dispatch=1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.sampling = sampling or SamplingConfig()
        self.draft_k = int(draft_k)
        self.draft_ngram = int(draft_ngram)
        self.draft_ring = int(draft_ring)
        # config validation is loud, as in the JAX engine
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
        if needs_history(self.sampling):
            raise NotImplementedError(
                "penalized sampling (repetition/presence/frequency) is not "
                "ported yet (ROADMAP Queue 1: penalties)")
        if sparse_blocks is not None:
            raise NotImplementedError(
                "sparse_blocks: block-sparse decode is not ported yet "
                "(ROADMAP Queue 1: block-sparse KV, select_blocks)")
        if ticks_per_dispatch != 1:
            raise NotImplementedError(
                "ticks_per_dispatch > 1: the multi-tick decode loop is not "
                "ported yet (ROADMAP Queue 1: multi-tick device-resident "
                "decode)")
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

        self.scheduler = Scheduler(self.kv, max_slots=max_slots,
                                   token_budget=self.token_budget,
                                   clock=clock, draft_k=self.draft_k,
                                   draft_fn=windowed_draft)
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
                    sample_index):
        """One fixed-shape step: [T] tokens -> (outputs, the MoE routing
        stats or None), with the pools updated in place. Outputs: the
        [S] sampled tokens; with speculation also the verify region's
        [S, K] scores — greedy (tok, tok_v), sampling (tok, tok_v,
        tok_res, acc), see `_verify_head`. Stats: per-expert counts and
        drops summed over the layers (fp32), the balance loss averaged
        over them."""
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
        tok = select_token(logits, self.sampling, self._gen)
        if moe is not None:
            moe["aux"] = moe["aux"] / float(len(self._layers))
        if K == 1:
            return (tok,), moe
        return (tok,) + self._verify_head(xf, token_ids), moe

    def _verify_head(self, xf, token_ids):
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
        generator, not JAX's stream."""
        S, K = self.kv.max_slots, self.draft_k + 1
        R = S * K
        lv = _mm(xf[:R], self._head).float().reshape(S, K, -1)
        if not self.spec_sampling:
            return (lv.argmax(dim=-1),)
        fed = token_ids[:R].reshape(S, K).long()
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

    def step(self):
        """One engine iteration. Returns True when any work (tokens or
        expiries) happened, False when the engine is idle/starved."""
        sch = self.scheduler
        plan = sch.plan()
        if plan.empty:
            return bool(plan.expired)
        sp = pack_step(self.token_budget, self.kv.max_slots, plan.decode,
                       plan.prefills, verify_width=self.draft_k + 1)
        inputs = [torch.from_numpy(a).to(self.device) for a in
                  (sp.token_ids, sp.slot_ids, sp.positions,
                   self.kv.block_tables, sp.sample_index)]
        outs, moe = self._mixed_step(*inputs)
        # every output (and the MoE stats) rides one copy to the host
        parts = list(outs)
        if moe is not None:
            parts += [moe["counts"], moe["dropped"], moe["aux"]]
        flat = torch.cat([p.double().reshape(-1) for p in parts])
        flat = flat.cpu().numpy()
        host, at = [], 0
        for p in parts:
            host.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        if moe is not None:
            counts, dropped, aux = host[-3:]
            self._note_moe_stats(counts, dropped, aux)
            host = host[:-3]
        tok_np = host[0].astype(np.int64)
        sch.note_fed(plan)
        self.tokens_fed += int((sp.slot_ids >= 0).sum())
        self.steps_run += 1
        now = self.clock()

        def emit(req, tokens):
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
                    sch.finish(req, now)
                    return True
            return False

        for slot in sp.prefill_done:
            req = sch.slots[slot]
            if req is not None:
                emit(req, [int(tok_np[slot])])
        if not self.draft_k:
            for slot in sp.decode_slots:
                req = sch.slots[slot]
                if req is not None:
                    emit(req, [int(tok_np[slot])])
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
            if not emit(req, emitted):
                # roll back blocks whose only contents were
                # rejected-draft K/V
                sch.note_accept(slot, pos + m + 1)
        return True

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
