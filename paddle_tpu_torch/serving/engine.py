"""ServingEngine — paged-KV continuous batching over the fused GPT stack.

Port of `paddle_tpu/serving/engine.py:ServingEngine` with float KV
pools, dense or MoE decoders (float, int8 or packed-int4 experts), no
speculation, no sparse decode, no adapters, one tick per dispatch. Host
loop per `step()`:

    scheduler.plan()  ->  pack_step()  ->  mixed step  ->  sample
    bookkeeping (EOS + length termination, block release)

The mixed step runs one flat `[T]` token axis holding decode tokens and
prefill chunks together; every step takes the same input shapes (`[T]`
tokens, slots and positions, `[S, MB]` block tables, `[S]` sample
index), whatever requests come and go. Each layer writes the new K/V
into the paged pools in place and attends through
`ops.paged_attention.ragged_paged_attention` — the Hopper kernel on a
CUDA device, its plain version on the CPU. A MoE layer routes the valid
tokens into fixed expert-capacity slots (C from T, so routing never
changes a shape) and runs the expert products through
`ops.grouped_matmul.grouped_expert_matmul`; its routing statistics come
back to the host with the sampled tokens, in one copy.
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
from ..ops.paged_attention import ragged_paged_attention
from .batcher import SamplingConfig, choose_token_budget, pack_step, \
    select_token
from .kv_cache import PagedKVCache
from .scheduler import Scheduler


def _mixed_layer(cfg, pl, h, k_pool, v_pool, wb, wo, block_tables,
                 slot_ids, pos):
    """One decoder layer of the mixed step on the flat token axis.

    h [T, D]; pl the layer's parameters; k_pool/v_pool this layer's
    `[NB, BS, H, Dh]` pools; (wb, wo) [T] the block and offset each
    token's K/V lands at (padding tokens aim at the NULL block).
    Returns (h, the MoE layer's routing stats or None)."""
    T = h.shape[0]
    hn = _ln(h, pl["ln_s"], pl["ln_b"], cfg.epsilon)
    q, k, v = _qkv(cfg, pl, hn[None])
    q, k, v = q[0], k[0], v[0]                       # [T, H, Dh]
    # in place, where the JAX step rebuilt the pools with .at[].set
    k_pool[wb, wo] = k.to(k_pool.dtype)
    v_pool[wb, wo] = v.to(v_pool.dtype)
    attn = ragged_paged_attention(q.contiguous(), k_pool, v_pool,
                                  block_tables, slot_ids, pos)
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
                 moe_weight_dtype=None, seed=0, clock=time.monotonic,
                 device="cuda"):
        self.device = resolve_device(device)
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
        self.sampling = sampling or SamplingConfig()
        self.token_budget = choose_token_budget(max_slots, self.block_size,
                                                token_budget)
        self.kv = PagedKVCache(
            L, H, Dh, num_blocks=num_blocks, block_size=self.block_size,
            max_slots=max_slots, max_blocks_per_slot=mbps,
            dtype=cache_dtype or "bfloat16", device=self.device)
        self.scheduler = Scheduler(self.kv, max_slots=max_slots,
                                   token_budget=self.token_budget,
                                   clock=clock)
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
        """One fixed-shape step: [T] tokens -> ([S] sampled tokens, the
        MoE routing stats or None), with the pools updated in place.
        Stats: per-expert counts and drops summed over the layers (fp32),
        the balance loss averaged over them."""
        cfg, BS = self.cfg, self.block_size
        T = token_ids.shape[0]
        valid = slot_ids >= 0
        pos = torch.where(valid, positions, 0)
        h = self.model._embed(self._we, self._pe, token_ids, pos)  # [T, D]
        safe_slot = torch.where(valid, slot_ids, 0)
        # padding tokens write into the reserved NULL block
        wb = torch.where(valid, block_tables[safe_slot, pos // BS], 0)
        wo = pos % BS
        moe = None
        for li, pl in enumerate(self._layers):
            h, st = _mixed_layer(cfg, pl, h, self.kv.k_pool[li],
                                 self.kv.v_pool[li], wb, wo, block_tables,
                                 slot_ids, pos)
            if st is not None:
                moe = st if moe is None else \
                    {k: moe[k] + st[k] for k in moe}
        xf = _ln(h, *self._lnf, cfg.epsilon)
        h_last = xf[sample_index.clamp(0, T - 1)]      # [S, D]
        logits = _mm(h_last, self._head)
        tok = select_token(logits, self.sampling, self._gen)
        if moe is not None:
            moe["aux"] = moe["aux"] / float(len(self._layers))
        return tok, moe

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
                       plan.prefills)
        inputs = [torch.from_numpy(a).to(self.device) for a in
                  (sp.token_ids, sp.slot_ids, sp.positions,
                   self.kv.block_tables, sp.sample_index)]
        tok, moe = self._mixed_step(*inputs)
        if moe is None:
            tok_np = tok.cpu().numpy()
        else:
            # the stats ride the tokens' copy to the host: one sync
            E = self.num_experts
            packed = torch.cat([tok.double(), moe["counts"].double(),
                                moe["dropped"].double().reshape(1),
                                moe["aux"].double().reshape(1)])
            packed = packed.cpu().numpy()
            tok_np = packed[:-E - 2].astype(np.int64)
            self._note_moe_stats(packed[-E - 2:-2], packed[-2], packed[-1])
        sch.note_fed(plan)
        self.tokens_fed += int((sp.slot_ids >= 0).sum())
        self.steps_run += 1
        now = self.clock()

        def emit(req, token):
            """Append one generated token; finish the request at EOS
            or its horizon."""
            if req.state == "prefill":
                req.state = "decode"
            if req.first_token_time is None:
                req.first_token_time = now
            req.output.append(token)
            if len(req.output) >= req.max_new_tokens or (
                    req.eos_token_id is not None
                    and token == req.eos_token_id):
                sch.finish(req, now)

        for slot in sp.prefill_done + sp.decode_slots:
            req = sch.slots[slot]
            if req is not None:
                emit(req, int(tok_np[slot]))
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
