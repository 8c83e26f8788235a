"""Autoregressive generation over the dense-cache decoder stack.

Port of `paddle_tpu/incubate/nn/generation.py`: `GenerationMixin`
adds `generate()` to a causal LM that provides the cores (tensors in,
tensors out):

* `_gen_tensors()` -> list of tensors, every array the cores need;
* `_split_arrays(arrays)` -> the cores' view of them (taken once a
  call);
* `_gen_cache(batch, s_max, dtype)` -> the (k, v) cache pair;
* `_prefill_core(parts, ids, seq_lens, cache)` -> (last logits [B, V],
  cache);
* `_decode_core(parts, token, positions, cache)` -> (logits [B, V],
  cache);
* `_verify_core(parts, tokens, positions, cache)` -> (logits [B, K, V],
  cache).

The prompt is right-padded to a power-of-two bucket and masked by
`seq_lens`; the cache covers prompt + new tokens in one fixed shape and
every step writes it in place. `use_scan=True` (JAX's `lax.scan`) runs
the decode steps with no host read: EOS masking stays on the device
and one readback-free `[B, M]` result comes out. `use_scan=False` reads
each step's tokens on the host and stops as soon as every row has
emitted EOS. `draft_k > 0` is greedy speculative decoding: the host
n-gram drafter proposes and one verify pass a step scores every draft.
In fp32 the output equals `draft_k=0` token for token; in bf16 a verify
product rounds unlike a decode step's, so the two may part at a
near-tie.

Sampling draws from a `torch.Generator` on the model's device: seeded
from `seed`, or, with `seed=None`, the device's generator of
`paddle_tpu_torch.core.random` (`seed(n)` governs it). The streams are
torch's, not JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import random as rng_mod
from ...serving.batcher import (SamplingConfig, next_pow2, round_up,
                                select_token)
from ...serving.draft import accept_length, ngram_propose


def _gen_lens(toks, eos_id):
    """[B, M] generated ids -> [B] int32 actual lengths: up to and
    including the first EOS, M where a row has none (or no `eos_id`).
    Computed where `toks` lives, with no host read."""
    B, M = toks.shape
    if eos_id is None:
        return torch.full((B,), M, dtype=torch.int32, device=toks.device)
    hit = toks == eos_id
    first = hit.to(torch.int32).argmax(dim=1)
    return torch.where(hit.any(dim=1), first + 1, M).to(torch.int32)


def _host_ids(x):
    """`x` (a tensor, array or list) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class GenerationMixin:
    """Adds `generate()` to a causal-LM module providing the cores of
    the module docstring."""

    def _gen_device(self):
        return self._gen_tensors()[0].device

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32,
                 decode_strategy="greedy", temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, seed=None, use_scan=True,
                 cache_dtype=None, seq_lens=None, draft_k=0,
                 draft_ngram=3):
        """Returns (ids [B, max_new_tokens], gen_lens [B]), int32 tensors
        on the model's device. `gen_lens` is each row's generated length
        up to and including its first EOS (max_new_tokens without one);
        positions past it hold EOS. `seq_lens` [B] gives each row's true
        prompt length in a right-padded batch (default: the full width).
        `draft_k > 0` turns on greedy speculative decoding (n-gram
        drafts of up to `draft_ngram`-grams, one verify pass a step);
        `last_accept_counts` then lists each step's emitted counts. The
        KV cache is `cache_dtype` (default bfloat16, as the JAX
        package's)."""
        ids_np = _host_ids(input_ids).astype(np.int32)
        if ids_np.ndim == 1:
            ids_np = ids_np[None]
        B, S = ids_np.shape
        maxpos = getattr(self, "max_position_embeddings", None)
        if maxpos is not None and S + max_new_tokens > maxpos:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_position_embeddings ({maxpos}); late "
                "positions would silently share one position embedding")
        draft_k = int(draft_k)
        if draft_k > 0 and decode_strategy != "greedy":
            raise ValueError(
                "speculative decoding (draft_k > 0) verifies against the "
                "greedy continuation; sampling strategies need rejection "
                "sampling, which is not implemented - use "
                "decode_strategy='greedy' or draft_k=0")
        s_bucket = next_pow2(S)
        # speculation needs draft_k columns of slack past the horizon
        # (the last verify step writes draft K/V beyond the final token)
        s_max = round_up(s_bucket + max_new_tokens + draft_k, 128)
        dt = cache_dtype or "bfloat16"
        sc = SamplingConfig("greedy" if decode_strategy == "greedy"
                            else "sampling", float(temperature),
                            int(top_k), float(top_p))
        if seq_lens is not None:
            lens_np = _host_ids(seq_lens).astype(
                np.int32).reshape(-1)
            if lens_np.shape != (B,):
                raise ValueError(
                    f"seq_lens must have shape [{B}], got {lens_np.shape}")
            if (lens_np < 1).any() or (lens_np > S).any():
                raise ValueError(f"seq_lens entries must lie in [1, {S}]")
        else:
            lens_np = np.full((B,), S, np.int32)
        uniform = bool((lens_np == lens_np[0]).all())
        dev = self._gen_device()
        # float weights cast to the compute dtype once a call, not a step
        parts = self._split_arrays(self._gen_arrays())
        padded = np.zeros((B, s_bucket), np.int64)
        padded[:, :S] = ids_np
        lens_t = torch.from_numpy(lens_np.astype(np.int64)).to(dev)
        if seed is None:
            gen = rng_mod.generator(dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        kv = self._gen_cache(B, s_max, dt)
        logits, kv = self._prefill_core(parts, torch.from_numpy(padded).to(
            dev), lens_t, kv)
        tok = select_token(logits, sc, gen).to(torch.int32)
        if max_new_tokens == 1:
            toks = tok[:, None]
            return toks, _gen_lens(toks, eos_token_id)
        if draft_k > 0:
            return self._generate_speculative(
                parts, kv, tok, ids_np, lens_np, max_new_tokens,
                eos_token_id, draft_k, draft_ngram)
        # a host int when every row shares its prompt length (a slice
        # write), else the rows' positions on the device (indexed writes)
        pos0 = int(lens_np[0]) if uniform else lens_t
        if use_scan:
            # the counterpart of JAX's scan: every step enqueued with no
            # host read; finished rows keep emitting EOS on the device
            eos = eos_token_id
            finished = (tok == eos) if eos is not None else None
            out = [tok]
            for i in range(max_new_tokens - 1):
                logits, kv = self._decode_core(parts, tok, pos0 + i, kv)
                tok = select_token(logits, sc, gen).to(torch.int32)
                if eos is not None:
                    tok = torch.where(finished, torch.full_like(tok, eos),
                                      tok)
                    finished = finished | (tok == eos)
                out.append(tok)
            toks = torch.stack(out, dim=1)
            return toks, _gen_lens(toks, eos_token_id)
        # the streaming loop: each step's tokens are read on the host,
        # and it stops as soon as every row has emitted EOS (checked
        # before each step, so an all-EOS prefill token runs none)
        out = [tok.cpu().numpy()]
        finished = (out[0] == eos_token_id) if eos_token_id is not None \
            else np.zeros((B,), bool)
        for i in range(max_new_tokens - 1):
            if eos_token_id is not None and finished.all():
                break
            logits, kv = self._decode_core(parts, tok, pos0 + i, kv)
            tok = select_token(logits, sc, gen).to(torch.int32)
            t_np = tok.cpu().numpy()
            if eos_token_id is not None:
                t_np = np.where(finished, eos_token_id, t_np)
                finished |= t_np == eos_token_id
            out.append(t_np)
        toks = np.stack(out, axis=1).astype(np.int32)
        if toks.shape[1] < max_new_tokens and eos_token_id is not None:
            pad = np.full((B, max_new_tokens - toks.shape[1]),
                          eos_token_id, np.int32)
            toks = np.concatenate([toks, pad], axis=1)
        toks = torch.from_numpy(toks).to(dev)
        return toks, _gen_lens(toks, eos_token_id)

    def _generate_speculative(self, parts, kv, tok, ids_np, lens_np,
                              max_new_tokens, eos_token_id, draft_k,
                              draft_ngram):
        """The greedy speculative loop over the verify core. Each step
        feeds [last token, d_1 .. d_draft_k] at each row's position and
        emits the longest prefix where draft j equals the model's argmax
        after j - 1, plus the model's own next token: 1 .. draft_k + 1
        tokens a row, exactly the sequential greedy continuation.
        Rejected drafts' K/V need no rollback: the next step's write
        starts at the first invalid position and covers them before any
        query can attend that range."""
        B = ids_np.shape[0]
        dev = tok.device
        tok_np = tok.cpu().numpy()
        outs = [[int(tok_np[b])] for b in range(B)]
        seqs = [[int(t) for t in ids_np[b, :int(lens_np[b])]]
                + [outs[b][0]] for b in range(B)]
        finished = [eos_token_id is not None
                    and outs[b][0] == eos_token_id for b in range(B)]

        def active(b):
            return not finished[b] and len(outs[b]) < max_new_tokens

        K = draft_k + 1
        step_toks = np.zeros((B, K), np.int64)
        pos0 = np.zeros((B,), np.int64)
        #: each verify step's emitted counts, one per active row
        self.last_accept_counts = []
        while any(active(b) for b in range(B)):
            for b in range(B):
                pos0[b] = len(seqs[b]) - 1
                step_toks[b, 0] = seqs[b][-1]
                if active(b):
                    step_toks[b, 1:] = ngram_propose(
                        seqs[b], draft_k, max_ngram=draft_ngram)
                else:
                    # frozen rows re-feed their last token in place
                    step_toks[b, 1:] = seqs[b][-1]
            logits, kv = self._verify_core(
                parts, torch.from_numpy(step_toks).to(dev),
                torch.from_numpy(pos0).to(dev), kv)
            nxt_np = logits.float().argmax(dim=-1).cpu().numpy()
            emitted = []
            for b in range(B):
                if not active(b):
                    continue
                g = nxt_np[b]
                m = accept_length(step_toks[b], g)
                emit = [int(t) for t in g[:m + 1]]
                emit = emit[:max_new_tokens - len(outs[b])]
                if eos_token_id is not None and eos_token_id in emit:
                    emit = emit[:emit.index(eos_token_id) + 1]
                    finished[b] = True
                outs[b].extend(emit)
                seqs[b].extend(emit)
                emitted.append(len(emit))
            self.last_accept_counts.append(emitted)
        pad = eos_token_id if eos_token_id is not None else 0
        toks = torch.tensor(
            [outs[b] + [pad] * (max_new_tokens - len(outs[b]))
             for b in range(B)], dtype=torch.int32, device=dev)
        return toks, _gen_lens(toks, eos_token_id)
