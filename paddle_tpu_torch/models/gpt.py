"""GPT for generation — the serving model.

Port of `paddle_tpu/models/gpt.py:GPTForGeneration`: word and position
embeddings, the stacked `FusedMultiTransformer` decoder
(`FusedMultiTransformerMoe` with `moe=dict(num_expert, top_k,
capacity_factor)`; with `weight_only=True` the int8 stacks
`FusedMultiTransformerWeightOnly` and, with `moe=` (which may add
`moe_quant_bits`), `FusedMultiTransformerMoeWeightOnly`), a final
LayerNorm `ln_f` and a bias-free `lm_head` whose weight keeps Paddle's
`[in, out]` = `[D, V]` layout.

`forward` is the plain dense causal pass over whole sequences — the
scoring oracle the serving engine's paged path is checked against.
`generate()` (`incubate.nn.generation.GenerationMixin`) runs the
dense-cache decoder through the cores below: `_gen_tensors()` lists
every parameter in the JAX model's order (the embeddings, the decoder's
stacks in `_PARAM_ORDER`, `ln_f.weight`, `ln_f.bias`,
`lm_head.weight`), which bundles and `ServingEngine.swap_weights`
consume too.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..incubate.nn.fused_transformer import (
    FusedMultiTransformer, FusedMultiTransformerMoe,
    FusedMultiTransformerMoeWeightOnly, FusedMultiTransformerWeightOnly,
    _cast_param, _ln, _mm, _run_stack)
from ..incubate.nn.generation import GenerationMixin

#: the names of `_gen_tensors()`' entries around the decoder's stacks
_HEAD_NAMES = ("word_embeddings", "position_embeddings")
_TAIL_NAMES = ("ln_f.weight", "ln_f.bias", "lm_head.weight")


class _Head(nn.Module):
    """Bias-free projection holding its weight as `[in, out]`."""

    def __init__(self, d_in, d_out, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(d_in, d_out, device=device, dtype=dtype),
            requires_grad=False)


class GPTForGeneration(nn.Module, GenerationMixin):
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, weight_only=False, moe=None,
                 compute_dtype="float32", device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        d_ff = intermediate_size or 4 * hidden_size
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.compute_dtype = str(compute_dtype)
        fac = {"device": dev, "dtype": dtype}
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size, **fac)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size, **fac)
        if moe:
            cls = (FusedMultiTransformerMoeWeightOnly if weight_only
                   else FusedMultiTransformerMoe)
            self.decoder = cls(hidden_size, num_attention_heads, d_ff,
                               num_layers=num_layers, activation="gelu",
                               **moe, **fac)
        else:
            self.decoder = FusedMultiTransformer(
                hidden_size, num_attention_heads, d_ff,
                num_layers=num_layers, activation="gelu", **fac)
            if weight_only:
                self.decoder = FusedMultiTransformerWeightOnly.from_float(
                    self.decoder)
        self.ln_f = nn.LayerNorm(hidden_size, eps=1e-5, **fac)
        self.lm_head = _Head(hidden_size, vocab_size, **fac)
        self.requires_grad_(False)
        with torch.no_grad():
            self.word_embeddings.weight.normal_(0.0, 0.02)
            self.position_embeddings.weight.normal_(0.0, 0.02)
            self.lm_head.weight.normal_(0.0, 1.0 / math.sqrt(hidden_size))

    def _embed(self, we, pe, ids, positions):
        """Token + position embeddings: positions clip to the table,
        the sum is taken in fp32 and cast to the compute dtype."""
        positions = positions.clamp(0, self.max_position_embeddings - 1)
        x = we[ids].float() + pe[positions].float()
        return x.to(getattr(torch, self.compute_dtype))

    @torch.no_grad()
    def forward(self, input_ids, dtype=None):
        """input_ids [B, S] -> logits [B, S, V], dense causal attention
        over the whole sequence (a MoE stack routes all B * S tokens at
        once, under that token count's capacity). Computes in `dtype`
        (default: the parameters' own dtype), independent of the compute
        dtype the serving engine uses."""
        dt = dtype or self.word_embeddings.weight.dtype
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)[None, :]
        positions = pos.clamp(0, self.max_position_embeddings - 1)
        x = (self.word_embeddings.weight[input_ids].float()
             + self.position_embeddings.weight[positions].float()).to(dt)
        dec = self.decoder
        cfg = dec._cfg()
        layers = [dec.layer_params(li, dt) for li in range(cfg.num_layers)]
        x, _, _ = _run_stack(cfg, layers, x, None, "forward")
        x = _ln(x, self.ln_f.weight, self.ln_f.bias, 1e-5)
        return _mm(cfg, x, self.lm_head.weight)

    # ---- GenerationMixin cores -------------------------------------------
    @property
    def _dec_names(self):
        return self.decoder.param_names

    def gen_names(self):
        """The names of `_gen_tensors()`' entries, in order (the decoder's
        under their `_PARAM_ORDER` names)."""
        return list(_HEAD_NAMES) + list(self._dec_names) + list(_TAIL_NAMES)

    def _gen_tensors(self):
        """Every parameter in the JAX model's `_gen_tensors()` order."""
        dec = self.decoder
        return ([self.word_embeddings.weight,
                 self.position_embeddings.weight]
                + [getattr(dec, n) for n in dec.param_names]
                + [self.ln_f.weight, self.ln_f.bias, self.lm_head.weight])

    def _gen_arrays(self):
        """`_gen_tensors()` with the float entries in the compute dtype
        (`_cast_param`: integer weights never, a weight-only scale only
        from fp32)."""
        cdt = getattr(torch, self.compute_dtype)
        return [_cast_param(n, t, cdt)
                for n, t in zip(self.gen_names(), self._gen_tensors())]

    def _gen_cache(self, batch, s_max, dtype):
        return self.decoder.gen_cache(batch, s_max, dtype)

    def _split_arrays(self, arrays):
        """(we, pe, layers, ln_f weight, ln_f bias, head): the decoder's
        stacks cut into one `{name: tensor}` dict a layer (views)."""
        n_dec = len(self._dec_names)
        dec = dict(zip(self._dec_names, arrays[2:2 + n_dec]))
        layers = [{n: t[li] for n, t in dec.items()}
                  for li in range(self.decoder.num_layers)]
        return (arrays[0], arrays[1], layers, arrays[-3], arrays[-2],
                arrays[-1])

    def _head_logits(self, parts, out):
        _we, _pe, _layers, lnw, lnb, head = parts
        out = _ln(out, lnw, lnb, 1e-5)
        return torch.matmul(out, head.to(out.dtype))

    def _prefill_core(self, parts, ids, seq_lens, cache):
        """ids [B, S_pad] -> (logits [B, V] at each row's last prompt
        token, seq_lens - 1; cache written at [0, S_pad))."""
        we, pe, layers = parts[:3]
        S = ids.shape[1]
        x = self._embed(we, pe, ids,
                        torch.arange(S, device=ids.device)[None, :])
        out, cache, _ = _run_stack(self.decoder._cfg(), layers, x, cache,
                                   "prefill", seq_lens=seq_lens)
        h_last = out[torch.arange(out.shape[0], device=out.device),
                     seq_lens - 1]
        return self._head_logits(parts, h_last), cache

    def _decode_core(self, parts, token, positions, cache):
        """token [B] at `positions` (an int, or [B]) -> (logits [B, V],
        cache)."""
        we, pe, layers = parts[:3]
        pos = (torch.full((1, 1), positions, device=token.device)
               if isinstance(positions, int) else positions[:, None])
        x = self._embed(we, pe, token[:, None].long(), pos)
        out, cache, _ = _run_stack(self.decoder._cfg(), layers, x, cache,
                                   "decode", positions)
        return self._head_logits(parts, out[:, 0]), cache

    def _verify_core(self, parts, tokens, positions, cache):
        """Speculative verify: tokens [B, K], token j at positions + j
        (`positions` [B]) -> (logits [B, K, V], cache); logits[:, j]
        scores the next token after token j."""
        we, pe, layers = parts[:3]
        K = tokens.shape[1]
        pos = positions[:, None] + torch.arange(K, device=tokens.device)
        x = self._embed(we, pe, tokens.long(), pos)
        out, cache, _ = _run_stack(self.decoder._cfg(), layers, x, cache,
                                   "decode", positions)
        return self._head_logits(parts, out), cache
