"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The JAX package `paddle_tpu` is the reference this port is held
against, on the same weights and inputs; this package imports torch and
numpy only, never jax and nothing of `paddle_tpu`. Its layout mirrors
the JAX package so each counterpart is easy to find.

Ported so far:

* the serving path — `serving.ServingEngine`: continuous batching over
  a paged KV cache (`serving.kv_cache`; float, int8 or fp8 pools,
  `kv_dtype=`), `serving.scheduler`, `serving.batcher`, one
  fixed-shape mixed step per iteration, over `models.GPTForGeneration`
  and the stacked decoder of `incubate.nn.fused_transformer`;
  speculative decoding (`draft_k=`: the n-gram drafter of
  `serving.draft`, a fixed verify region, greedy or rejection-sampling
  acceptance, KV rollback); MoE models (`GPTForGeneration(moe=...)`,
  the routing of `parallel.moe_utils`) with float, int8 or packed-int4
  experts (`moe_weight_dtype=`);
* the single-device train step — `parallel.hybrid_gpt.HybridGPT`;
* BERT inference — `models.bert` (`BertModel`, `BertForPretraining`
  with `BertPretrainingCriterion`, `BertForSequenceClassification`,
  `bert_tiny`/`bert_base`/`bert_large`) over the port's first `nn`
  surface: `nn.Linear`, `Embedding`, `Dropout`, `LayerNorm`, `GELU`,
  `Tanh`, `LayerList`, `MultiHeadAttention`, the Transformer encoder,
  and `nn.functional` (`scaled_dot_product_attention`, which routes a
  key-padding mask to the segmented flash kernel, `linear`, `dropout`,
  `embedding`, `gelu`, `tanh`, `relu`, `layer_norm`, `cross_entropy`);
* the kernels, each a CUDA source written for Hopper under `ops/csrc/`
  with its plain PyTorch version beside it: `ops.paged_attention`
  (block-table paged attention: ragged and verify entries, float or
  quantized pools), `ops.grouped_matmul` (the grouped
  expert matmul, float/int8/int4 weights), `ops.flash_attention`
  (flash attention, causal or full, forward and backward; the segmented
  forward over key-padding or packed segment ids; the paddle-layout
  forward), `ops.layer_norm` (fused residual-add + LayerNorm, forward and
  backward), `ops.qkv_proj` (the fused QKV projection) and
  `ops.conv_wgrad` (the split-K 1x1 weight gradient);
* `convert.load_jax_gpt`, `convert.load_jax_hybrid_gpt` and
  `convert.load_jax_bert` — carry a JAX model's or trainer's parameters
  across.

Every entry point takes `device=`, defaulting to "cuda"; without a card
that default raises instead of falling back to the CPU.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
