"""The port's weight-only stacks against the JAX package's.

`GPTForGeneration(weight_only=True)` keeps the decoder's projections as
int8 with a scale for each output channel (`FusedMultiTransformerWeightOnly`;
with `moe=`, `FusedMultiTransformerMoeWeightOnly`: int8 attention and
int8 or packed int4 experts), and `convert.load_jax_gpt` carries a JAX
model's `*_s` weights across as they are. At tests/test_adapters.py's
sizes (vocab 211, hidden 32, 2 layers, 4 heads, block_size=4, fp32,
CPU):

* `_quantize_stack` gives JAX's int8 values and fp32 scales bit for bit
  on the same fp32 input, `from_float` JAX's buffers, and `_mm` with a
  scale JAX's product within fp32 rounding;
* `GPTForGeneration(weight_only=True).forward` gives JAX's logits
  within 1e-5, dense and MoE (int8 and int4 experts);
* engines over the carried weights give the JAX engine's greedy tokens,
  tolerance 0: dense, MoE with int8 experts, MoE with int4 experts (at
  1 and 4 ticks and with draft_k=3), JAX's grid-snapped int4 case (equal
  to the float engine), and adapters on a weight-only stack;
* no integer weight is cast to a float dtype (`layer_params`, the
  engine's once-only cast), scales are cast only from fp32 (as the JAX
  engine casts them), `moe_weight_dtype` is refused on an
  already-quantized stack, `from_float` refuses a MoE stack, and
  `convert` refuses weights of the wrong dtype or shape.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.incubate.nn import fused_transformer as jft
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving.adapters import make_random_adapter
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.incubate.nn import fused_transformer as tft
from paddle_tpu_torch.models.gpt import GPTForGeneration
from paddle_tpu_torch.serving.engine import ServingEngine

VOCAB, HEADS = 211, 4
MOE = dict(num_expert=4, top_k=2, capacity_factor=2.0)
STACKS = {"dense": None, "moe-int8": MOE,
          "moe-int4": dict(MOE, moe_quant_bits=4)}


def _arrays(jm):
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    return {n: np.asarray(t._data) for n, t in zip(names, tensors)}


def _jax_model(moe=None, weight_only=True, seed=0):
    paddle.seed(seed)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32", weight_only=weight_only, moe=moe)
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def stacks():
    """{name: (jax model, port model on the CPU)}, weight-only, the same
    bytes carried across through `*_s`."""
    out = {}
    for name, moe in STACKS.items():
        jm = _jax_model(moe)
        out[name] = (jm, load_jax_gpt(_arrays(jm), HEADS, moe=moe,
                                      device="cpu"))
    return out


def _prompts(seed=7, lens=(3, 9, 17, 5)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(n)).tolist() for n in lens]


def _kw(**kw):
    return dict(dict(max_slots=4, block_size=4, max_seq_len=64,
                     cache_dtype="float32", seed=0), **kw)


# ------------------------------------------------------------ the math


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(2, 32, 96), (3, 128, 32)])
def test_quantize_stack_bit_equal(bits, shape):
    rng = np.random.RandomState(sum(shape) + bits)
    w = (rng.randn(*shape) * rng.choice([1e-3, 1.0, 30.0], shape[-1])
         ).astype(np.float32)
    w[0, :, 0] = 0.0                       # an all-zero channel
    jq, js = jft._quantize_stack(jnp.asarray(w), bits)
    tq, ts = tft._quantize_stack(torch.tensor(w), bits)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [8, 4])
def test_mm_with_scale_matches_jax(bits):
    rng = np.random.RandomState(bits)
    x = rng.randn(5, 32).astype(np.float32)
    q, s = tft._quantize_stack(torch.randn(1, 32, 48), bits)
    cfg = dict(num_layers=1, num_heads=4, head_dim=8, dim_ff=48,
               quant_bits=bits)
    want = jft._mm(jft._MTConfig(**cfg), jnp.asarray(x),
                   jnp.asarray(q[0].numpy()), jnp.asarray(s[0].numpy()))
    got = tft._mm(tft._MTConfig(**cfg), torch.tensor(x), q[0], s[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_from_float_matches_jax():
    jf = _jax_model(weight_only=False)
    jw = jft.FusedMultiTransformerWeightOnly.from_float(jf.decoder)
    tf = load_jax_gpt(_arrays(jf), HEADS, device="cpu")
    tw = tft.FusedMultiTransformerWeightOnly.from_float(tf.decoder)
    assert tw.param_names == tuple(jw._param_tensors()[0])
    assert tw._cfg().quant_bits == 8
    for name, t in zip(*jw._param_tensors()):
        got = getattr(tw, name)
        assert np.array_equal(got.numpy(), np.asarray(t._data)), name
        assert got.dtype == (torch.int8 if name.endswith("_w")
                             else torch.float32)
    with pytest.raises(TypeError):
        tft.FusedMultiTransformerWeightOnly.from_float(
            GPTForGeneration(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                             num_attention_heads=HEADS, moe=MOE,
                             device="cpu").decoder)
    assert tft.FusedMultiTransformerINT8 is \
        tft.FusedMultiTransformerWeightOnly
    assert tft.FusedMultiTransformerMoeINT8 is \
        tft.FusedMultiTransformerMoeWeightOnly


@pytest.mark.parametrize("name", list(STACKS))
def test_forward_matches_jax_logits(stacks, name):
    jm, tm = stacks[name]
    ids = np.asarray(_prompts(lens=(17,)))
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = tm(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_port_built_stacks_keep_integers():
    """`GPTForGeneration(weight_only=True)` built in the port: integer
    weights, fp32 scales (fp16 for int4 experts), and casts that leave
    the integers alone."""
    for moe, ebits in ((None, 0), (MOE, 8), (dict(MOE, moe_quant_bits=4),
                                              4)):
        m = GPTForGeneration(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                             num_attention_heads=HEADS, weight_only=True,
                             moe=moe, device="cpu")
        d = m.decoder
        cfg = d._cfg()
        assert cfg.quant_bits == 8
        assert cfg.moe_quant_bits == (4 if ebits == 4 else 0)
        pl = d.layer_params(0, torch.bfloat16)
        for n in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"):
            assert pl[n].dtype == torch.int8
        assert pl["qkv_s"].dtype == torch.bfloat16
        assert pl["ffn1_s"].dtype == (torch.float16 if ebits == 4
                                      else torch.bfloat16)
        if ebits == 4:
            assert d.ffn1_w.shape[-2] == d.embed_dim // 2
        eng = ServingEngine(m, device="cpu",
                            **_kw(cache_dtype="bfloat16"))
        assert all(eng._layers[0][n].dtype == torch.int8
                   for n in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"))
        m.compute_dtype = "bfloat16"
        eng = ServingEngine(m, device="cpu", **_kw(cache_dtype="bfloat16"))
        assert eng._layers[0]["qkv_w"].dtype == torch.int8
        assert eng._layers[0]["qkv_s"].dtype == torch.bfloat16
        assert eng._layers[0]["ln_s"].dtype == torch.bfloat16
        out = eng.generate_batch(_prompts(lens=(5,)), max_new_tokens=3)
        assert len(out[0]) == 3
    with pytest.raises(ValueError):
        GPTForGeneration(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                         num_attention_heads=HEADS, weight_only=True,
                         moe=dict(MOE, moe_quant_bits=2), device="cpu")


# ------------------------------------------------------------ engines


@pytest.mark.parametrize("name,kw", [
    ("dense", {}), ("moe-int8", {}), ("moe-int4", {}),
    ("moe-int4", dict(ticks_per_dispatch=4)),
    ("dense", dict(draft_k=3, ticks_per_dispatch=4)),
    ("moe-int8", dict(draft_k=3))],
    ids=["dense", "moe-int8", "moe-int4", "moe-int4-ticks4",
         "dense-draft3-ticks4", "moe-int8-draft3"])
def test_engine_matches_jax(stacks, name, kw):
    jm, tm = stacks[name]
    ps = _prompts()
    want = JaxEngine(jm, **_kw(**kw)).generate_batch(ps, max_new_tokens=6)
    eng = ServingEngine(tm, device="cpu", **_kw(**kw))
    assert eng.generate_batch(ps, max_new_tokens=6) == want
    assert eng.kv.blocks_in_use == 0
    assert eng.cfg.quant_bits == 8


def test_refuses_engine_quantization_of_quantized_experts(stacks):
    tm = stacks["moe-int8"][1]
    for dt in ("int8", "int4"):
        with pytest.raises(ValueError, match="already"):
            ServingEngine(tm, device="cpu", moe_weight_dtype=dt, **_kw())


def test_grid_snapped_int4_token_identical(stacks):
    """Expert weights on the exact int4 grid: the engine's int4 packing
    round-trips them, so the float and int4 engines agree, as JAX's do."""
    jm = _jax_model(moe=MOE, weight_only=False, seed=7)
    for attr in ("ffn1_weights", "ffn2_weights"):
        w = getattr(jm.decoder, attr)._data.astype(jnp.float32)
        sc = jnp.maximum(jnp.max(jnp.abs(w), axis=-2), 1e-9)
        q = jnp.clip(jnp.round(w / sc[:, :, None, :] * 7.0), -7, 7)
        getattr(jm.decoder, attr)._data = q * (sc[:, :, None, :] / 7.0)
    tm = load_jax_gpt(_arrays(jm), HEADS, moe=MOE, device="cpu")
    ps = _prompts(3, (3, 9, 17, 5, 12))
    want = JaxEngine(jm, **_kw(moe_weight_dtype="int4")).generate_batch(
        ps, max_new_tokens=6)
    fp = ServingEngine(tm, device="cpu", **_kw()).generate_batch(
        ps, max_new_tokens=6)
    q4 = ServingEngine(tm, device="cpu", **_kw(moe_weight_dtype="int4"))
    assert q4.generate_batch(ps, max_new_tokens=6) == fp == want
    assert q4._layers[0]["ffn1_w"].shape[-2] == 16
    assert q4._layers[0]["ffn1_s"].dtype == torch.float16


@pytest.mark.parametrize("name", ["dense", "moe-int4"])
def test_adapters_on_weight_only_stack_match_jax(stacks, name):
    jm, tm = stacks[name]
    ads = {t: make_random_adapter(jm.decoder, 4, seed=i + 1, scale=0.3)
           for i, t in enumerate(("t1", "t2", "t3"))}
    ps = _prompts(3, (4, 11, 6, 9, 14))
    mix = ["t1", "t2", None, "t3", "t1"]
    outs = []
    for eng in (JaxEngine(jm, **_kw(max_adapters=3, lora_rank=4)),
                ServingEngine(tm, device="cpu",
                              **_kw(max_adapters=3, lora_rank=4))):
        for t, w in ads.items():
            eng.register_adapter(t, w)
        reqs = [eng.submit(p, 6, adapter_id=t) for p, t in zip(ps, mix)]
        eng.run()
        outs.append([list(r.output) for r in reqs])
    assert outs[1] == outs[0]
    assert eng.adapters.evictions >= 1 and eng.adapters.total_pins == 0


def test_convert_refuses_what_does_not_fit(stacks):
    jm = stacks["dense"][0]
    arrays = _arrays(jm)
    bad = dict(arrays, qkv_w=arrays["qkv_w"].astype(np.float32))
    with pytest.raises(ValueError, match="qkv_w"):
        load_jax_gpt(bad, HEADS, device="cpu")
    bad = dict(arrays, out_s=arrays["out_s"].astype(np.float16))
    with pytest.raises(ValueError, match="out_s"):
        load_jax_gpt(bad, HEADS, device="cpu")
    bad = dict(arrays)
    del bad["ffn2_s"]
    with pytest.raises(ValueError, match="scales"):
        load_jax_gpt(bad, HEADS, device="cpu")
    bad = dict(arrays, qkv_s=arrays["qkv_s"][:, :-1])
    with pytest.raises(ValueError, match="qkv_s"):
        load_jax_gpt(bad, HEADS, device="cpu")
    # packed int4 experts (fp16 scales, half the rows) need
    # moe_quant_bits=4
    arrays4 = _arrays(stacks["moe-int4"][0])
    with pytest.raises(ValueError, match="ffn"):
        load_jax_gpt(arrays4, HEADS, moe=MOE, device="cpu")
    tm = load_jax_gpt(arrays4, HEADS, moe=STACKS["moe-int4"], device="cpu")
    assert tm.decoder.ffn1_s.dtype == torch.float16
