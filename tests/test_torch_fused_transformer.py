"""The PyTorch port's decoder math against the JAX package.

`_ln`, `_qkv`, `_ffn_dense`, one whole layer of the serving mixed step
(pool writes + paged attention included), the embedding, the dense
causal forward and the weight carry-over (`convert.load_jax_gpt`), each
on the same numpy weights and inputs, in fp32 at 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import fused_transformer as jft
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.ops.pallas.flash_attention import ragged_gather_reference
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.incubate.nn import fused_transformer as tft
from paddle_tpu_torch.serving.engine import _mixed_layer

D, H, Dh, FF = 32, 4, 8, 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _layer_params(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"ln_s": (D,), "ln_b": (D,), "qkv_w": (D, 3 * D),
              "qkv_b": (3 * D,), "out_w": (D, D), "out_b": (D,),
              "ffn_ln_s": (D,), "ffn_ln_b": (D,), "ffn1_w": (D, FF),
              "ffn1_b": (FF,), "ffn2_w": (FF, D), "ffn2_b": (D,)}
    p = {n: (rng.randn(*s) * (0.3 if n.endswith("_w") else 0.1)
             ).astype(np.float32) for n, s in shapes.items()}
    p["ln_s"] += 1.0
    p["ffn_ln_s"] += 1.0
    return p


def _both(p):
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.tensor(a) for n, a in p.items()})


def _cfgs():
    jcfg = jft._MTConfig(num_layers=1, num_heads=H, head_dim=Dh,
                         dim_ff=FF)
    tcfg = tft._MTConfig(num_layers=1, num_heads=H, head_dim=Dh,
                         dim_ff=FF)
    return jcfg, tcfg


def test_ln_matches():
    x = np.random.RandomState(1).randn(5, D).astype(np.float32) * 3 + 1
    p = _layer_params()
    want = jft._ln(jnp.asarray(x), jnp.asarray(p["ln_s"]),
                   jnp.asarray(p["ln_b"]), 1e-5)
    got = tft._ln(torch.tensor(x), torch.tensor(p["ln_s"]),
                  torch.tensor(p["ln_b"]), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qkv_matches():
    x = np.random.RandomState(2).randn(2, 6, D).astype(np.float32)
    jp, tp = _both(_layer_params())
    jcfg, tcfg = _cfgs()
    for want, got in zip(jft._qkv(jcfg, jp, jnp.asarray(x)),
                         tft._qkv(tcfg, tp, torch.tensor(x))):
        assert tuple(got.shape) == (2, 6, H, Dh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_ffn_dense_matches(activation):
    import dataclasses
    x = np.random.RandomState(3).randn(7, D).astype(np.float32)
    jp, tp = _both(_layer_params())
    jcfg, tcfg = (dataclasses.replace(c, activation=activation)
                  for c in _cfgs())
    want = jft._ffn_dense(jcfg, jp, jnp.asarray(x))
    got = tft._ffn_dense(tcfg, tp, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_mixed_layer(cfg, pl, h, kp, vp, wb, wo, bt, slot_ids, pos):
    """serving/engine.py's layer body (K == 1, float pools, no
    LoRA/MoE/sparse), composed from the JAX package's functions."""
    hn = jft._ln(h, pl["ln_s"], pl["ln_b"], cfg.epsilon)
    q, k, v = jft._qkv(cfg, pl, hn[None])
    q, k, v = q[0], k[0], v[0]
    kp = kp.at[wb, wo].set(k.astype(kp.dtype))
    vp = vp.at[wb, wo].set(v.astype(vp.dtype))
    attn = ragged_gather_reference(q, kp, vp, bt, slot_ids, pos)
    attn = attn.reshape(h.shape[0], cfg.num_heads * cfg.head_dim)
    out = jft._mm(cfg, attn, pl["out_w"], None)
    h = h + (out + pl["out_b"].astype(out.dtype))
    hn = jft._ln(h, pl["ffn_ln_s"], pl["ffn_ln_b"], cfg.epsilon)
    return h + jft._ffn_dense(cfg, pl, hn), kp, vp


def test_mixed_layer_matches():
    """One layer of the mixed step on a flat axis of two decodes, a
    prefill chunk and padding: output and pools (the in-place writes)
    against the JAX layer body."""
    rng = np.random.RandomState(4)
    BS, NB, S, MB, T = 4, 9, 3, 4, 12
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]], np.int32)
    slots = np.array([0, 1] + [2] * 3 + [-1] * 7, np.int32)
    pos = np.array([9, 5, 0, 1, 2] + [0] * 7, np.int32)
    kp = rng.randn(NB, BS, H, Dh).astype(np.float32)
    vp = rng.randn(NB, BS, H, Dh).astype(np.float32)
    h = rng.randn(T, D).astype(np.float32)
    valid = slots >= 0
    wb = np.where(valid, bt[np.maximum(slots, 0), pos // BS], 0)
    wo = pos % BS
    jp, tp = _both(_layer_params(5))
    jcfg, tcfg = _cfgs()
    want, jk, jv = _jax_mixed_layer(
        jcfg, jp, jnp.asarray(h), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(wb), jnp.asarray(wo), jnp.asarray(bt),
        jnp.asarray(slots), jnp.asarray(pos))
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    got, moe_stats = _mixed_layer(tcfg, tp, torch.tensor(h), tk, tv,
                                  torch.tensor(wb), torch.tensor(wo),
                                  torch.tensor(bt), torch.tensor(slots),
                                  torch.tensor(pos))
    assert moe_stats is None                 # a dense layer routes nothing
    np.testing.assert_allclose(got.numpy()[valid],
                               np.asarray(want)[valid], **TOL)
    # block 0 is the NULL block: padding writes there race by design
    np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:], **TOL)
    np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:], **TOL)


def _jax_model():
    paddle.seed(1234)
    m = JaxGPT(vocab_size=193, hidden_size=D, num_layers=2,
               num_attention_heads=H, max_position_embeddings=128,
               compute_dtype="float32")
    m.eval()
    tensors = m._gen_tensors()             # also sets m._dec_names
    names = (["word_embeddings", "position_embeddings"]
             + list(m._dec_names) + ["ln_f.weight", "ln_f.bias",
                                     "lm_head.weight"])
    arrays = {n: np.asarray(t._data) for n, t in zip(names, tensors)}
    return m, arrays


def test_embed_matches():
    jm, arrays = _jax_model()
    tm = load_jax_gpt(arrays, H, device="cpu")
    ids = np.array([5, 0, 192, 7], np.int32)
    pos = np.array([0, 3, 127, 400], np.int32)      # 400 clips to 127
    want = jm._embed(jnp.asarray(arrays["word_embeddings"]),
                     jnp.asarray(arrays["position_embeddings"]),
                     jnp.asarray(ids), jnp.asarray(pos))
    got = tm._embed(tm.word_embeddings.weight,
                    tm.position_embeddings.weight, torch.tensor(ids),
                    torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_forward_matches_jax_forward():
    """The plain causal forward (the on-card scoring oracle) against
    the JAX model's eager forward on carried-over weights."""
    jm, arrays = _jax_model()
    tm = load_jax_gpt(arrays, H, device="cpu")
    ids = np.random.RandomState(6).randint(0, 193, (2, 11))
    want = np.asarray(jm(Tensor(ids.astype(np.int64))).numpy())
    got = tm(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_convert_carries_every_parameter():
    _, arrays = _jax_model()
    tm = load_jax_gpt(arrays, H, device="cpu")
    state = tm.state_dict()
    assert len(state) == len(arrays)
    np.testing.assert_array_equal(state["decoder.qkv_w"].numpy(),
                                  arrays["qkv_w"])
    np.testing.assert_array_equal(state["lm_head.weight"].numpy(),
                                  arrays["lm_head.weight"])
    bad = dict(arrays)
    del bad["ln_f.bias"]
    with pytest.raises(ValueError):
        load_jax_gpt(bad, H, device="cpu")
