"""The port's MoE serving path against the JAX package's.

Routing (`parallel.moe_utils`), the MoE FFN of the mixed step
(`_ffn_moe_tokens`, float / int8 / int4 experts), the MoE
`GPTForGeneration.forward` and the `ServingEngine` on a MoE model: the
same numpy inputs, or the same weights carried across by
`convert.load_jax_gpt(moe=...)`, on both sides. The JAX engine runs on
its CPU einsum path (one-hot dispatch and combine), the port on its
index path with the plain grouped matmul: the same function, summed in
another order. Vocab 193, hidden 32, 2 layers, 4 heads, 4 experts,
top-2; capacity factor 1.25 (prefill chunks overflow, tokens drop) and
2.0 (nothing drops at T = 8, E = 4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import fused_transformer as jft
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.parallel import moe_utils as jmu
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.incubate.nn import fused_transformer as tft
from paddle_tpu_torch.models.gpt import GPTForGeneration
from paddle_tpu_torch.parallel import moe_utils as tmu
from paddle_tpu_torch.serving.engine import ServingEngine

VOCAB, HIDDEN, LAYERS, HEADS, E, TOPK = 193, 32, 2, 4, 4, 2


def _np(a):
    return np.asarray(a)


def _routing_case(seed=0, T=37):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(T, E) * 2).astype(np.float32)
    logits[:, 0] += 3.0                     # a favourite: it overflows
    valid = rng.rand(T) > 0.2
    return logits, valid


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_top_k_routing_matches(cf):
    logits, valid = _routing_case()
    T = logits.shape[0]
    C = tmu.expert_capacity(T, E, TOPK, cf)
    assert C == jmu.expert_capacity(T, E, TOPK, cf)
    j = jmu.top_k_routing(jnp.asarray(logits), TOPK, C,
                          valid=jnp.asarray(valid), build_masks=False)
    t = tmu.top_k_routing(torch.tensor(logits), TOPK, C,
                          valid=torch.tensor(valid))
    ok = valid[:, None]                    # padding rows route nowhere
    assert np.array_equal(np.where(ok, t.plan.gate_idx.numpy(), -1),
                          np.where(ok, _np(j.plan.gate_idx), -1))
    for f in ("slot", "in_cap", "counts", "dropped"):
        assert np.array_equal(getattr(t.plan, f).numpy(),
                              _np(getattr(j.plan, f))), f
    if cf == 1.25:
        assert float(t.plan.dropped) > 0       # overflow really happened
    assert np.array_equal(tmu.dispatch_indices(t.plan, E, C).numpy(),
                          _np(jmu.dispatch_indices(j.plan, E, C)))
    # fp32 softmax and sums in another order: within 1e-6
    np.testing.assert_allclose(t.gates.numpy(), _np(j.gates), atol=1e-6)
    for f in ("balance_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(t, f)),
                                   float(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6)


def _tied_logits(case):
    """[6, 8] router logits that tie: all of them (a zero gate_w), or
    some rows' top two and some lower entries (partly)."""
    logits = np.zeros((6, 8), np.float32)
    if case == "partly":
        logits[0, [6, 3]] = 2.0          # a tie for the top
        logits[1, [7, 1, 4]] = 1.5       # three-way tie for the top two
        logits[2, 5], logits[2, [2, 0]] = 3.0, 1.0   # a tie for second
        logits[3] = np.arange(8, dtype=np.float32)   # no tie
        logits[4, 2] = -1.0              # the rest tied at the top
    return logits


# The input of ROADMAP Queue 3 item 1: T=6, E=8, k=2, C=2. On ties the
# lower expert comes first, as in jax.lax.top_k: a zero gate_w sends
# every token to (0, 1), and the capacity keeps two of each.
@pytest.mark.parametrize("case", ["all", "partly"])
def test_top_k_routing_matches_on_ties(case):
    logits = _tied_logits(case)
    j = jmu.top_k_routing(jnp.asarray(logits), 2, 2, build_masks=False)
    t = tmu.top_k_routing(torch.tensor(logits), 2, 2)
    if case == "all":
        assert t.plan.gate_idx.tolist() == [[0, 1]] * 6
        assert t.plan.counts.tolist() == [2, 2, 0, 0, 0, 0, 0, 0]
    for f in ("gate_idx", "slot", "in_cap", "counts", "dropped"):
        assert np.array_equal(getattr(t.plan, f).numpy(),
                              _np(getattr(j.plan, f))), f
    np.testing.assert_allclose(t.gates.numpy(), _np(j.gates), atol=1e-6)


def test_dispatch_and_combine_indexed_match():
    logits, valid = _routing_case(1)
    T, d = logits.shape[0], 6
    C = tmu.expert_capacity(T, E, TOPK, 1.25)
    j = jmu.top_k_routing(jnp.asarray(logits), TOPK, C,
                          valid=jnp.asarray(valid), build_masks=False)
    t = tmu.top_k_routing(torch.tensor(logits), TOPK, C,
                          valid=torch.tensor(valid))
    rng = np.random.RandomState(2)
    x = rng.randn(T, d).astype(np.float32)
    assert np.array_equal(
        tmu.dispatch_tokens_indexed(torch.tensor(x), t.plan, E, C).numpy(),
        _np(jmu.dispatch_tokens_indexed(jnp.asarray(x), j.plan, E, C)))
    eout = rng.randn(E, C, d).astype(np.float32)
    np.testing.assert_allclose(
        tmu.combine_tokens_indexed(torch.tensor(eout), t.plan).numpy(),
        _np(jmu.combine_tokens_indexed(jnp.asarray(eout), j.plan)),
        atol=1e-6)


def _moe_layer(seed, D=HIDDEN, Fd=4 * HIDDEN):
    rng = np.random.RandomState(seed)
    return {"gate_w": (rng.randn(D, E) / np.sqrt(D)).astype(np.float32),
            "ffn1_w": (rng.randn(E, D, Fd) / np.sqrt(D)).astype(np.float32),
            "ffn1_b": (rng.randn(E, Fd) * 0.1).astype(np.float32),
            "ffn2_w": (rng.randn(E, Fd, D) / np.sqrt(Fd)).astype(np.float32),
            "ffn2_b": (rng.randn(E, D) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("fmt", [None, "int8", "int4"])
def test_ffn_moe_tokens_matches(fmt):
    """One mixed-step MoE FFN (T = 16, capacity factor 1.25: drops),
    float or engine-quantized experts. Tolerance 1e-5: fp32 products
    summed in another order (einsum combine vs gather-sum)."""
    p = _moe_layer(3)
    p["gate_w"][:, 0] += 3.0 / HIDDEN       # with h + 1: expert 0 overflows
    bits = {None: 0, "int8": 8, "int4": 4}[fmt]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    if bits:
        for w in ("ffn1_w", "ffn2_w"):
            jq, js = jft._quantize_expert_stack(jp[w][None], bits)
            tq, ts = tft._quantize_expert_stack(tp[w][None], bits)
            assert np.array_equal(tq.numpy(), _np(jq))
            jp[w], jp[w[:-2] + "_s"] = jq[0], js[0]
            tp[w], tp[w[:-2] + "_s"] = tq[0], ts[0]
    kw = dict(num_layers=1, num_heads=HEADS, head_dim=HIDDEN // HEADS,
              dim_ff=4 * HIDDEN, num_experts=E, moe_topk=TOPK,
              capacity_factor=1.25, moe_quant_bits=bits)
    rng = np.random.RandomState(4)
    h = rng.randn(16, HIDDEN).astype(np.float32) + 1.0
    valid = np.arange(16) < 13
    jout, jst = jft._ffn_moe_tokens(jft._MTConfig(**kw), jp, jnp.asarray(h),
                                    jnp.asarray(valid))
    tout, tst = tft._ffn_moe_tokens(tft._MTConfig(**kw), tp,
                                    torch.tensor(h), torch.tensor(valid))
    np.testing.assert_allclose(tout.numpy(), _np(jout), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(tst["counts"].numpy(), _np(jst["counts"]))
    assert float(tst["dropped"]) == float(jst["dropped"]) > 0
    np.testing.assert_allclose(float(tst["aux"]), float(jst["aux"]),
                               rtol=1e-6)


def _jax_moe_model(cf):
    paddle.seed(1234)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                num_attention_heads=HEADS, max_position_embeddings=64,
                compute_dtype="float32",
                moe=dict(num_expert=E, top_k=TOPK, capacity_factor=cf))
    jm.eval()
    tensors = jm._gen_tensors()             # also sets jm._dec_names
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    return jm, {n: np.asarray(t._data) for n, t in zip(names, tensors)}


@pytest.fixture(scope="module")
def models():
    """cf -> (jax MoE model, its arrays, the port's model on the CPU),
    each built once."""
    built = {}

    def get(cf):
        if cf not in built:
            jm, arrays = _jax_moe_model(cf)
            moe = dict(num_expert=E, top_k=TOPK, capacity_factor=cf)
            built[cf] = (jm, arrays, load_jax_gpt(arrays, HEADS, moe=moe,
                                                  device="cpu"))
        return built[cf]
    return get


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_forward_logits_match(models, cf):
    """The dense scoring pass: all B * S tokens routed at once. fp32,
    1e-4: two layers of products summed in another order."""
    jm, _, tm = models(cf)
    ids = np.random.RandomState(5).randint(1, VOCAB, (2, 11))
    want = _np(jm(paddle.to_tensor(ids))._data)
    got = tm(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


PROMPTS = [[3, 14, 15, 9, 2], [7, 8, 21, 90, 4, 33, 6, 1, 12], [42, 5, 17]]
ENGINE = dict(max_slots=4, block_size=4, max_seq_len=48,
              cache_dtype="float32")


def _serve_both(models, prompts, new_tokens, moe_weight_dtype, **kw):
    jm, _, tm = models
    je = JaxEngine(jm, moe_weight_dtype=moe_weight_dtype, **ENGINE, **kw)
    te = ServingEngine(tm, moe_weight_dtype=moe_weight_dtype, device="cpu",
                       **ENGINE, **kw)
    want = [je.submit(p, n) for p, n in zip(prompts, new_tokens)]
    got = [te.submit(p, n) for p, n in zip(prompts, new_tokens)]
    je.run()
    te.run()
    return [r.output for r in want], [r.output for r in got], je, te


@pytest.mark.parametrize("cf,fmt", [(1.25, None), (1.25, "int8"),
                                    (1.25, "int4"), (2.0, None)])
def test_engine_token_identical(models, cf, fmt):
    """Greedy tokens identical to the JAX engine's; the routing counts
    and drops summed over the run exactly equal, the last step's aux
    within 1e-5 (fp32 sums in another order)."""
    want, got, je, te = _serve_both(models(cf), PROMPTS, (4, 6, 5), fmt)
    assert got == want
    assert te.steps_run == je.steps_run
    assert np.array_equal(te.moe_expert_counts, je.moe_expert_counts)
    assert te.moe_dropped_total == je.moe_dropped_total
    np.testing.assert_allclose(te.moe_last_aux, je.moe_last_aux,
                               rtol=1e-5, atol=1e-5)
    if cf == 1.25:
        assert te.moe_dropped_total > 0
    else:
        assert te.moe_dropped_total == 0
    # every valid token's k choices are counted or dropped
    assert te.moe_expert_counts.sum() + te.moe_dropped_total == \
        TOPK * LAYERS * te.tokens_fed
    np.testing.assert_allclose(te.moe_utilization_entropy(),
                               je.moe_utilization_entropy(), rtol=1e-12)


def test_engine_token_identical_under_preemption(models):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (9, 5, 12, 3, 7)]
    want, got, je, te = _serve_both(models(1.25), prompts, (6,) * 5, None,
                                    num_blocks=8)
    assert te.scheduler.preemption_count > 0     # pressure was real
    assert te.scheduler.preemption_count == je.scheduler.preemption_count
    assert got == want
    assert np.array_equal(te.moe_expert_counts, je.moe_expert_counts)


def test_refusals(models):
    jm, arrays, tm = models(1.25)
    with pytest.raises(ValueError, match="int8"):
        ServingEngine(tm, moe_weight_dtype="int2", device="cpu", **ENGINE)
    dense_tm = GPTForGeneration(
        vocab_size=17, hidden_size=8, num_layers=1, num_attention_heads=2,
        device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(dense_tm, moe_weight_dtype="int8", device="cpu",
                      **ENGINE)
    moe = dict(num_expert=E, top_k=TOPK, capacity_factor=1.25)
    with pytest.raises(ValueError, match="gate_w"):
        load_jax_gpt(arrays, HEADS, device="cpu")        # moe= missing
    dense = {k: v for k, v in arrays.items() if k != "gate_w"}
    with pytest.raises(ValueError, match="gate_w"):
        load_jax_gpt(dense, HEADS, moe=moe, device="cpu")
    with pytest.raises(ValueError, match="scales"):
        load_jax_gpt(dict(arrays, ffn1_s=np.ones((LAYERS, E, 4 * HIDDEN),
                                                  np.float32)),
                     HEADS, moe=moe, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPTForGeneration(vocab_size=17, hidden_size=8, num_layers=1,
                         num_attention_heads=2, weight_only=True,
                         device="cpu")
    with pytest.raises(ValueError, match="ep_size"):
        tft.FusedMultiTransformerMoe(8, 2, 16, num_layers=1, ep_size=2,
                                     device="cpu")
