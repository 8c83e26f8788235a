"""The port's multi-LoRA adapters against the JAX package's.

`ServingEngine(max_adapters=K, lora_rank=r)` serves registered LoRA
finetunes beside the base model: `serving.adapters.AdapterCache` keeps
the fixed [L, K, ...] slot tensors and the pin / LRU ledger, the
scheduler pins a request's adapter at admission (blocking while every
slot is pinned) and bypasses the prefix cache for it, and every hooked
projection adds `_lora_delta` through one [T, K] one-hot a step. At
tests/test_adapters.py's sizes (vocab 211, hidden 32, 2 layers, 4 heads,
block_size=4, fp32, CPU, the weights carried across by
`paddle_tpu_torch.convert`, the adapters JAX's `make_random_adapter`
as numpy):

* `_lora_delta` equals JAX's within 1e-6, and the null slot's delta is
  exactly 0;
* the same register / acquire / release sequence gives JAX's slots,
  pins, hits, misses, evictions and `bytes_per_slot`; MoE stacks hook
  attention only; bad registrations raise as JAX's do;
* engines give the JAX engine's greedy tokens, tolerance 0: null-adapter
  requests (also equal to an engine without adapters), three tenants on
  two usable slots with evictions (each tenant also equal to a solo
  engine), preemption that re-acquires the adapter, admission blocked
  until a pin frees, adapter requests beside a prefix cache (hits only
  for base requests), draft_k=3 and 4 ticks a dispatch; unknown
  adapters are refused at `submit`, and pins and blocks are zero after
  every drain.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.incubate.nn import fused_transformer as jft
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving.adapters import AdapterCache as JaxCache
from paddle_tpu.serving.adapters import hook_dims as jax_hook_dims
from paddle_tpu.serving.adapters import make_random_adapter
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.incubate.nn import fused_transformer as tft
from paddle_tpu_torch.serving import adapters as tad
from paddle_tpu_torch.serving.engine import ServingEngine

VOCAB, HEADS, RANK = 211, 4, 4
MOE = dict(num_expert=4, top_k=2, capacity_factor=2.0)


def _carry(jm, moe=None):
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    arrays = {n: np.asarray(t._data) for n, t in zip(names, tensors)}
    return load_jax_gpt(arrays, HEADS, moe=moe, device="cpu")


def _jax_model(moe=None, seed=0):
    paddle.seed(seed)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32", moe=moe)
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def models():
    """(jax model, port model on the CPU) with the same weights."""
    jm = _jax_model()
    return jm, _carry(jm)


@pytest.fixture(scope="module")
def tenants(models):
    """Three tenants' adapters (JAX's draws, as numpy)."""
    return {t: make_random_adapter(models[0].decoder, RANK, seed=i + 1,
                                   scale=0.3)
            for i, t in enumerate(("t1", "t2", "t3"))}


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(n)).tolist() for n in lens]


def _kw(**kw):
    return dict(dict(max_slots=4, block_size=4, max_seq_len=64,
                     cache_dtype="float32", seed=0), **kw)


def _serve(eng, prompts, adapters, new, ads):
    """Register `ads`, submit each prompt under its adapter, drain;
    returns (outputs, requests)."""
    for t, w in ads.items():
        eng.register_adapter(t, w)
    reqs = [eng.submit(p, new, adapter_id=a)
            for p, a in zip(prompts, adapters)]
    eng.run()
    return [list(r.output) for r in reqs], reqs


def _both(models, prompts, adapters, new, ads, **kw):
    """The JAX engine's and the port's (outputs, engine) on one mix."""
    jm, tm = models
    je = JaxEngine(jm, **_kw(**kw))
    te = ServingEngine(tm, device="cpu", **_kw(**kw))
    jo, _ = _serve(je, prompts, adapters, new, ads)
    to, _ = _serve(te, prompts, adapters, new, ads)
    return (jo, je), (to, te)


def _drained(te):
    assert te.adapters.total_pins == 0
    assert te.kv.blocks_in_use == 0 or te.prefix_cache is not None


# ------------------------------------------------------------ the delta


@pytest.mark.parametrize("T,K,d_in,d_out", [(7, 3, 32, 96), (16, 5, 64, 32)])
def test_lora_delta_matches_jax(T, K, d_in, d_out):
    rng = np.random.RandomState(T + K)
    x = rng.randn(T, d_in).astype(np.float32)
    a = rng.randn(K, d_in, RANK).astype(np.float32) * 0.3
    b = rng.randn(K, RANK, d_out).astype(np.float32) * 0.3
    a[0] = 0.0
    b[0] = 0.0
    ids = rng.randint(0, K, T)
    ids[:2] = 0
    oh = np.eye(K, dtype=np.float32)[ids]
    want = np.asarray(jft._lora_delta(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), jnp.asarray(oh)))
    got = tft._lora_delta(torch.tensor(x), torch.tensor(a), torch.tensor(b),
                          torch.tensor(oh)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the null slot's rows are exactly zero
    assert np.all(got[ids == 0] == 0.0)
    # a [B, S, D] input keeps its leading axes
    got3 = tft._lora_delta(torch.tensor(x)[None], torch.tensor(a),
                           torch.tensor(b), torch.tensor(oh))
    assert got3.shape == (1, T, d_out)
    assert torch.equal(got3[0], torch.tensor(got))


# ------------------------------------------------------------ the ledger


def _ledger(c):
    return (dict(c._resident), list(c._slot_ids),
            [int(p) for p in c._pins], c.cache_hits, c.cache_misses,
            c.evictions)


def test_cache_ledger_matches_jax(models):
    jm, tm = models
    jc = JaxCache(jm.decoder, max_adapters=3, rank=RANK)
    tc = tad.AdapterCache(tm.decoder, max_adapters=3, rank=RANK,
                          device="cpu")
    assert tc.bytes_per_slot == jc.bytes_per_slot
    for name in ("a", "b", "d"):
        ad = make_random_adapter(jm.decoder, RANK, seed=1)
        jc.register(name, ad)
        tc.register(name, ad)
    ops = [("acquire", "a"), ("acquire", "b"), ("acquire", "d"),
           ("release", "a"), ("acquire", "d"), ("acquire", "a"),
           ("release", "b"), ("acquire", "a"), ("acquire", "a"),
           ("acquire", None), ("release", "a"), ("release", "a"),
           ("release", "d"), ("acquire", "b"), ("release", "b")]
    for op, name in ops:
        assert getattr(tc, op)(name) == getattr(jc, op)(name), (op, name)
        assert _ledger(tc) == _ledger(jc), (op, name)
    assert tc.total_pins == jc.total_pins == 0
    assert tc.evictions >= 2 and tc.hit_ratio() == jc.hit_ratio()
    for c in (tc, jc):
        with pytest.raises(ValueError):
            c.release("a")                       # release without a pin


def test_loaded_slots_hold_the_scaled_weights(models):
    """A load writes A and B * alpha / r into the slot, the null slot
    stays zero, and a re-load after eviction rewrites the slot."""
    jm, tm = models
    c = tad.AdapterCache(tm.decoder, max_adapters=2, rank=RANK, alpha=8.0,
                         device="cpu")
    ads = {t: make_random_adapter(jm.decoder, RANK, seed=s)
           for t, s in (("x", 3), ("y", 4))}
    for t, w in ads.items():
        c.register(t, w)
    for t in ("x", "y", "x"):
        slot = c.acquire(t)
        assert slot == 1
        for name, (a, b) in ads[t].items():
            ta = c.tensors[f"lora_{name}_a"]
            tb = c.tensors[f"lora_{name}_b"]
            assert torch.equal(ta[:, 1], torch.tensor(a))
            want_b = (np.asarray(b, np.float64) * 2.0).astype(np.float32)
            assert torch.equal(tb[:, 1], torch.tensor(want_b))
            assert not ta[:, 0].any() and not tb[:, 0].any()
        c.release(t)
    assert c.evictions == 2 and c.cache_misses == 3


def test_registration_checks_match_jax(models):
    jm, tm = models
    with pytest.raises(ValueError):
        tad.AdapterCache(tm.decoder, max_adapters=1, rank=RANK,
                         device="cpu")
    with pytest.raises(ValueError):
        tad.AdapterCache(tm.decoder, max_adapters=3, rank=0, device="cpu")
    c = tad.AdapterCache(tm.decoder, max_adapters=3, rank=RANK,
                         device="cpu")
    assert c.acquire(None) == 0 and c.resident(None)
    assert c.resident_count == 0
    ad = make_random_adapter(jm.decoder, RANK, seed=1)
    c.register("a", ad)
    with pytest.raises(ValueError):
        c.register("b", {"qkv": ad["qkv"]})               # missing hooks
    a, b = ad["qkv"]
    with pytest.raises(ValueError):
        c.register("b", dict(ad, qkv=(a[:, :, :2], b)))   # wrong rank
    with pytest.raises(ValueError):
        c.register(None, ad)
    with pytest.raises(ValueError):
        c.acquire("never-registered")


def test_hooks_and_random_adapters_match_jax():
    jm = _jax_model(moe=MOE)
    tm = _carry(jm, moe=MOE)
    assert tad.hook_dims(tm.decoder) == jax_hook_dims(jm.decoder)
    assert [n for n, _, _ in tad.hook_dims(tm.decoder)] == list(tad.MOE_HOOKS)
    want = make_random_adapter(jm.decoder, RANK, seed=5)
    got = tad.make_random_adapter(tm.decoder, RANK, seed=5)
    assert list(got) == list(want) == ["qkv", "out"]
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert np.array_equal(g, w)


# ------------------------------------------------------------ engines


def test_null_adapter_matches_jax_and_adapter_free(models, tenants):
    jm, tm = models
    ps = _prompts(7, (3, 9, 17, 5))
    base = ServingEngine(tm, device="cpu", **_kw()).generate_batch(
        ps, max_new_tokens=6)
    (jo, _), (to, te) = _both(models, ps, [None] * 4, 6,
                              {"t1": tenants["t1"]}, max_adapters=3,
                              lora_rank=RANK)
    assert to == jo == base
    assert te.adapters.cache_misses == 0
    _drained(te)


def test_tenant_churn_matches_jax_and_solo(models, tenants):
    """Three tenants and the base model on two usable slots: at least one
    eviction; each tenant's requests also equal a solo engine's."""
    ps = _prompts(3, (4, 11, 6, 9, 14, 5, 8, 7))
    mix = ["t1", "t2", "t1", "t3", None, "t1", "t3", "t2"]
    (jo, je), (to, te) = _both(models, ps, mix, 6, tenants, max_adapters=3,
                               lora_rank=RANK)
    assert to == jo
    assert te.adapters.evictions == je.adapters.evictions >= 1
    assert (te.adapters.cache_hits, te.adapters.cache_misses) == \
        (je.adapters.cache_hits, je.adapters.cache_misses)
    _drained(te)
    # a tenant changes tokens: its rows differ from the base model's
    base = ServingEngine(models[1], device="cpu", **_kw()).generate_batch(
        ps, max_new_tokens=6)
    assert any(to[i] != base[i] for i, t in enumerate(mix) if t)
    for t in tenants:
        solo = ServingEngine(models[1], device="cpu",
                             **_kw(max_adapters=2, lora_rank=RANK))
        idx = [i for i, x in enumerate(mix) if x == t]
        so, _ = _serve(solo, [ps[i] for i in idx], [t] * len(idx), 6,
                       {t: tenants[t]})
        assert so == [to[i] for i in idx]


def test_preemption_reacquires_adapter(models, tenants):
    ps = _prompts(13, (9, 11, 10))
    (jo, _), (to, te) = _both(models, ps, ["t1", "t1", None], 8,
                              {"t1": tenants["t1"]}, max_adapters=2,
                              lora_rank=RANK, num_blocks=13)
    assert te.scheduler.preemption_count > 0
    assert to == jo
    roomy = ServingEngine(models[1], device="cpu",
                          **_kw(max_adapters=2, lora_rank=RANK))
    ro, _ = _serve(roomy, ps, ["t1", "t1", None], 8, {"t1": tenants["t1"]})
    assert to == ro
    _drained(te)


def test_admission_blocks_until_a_pin_frees(models, tenants):
    """Every usable slot pinned by running requests: a third tenant's
    request waits queued, then runs once a tenant finishes."""
    jm, tm = models
    ps = _prompts(9, (4, 4, 4))
    mix, news = ["t1", "t2", "t3"], (10, 10, 4)
    outs = []
    for eng in (JaxEngine(jm, **_kw(max_slots=2, max_adapters=3,
                                    lora_rank=RANK)),
                ServingEngine(tm, device="cpu",
                              **_kw(max_slots=2, max_adapters=3,
                                    lora_rank=RANK))):
        for t in mix:
            eng.register_adapter(t, tenants[t])
        reqs = [eng.submit(p, n, adapter_id=t)
                for p, n, t in zip(ps, news, mix)]
        eng.step()
        assert reqs[0].slot >= 0 and reqs[1].slot >= 0
        assert reqs[2].state == "queued"
        eng.run()
        assert all(r.state == "finished" for r in reqs)
        outs.append([list(r.output) for r in reqs])
    assert outs[1] == outs[0]
    assert len(outs[1][2]) == 4
    _drained(eng)


def test_prefix_cache_bypassed_for_adapter_requests(models, tenants):
    """The same prompt under two adapters, then twice under the base
    model: adapter requests neither hit nor seed the tree; the second
    base request hits."""
    jm, tm = models
    head = _prompts(17, (16,))[0]
    order = ["t1", "t2", None, None]
    runs = []
    for eng in (JaxEngine(jm, **_kw(max_adapters=3, lora_rank=RANK,
                                    prefix_caching=True)),
                ServingEngine(tm, device="cpu",
                              **_kw(max_adapters=3, lora_rank=RANK,
                                    prefix_caching=True))):
        for t in ("t1", "t2"):
            eng.register_adapter(t, tenants[t])
        reqs = []
        for t in order:
            reqs.append(eng.submit(head, 6, adapter_id=t))
            eng.run()
        runs.append(([list(r.output) for r in reqs],
                     [r.cache_hit_tokens for r in reqs]))
    assert runs[1] == runs[0]
    outs, hits = runs[1]
    assert hits[0] == hits[1] == hits[2] == 0 and hits[3] > 0
    assert outs[0] != outs[1] and outs[2] == outs[3]
    assert eng.adapters.total_pins == 0


@pytest.mark.parametrize("kw", [dict(draft_k=3), dict(ticks_per_dispatch=4),
                                dict(draft_k=3, ticks_per_dispatch=4)],
                         ids=["draft3", "ticks4", "draft3-ticks4"])
def test_engine_variants_match_jax(models, tenants, kw):
    ps = _prompts(5, (6, 12, 3, 9, 7))
    mix = ["t1", None, "t2", "t3", "t1"]
    (jo, _), (to, te) = _both(models, ps, mix, 8, tenants, max_adapters=3,
                              lora_rank=RANK, **kw)
    assert to == jo
    assert te.adapters.evictions >= 1
    _drained(te)
    if kw.get("ticks_per_dispatch"):
        # the multi-tick engine equals its 1-tick twin
        one = ServingEngine(models[1], device="cpu",
                            **_kw(max_adapters=3, lora_rank=RANK,
                                  draft_k=kw.get("draft_k", 0)))
        oo, _ = _serve(one, ps, mix, 8, tenants)
        assert to == oo
        assert te.device_ticks_run > te.dispatches_run


def test_unknown_adapter_refused_at_submit(models, tenants):
    tm = models[1]
    e = ServingEngine(tm, device="cpu", **_kw(max_adapters=2,
                                              lora_rank=RANK))
    with pytest.raises(ValueError):
        e.submit([1, 2, 3], 4, adapter_id="nope")
    base = ServingEngine(tm, device="cpu", **_kw())
    with pytest.raises(ValueError):
        base.submit([1, 2, 3], 4, adapter_id="t1")
    with pytest.raises(ValueError):
        base.register_adapter("t1", tenants["t1"])
    assert not e.scheduler.queue and not base.scheduler.queue
