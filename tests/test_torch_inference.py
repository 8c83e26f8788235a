"""The port's `inference` surface against the JAX package's.

At the port's test size (vocab 193, hidden 32, 2 layers, 4 heads, fp32
pools, CPU, one JAX `GPTForGeneration` carried across by
`paddle_tpu_torch.convert.load_jax_gpt`), tolerance 0 (tokens are
integers):

* **`Config`** takes the knobs JAX's takes and refuses, with JAX's
  `ValueError`, what JAX's refuses, leaving itself as it was; the
  AnalysisConfig switches are no-ops;
* **`create_serving_engine`** builds engines whose tokens equal the JAX
  factory's engines' (greedy, a sampling dict's knobs, draft_k=2,
  overrides); `tensor_parallel=2` takes the `TPServingEngine` route;
* **`create_serving_router`** and **`create_serving_frontend`** serve
  JAX's tokens; the disaggregated fleet's knobs make the round trip to
  the router and every engine as they do in JAX; tensor-parallel fleets
  and `create_predictor` raise.
"""
import asyncio

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.serving import SamplingConfig
from paddle_tpu_torch.serving.distributed import ReplicaRouter

VOCAB, HEADS = 193, 4
PROMPTS = [[3, 14, 15, 9, 2], [7, 8], list(range(1, 12))]


@pytest.fixture(scope="module")
def models():
    paddle.seed(1234)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32")
    jm.eval()
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    arrays = {n: np.asarray(t._data) for n, t in zip(names, tensors)}
    return jm, load_jax_gpt(arrays, HEADS, device="cpu")


def _cfgs(**kw):
    return [pkg.Config().enable_continuous_batching(**kw)
            for pkg in (jinf, tinf)]


# ---------------------------------------------------------------- Config


BAD_KNOBS = [
    (dict(kv_dtype="int4"), "not supported"),
    (dict(prefill_replicas=1), "pair"),
    (dict(decode_replicas=1), "pair"),
    (dict(num_replicas=2, prefill_replicas=1, decode_replicas=1),
     "not both"),
    (dict(ticks_per_dispatch=0), "ticks_per_dispatch"),
    (dict(ticks_per_dispatch="fast"), "ticks_per_dispatch"),
    (dict(ticks_per_dispatch=True), "ticks_per_dispatch"),
    (dict(draft_k=-1), "draft_k"),
    (dict(draft_k=1.5), "draft_k"),
    (dict(draft_ring=1), "draft_ring"),
    (dict(penalty_vocab_bins=0), "penalty_vocab_bins"),
    (dict(penalty_vocab_bins=False), "penalty_vocab_bins"),
]


@pytest.mark.parametrize("knobs,match", BAD_KNOBS,
                         ids=[str(sorted(k)) + str(i) for i, (k, _m)
                              in enumerate(BAD_KNOBS)])
def test_config_refuses_what_jax_refuses(knobs, match):
    for pkg in (jinf, tinf):
        cfg = pkg.Config()
        cfg.enable_continuous_batching(max_slots=5, num_replicas=2)
        with pytest.raises(ValueError, match=match):
            cfg.enable_continuous_batching(**knobs)
        # a raising call leaves the config as it was
        assert cfg.serving_config()["max_slots"] == 5
        assert cfg._num_replicas == 2 and cfg._prefill_replicas is None


def test_config_takes_what_jax_takes():
    knobs = dict(max_slots=3, block_size=4, num_blocks=40, max_seq_len=64,
                 token_budget=32, eos_token_id=2, cache_dtype="float32",
                 kv_dtype="int8", draft_k=2, draft_ngram=2, draft_ring=16,
                 penalty_vocab_bins=64, prefix_caching=True, max_pending=9,
                 sampling=dict(strategy="sampling", top_k=5),
                 tensor_parallel=1, expert_parallel=1, num_replicas=None,
                 router_policy="round_robin", prefill_replicas=1,
                 decode_replicas=2, migration={"imbalance": 3},
                 max_adapters=2, lora_rank=4, lora_alpha=8.0,
                 moe_weight_dtype=None, sparse_blocks=4, sparse_recent=2,
                 ticks_per_dispatch="auto")
    jc, tc = _cfgs(**knobs)
    assert tc.continuous_batching_enabled() and jc.continuous_batching_enabled()
    assert tc.serving_config() == jc.serving_config()
    for attr in ("_max_pending", "_tensor_parallel", "_expert_parallel",
                 "_num_replicas", "_router_policy", "_sampling",
                 "_prefill_replicas", "_decode_replicas", "_migration"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    for cfg in (jinf.Config("m"), tinf.Config("m")):
        assert not cfg.continuous_batching_enabled()
        assert cfg.serving_config() is None
        cfg.enable_use_gpu(100, 0)
        cfg.disable_gpu()
        cfg.enable_tensorrt_engine(1, x=2)
        cfg.enable_mkldnn()
        cfg.enable_memory_optim()
        cfg.switch_ir_optim(False)
        cfg.set_cpu_math_library_num_threads(4)
        assert cfg._ir_optim is False and cfg._threads == 4


# -------------------------------------------------------------- factories


ENGINE_CASES = {
    "greedy": (dict(max_slots=4, block_size=8, max_seq_len=64,
                    cache_dtype="float32"), {}),
    "draft2": (dict(max_slots=2, block_size=8, max_seq_len=64,
                    cache_dtype="float32", draft_k=2), {}),
    "sampling-knob": (dict(max_slots=2, block_size=4, max_seq_len=48,
                           cache_dtype="float32",
                           sampling=dict(strategy="greedy",
                                         repetition_penalty=1.3)), {}),
    "overrides": (dict(max_slots=2, block_size=4, max_seq_len=48,
                       cache_dtype="float32", prefix_caching=True),
                  dict(draft_k=1, token_budget=32)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_create_serving_engine_matches_jax(models, case):
    jm, tm = models
    knobs, overrides = ENGINE_CASES[case]
    jc, tc = _cfgs(**knobs)
    je = jinf.create_serving_engine(jc, jm, seed=5, **overrides)
    te = tinf.create_serving_engine(tc, tm, seed=5, device="cpu",
                                    **overrides)
    for attr in ("draft_k", "token_budget", "block_size"):
        assert getattr(te, attr) == getattr(je, attr), attr
    assert te.sampling.strategy == je.sampling.strategy
    assert te.sampling.repetition_penalty == je.sampling.repetition_penalty
    assert (te.prefix_cache is None) == (je.prefix_cache is None)
    assert te.generate_batch(PROMPTS, max_new_tokens=6) == \
        je.generate_batch(PROMPTS, max_new_tokens=6)


def test_factories_refuse(models):
    _, tm = models
    with pytest.raises(ValueError, match="enable_continuous_batching"):
        tinf.create_serving_engine(tinf.Config(), tm, device="cpu")
    cfg = tinf.Config().enable_continuous_batching(
        max_slots=2, cache_dtype="float32", tensor_parallel=2)
    # the TP route: this process has no 2-rank group to shard over
    with pytest.raises(ValueError, match="process group"):
        tinf.create_serving_engine(cfg, tm, device="cpu")
    cfg.enable_continuous_batching(max_slots=2, tensor_parallel=2,
                                   num_replicas=2)
    with pytest.raises(NotImplementedError, match="process per rank"):
        tinf.create_serving_router(cfg, tm, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        tinf.create_serving_router(
            tinf.Config().enable_continuous_batching(
                prefill_replicas=0, decode_replicas=1), tm, device="cpu")
    with pytest.raises(NotImplementedError, match="jit"):
        tinf.create_predictor(tinf.Config("model"))


def _serve(router_or_fe, prompts, n=6):
    async def run():
        async with router_or_fe:
            return [await router_or_fe.submit(list(p), max_new_tokens=n)
                    for p in prompts]
    return asyncio.run(run())


def test_router_and_frontend_match_jax(models):
    jm, tm = models
    knobs = dict(max_slots=2, block_size=4, max_seq_len=48,
                 cache_dtype="float32", prefix_caching=True, num_replicas=2,
                 max_pending=8)
    jc, tc = _cfgs(**knobs)
    want = jinf.create_serving_engine(jc, jm).generate_batch(
        PROMPTS, max_new_tokens=6)
    router = tinf.create_serving_router(tc, tm, device="cpu")
    assert len(router.frontends) == 2 and router.roles == ["mixed"] * 2
    assert all(fe._fair.max_pending == 8 for fe in router.frontends)
    assert _serve(router, PROMPTS) == want
    fe = tinf.create_serving_frontend(tc, tm, device="cpu")
    assert fe._fair.max_pending == 8
    assert _serve(fe, PROMPTS) == want
    assert _serve(jinf.create_serving_router(jc, jm), PROMPTS) == want


def test_disagg_knobs_round_trip_as_jax(models):
    """`tests/test_disagg.py::TestConfigRoundTrip`'s fleet in both
    packages: roles, migration, transport and each replica's role,
    drafts, ticks and budget the same; the fleet serves JAX's tokens."""
    jm, tm = models
    knobs = dict(max_slots=3, block_size=4, max_seq_len=64,
                 cache_dtype="float32", draft_k=2, prefix_caching=True,
                 prefill_replicas=1, decode_replicas=2,
                 migration={"imbalance": 3})
    jc, tc = _cfgs(**knobs)
    jr = jinf.create_serving_router(jc, jm)
    tr = tinf.create_serving_router(tc, tm, device="cpu")
    assert tr.roles == jr.roles == ["prefill", "decode", "decode"]
    assert tr.migration == jr.migration
    assert tr.migration["interval"] == \
        ReplicaRouter.MIGRATION_DEFAULTS["interval"]
    assert tr.transport is not None
    for tf, jf in zip(tr.frontends, jr.frontends):
        te, je = tf.engine, jf.engine
        for attr in ("role", "draft_k", "token_budget"):
            assert getattr(te, attr) == getattr(je, attr), attr
        assert te.ticks_per_dispatch == je.ticks_per_dispatch
    pre = tr.frontends[0].engine
    assert pre.draft_k == 0 and pre.ticks_per_dispatch == 1
    assert [fe.engine.ticks_per_dispatch for fe in tr.frontends[1:]] == \
        [4, 4]
    want = jinf.create_serving_engine(
        jinf.Config().enable_continuous_batching(
            max_slots=3, block_size=4, max_seq_len=64,
            cache_dtype="float32"), jm).generate_batch(PROMPTS,
                                                       max_new_tokens=6)
    assert _serve(tr, PROMPTS) == want
    # a sparse disaggregated fleet's prefill replica keeps the summaries
    # without the sparse region
    jc, tc = _cfgs(max_slots=2, block_size=4, max_seq_len=64,
                   cache_dtype="float32", sparse_blocks=2,
                   prefill_replicas=1, decode_replicas=1)
    pre = tinf.create_serving_router(tc, tm, device="cpu").frontends[0]
    jpre = jinf.create_serving_router(jc, jm).frontends[0]
    assert pre.engine.sparse_blocks is None is jpre.engine.sparse_blocks
    assert pre.engine._track_summaries and jpre.engine._track_summaries


def test_sampling_resolution(models):
    _, tm = models
    sc = SamplingConfig(strategy="sampling", top_k=3)
    cfg = tinf.Config().enable_continuous_batching(
        max_slots=2, cache_dtype="float32",
        sampling=dict(strategy="sampling", temperature=1.1, top_k=20))
    eng = tinf.create_serving_engine(cfg, tm, device="cpu")
    assert (eng.sampling.strategy, eng.sampling.top_k,
            eng.sampling.temperature) == ("sampling", 20, 1.1)
    assert tinf.create_serving_engine(cfg, tm, sampling=sc,
                                      device="cpu").sampling is sc
