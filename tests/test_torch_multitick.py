"""The port's multi-tick decode dispatch against the JAX package's and
against its own 1-tick engine.

`ServingEngine(ticks_per_dispatch=N)` runs up to N decode ticks per host
dispatch, the n-gram drafter, the accept roll, the token rings and the
penalty histogram advancing between ticks without a host read, and every
tick after the first per-slot event running as padding. At
tests/test_multitick.py's sizes (vocab 193, hidden 32, 2 layers, 4
heads, max_slots=4, block_size=4, fp32, CPU, the same weights carried
across by `paddle_tpu_torch.convert`):

* greedy engines at N = 4 and 8, "auto", under preemption
  (num_blocks=14), with draft_k 0 and 3, with penalties, with an EOS
  inside a dispatch and with MoE layers are token-identical to the JAX
  engine of the same config and to the port's N = 1;
* seeded sampling (top-p, repetition penalty; draft_k 0 and 3) at N = 4
  is token-identical to the port's N = 1 (the generators differ from
  JAX's, so these hold the port against itself), as is a penalty window
  shorter than the sequences (the loop slides it as the host rebuild
  does);
* the counters (more ticks than dispatches, early exits, issued ticks,
  `speculation_mode`), every block back, and the bad configurations of
  the JAX tests raise.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving.batcher import SamplingConfig as JaxSampling
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.serving.batcher import SamplingConfig
from paddle_tpu_torch.serving.engine import ServingEngine

VOCAB, HEADS, E = 193, 4, 4
NEW = 8
SAMPLING = {
    "greedy": {},
    "top-p": dict(strategy="sampling", temperature=0.8, top_p=0.9),
    "rep-pen": dict(strategy="sampling", temperature=0.9,
                    repetition_penalty=1.3),
    "rep-pen-greedy": dict(repetition_penalty=1.3, presence_penalty=0.2),
}


def _carry(jm, moe=None):
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    arrays = {n: np.asarray(t._data) for n, t in zip(names, tensors)}
    return load_jax_gpt(arrays, HEADS, moe=moe, device="cpu")


@pytest.fixture(scope="module")
def models():
    """(jax model, port model on the CPU) with the same weights."""
    paddle.seed(1234)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32")
    jm.eval()
    return jm, _carry(jm)


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, VOCAB, n).tolist() for n in (5, 9, 3, 12)]


def _kw(name="greedy", **kw):
    """(engine keywords, sampling fields): `name` is a key of SAMPLING
    or the fields themselves."""
    kw = dict(dict(max_slots=4, block_size=4, max_seq_len=64,
                   cache_dtype="float32", seed=0), **kw)
    return kw, SAMPLING[name] if isinstance(name, str) else name


def _jax(jm, name="greedy", prompts=None, new=NEW, **kw):
    kw, sc = _kw(name, **kw)
    eng = JaxEngine(jm, sampling=JaxSampling(**sc), **kw)
    return eng.generate_batch(prompts or _prompts(), max_new_tokens=new), eng


def _port(tm, name="greedy", prompts=None, new=NEW, **kw):
    kw, sc = _kw(name, **kw)
    eng = ServingEngine(tm, sampling=SamplingConfig(**sc), device="cpu",
                        **kw)
    return eng.generate_batch(prompts or _prompts(), max_new_tokens=new), eng


@pytest.fixture(scope="module")
def one_tick(models):
    """The port's N = 1 outputs, one run per config."""
    cache = {}

    def get(name="greedy", **kw):
        key = (str(name), tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _port(models[1], name, **kw)[0]
        return cache[key]
    return get


def _held(eng, n):
    """Counters every multi-tick run keeps."""
    assert eng.kv.blocks_in_use == 0
    assert eng.device_ticks_issued >= eng.device_ticks_run \
        >= eng.dispatches_run
    assert eng.ticks_per_dispatch == (8 if n == "auto" else n)


# ------------------------------------------------------- greedy identity


@pytest.mark.parametrize("n", [4, 8, "auto"])
def test_greedy_matches_jax(models, one_tick, n):
    jm, tm = models
    want, jeng = _jax(jm, ticks_per_dispatch=n)
    got, eng = _port(tm, ticks_per_dispatch=n)
    assert got == want == one_tick()
    _held(eng, n)
    if n != "auto":
        # the loop really ran several ticks a dispatch, and events ended
        # dispatches early
        assert eng.device_ticks_run > eng.dispatches_run
        assert sum(eng.early_exit_counts.values()) > 0
        assert eng.device_ticks_run == jeng.device_ticks_run
        assert eng.dispatches_run == jeng.dispatches_run
    assert eng.speculation_mode == "off"


@pytest.mark.parametrize("n", [4, 8])
def test_preemption_matches_jax(models, one_tick, n):
    """Block pressure (num_blocks=14): caps stop a slot at its
    preallocated frontier (overflow events), and preempt/resume cycles
    land where the 1-tick engine's do."""
    jm, tm = models
    want, jeng = _jax(jm, num_blocks=14, ticks_per_dispatch=n)
    got, eng = _port(tm, num_blocks=14, ticks_per_dispatch=n)
    assert got == want == one_tick(num_blocks=14)
    _held(eng, n)
    assert eng.early_exit_counts["overflow"] > 0
    assert eng.scheduler.preemption_count == \
        jeng.scheduler.preemption_count > 0


@pytest.mark.parametrize("name", ["greedy", "rep-pen-greedy"])
@pytest.mark.parametrize("draft_k", [0, 3])
@pytest.mark.parametrize("n", [4, "auto"])
def test_speculative_and_penalized_match_jax(models, one_tick, n, draft_k,
                                            name):
    """Device drafting (draft_k=3) and the in-loop penalty histogram
    against the JAX engine of the same config and the port's N = 1
    (host drafting, host-built histogram)."""
    jm, tm = models
    want, jeng = _jax(jm, name, draft_k=draft_k, ticks_per_dispatch=n)
    got, eng = _port(tm, name, draft_k=draft_k, ticks_per_dispatch=n)
    assert got == want == one_tick(name, draft_k=draft_k)
    _held(eng, n)
    assert eng.speculation_mode == ("device" if draft_k else "off")
    assert (eng.spec_proposed_total, eng.spec_accepted_total) == \
        (jeng.spec_proposed_total, jeng.spec_accepted_total)


def test_repetitive_prompts_accept_on_device(models):
    """Prompts the drafter predicts: the in-loop accept roll lands
    multi-token groups, and the totals equal the JAX loop's."""
    jm, tm = models
    prompts = [[7, 8, 9] * 6, [3, 4] * 8]
    want, jeng = _jax(jm, prompts=prompts, new=12, draft_k=3,
                      ticks_per_dispatch=4)
    got, eng = _port(tm, prompts=prompts, new=12, draft_k=3,
                     ticks_per_dispatch=4)
    assert got == want
    assert got == _port(tm, prompts=prompts, new=12, draft_k=3)[0]
    assert eng.spec_accepted_total == jeng.spec_accepted_total > 0
    assert eng.spec_proposed_total == jeng.spec_proposed_total
    assert eng.device_ticks_run > eng.dispatches_run


def test_eos_inside_a_dispatch_matches_jax(models, one_tick):
    """An EOS a request emits mid-dispatch finishes it there (event bit
    1), on both sides, and the replay stops on the same token."""
    jm, tm = models
    ref = one_tick()
    eos = ref[1][3]                       # request 1's fourth token
    want, _ = _jax(jm, eos_token_id=eos, ticks_per_dispatch=4)
    got, eng = _port(tm, eos_token_id=eos, ticks_per_dispatch=4)
    assert got == want
    assert got[1] == ref[1][:ref[1].index(eos) + 1]
    assert eng.early_exit_counts["finish"] > 0
    _held(eng, 4)


# ---------------------------------------------------- seeded sampling


@pytest.mark.parametrize("draft_k", [0, 3])
@pytest.mark.parametrize("name", ["top-p", "rep-pen"])
def test_seeded_sampling_matches_one_tick(models, one_tick, name, draft_k):
    """Ticks issued past a dispatch's exit (here an EOS) draw from the
    generator too; it is set back at harvest, so the N = 4 engine draws
    exactly what the 1-tick engine draws."""
    _, tm = models
    eos = one_tick(name, seed=7, draft_k=draft_k)[1][3]
    got, eng = _port(tm, name, seed=7, draft_k=draft_k, eos_token_id=eos,
                     ticks_per_dispatch=4)
    assert got == one_tick(name, seed=7, draft_k=draft_k, eos_token_id=eos)
    assert got[1][-1] == eos
    _held(eng, 4)
    assert eng.device_ticks_issued > eng.device_ticks_run


def test_penalty_window_slides_in_the_loop(models, one_tick):
    """A 5-token penalty window over longer sequences: the loop drops
    the token leaving the window as the host rebuild does, so greedy and
    seeded sampling engines at N = 4 equal their N = 1 twins and the
    JAX 1-tick engine."""
    jm, tm = models
    sc = dict(repetition_penalty=1.3, frequency_penalty=0.4,
              penalty_window=5)
    want, _ = _jax(jm, sc, new=12)
    got, eng = _port(tm, sc, new=12, ticks_per_dispatch=4)
    assert got == want == _port(tm, sc, new=12)[0]
    assert eng.device_ticks_run > eng.dispatches_run
    sampled = dict(sc, strategy="sampling")
    for dk in (0, 3):
        assert _port(tm, sampled, new=12, seed=3, draft_k=dk,
                     ticks_per_dispatch=4)[0] == \
            _port(tm, sampled, new=12, seed=3, draft_k=dk)[0]


# ------------------------------------------------------------------ MoE


def test_moe_matches_jax():
    """MoE layers (4 experts, top-2, capacity factor 2.0): tokens equal
    the JAX N = 4 engine's and the port's N = 1, and the routing stats
    sum over the ticks that counted: routed + dropped = 2 x layers x
    valid tokens, and the same totals as the 1-tick engine."""
    moe = dict(num_expert=E, top_k=2, capacity_factor=2.0)
    paddle.seed(99)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32", moe=moe)
    jm.eval()
    tm = _carry(jm, moe)
    want, _ = _jax(jm, ticks_per_dispatch=4)
    got, eng = _port(tm, ticks_per_dispatch=4)
    ref, one = _port(tm)
    assert got == want == ref
    _held(eng, 4)
    assert eng.device_ticks_run > eng.dispatches_run
    assert eng.tokens_fed == one.tokens_fed
    assert eng.moe_expert_counts.sum() + eng.moe_dropped_total == \
        2 * 2 * eng.tokens_fed
    np.testing.assert_array_equal(eng.moe_expert_counts,
                                  one.moe_expert_counts)
    assert eng.moe_dropped_total == one.moe_dropped_total


# ------------------------------------------------------- configuration


def test_bad_ticks_rejected(models):
    for bad in (0, -1, "fast"):
        with pytest.raises((ValueError, TypeError)):
            ServingEngine(models[1], ticks_per_dispatch=bad, device="cpu",
                          **_kw()[0])


def test_bad_spec_configs_raise_loudly(models):
    tm = models[1]
    kw = _kw()[0]
    for bad in (dict(draft_k=-1), dict(draft_k=2, draft_ngram=0),
                dict(draft_k=2, draft_ring=1)):
        with pytest.raises(ValueError):
            ServingEngine(tm, device="cpu", **bad, **kw)
    with pytest.raises(ValueError):
        ServingEngine(tm, penalty_vocab_bins=0, device="cpu",
                      sampling=SamplingConfig(repetition_penalty=1.3), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(tm, sparse_blocks=4, ticks_per_dispatch=4,
                      device="cpu", **kw)
