"""Speculative serving and quantized KV pools of the PyTorch port against
the JAX package.

Host side, compared exactly on the same inputs: the n-gram drafter and
both acceptance rules (`serving.draft`), `pack_step` and
`choose_token_budget` with a verify region, the speculative scheduler
(drafts shrunk to free blocks, `note_accept` rollback) driven through
one scripted run on both, the KV sizing of every `kv_dtype`, and the
quantize-on-append of the JAX step (identical int8 / fp8 bytes and
scales).

Engines (fp32, CPU, the same weights carried across by
`paddle_tpu_torch.convert`): `draft_k=3` greedy is token-identical to
the JAX `draft_k=3` engine and to the port's `draft_k=0`, with equal
proposed/accepted totals, under preemption and with EOS inside an
accepted run; int8 and fp8 engines, with and without speculation,
match the JAX engine with the same `kv_dtype`; top_k=1 speculative
sampling equals greedy; block-sparse decode, not ported yet, raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving import batcher as jb
from paddle_tpu.serving import draft as jd
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import scheduler as jsch
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.serving import batcher as tb
from paddle_tpu_torch.serving import draft as td
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import scheduler as tsch
from paddle_tpu_torch.serving.batcher import SamplingConfig
from paddle_tpu_torch.serving.engine import ServingEngine, quantize_kv

HEADS = 4
KV_DTYPES = ["float32", "bfloat16", "float16", "int8", "fp8_e4m3"]


# --------------------------------------------------------------- drafter


def test_ngram_propose_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(300):
        n = int(rng.randint(0, 40))
        seq = rng.randint(0, int(rng.randint(2, 9)), n).tolist()
        k = int(rng.randint(0, 6))
        ng = int(rng.randint(1, 5))
        assert td.ngram_propose(seq, k, max_ngram=ng) == \
            jd.ngram_propose(seq, k, max_ngram=ng)


def test_accept_lengths_match_jax():
    rng = np.random.RandomState(1)
    for _ in range(300):
        K = int(rng.randint(1, 6))
        fed = rng.randint(0, 3, K).tolist()
        scored = rng.randint(0, 3, K).tolist()
        flags = (rng.rand(K) < 0.7).tolist()
        assert td.accept_length(fed, scored) == jd.accept_length(fed, scored)
        assert td.accept_length_sampled(fed, flags) == \
            jd.accept_length_sampled(fed, flags)


# ----------------------------------------------------- packing and budget


def test_choose_token_budget_matches_jax():
    for slots in (1, 3, 4, 8):
        for bs in (4, 16):
            for vw in (1, 2, 4, 8):
                for req in (None, 1, 17, 64, 256):
                    assert tb.choose_token_budget(
                        slots, bs, req, verify_width=vw) == \
                        jb.choose_token_budget(slots, bs, req,
                                               verify_width=vw)


def test_pack_step_verify_width_matches_jax():
    """Random verify groups (some short, some slots idle) and prefill
    chunks packed by both: every array and field equal."""
    rng = np.random.RandomState(2)
    fields = ("token_ids", "slot_ids", "positions", "sample_index")
    for _ in range(100):
        S, vw = int(rng.randint(1, 6)), int(rng.randint(1, 5))
        slots = rng.permutation(S)
        n_dec = int(rng.randint(0, S + 1))
        decode = []
        for s in slots[:n_dec]:
            toks = rng.randint(1, 99, int(rng.randint(1, vw + 1))).tolist()
            decode.append((int(s), toks[0] if vw == 1 and rng.rand() < 0.5
                           else toks, int(rng.randint(0, 50))))
        prefills = []
        for s in slots[n_dec:]:
            m = int(rng.randint(1, 6))
            prefills.append((int(s), rng.randint(1, 99, m).astype(np.int32),
                             int(rng.randint(0, 20)), bool(rng.rand() < .5)))
        T = 64                                   # room for any plan
        got = tb.pack_step(T, S, decode, prefills, verify_width=vw)
        want = jb.pack_step(T, S, decode, prefills, verify_width=vw)
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for f in ("num_tokens", "decode_slots", "prefill_done",
                  "prefill_tokens", "decode_tokens", "verify_width",
                  "decode_entries"):
            assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError):
        tb.pack_step(32, 4, [(0, [1, 2, 3, 4, 5], 0)], [], verify_width=4)


def test_speculative_scheduler_matches_jax():
    """One scripted run on both schedulers: drafts shrink to the horizon,
    the slot and the free blocks; prefill packs after the reserved
    region; random accept lengths roll back through `note_accept`;
    preemption under a small pool. Plans, tables, lengths, queues and
    preemptions stay equal, and every block comes back."""
    rng = np.random.RandomState(3)
    geo = (1, 1, 8)
    kw = dict(num_blocks=9, block_size=4, max_slots=3,
              max_blocks_per_slot=8)
    jkvc = jkv.PagedKVCache(*geo, **kw)
    tkvc = tkv.PagedKVCache(*geo, device="cpu", **kw)

    def drafter(propose):
        return lambda seq: propose(seq[-16:], 3, max_ngram=2)

    js = jsch.Scheduler(jkvc, max_slots=3, token_budget=16, draft_k=3,
                        draft_fn=drafter(jd.ngram_propose))
    ts = tsch.Scheduler(tkvc, max_slots=3, token_budget=16, draft_k=3,
                        draft_fn=drafter(td.ngram_propose))
    for _ in range(5):
        prompt = rng.randint(0, 4, int(rng.randint(2, 12))).tolist()
        new = int(rng.randint(3, 12))
        js.submit(prompt, new)
        ts.submit(prompt, new)
    for _step in range(200):
        if not ts.has_work:
            break
        jp, tp = js.plan(), ts.plan()
        assert [(s, list(np.atleast_1d(t)), p) for s, t, p in tp.decode] \
            == [(s, list(np.atleast_1d(t)), p) for s, t, p in jp.decode]
        assert [(s, c.tolist(), st, d) for s, c, st, d in tp.prefills] == \
            [(s, c.tolist(), st, d) for s, c, st, d in jp.prefills]
        js.note_fed(jp)
        ts.note_fed(tp)
        for sch, plan in ((js, jp), (ts, tp)):
            state = np.random.RandomState(_step)   # same draws for both
            for slot, chunk, start, completes in plan.prefills:
                if completes:
                    req = sch.slots[slot]
                    req.state = "decode"
                    req.output.append(int(state.randint(0, 4)))
                    if len(req.output) >= req.max_new_tokens:
                        sch.finish(req)
            for slot, toks, pos in plan.decode:
                req = sch.slots[slot]
                m = int(state.randint(0, len(toks)))
                req.output += list(toks[1:m + 1]) + [int(state.randint(0, 4))]
                if len(req.output) >= req.max_new_tokens:
                    del req.output[req.max_new_tokens:]
                    sch.finish(req)
                else:
                    sch.note_accept(slot, pos + m + 1)
        np.testing.assert_array_equal(tkvc.block_tables, jkvc.block_tables)
        np.testing.assert_array_equal(tkvc.slot_lens, jkvc.slot_lens)
        assert [r.req_id for r in ts.queue] == [r.req_id for r in js.queue]
        assert ts.preemption_count == js.preemption_count
    assert not ts.has_work and not js.has_work
    assert ts.preemption_count > 0
    assert tkvc.blocks_in_use == 0 and tkvc.allocator.invariant_ok


# ------------------------------------------------------- KV pool sizing


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_kv_sizing_matches_jax(kv_dtype):
    kw = dict(num_blocks=3, block_size=16, max_slots=1,
              max_blocks_per_slot=2, kv_dtype=kv_dtype)
    for geo in ((2, 4, 8), (24, 16, 64)):   # tiny, GPT-350M's widths
        j = jkv.PagedKVCache(*geo, **kw)
        t = tkv.PagedKVCache(*geo, device="cpu", **kw)
        assert t.quantized == j.quantized
        assert t.kv_bytes_per_token == j.kv_bytes_per_token
        assert t.block_bytes == j.block_bytes
        assert t.k_pool.shape == j.k_pool.shape
        if t.quantized:
            assert t.k_scale.shape == j.k_scale.shape
            assert t.k_scale.dtype == torch.float32
        else:
            assert t.k_scale is None and j.k_scale is None
    big = {"float32": 196608, "bfloat16": 98304, "float16": 98304,
           "int8": 52224, "fp8_e4m3": 52224}[kv_dtype]
    assert t.kv_bytes_per_token == big


def test_kv_dtype_validation_is_loud():
    with pytest.raises(ValueError, match="fp8_e4m3"):
        tkv.PagedKVCache(1, 1, 8, num_blocks=3, block_size=4, max_slots=1,
                         max_blocks_per_slot=2, kv_dtype="int4",
                         device="cpu")


# ------------------------------------------------------- quantize bytes


@pytest.fixture(scope="module")
def models():
    """(jax model, port model on the CPU) with the same weights."""
    paddle.seed(1234)
    jm = JaxGPT(vocab_size=193, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32")
    jm.eval()
    tensors = jm._gen_tensors()             # also sets jm._dec_names
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    arrays = {n: np.asarray(t._data) for n, t in zip(names, tensors)}
    return jm, load_jax_gpt(arrays, HEADS, device="cpu")


def _jax_quantize(jm, kv_dtype):
    """The `quantize` the JAX engine's mixed step closes over."""
    je = JaxEngine(jm, max_slots=2, block_size=4, max_seq_len=32,
                   kv_dtype=kv_dtype)
    step = je._step_body(je._step_cfg())
    free = dict(zip(step.__code__.co_freevars,
                    (c.cell_contents for c in step.__closure__)))
    return free["quantize"]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantize_matches_jax_step(models, kv_dtype):
    """Random K/V rows, an all-zero row, rows past fp8's range and rows
    whose scaled values sit on int8 rounding ties (amax 127 makes the
    scale exactly 1): bytes and scales equal exactly."""
    import jax.numpy as jnp
    rng = np.random.RandomState(4)
    x = rng.randn(7, 3, 16).astype(np.float32)
    x[1, 0] = 0.0
    x[2] *= 1e3
    x[3, 1] = 0.0
    x[3, 1, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    qj, sj = _jax_quantize(models[0], kv_dtype)(jnp.asarray(x))
    qt, st = quantize_kv(torch.from_numpy(x), kv_dtype)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qj).view(np.uint8))
    if kv_dtype == "int8":
        assert qt[3, 1, :6].tolist() == [127, 2, -4, 0, 0, 2]


# --------------------------------------------------------------- engines


def _serve_both(models, prompts, max_new_tokens, **kw):
    """The same prompts through the JAX engine and the port's engine;
    returns (jax outputs, port outputs, jax engine, port engine)."""
    jm, tm = models
    je = JaxEngine(jm, **kw)
    te = ServingEngine(tm, device="cpu", **kw)
    return (je.generate_batch(prompts, max_new_tokens=max_new_tokens),
            te.generate_batch(prompts, max_new_tokens=max_new_tokens),
            je, te)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 193, n).tolist() for n in lens]


def test_speculative_greedy_token_identical(models):
    prompts = [[3, 14, 15, 9, 2, 3, 14, 15], [7, 8], list(range(1, 12)),
               [42]]
    kw = dict(max_slots=4, block_size=8, max_seq_len=64,
              cache_dtype="float32")
    want, got, je, te = _serve_both(models, prompts, 10, draft_k=3, **kw)
    assert got == want
    assert te.spec_proposed_total == je.spec_proposed_total > 0
    assert te.spec_accepted_total == je.spec_accepted_total > 0
    plain = ServingEngine(models[1], device="cpu", **kw)
    assert got == plain.generate_batch(prompts, max_new_tokens=10)
    assert te.steps_run < plain.steps_run
    assert te.kv.blocks_in_use == 0


def test_speculative_under_preemption(models):
    """tests/test_speculative.py's configuration: 6 requests over 4
    slots and 9 allocatable blocks of 4 tokens, draft_k=3."""
    prompts = _prompts(0, (9, 5, 12, 3, 7, 10))
    kw = dict(max_slots=4, block_size=4, num_blocks=10, max_seq_len=32,
              cache_dtype="float32")
    want, got, je, te = _serve_both(models, prompts, 8, draft_k=3, **kw)
    assert te.scheduler.preemption_count > 0
    assert te.scheduler.preemption_count == je.scheduler.preemption_count
    assert got == want
    assert (te.spec_proposed_total, te.spec_accepted_total) == \
        (je.spec_proposed_total, je.spec_accepted_total)
    plain = ServingEngine(models[1], device="cpu", **kw)
    assert got == plain.generate_batch(prompts, max_new_tokens=8)
    assert te.kv.blocks_in_use == 0 and je.kv.blocks_in_use == 0


def test_speculative_eos_inside_accepted_run(models):
    """A free run records which tokens each step emitted; the EOS is a
    token emitted inside an accepted run (not its last) at its first
    occurrence. With it, both engines stop there, identically. Each
    prompt holds the model's own greedy continuation of its head (found
    by feeding a continuation back until it reproduced itself), so the
    drafter proposes from the prompt and the model accepts."""
    _, tm = models
    prompts = [[85, 106, 134, 137, 130, 47, 33, 84, 105, 192],
               [108, 89, 13, 151, 124, 116, 11, 72, 103, 157]]
    kw = dict(max_slots=2, block_size=8, max_seq_len=64,
              cache_dtype="float32", draft_k=3)
    eng = ServingEngine(tm, device="cpu", **kw)
    reqs = [eng.submit(p, 16) for p in prompts]
    runs = [[] for _ in reqs]
    while eng.scheduler.has_work:
        n = [len(r.output) for r in reqs]
        eng.step()
        for run, r, n0 in zip(runs, reqs, n):
            if len(r.output) > n0:
                run.append(r.output[n0:])
    eos = None
    for ri, (run, r) in enumerate(zip(runs, reqs)):
        at = 0
        for group in run:
            for j, t in enumerate(group[:-1]):
                if r.output.index(t) == at + j and eos is None:
                    eos, who, cut = t, ri, at + j + 1
            at += len(group)
    assert eos is not None, "no accepted run to place an EOS in"
    want, got, _, _ = _serve_both(models, prompts, 16, eos_token_id=eos,
                                  **kw)
    assert got == want
    assert got[who] == reqs[who].output[:cut]


@pytest.mark.parametrize("draft_k", [0, 3])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantized_engines_match_jax(models, kv_dtype, draft_k):
    prompts = _prompts(1, (6, 13, 2, 9))
    prompts[1][6:] = prompts[1][:7]              # something to draft
    kw = dict(max_slots=2, block_size=4, max_seq_len=40, kv_dtype=kv_dtype,
              draft_k=draft_k)
    want, got, je, te = _serve_both(models, prompts, 8, **kw)
    assert got == want
    assert (te.spec_proposed_total, te.spec_accepted_total) == \
        (je.spec_proposed_total, je.spec_accepted_total)
    assert te.kv.blocks_in_use == 0


def test_speculative_top_k_one_sampling_equals_greedy(models):
    """With top_k=1 the target distribution is one-hot: a draft is
    accepted exactly when it is the argmax, and the residual and bonus
    samples are the argmax — rejection sampling must equal greedy token
    for token."""
    _, tm = models
    prompts = [[3, 14, 15, 9, 2, 3, 14, 15], [7, 8], list(range(1, 12))]
    kw = dict(max_slots=2, block_size=8, max_seq_len=64,
              cache_dtype="float32", device="cpu", draft_k=3)
    greedy = ServingEngine(tm, **kw)
    want = greedy.generate_batch(prompts, 10)
    spec = ServingEngine(
        tm, sampling=SamplingConfig(strategy="sampling", top_k=1,
                                    temperature=0.7), seed=3, **kw)
    assert spec.spec_sampling
    assert spec.generate_batch(prompts, 10) == want
    assert spec.spec_accepted_total == greedy.spec_accepted_total > 0
    # a real sampling config is seed-deterministic
    hot = SamplingConfig(strategy="sampling", temperature=1.5, top_p=0.9)
    runs = [ServingEngine(tm, sampling=hot, seed=7, **kw).generate_batch(
        prompts, 10) for _ in range(2)]
    assert runs[0] == runs[1]


def test_unported_options_raise(models):
    """Adapters, block-sparse decode, the prefix cache, penalized
    sampling and the multi-tick dispatch are ported and build
    (tests/test_torch_adapters, test_torch_sparse_kv,
    test_torch_prefix_cache, test_torch_penalties and
    test_torch_multitick hold them); bad values raise."""
    _, tm = models
    kw = dict(max_slots=2, block_size=8, max_seq_len=64, device="cpu")
    assert ServingEngine(tm, max_adapters=2, **kw).adapters.max_adapters == 2
    with pytest.raises(ValueError, match="max_adapters"):
        ServingEngine(tm, max_adapters=1, **kw)
    # 8 blocks a slot: the first, 2 recent and 4 selected take 7
    assert ServingEngine(tm, sparse_blocks=4, **kw).sparse_table_width == 7
    assert ServingEngine(tm, prefix_caching=True, **kw).prefix_cache
    assert ServingEngine(tm, ticks_per_dispatch=4, **kw)._multitick
    for pen in (dict(repetition_penalty=1.2), dict(presence_penalty=0.5),
                dict(frequency_penalty=0.5)):
        ServingEngine(tm, sampling=SamplingConfig(strategy="sampling",
                                                  **pen), **kw)
    for bad in (dict(draft_k=-1), dict(draft_k=2, draft_ngram=0),
                dict(draft_k=2, draft_ring=1), dict(ticks_per_dispatch=0)):
        with pytest.raises(ValueError):
            ServingEngine(tm, **bad, **kw)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(tm, kv_dtype="int4", **kw)
