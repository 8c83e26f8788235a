"""Penalized sampling, the device drafter and the tick preallocation of
the PyTorch port against the JAX package.

The same numpy inputs on both sides: the count-histogram penalties
(`apply_count_penalties`, `history_to_counts`, `apply_logit_penalties`,
`select_token(counts=)`) with every penalty alone and together, over
Vb = V and Vb < V bins and several leading shapes, within 1e-6; the
device drafter (`ring_chronological`, `ngram_propose_device`) on seeded
rings, exactly, and against the host proposer on the same windows; the
scheduler's `extend_for_ticks` and device-draft plans driven through one
scripted run under block pressure on both schedulers. Then the 1-tick
engine with penalties (fp32, CPU, the same weights carried across by
`paddle_tpu_torch.convert`): token-identical to the JAX engine of the
same config, with and without speculation, with fewer bins than the
vocab, and with a penalty window shorter than the sequences.
"""
import jax.numpy as jnp
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
from paddle_tpu_torch.serving.engine import ServingEngine

VOCAB, HEADS = 193, 4
PENALTIES = {"repetition": dict(repetition_penalty=1.3),
             "presence": dict(presence_penalty=0.7),
             "frequency": dict(frequency_penalty=0.4),
             "all": dict(repetition_penalty=1.2, presence_penalty=0.5,
                         frequency_penalty=0.3)}


def _configs(name, **kw):
    """The same SamplingConfig on both sides."""
    kw = dict(PENALTIES[name], **kw)
    return jb.SamplingConfig(**kw), tb.SamplingConfig(**kw)


def _logits_and_counts(seed, lead, bins):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*lead, VOCAB) * 3).astype(np.float32)
    counts = (rng.randint(1, 4, (*lead, bins))
              * (rng.rand(*lead, bins) < 0.3)).astype(np.float32)
    return logits, counts


# ------------------------------------------------------------ penalties


@pytest.mark.parametrize("lead", [(5,), (3, 4)])
@pytest.mark.parametrize("bins", [VOCAB, 50])
@pytest.mark.parametrize("name", PENALTIES)
def test_apply_count_penalties_matches_jax(name, bins, lead):
    logits, counts = _logits_and_counts(hash((name, bins, lead)) % 1000,
                                        lead, bins)
    jsc, tsc = _configs(name)
    want = np.asarray(jb.apply_count_penalties(
        jnp.asarray(logits), jnp.asarray(counts), jsc))
    got = tb.apply_count_penalties(torch.from_numpy(logits),
                                   torch.from_numpy(counts), tsc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(want, logits)      # something was penalized


@pytest.mark.parametrize("name", PENALTIES)
def test_history_penalties_match_jax(name):
    """A -1-padded [B, W] history: the histogram exactly, the penalized
    logits within 1e-6."""
    rng = np.random.RandomState(5)
    hist = rng.randint(0, VOCAB, (6, 12)).astype(np.int32)
    hist[:, :3] = hist[:, 3:6]                   # repeats
    hist[1, 7:] = -1
    hist[4, :] = -1
    logits = (rng.randn(6, VOCAB) * 3).astype(np.float32)
    for bins in (VOCAB, 17):
        np.testing.assert_array_equal(
            tb.history_to_counts(torch.from_numpy(hist), bins).numpy(),
            np.asarray(jb.history_to_counts(jnp.asarray(hist), bins)))
    jsc, tsc = _configs(name)
    want = np.asarray(jb.apply_logit_penalties(
        jnp.asarray(logits), jnp.asarray(hist), jsc))
    got = tb.apply_logit_penalties(torch.from_numpy(logits),
                                   torch.from_numpy(hist), tsc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", PENALTIES)
def test_select_token_greedy_with_counts_matches_jax(name):
    """Penalties first, then the argmax; with no penalty on, counts are
    ignored."""
    import jax
    logits, counts = _logits_and_counts(7, (16,), VOCAB)
    # make the penalties decide: the argmax of every row has been seen
    counts[np.arange(16), logits.argmax(-1)] = 2.0
    jsc, tsc = _configs(name)
    want = np.asarray(jb.select_token(jnp.asarray(logits),
                                      jax.random.PRNGKey(0), jsc,
                                      counts=jnp.asarray(counts)))
    got = tb.select_token(torch.from_numpy(logits), tsc,
                          counts=torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tb.select_token(torch.from_numpy(logits), tb.SamplingConfig(),
                            counts=torch.from_numpy(counts))
    np.testing.assert_array_equal(plain.numpy(), logits.argmax(-1))


# ---------------------------------------------------------- device draft


def _rings(seed, S, W):
    """Seeded rings of short-alphabet sequences (so n-grams repeat),
    some shorter than the ring, some longer, one empty."""
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(0, int(rng.randint(2, 6)),
                        int(rng.randint(0, 3 * W))).tolist()
            for _ in range(S)]
    seqs[0] = []
    ring = np.zeros((S, W), np.int32)
    lens = np.zeros(S, np.int32)
    for s, toks in enumerate(seqs):
        n, w = len(toks), min(len(toks), W)
        if w:
            ring[s, np.arange(n - w, n) % W] = toks[-w:]
        lens[s] = n
    return seqs, ring, lens


@pytest.mark.parametrize("W", [2, 5, 16])
@pytest.mark.parametrize("k,ngram", [(1, 1), (3, 3), (4, 2)])
def test_device_drafter_matches_jax(W, k, ngram):
    for seed in range(8):
        seqs, ring, lens = _rings(seed * 31 + W, 7, W)
        jview = jd.ring_chronological(jnp.asarray(ring), jnp.asarray(lens))
        tview = td.ring_chronological(torch.from_numpy(ring),
                                      torch.from_numpy(lens))
        np.testing.assert_array_equal(tview.numpy(), np.asarray(jview))
        want = np.asarray(jd.ngram_propose_device(
            jview, jnp.asarray(lens), k, max_ngram=ngram))
        got = td.ngram_propose_device(tview, torch.from_numpy(lens), k,
                                      max_ngram=ngram)
        np.testing.assert_array_equal(got.numpy(), want)
        host = [td.ngram_propose(s[-W:], k, max_ngram=ngram) if s else None
                for s in seqs]
        for s, h in enumerate(host):
            if h is not None:
                assert got[s].tolist() == h


# ----------------------------------------------------- tick preallocation


def test_extend_for_ticks_matches_jax():
    """One scripted run on both schedulers with device drafting on: each
    decode is planned as [last] alone, extended for a random number of
    ticks from free blocks only, advanced by a random emitted count and
    truncated back (`note_accept`); prefill and preemption under a small
    pool. Plans, caps, tables, lengths, queues and preemptions stay
    equal, and every block comes back."""
    rng = np.random.RandomState(9)
    geo = (1, 1, 8)
    kw = dict(num_blocks=8, block_size=4, max_slots=3,
              max_blocks_per_slot=8)
    jkvc = jkv.PagedKVCache(*geo, **kw)
    tkvc = tkv.PagedKVCache(*geo, device="cpu", **kw)
    js = jsch.Scheduler(jkvc, max_slots=3, token_budget=16, draft_k=2,
                        device_draft=True)
    ts = tsch.Scheduler(tkvc, max_slots=3, token_budget=16, draft_k=2,
                        device_draft=True)
    for _ in range(6):
        prompt = rng.randint(0, 9, int(rng.randint(2, 12))).tolist()
        new = int(rng.randint(6, 14))
        js.submit(prompt, new)
        ts.submit(prompt, new)
    capped = 0
    for step in range(300):
        if not ts.has_work:
            break
        jp, tp = js.plan(), ts.plan()
        assert [(s, list(t), p) for s, t, p in tp.decode] == \
            [(s, list(t), p) for s, t, p in jp.decode]
        assert all(len(t) == 1 for _, t, _ in tp.decode)
        assert [(s, c.tolist(), st, d) for s, c, st, d in tp.prefills] == \
            [(s, c.tolist(), st, d) for s, c, st, d in jp.prefills]
        draws = np.random.RandomState(step)
        caps = []
        for slot, _toks, pos in tp.decode:
            n = int(draws.randint(1, 12))
            want = js.extend_for_ticks(slot, pos, n)
            got = ts.extend_for_ticks(slot, pos, n)
            assert got == want and pos + 1 <= got <= pos + max(n, 1)
            capped += got < pos + n
            caps.append(got)
        np.testing.assert_array_equal(tkvc.block_tables, jkvc.block_tables)
        js.note_fed(jp)
        ts.note_fed(tp)
        for sch, plan in ((js, jp), (ts, tp)):
            state = np.random.RandomState(step)      # same draws for both
            for slot, chunk, start, completes in plan.prefills:
                if completes:
                    req = sch.slots[slot]
                    req.state = "decode"
                    req.output.append(int(state.randint(0, 9)))
                    if len(req.output) >= req.max_new_tokens:
                        sch.finish(req)
            for (slot, toks, pos), cap in zip(plan.decode, caps):
                req = sch.slots[slot]
                c = int(state.randint(1, cap - pos + 1))
                req.output += state.randint(0, 9, c).tolist()
                if len(req.output) >= req.max_new_tokens:
                    del req.output[req.max_new_tokens:]
                    sch.finish(req)
                else:
                    sch.note_accept(slot, pos + c)
        np.testing.assert_array_equal(tkvc.block_tables, jkvc.block_tables)
        np.testing.assert_array_equal(tkvc.slot_lens, jkvc.slot_lens)
        assert [r.req_id for r in ts.queue] == [r.req_id for r in js.queue]
        assert ts.preemption_count == js.preemption_count
    assert not ts.has_work and not js.has_work
    assert ts.preemption_count > 0 and capped > 0
    assert tkvc.blocks_in_use == 0 and tkvc.allocator.invariant_ok


# ------------------------------------------------------- 1-tick engines


@pytest.fixture(scope="module")
def models():
    """(jax model, port model on the CPU) with the same weights."""
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


def _prompts():
    rng = np.random.RandomState(0)
    out = [rng.randint(1, VOCAB, n).tolist() for n in (5, 9, 3, 12)]
    out[3][6:] = out[3][:6]                       # something to draft
    return out


@pytest.mark.parametrize("case", [
    dict(name="all"),
    dict(name="repetition", draft_k=3),
    dict(name="frequency", bins=31),
    dict(name="all", window=5, draft_k=3),
])
def test_penalized_engine_matches_jax(models, case):
    """Greedy penalized serving, token for token: the JAX engine's
    host-built count histogram and verify priors against the port's,
    over the full vocab or 31 bins, and with a window of 5 tokens (the
    window slides over prompt and output)."""
    jm, tm = models
    extra = {} if "window" not in case else dict(
        penalty_window=case["window"])
    jsc, tsc = _configs(case["name"], **extra)
    kw = dict(max_slots=4, block_size=4, max_seq_len=64,
              cache_dtype="float32", draft_k=case.get("draft_k", 0),
              penalty_vocab_bins=case.get("bins"))
    want = JaxEngine(jm, sampling=jsc, **kw).generate_batch(_prompts(), 10)
    got = ServingEngine(tm, sampling=tsc, device="cpu",
                        **kw).generate_batch(_prompts(), 10)
    assert got == want
    plain = ServingEngine(tm, device="cpu", **kw).generate_batch(
        _prompts(), 10)
    assert got != plain                        # the penalties did act
