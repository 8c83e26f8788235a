"""The port's `generate()` and dense-cache decoder against the JAX package.

At the port's test size (vocab 193, hidden 32, 2 layers, 4 heads, fp32,
CPU), JAX `GPTForGeneration`s carried across by
`paddle_tpu_torch.convert.load_jax_gpt`:

* **`generate()`** gives JAX's ids and `gen_lens` at tolerance 0 (they
  are integers) on the dense, MoE, weight-only and MoE weight-only
  stacks: a uniform batch, ragged `seq_lens`, EOS inside the run,
  `max_new_tokens=1`, `use_scan` True and False, `draft_k=3`, a float
  cache; speculation's `last_accept_counts` equal JAX's; the streaming
  loop stops once every row has emitted EOS; the validation errors are
  JAX's; seeded sampling repeats itself (the streams differ from JAX's
  by design, so only the port's own runs are compared).
* **`FusedMultiTransformer.forward`**: the causal pass, prefill (with
  `seq_lens`) and decode at a scalar and a per-row `time_step` match
  JAX's outputs and caches within 1e-5 (the port's K cache is JAX's
  transposed: [L, B, H, S, Dh] against [L, B, H, Dh, S]).
* `_sdp_chunked` equals JAX's within 1e-5; `_gen_tensors()` is JAX's
  order and bytes.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import fused_transformer as jft
from paddle_tpu.incubate.nn import generation as jgen
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu_torch import seed as torch_seed
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.incubate.nn import fused_transformer as tft
from paddle_tpu_torch.incubate.nn.generation import _gen_lens

import jax.numpy as jnp

VOCAB, HEADS = 193, 4
MOE = dict(num_expert=4, top_k=2, capacity_factor=2.0)
STACKS = {"dense": (None, False), "moe": (MOE, False),
          "weight-only": (None, True), "moe-weight-only": (MOE, True)}
IDS = np.array([[5, 6, 7, 0, 0], [8, 9, 1, 2, 3]], np.int64)
LENS = [3, 5]
#: forward-value tolerance (fp32, two frameworks' sums in other orders)
TOL = 1e-5


def _arrays(jm):
    tensors = jm._gen_tensors()          # sets jm._dec_names
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    return {n: np.asarray(t._data) for n, t in zip(names, tensors)}


@pytest.fixture(scope="module")
def stacks():
    """{name: (JAX model, port model on the CPU)}, the same weights."""
    out = {}
    for name, (moe, wo) in STACKS.items():
        paddle.seed(1234)
        jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                    num_attention_heads=HEADS, max_position_embeddings=128,
                    compute_dtype="float32", moe=moe, weight_only=wo)
        jm.eval()
        out[name] = (jm, load_jax_gpt(_arrays(jm), HEADS, moe=moe,
                                      device="cpu"))
    return out


def _both(jm, tm, ids, **kw):
    a, al = jm.generate(Tensor(ids), **kw)
    b, bl = tm.generate(ids, **kw)
    assert b.dtype == bl.dtype == torch.int32
    return ((a.numpy().tolist(), al.numpy().tolist()),
            (b.numpy().tolist(), bl.numpy().tolist()))


def _eos_inside(jm):
    """A token row 1 emits at its third step: EOS then lands inside the
    run (and row 0 may or may not meet it)."""
    toks, _ = jm.generate(Tensor(IDS), max_new_tokens=10, seq_lens=LENS)
    return int(toks.numpy()[1, 2])


CASES = {
    "uniform": dict(max_new_tokens=10),
    "ragged": dict(max_new_tokens=10, seq_lens=LENS),
    "eos": dict(max_new_tokens=10, seq_lens=LENS, eos_token_id="inside"),
    "eos-loop": dict(max_new_tokens=10, seq_lens=LENS, use_scan=False,
                     eos_token_id="inside"),
    "one-token": dict(max_new_tokens=1, seq_lens=LENS),
    "draft3": dict(max_new_tokens=10, seq_lens=LENS, draft_k=3,
                   eos_token_id="inside"),
    "float-cache": dict(max_new_tokens=10, cache_dtype="float32"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_generate_matches_jax(stacks, stack, case):
    jm, tm = stacks[stack]
    kw = dict(CASES[case])
    if kw.get("eos_token_id") == "inside":
        kw["eos_token_id"] = _eos_inside(jm)
    want, got = _both(jm, tm, IDS, **kw)
    assert got == want
    if "eos_token_id" in kw:
        assert min(got[1]) < kw["max_new_tokens"]      # EOS was hit


def test_scan_equals_loop_and_draft(stacks):
    _, tm = stacks["dense"]
    kw = dict(max_new_tokens=12, seq_lens=LENS, cache_dtype="float32")
    a = tm.generate(IDS, **kw)
    b = tm.generate(IDS, use_scan=False, **kw)
    c = tm.generate(IDS, draft_k=3, **kw)
    for x in (b, c):
        assert torch.equal(a[0], x[0]) and torch.equal(a[1], x[1])


def test_accept_counts_match_jax(stacks):
    jm, tm = stacks["dense"]
    p = np.array([[3, 14, 15, 9, 2, 6, 5, 3, 14, 15, 9, 2]], np.int64)
    want, got = _both(jm, tm, p, max_new_tokens=24, draft_k=4,
                      cache_dtype="float32")
    assert got == want
    assert tm.last_accept_counts == jm.last_accept_counts
    assert len(tm.last_accept_counts) < 23      # some drafts accepted


def test_streaming_loop_stops_on_all_eos(stacks, monkeypatch):
    """The loop path runs no decode step when the prefill token of every
    row is EOS (JAX's `test_streaming_loop_stops_on_all_eos`)."""
    _, tm = stacks["dense"]
    ids = np.array([[5, 6, 7]], np.int64)
    first = int(tm.generate(ids, max_new_tokens=1)[0][0, 0])
    calls = []
    real = tm._decode_core
    monkeypatch.setattr(tm, "_decode_core",
                        lambda *a: calls.append(1) or real(*a))
    out, lens = tm.generate(ids, max_new_tokens=50, eos_token_id=first,
                            use_scan=False)
    assert calls == [] and lens.tolist() == [1]
    assert (out[0] == first).all() and out.shape == (1, 50)
    tm.generate(ids, max_new_tokens=5, eos_token_id=first)
    assert len(calls) == 4          # the scan path always runs M - 1


def test_validation_errors_match_jax(stacks):
    jm, tm = stacks["dense"]
    ids = np.array([[1, 2, 3]], np.int64)
    bad = [dict(max_new_tokens=126),                         # positions
           dict(max_new_tokens=2, draft_k=2, decode_strategy="sampling"),
           dict(max_new_tokens=2, seq_lens=np.array([4], np.int32)),
           dict(max_new_tokens=2, seq_lens=np.array([0], np.int32)),
           dict(max_new_tokens=2, seq_lens=np.array([1, 2], np.int32))]
    for kw in bad:
        with pytest.raises(ValueError) as je:
            jm.generate(Tensor(ids), **kw)
        with pytest.raises(ValueError) as te:
            tm.generate(ids, **kw)
        assert str(te.value).split()[:3] == str(je.value).split()[:3]


def test_sampling_is_seeded(stacks):
    """Seeded sampling repeats itself; `seed=None` draws from the port's
    framework generator, which `paddle_tpu_torch.seed` restarts."""
    _, tm = stacks["dense"]
    kw = dict(max_new_tokens=8, decode_strategy="sampling", top_k=20,
              top_p=0.9, temperature=0.8, seq_lens=LENS)
    a = tm.generate(IDS, seed=7, **kw)[0]
    assert torch.equal(a, tm.generate(IDS, seed=7, **kw)[0])
    assert a.shape == (2, 8) and (a >= 0).all() and (a < VOCAB).all()
    torch_seed(3)
    b = tm.generate(IDS, **kw)[0]
    torch_seed(3)
    assert torch.equal(b, tm.generate(IDS, **kw)[0])


def test_gen_lens_matches_jax():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 4, (6, 9)).astype(np.int32)
    for eos in (None, 0, 3, 7):
        want = jgen._gen_lens_np(toks, eos)
        got = _gen_lens(torch.from_numpy(toks), eos)
        assert got.dtype == torch.int32
        assert got.tolist() == want.tolist()


def test_gen_tensors_in_jax_order(stacks):
    for name, (jm, tm) in stacks.items():
        assert tm.gen_names() == list(_arrays(jm))
        for t, j in zip(tm._gen_tensors(), jm._gen_tensors()):
            assert np.array_equal(t.numpy(), np.asarray(j._data))


# ------------------------------------------------ the decoder's protocol


def _k_as_jax(k):
    """The port's [L, B, H, S, Dh] K cache in JAX's [L, B, H, Dh, S]."""
    return k.transpose(-1, -2).numpy()


@pytest.mark.parametrize("stack", ["dense", "moe"])
def test_decoder_cache_protocol_matches_jax(stacks, stack):
    """Forward, prefill with `seq_lens`, then decode at a per-row
    `time_step` and at a scalar one: outputs and both caches."""
    jm, tm = stacks[stack]
    jd, td = jm.decoder, tm.decoder
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 32).astype(np.float32)
    np.testing.assert_allclose(td(torch.from_numpy(x)).numpy(),
                               jd(Tensor(x)).numpy(), rtol=TOL, atol=TOL)
    jc = jd.gen_cache(2, 16)
    tc = td.gen_cache(2, 16)
    lens = np.array([3, 5], np.int32)
    jo, jc = jd(Tensor(x), caches=jc, seq_lens=Tensor(lens))
    to, tc2 = td(torch.from_numpy(x), caches=tc,
                 seq_lens=torch.from_numpy(lens))
    assert tc2[0] is tc[0] and tc2[1] is tc[1]       # written in place
    np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=TOL, atol=TOL)
    for step in (lens, np.int32(6)):
        x1 = rng.randn(2, 1, 32).astype(np.float32)
        jo, jc = jd(Tensor(x1), caches=jc, time_step=Tensor(step))
        to, tc = td(torch.from_numpy(x1), caches=tc,
                    time_step=torch.from_numpy(np.asarray(step)))
        np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(_k_as_jax(tc[0]),
                                   np.asarray(jc[0]._data), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tc[1].numpy(), np.asarray(jc[1]._data),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError):
        td(torch.from_numpy(x1), caches=tc, time_step=7,
           attn_mask=torch.zeros(1))
    with pytest.raises(NotImplementedError):
        td(torch.from_numpy(x), beam_offset=0)


def test_sdp_chunked_matches_jax():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(1, 512, 2, 8).astype(np.float32)
               for _ in range(3))
    mask = np.where(np.tril(np.ones((512, 512))), 0.0, -1e9).astype(
        np.float32)[None, None]
    want = jft._sdp_chunked(*(jnp.asarray(a) for a in (q, k, v, mask)))
    got = tft._sdp_chunked(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    full = tft._sdp(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=TOL,
                               atol=TOL)
