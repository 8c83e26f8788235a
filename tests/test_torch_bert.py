"""CPU parity of the port's BERT (`paddle_tpu_torch.models.bert`) against
the JAX package's, in eval over padded batches: a JAX model holding
random numpy parameters is carried across with
`convert.load_jax_bert(state_dict arrays)`, and both take the same
numpy ids. Hidden 128 with 2 heads gives head_dim 64, so every encoder
layer takes the segmented flash kernel's route (its plain version
here). Against JAX's splash kernel in Pallas interpret mode every row
agrees; against JAX's default CPU path (the additive one, where a
padded query also sees real keys) the real rows, the pooled output, the
logits and the losses agree. `bert_tiny` (head_dim 32) takes the
additive path on both sides and agrees on every row."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.convert import load_jax_bert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn.functional import attention as tattn

CONFIG = dict(vocab_size=193, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=128)
TINY = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=128)
B, S = 3, 128
# fp32 on both sides through 2 layers, LayerNorms and a tanh pooler,
# summed in another order: 1e-4 on O(1) values (observed ~2e-6)
TOL = 1e-4


@pytest.fixture
def _interpret_splash():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def random_arrays(jmodel, seed=0):
    """Random numpy values for every parameter of the JAX model, set on
    it: matrices with unit-variance outputs, vectors of O(0.1) around
    their usual 0 or 1."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for n, p in jmodel.state_dict().items():
        a = rng.randn(*p.shape)
        if len(p.shape) == 2:
            a = a / np.sqrt(p.shape[0])
        else:
            a = 0.1 * a + ("norm" in n and n.endswith("weight"))
        arrays[n] = a.astype(np.float32)
    jmodel.set_state_dict({n: paddle.to_tensor(a)
                           for n, a in arrays.items()})
    jmodel.eval()
    return arrays


def build(head=None, config=CONFIG, **kw):
    """(JAX model, port model) holding the same random parameters."""
    jm = jbert.BertModel(**config)
    if head == "pretraining":
        jm = jbert.BertForPretraining(jm)
    elif head == "sequence_classification":
        jm = jbert.BertForSequenceClassification(jm, num_classes=3)
    arrays = random_arrays(jm)
    tm = load_jax_bert(arrays, config, head=head, device="cpu", **kw)
    return jm, tm.eval(), arrays


def batch(vocab=CONFIG["vocab_size"], seq=S, seed=1):
    """Padded ids (pad id 0 after each sequence; the first unpadded),
    token types, and the [B, S] real-token mask."""
    rng = np.random.RandomState(seed)
    lens = np.array([seq, 50 * seq // 128, 77 * seq // 128])
    real = np.arange(seq)[None] < lens[:, None]
    ids = np.where(real, rng.randint(1, vocab, (B, seq)), 0)
    types = np.where(real, rng.randint(0, 2, (B, seq)), 0)
    return ids, types, real


def run_jax(jm, *inputs):
    out = jm(*(paddle.to_tensor(a) for a in inputs))
    return [np.asarray(o.numpy()) for o in (out if isinstance(out, tuple)
                                            else (out,))]


def run_port(tm, *inputs):
    with torch.no_grad():
        out = tm(*(torch.tensor(a) for a in inputs))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def close(got, want, rows=None):
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("head", [None, "pretraining",
                                  "sequence_classification"])
def test_load_jax_bert_round_trip(head):
    _, tm, arrays = build(head)
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(arrays)
    for n, a in arrays.items():
        assert np.array_equal(params[n].detach().numpy(), a), n
    if head == "pretraining":          # the decoder is the embedding table
        assert tm.cls._tied_weight is \
            tm.bert.embeddings.word_embeddings.weight


def test_load_jax_bert_casts_every_parameter():
    _, tm, _ = build(dtype=torch.bfloat16)
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("fault", ["missing", "unknown", "misshapen",
                                   "head"])
def test_load_jax_bert_refuses(fault):
    jm = jbert.BertModel(**CONFIG)
    arrays = random_arrays(jm)
    name = "encoder.layers.0.self_attn.q_proj.weight"
    kw = {}
    if fault == "missing":
        del arrays[name]
    elif fault == "unknown":
        arrays["encoder.layers.2.norm1.weight"] = np.ones(128, np.float32)
    elif fault == "misshapen":
        arrays[name] = arrays[name][:, :64]
    else:
        kw["head"] = "masked_lm"
    with pytest.raises(ValueError):
        load_jax_bert(arrays, CONFIG, device="cpu", **kw)


def test_bert_model_matches_jax_splash_route(_interpret_splash):
    jm, tm, _ = build()
    ids, types, _ = batch()
    for a, e in zip(run_port(tm, ids, types), run_jax(jm, ids, types)):
        assert np.isfinite(a).all()
        close(a, e)


def test_bert_model_real_rows_match_jax_default_path(monkeypatch):
    calls = []
    orig = tattn.splash_mha
    monkeypatch.setattr(tattn, "splash_mha",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    jm, tm, _ = build()
    ids, types, real = batch()
    (seq, pooled), (jseq, jpooled) = run_port(tm, ids, types), \
        run_jax(jm, ids, types)
    assert len(calls) == CONFIG["num_hidden_layers"]    # one a layer
    close(seq, jseq, rows=real)
    close(pooled, jpooled)


def test_sequence_classification(_interpret_splash):
    jm, tm, _ = build("sequence_classification")
    ids, types, _ = batch()
    (got,), (want,) = run_port(tm, ids, types), run_jax(jm, ids, types)
    assert got.shape == (B, 3)
    close(got, want)
    jfa._INTERPRET = False                     # JAX's default path
    (want,) = run_jax(jm, ids, types)
    close(got, want)


@pytest.mark.parametrize("jax_route", ["splash", "default"])
def test_pretraining_and_criterion(jax_route):
    """MLM scores (every row against the splash route, real rows
    against the default one), NSP scores and the MLM + NSP loss; the
    padded positions' MLM labels are -1."""
    jfa._INTERPRET = jax_route == "splash"
    try:
        jm, tm, _ = build("pretraining")
        ids, types, real = batch(seed=2)
        rng = np.random.RandomState(3)
        labels = np.where(real & (rng.rand(B, S) < 0.3),
                          rng.randint(0, CONFIG["vocab_size"], (B, S)), -1)
        nsp = rng.randint(0, 2, B)
        (scores, rel), (jscores, jrel) = run_port(tm, ids, types), \
            run_jax(jm, ids, types)
        close(scores, jscores, rows=None if jax_route == "splash" else real)
        close(rel, jrel)
        tcrit = tbert.BertPretrainingCriterion(CONFIG["vocab_size"])
        jcrit = jbert.BertPretrainingCriterion(CONFIG["vocab_size"])
        for args in ((labels,), (labels, nsp)):
            got = tcrit(torch.tensor(scores), torch.tensor(rel),
                        *map(torch.tensor, args))
            want = jcrit(paddle.to_tensor(jscores), paddle.to_tensor(jrel),
                         *map(paddle.to_tensor, args))
            np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    finally:
        jfa._INTERPRET = False


def test_bert_tiny_takes_the_additive_route(monkeypatch):
    """head_dim 32 fails the kernel's gate: both sides take the additive
    path, and every row agrees."""
    monkeypatch.setattr(tattn, "splash_mha", None)     # never reached
    jm = jbert.bert_tiny()
    arrays = random_arrays(jm)
    tm = load_jax_bert(arrays, TINY, device="cpu").eval()
    ids, types, _ = batch(vocab=TINY["vocab_size"], seq=64)
    for a, e in zip(run_port(tm, ids, types), run_jax(jm, ids, types)):
        close(a, e)


def test_bert_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbert.BertModel(**CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbert.bert_tiny()
    jm = jbert.BertModel(**CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_jax_bert(random_arrays(jm), CONFIG)
