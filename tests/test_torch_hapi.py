"""CPU parity of the port's `hapi.Model` over a 2-layer BERT
(`paddle_tpu_torch.models.bert`, hidden 128, 2 heads: head_dim 64, the
segmented kernel's route), prepared with `Lamb` and
`BertPretrainingCriterion`, against the JAX package's `Model`: 3
`train_batch` steps from the same numpy parameters on the same batch,
the loss and every parameter after each step, fp32; then `eval_batch`
and `predict_batch`.

Against JAX's segmented splash kernel in Pallas interpret mode the batch
has trailing and left padding, and every row agrees. Against JAX's
default (additive) path a padded query also sees real keys, so padded
rows differ; the batch there has trailing padding only, where no padded
row reaches the loss (MLM labels are -1 there and the NSP head reads
position 0), so the losses and every parameter agree all the same. With
left padding position 0 is a padded row, which the two routes define
differently.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.convert import load_jax_bert
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.optimizer import Lamb

CONFIG = dict(vocab_size=193, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=128, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
B, S, STEPS, LR = 2, 128, 3, 1e-3
# fp32 on both sides: the same forward, backward and LAMB update summed
# in another order; LAMB divides each gradient element by its own scale,
# so rounding differences in small gradients carry into the update at
# up to ~lr: 1e-5 on parameters of O(0.1-1) (observed 1.5e-6), and
# 1e-5 relative on the loss (observed ~1e-7).
TOL = dict(rtol=1e-5, atol=1e-5)
# The key projection's bias gets a zero gradient up to rounding (a bias
# on every key adds one constant to a query's scores, which the softmax
# cancels). LAMB scales whatever that noise is to a step of norm
# lr * ||w|| (trust ratio ||w|| / ||r||), so the two sides move it by
# the same norm in directions that rounding picks: hold each step's norm
# to lr * ||w|| on both, and the values within the steps' sum.
NOISE = "self_attn.k_proj.bias"


@pytest.fixture
def _interpret_splash():
    """JAX's segmented splash kernel in interpret mode, built here,
    outside any trace: JAX caches it, and one first built inside the
    train step's trace keeps arrays of that trace, which the next trace
    (the step's backward) cannot use."""
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    jfa._splash_kernel(CONFIG["num_attention_heads"], S, False,
                       segmented=True, dtype="float32",
                       head_dim=CONFIG["hidden_size"]
                       // CONFIG["num_attention_heads"])
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
    return arrays


def pretraining_batch(left, seed=1):
    """Ids (pad id 0), MLM labels (30% of real tokens, -1 elsewhere) and
    NSP labels; the second sequence padded before its tokens with
    `left`, after them otherwise."""
    rng = np.random.RandomState(seed)
    real = np.arange(S)[None] < np.array([100, 57])[:, None]
    if left:
        real[1] = real[1][::-1]
    ids = np.where(real, rng.randint(1, CONFIG["vocab_size"], (B, S)), 0)
    mlm = np.where(real & (rng.rand(B, S) < 0.3),
                   rng.randint(0, CONFIG["vocab_size"], (B, S)), -1)
    nsp = rng.randint(0, 2, B)
    return [a.astype(np.int32) for a in (ids, mlm, nsp)], real


def build(config=CONFIG):
    """(JAX Model, port Model) over the same parameters, each prepared
    with LAMB (lr 1e-3, weight decay 0.01) and the criterion."""
    jnet = jbert.BertForPretraining(jbert.BertModel(**config))
    arrays = random_arrays(jnet)
    tnet = load_jax_bert(arrays, config, head="pretraining", device="cpu")
    jm = paddle.Model(jnet)
    jm.prepare(paddle.optimizer.Lamb(learning_rate=LR,
                                     lamb_weight_decay=0.01,
                                     parameters=jnet.parameters()),
               jbert.BertPretrainingCriterion(config["vocab_size"]))
    tm = Model(tnet, device="cpu").prepare(
        Lamb(LR, lamb_weight_decay=0.01, parameters=tnet.parameters()),
        tbert.BertPretrainingCriterion(config["vocab_size"]))
    return jm, tm


def jax_step(jm, ids, mlm, nsp):
    (loss,) = jm.train_batch([paddle.to_tensor(ids)],
                             [paddle.to_tensor(mlm), paddle.to_tensor(nsp)])
    return float(loss), {n: np.asarray(v.numpy())
                         for n, v in jm.network.state_dict().items()}


def port_step(tm, ids, mlm, nsp):
    (loss,) = tm.train_batch([ids], [mlm, nsp])
    return float(loss), {n: p.detach().numpy().copy()
                         for n, p in tm.network.named_parameters()}


def check_params(got, want, before, step):
    """Every parameter after `step` (from 0) against JAX's; the key
    biases by their step norms (`before`: each side's values before the
    step) and within the sum of both sides' steps so far."""
    assert sorted(got) == sorted(want)
    for n in want:
        if not n.endswith(NOISE):
            np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)
            continue
        for side, prev in zip((got, want), before):
            np.testing.assert_allclose(
                np.linalg.norm(side[n] - prev[n]),
                LR * np.linalg.norm(prev[n]), rtol=1e-4, err_msg=n)
        bound = 2 * (step + 1) * LR * 1.01 * np.linalg.norm(before[0][n])
        assert np.abs(got[n] - want[n]).max() <= bound, n


@pytest.mark.parametrize("route", ["splash", "default"])
def test_train_batch_matches_jax(route, request):
    if route == "splash":
        request.getfixturevalue("_interpret_splash")
    jm, tm = build()
    (ids, mlm, nsp), _ = pretraining_batch(left=route == "splash")
    start = {n: p.detach().numpy().copy()
             for n, p in tm.network.named_parameters()}
    before = (start, start)
    for step in range(STEPS):
        want_loss, want = jax_step(jm, ids, mlm, nsp)
        got_loss, got = port_step(tm, ids, mlm, nsp)
        assert np.isfinite(got_loss)
        np.testing.assert_allclose(got_loss, want_loss, rtol=TOL["rtol"],
                                   err_msg=f"step {step}")
        check_params(got, want, before, step)
        before = (got, want)
    assert jm._jit_ok                    # JAX ran its compiled step
    assert tm._optimizer._step_count == STEPS


@pytest.mark.parametrize("route", ["splash", "default"])
def test_eval_and_predict_batch_match_jax(route, request):
    if route == "splash":
        request.getfixturevalue("_interpret_splash")
    jm, tm = build()
    (ids, mlm, nsp), real = pretraining_batch(left=route == "splash")
    (want,) = jm.eval_batch([paddle.to_tensor(ids)],
                            [paddle.to_tensor(mlm), paddle.to_tensor(nsp)])
    (got,) = tm.eval_batch([ids], [mlm, nsp])
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"])
    got = tm.predict_batch([ids])
    want = [np.asarray(o) for o in jm.predict_batch([paddle.to_tensor(ids)])]
    rows = slice(None) if route == "splash" else real
    np.testing.assert_allclose(got[0][rows], want[0][rows], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert not tm.network.training


def test_train_batch_routes(monkeypatch):
    """Attention dropout 0 sends every layer through the segmented
    kernel's route, forward and backward; 0.1 through the additive path.
    The two sides' dropout draws different masks, so only the route, a
    finite training loss and a falling eval loss are held."""
    calls = []
    orig = tattn.splash_mha
    monkeypatch.setattr(tattn, "splash_mha",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    (ids, mlm, nsp), _ = pretraining_batch(left=False)
    for p, want in ((0.0, CONFIG["num_hidden_layers"]), (0.1, 0)):
        _, tm = build(dict(CONFIG, attention_probs_dropout_prob=p,
                           hidden_dropout_prob=0.1))
        first = tm.eval_batch([ids], [mlm, nsp])[0]
        calls.clear()
        losses = [float(tm.train_batch([ids], [mlm, nsp])[0])
                  for _ in range(STEPS)]
        assert len(calls) == want * STEPS
        assert np.isfinite(losses).all()
        assert tm.eval_batch([ids], [mlm, nsp])[0] < first


def test_train_batch_without_update_keeps_parameters():
    _, tm = build()
    (ids, mlm, nsp), _ = pretraining_batch(left=False)
    before = [p.detach().clone() for p in tm.parameters()]
    tm.train_batch([ids], [mlm, nsp], update=False)
    assert all(torch.equal(p.detach(), b)
               for p, b in zip(tm.parameters(), before))
    assert all(p.grad is not None for p in tm.parameters())
    assert tm._optimizer._step_count == 0


def test_prepare_refuses_what_is_not_ported():
    _, tm = build()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.prepare(tm._optimizer, tm._loss, amp_configs="O1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.prepare(tm._optimizer, tm._loss, metrics=[object()])


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here: nothing to refuse")
    net = tbert.BertForPretraining(tbert.BertModel(**CONFIG, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(net)
