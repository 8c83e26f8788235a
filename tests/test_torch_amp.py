"""CPU parity of the port's AMP (`paddle_tpu_torch.amp`) against the JAX
package's: after `decorate(level="O2")` every parameter and buffer of a
BERT pretraining model has JAX's dtype, name for name; O1 raises, as it
is not ported."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import amp
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.optimizer import Lamb

CONFIG = dict(vocab_size=193, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=128)


def port_model():
    return tbert.BertForPretraining(tbert.BertModel(**CONFIG, device="cpu"))


def dtypes(named):
    return {n: str(t.dtype).split(".")[-1] for n, t in named}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_o2_casts_as_jax(dtype):
    jm = jbert.BertForPretraining(jbert.BertModel(**CONFIG))
    jamp.decorate(jm, level="O2", dtype=dtype)
    tm = port_model()
    emb = tm.bert.embeddings.word_embeddings.weight
    params = list(tm.parameters())
    assert amp.decorate(tm, level="O2", dtype=dtype) is tm
    want = dtypes(jm.named_parameters())
    assert dtypes(tm.named_parameters()) == want
    assert set(want.values()) == {dtype}
    assert dtypes(tm.named_buffers()) == dtypes(jm.named_buffers())
    # the same parameter objects, now cast: an optimizer built before
    # stays valid, and the MLM decoder stays tied to the embedding
    assert all(a is b for a, b in zip(tm.parameters(), params))
    assert tm.cls._tied_weight is emb and emb.dtype == getattr(torch, dtype)


def test_decorate_lists_and_optimizers():
    a, b = port_model(), port_model()
    opt = Lamb(parameters=a.parameters())
    models, opts = amp.decorate([a, b], optimizers=opt)
    assert models == [a, b] and opts is opt
    for m in models:
        assert {p.dtype for p in m.parameters()} == {torch.bfloat16}


def test_prepare_casts_with_amp_configs():
    for configs, dtype in (("O2", torch.bfloat16),
                           ({"level": "O2", "dtype": "float16"},
                            torch.float16)):
        net = port_model()
        Model(net, device="cpu").prepare(
            Lamb(parameters=net.parameters()),
            tbert.BertPretrainingCriterion(CONFIG["vocab_size"]),
            amp_configs=configs)
        assert {p.dtype for p in net.parameters()} == {dtype}


def test_o2_forward_matches_jax_dtype():
    """The decorated model's outputs take the parameters' dtype on both
    sides (the loss is cast to fp32 by the step)."""
    jm = jbert.BertForPretraining(jbert.BertModel(**CONFIG))
    jamp.decorate(jm, level="O2")
    tm = port_model().eval()
    amp.decorate(tm)
    ids = np.random.RandomState(0).randint(1, 193, (2, 128))
    jm.eval()
    want = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        got = tm(torch.tensor(ids))
    assert [str(t.dtype).split(".")[-1] for t in got] == \
        [str(t.dtype) for t in want]


def test_o1_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        with amp.auto_cast(level="O1"):
            pass
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        amp.decorate(port_model(), level="O1")
    with pytest.raises(ValueError):
        amp.decorate(port_model(), level="O3")
    with amp.auto_cast(enable=False):          # off: nothing to refuse
        pass
