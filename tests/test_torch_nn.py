"""CPU parity of the port's `nn` surface (`paddle_tpu_torch.nn`) against
the JAX package's `paddle_tpu.nn`: each layer built on both sides,
holding the same random numpy parameters (biases and LayerNorm affine
included), takes the same numpy input. Attention holds both routes of
`scaled_dot_product_attention`: a `[B, 1, 1, S]` bool mask at S = 128,
head_dim 64 takes the segmented flash kernel's plain version (JAX's
splash kernel in Pallas interpret mode on the other side, every row);
a float mask, head_dim 32, S = 100 or attention dropout in training
take the additive path."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.ops.pallas import flash_attention as jfa
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.nn.functional import attention as tattn

# fp32 on both sides, the same arithmetic summed in another order:
# 1e-5 on O(1) values (observed ~1e-6)
TOL = 1e-5


@pytest.fixture
def _interpret_splash():
    """JAX's splash kernel in interpret mode: its SDPA then routes a
    key-padding mask to the segmented kernel, as on the TPU."""
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def random_arrays(named_shapes, seed):
    """Random numpy parameters: matrices with unit-variance outputs,
    vectors (biases, LayerNorm affine) of O(0.1) around their usual
    0 or 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, shape in named_shapes:
        a = rng.randn(*shape)
        if len(shape) == 2:
            a = a / np.sqrt(shape[0])
        else:
            a = 0.1 * a + ("norm" in n and n.endswith("weight"))
        out[n] = a.astype(np.float32)
    return out


def carry(jlayer, tlayer, seed=0):
    """Random numpy values for every parameter, set on both layers."""
    arrays = random_arrays(((n, p.shape) for n, p in
                            jlayer.state_dict().items()), seed)
    jlayer.set_state_dict({n: paddle.to_tensor(a)
                           for n, a in arrays.items()})
    params = dict(tlayer.named_parameters())
    assert sorted(params) == sorted(arrays)
    with torch.no_grad():
        for n, a in arrays.items():
            params[n].copy_(torch.from_numpy(a))
    jlayer.eval()
    tlayer.eval()


def close(got, want, tol=TOL, rows=None):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def padded(B, S, seed):
    """A [B, S] key-padding mask: the first sequence unpadded, the
    others with random lengths, padding after the tokens."""
    rng = np.random.RandomState(seed)
    lens = np.concatenate([[S], rng.randint(1, S, B - 1)])
    return np.arange(S)[None] < lens[:, None]


def test_linear():
    jl, tl = jnn.Linear(16, 8), tnn.Linear(16, 8, device="cpu")
    carry(jl, tl)
    x = np.random.RandomState(1).randn(3, 5, 16).astype(np.float32)
    assert tuple(tl.weight.shape) == (16, 8)             # paddle's [in, out]
    close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)))


@pytest.mark.parametrize("padding_idx", [None, 2, -1])
def test_embedding(padding_idx):
    je = jnn.Embedding(11, 6, padding_idx=padding_idx)
    te = tnn.Embedding(11, 6, padding_idx=padding_idx, device="cpu")
    carry(je, te)                  # the padding row is nonzero: still 0
    ids = np.random.RandomState(2).randint(0, 11, (4, 9))
    ids[0, :3] = (padding_idx or 0) % 11
    close(te(torch.tensor(ids)), je(paddle.to_tensor(ids)), tol=0)


def test_layer_norm():
    jl, tl = jnn.LayerNorm(32, 1e-5), tnn.LayerNorm(32, 1e-5, device="cpu")
    carry(jl, tl)
    x = (np.random.RandomState(3).randn(4, 7, 32) * 3 + 1).astype(
        np.float32)
    close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)))
    xb = torch.tensor(x).to(torch.bfloat16)
    assert tl(xb).dtype == torch.bfloat16    # fp32 inside, cast back


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_and_tanh(approximate):
    x = (np.random.RandomState(4).randn(64) * 3).astype(np.float32)
    close(tF.gelu(torch.tensor(x), approximate=approximate),
          jF.gelu(paddle.to_tensor(x), approximate=approximate))
    close(tnn.GELU(approximate)(torch.tensor(x)),
          jnn.GELU(approximate=approximate)(paddle.to_tensor(x)))
    close(tnn.Tanh()(torch.tensor(x)), jnn.Tanh()(paddle.to_tensor(x)))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_ignore_index(reduction):
    rng = np.random.RandomState(5)
    logits = (rng.randn(12, 7) * 2).astype(np.float32)
    labels = rng.randint(0, 7, 12)
    labels[::3] = -1
    for lab in (labels, np.full(12, -1)):       # some, then all ignored
        got = tF.cross_entropy(torch.tensor(logits), torch.tensor(lab),
                               ignore_index=-1, reduction=reduction)
        want = jF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(lab), ignore_index=-1,
                                reduction=reduction)
        close(got, want)


def _mha_input(B, S, E, seed):
    return np.random.RandomState(seed).randn(B, S, E).astype(np.float32)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_multi_head_attention_key_padding(_interpret_splash, head_dim):
    """A [B, 1, 1, S] bool mask at S = 128: the port's segmented route
    against JAX's interpret splash route, every row."""
    B, S, H = 3, 128, 2
    E = H * head_dim
    jm, tm = jnn.MultiHeadAttention(E, H), tnn.MultiHeadAttention(
        E, H, device="cpu")
    carry(jm, tm)
    x = _mha_input(B, S, E, 6)
    keep = padded(B, S, 6)[:, None, None, :]
    close(tm(torch.tensor(x), attn_mask=torch.tensor(keep)),
          jm(paddle.to_tensor(x), attn_mask=paddle.to_tensor(keep)))


def test_multi_head_attention_real_rows_match_default_path():
    """Against JAX's default CPU path (the additive one): the real rows
    agree; padded rows differ by design (the port keeps the kernel's
    segment semantics)."""
    B, S, H, E = 3, 128, 2, 128
    jm, tm = jnn.MultiHeadAttention(E, H), tnn.MultiHeadAttention(
        E, H, device="cpu")
    carry(jm, tm)
    x = _mha_input(B, S, E, 7)
    keep = padded(B, S, 7)
    close(tm(torch.tensor(x), attn_mask=torch.tensor(keep[:, None, None])),
          jm(paddle.to_tensor(x),
             attn_mask=paddle.to_tensor(keep[:, None, None])), rows=keep)


@pytest.mark.parametrize("mask", ["none", "float", "bool_2d"])
def test_multi_head_attention_additive_masks(mask):
    B, S, H, E = 2, 24, 4, 32
    jm, tm = jnn.MultiHeadAttention(E, H), tnn.MultiHeadAttention(
        E, H, device="cpu")
    carry(jm, tm)
    x = _mha_input(B, S, E, 8)
    rng = np.random.RandomState(8)
    m = {"none": None,
         "float": (rng.randn(B, 1, S, S) * 2).astype(np.float32),
         "bool_2d": rng.rand(S, S) < 0.8}[mask]
    if m is not None and m.dtype == bool:
        m[:, 0] = True                         # every row sees a key
    close(tm(torch.tensor(x), attn_mask=None if m is None
             else torch.tensor(m)),
          jm(paddle.to_tensor(x), attn_mask=None if m is None
             else paddle.to_tensor(m)))


def test_multi_head_attention_refuses_cache():
    tm = tnn.MultiHeadAttention(8, 2, device="cpu")
    x = torch.zeros(1, 4, 8)
    with pytest.raises(NotImplementedError):
        tm(x, cache=(x, x))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_encoder_layer(_interpret_splash, normalize_before):
    """Post- and pre-norm encoder layers in eval with GELU, over a
    key-padding mask at S = 128, head_dim 64: every row against JAX's
    interpret splash route."""
    B, S, E, H, FF = 2, 128, 128, 2, 256
    kw = dict(dropout=0.1, activation="gelu",
              normalize_before=normalize_before)
    jl = jnn.TransformerEncoderLayer(E, H, FF, **kw)
    tl = tnn.TransformerEncoderLayer(E, H, FF, **kw, device="cpu")
    carry(jl, tl)
    x = _mha_input(B, S, E, 9)
    keep = padded(B, S, 9)[:, None, None, :]
    close(tl(torch.tensor(x), torch.tensor(keep)),
          jl(paddle.to_tensor(x), paddle.to_tensor(keep)))


def test_transformer_encoder_stack(_interpret_splash):
    B, S, E, H, FF = 2, 128, 128, 2, 256
    jl = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(E, H, FF), 2,
                                norm=jnn.LayerNorm(E))
    tl = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, H, FF, device="cpu"), 2, norm=tnn.LayerNorm(E, device="cpu"))
    carry(jl, tl)
    x = _mha_input(B, S, E, 10)
    keep = padded(B, S, 10)[:, None, None, :]
    close(tl(torch.tensor(x), torch.tensor(keep)),
          jl(paddle.to_tensor(x), paddle.to_tensor(keep)))


# ------------------------------------------------ the SDPA route gate


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kv_keep of every call the port's SDPA makes to splash_mha."""
    calls = []
    orig = tattn.splash_mha

    def spy(*a, **kw):
        calls.append(kw.get("kv_keep"))
        return orig(*a, **kw)
    monkeypatch.setattr(tattn, "splash_mha", spy)
    return calls


def _sdpa_inputs(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def test_sdpa_routes_key_padding_mask_to_kernel(kernel_calls):
    B, S, H, D = 2, 128, 2, 64
    q, k, v = _sdpa_inputs(B, S, H, D, 11)
    keep = padded(B, S, 11)
    out = tF.scaled_dot_product_attention(
        *map(torch.tensor, (q, k, v)),
        attn_mask=torch.tensor(keep[:, None, None]))
    assert len(kernel_calls) == 1
    assert torch.equal(kernel_calls[0], torch.tensor(keep, dtype=torch.int32))
    want = jF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)),
        attn_mask=paddle.to_tensor(keep[:, None, None]))
    close(out, want, rows=keep)                 # JAX's additive path
    # a [1, 1, 1, S] mask broadcasts over the batch
    tF.scaled_dot_product_attention(
        *map(torch.tensor, (q, k, v)),
        attn_mask=torch.tensor(keep[:1, None, None]))
    assert kernel_calls[1].shape == (B, S)


@pytest.mark.parametrize("case", ["float_mask", "head_dim_32", "seq_100",
                                  "dropout"])
def test_sdpa_additive_path(kernel_calls, case):
    B, H = 2, 2
    S = 100 if case == "seq_100" else 128
    D = 32 if case == "head_dim_32" else 64
    q, k, v = _sdpa_inputs(B, S, H, D, 12)
    keep = padded(B, S, 12)[:, None, None]
    mask = ((keep - 1.0) * 1e9).astype(np.float32) \
        if case == "float_mask" else keep
    p = 0.5 if case == "dropout" else 0.0
    torch.manual_seed(0)
    out = tF.scaled_dot_product_attention(
        *map(torch.tensor, (q, k, v)), attn_mask=torch.tensor(mask),
        dropout_p=p, training=True)
    assert kernel_calls == []
    if case == "dropout":        # the RNG streams differ: no JAX draw
        assert torch.isfinite(out).all()
        return
    want = jF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)), attn_mask=paddle.to_tensor(mask))
    close(out, want)             # every row: both take the additive path
