"""The port's tensor-parallel serving engine against the JAX package's.

`paddle_tpu_torch.serving.distributed.TPServingEngine` runs one process a
rank over a `torch.distributed` group. Here two CPU ranks over gloo
(`torch_tp_ranks.run_ranks`, one spawn for the whole module) serve every
scenario, and JAX's `TPServingEngine(tensor_parallel=2)` serves the same
requests on the conftest's virtual devices, on the same weights (numpy,
carried across by `convert.load_jax_gpt`), in fp32 at
tests/test_tp_serving.py's sizes (vocab 211, hidden 32, 2 layers, 4
heads). Tolerance 0:

* `shard_major_qkv` and the split rules give JAX's shards on the same
  arrays, the rules name what JAX's three dicts name, and every rank's
  shards concatenate back to the (permuted) full tensor;
* the port's TP = 2 tokens equal JAX's TP = 2 tokens, and every rank's
  tokens, states and allocator ledger equal the other's: dense,
  draft_k=3, the prefix cache with a copy-on-write replay, preemption,
  an int8 pool, 4 ticks a dispatch, block-sparse decode, two LoRA
  tenants and a weight-only int8 stack;
* rank 1's clock 1000 s ahead of rank 0's expires a request at the same
  step on both ranks (rank 0's clock is broadcast);
* `tensor_parallel=1` without a process group equals `ServingEngine`,
  and the engine refuses what JAX's refuses.

tests/test_torch_tp_moe_serving.py holds the MoE stacks at TP x EP.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import torch_tp_ranks as tr
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.parallel import mp_layers as jmp
from paddle_tpu.serving.adapters import make_random_adapter as jax_adapter
from paddle_tpu.serving.distributed import TPServingEngine as JaxTP
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.incubate.nn.fused_transformer import (
    FusedMultiTransformer)
from paddle_tpu_torch.parallel import mp_layers as tmp
from paddle_tpu_torch.serving.distributed import TPServingEngine
from paddle_tpu_torch.serving.engine import ServingEngine


def _arrays(jm):
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    return {n: np.asarray(t._data) for n, t in zip(names, tensors)}


def _jax_model(weight_only=False, moe=None):
    paddle.seed(1234)
    jm = JaxGPT(vocab_size=tr.VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=tr.HEADS, max_position_embeddings=128,
                compute_dtype="float32", weight_only=weight_only, moe=moe)
    jm.eval()
    return jm


def _jax_serve(jm, kw, traffic, tp=2, ep=1):
    eng = JaxTP(jm, tensor_parallel=tp, expert_parallel=ep,
                **dict(tr.BASE_KW, **kw))
    ads = ({"t1": jax_adapter(jm.decoder, 4, seed=1, scale=0.3),
            "t2": jax_adapter(jm.decoder, 4, seed=2, scale=0.3)}
           if traffic == "lora" else None)
    return tr.serve(eng, traffic, ads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the JAX models by kind, each rank's results of every scenario):
    one spawn of two ranks for the module."""
    d = tmp_path_factory.mktemp("tp_ranks")
    jms = {"float": _jax_model(), "weight_only": _jax_model(True)}
    for kind, jm in jms.items():
        np.savez(d / f"{kind}.npz", **_arrays(jm))
    jobs = [dict(name=name, model=kind, tp=2, ep=1, kw=kw, traffic=traffic,
                 layer0=name in ("dense", "weight_only", "lora"))
            for name, (kind, kw, traffic) in tr.SCENARIOS.items()]
    jobs.append(dict(name="clock", model="float", tp=2, ep=1, kw={},
                     traffic="clock"))
    return jms, tr.run_ranks(2, str(d), jobs)


# ------------------------------------------------------------ the layout


def test_rules_name_jax_sets():
    assert set(tmp.SERVING_TP_SPECS) == set(jmp.SERVING_TP_SPECS)
    assert set(tmp.SERVING_MOE_TP_SPECS) == set(jmp.SERVING_MOE_TP_SPECS)
    assert set(tmp.SERVING_LORA_TP_SPECS) == set(jmp.SERVING_LORA_TP_SPECS)
    with pytest.raises(ValueError, match="no tensor-parallel"):
        tmp.serving_tp_spec("gate_w")
    with pytest.raises(ValueError, match="no tensor-parallel"):
        jmp.serving_tp_spec("gate_w")
    assert tmp.serving_tp_spec("gate_w", moe=True) == tmp.SplitRule()


#: the stacked shape of every named tensor at L 2, D 8, H 4 x Dh 2, F 12,
#: E 4, K 3 adapter slots of rank 2
_SHAPES = {
    "ln_s": (2, 8), "ln_b": (2, 8), "qkv_w": (2, 8, 24), "qkv_b": (2, 24),
    "qkv_s": (2, 24), "out_w": (2, 8, 8), "out_b": (2, 8), "out_s": (2, 8),
    "ffn_ln_s": (2, 8), "ffn_ln_b": (2, 8), "ffn1_w": (2, 8, 12),
    "ffn1_b": (2, 12), "ffn1_s": (2, 12), "ffn2_w": (2, 12, 8),
    "ffn2_b": (2, 8), "ffn2_s": (2, 8),
    "lora_qkv_a": (2, 3, 8, 2), "lora_qkv_b": (2, 3, 2, 24),
    "lora_out_a": (2, 3, 8, 2), "lora_out_b": (2, 3, 2, 8),
    "lora_ffn1_a": (2, 3, 8, 2), "lora_ffn1_b": (2, 3, 2, 12),
    "lora_ffn2_a": (2, 3, 12, 2), "lora_ffn2_b": (2, 3, 2, 8)}
_MOE_SHAPES = {"gate_w": (2, 8, 4), "ffn1_w": (2, 4, 8, 12),
               "ffn1_b": (2, 4, 12), "ffn1_s": (2, 4, 12),
               "ffn2_w": (2, 4, 12, 8), "ffn2_b": (2, 4, 8),
               "ffn2_s": (2, 4, 8)}


def _jax_shard(arr, name, moe, tp, ep, mp_rank, ep_rank):
    """Rank (ep_rank, mp_rank)'s block of `arr` under JAX's spec."""
    spec, perm = jmp.serving_tp_spec(name, moe=moe)
    if perm:
        arr = np.asarray(jmp.shard_major_qkv(jnp.asarray(arr), tp, 4, 2))
    for axis, part in enumerate(tuple(spec)):
        n, i = {"mp": (tp, mp_rank), "ep": (ep, ep_rank),
                None: (1, 0)}[part]
        arr = np.split(arr, n, axis=axis)[i]
    return arr


@pytest.mark.parametrize("moe,tp,ep", [
    (False, 1, 1), (False, 2, 1), (False, 4, 1), (True, 2, 1),
    (True, 1, 2), (True, 2, 2), (True, 1, 4)])
def test_shard_tensor_matches_jax_spec(moe, tp, ep):
    rng = np.random.RandomState(tp * 10 + ep)
    shapes = dict(_SHAPES, **(_MOE_SHAPES if moe else {}))
    for name, shape in shapes.items():
        arr = rng.randn(*shape).astype(np.float32)
        for e in range(ep):
            for m in range(tp):
                got = tmp.shard_tensor(
                    torch.tensor(arr), tmp.serving_tp_spec(name, moe=moe),
                    tp=tp, mp_rank=m, ep=ep, ep_rank=e, num_heads=4,
                    head_dim=2)
                want = _jax_shard(arr, name, moe, tp, ep, m, e)
                assert got.is_contiguous()
                assert np.array_equal(got.numpy(), want), (name, m, e)


def test_shard_major_qkv_matches_jax():
    rng = np.random.RandomState(0)
    for shape, heads, dh, tp in (((2, 6, 60), 4, 5, 2),
                                 ((3, 48), 8, 2, 4), ((96,), 16, 2, 8)):
        w = rng.randn(*shape).astype(np.float32)
        want = np.asarray(jmp.shard_major_qkv(jnp.asarray(w), tp, heads,
                                              dh))
        got = tmp.shard_major_qkv(torch.tensor(w), tp, heads, dh)
        assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tmp.shard_major_qkv(torch.zeros(2, 6, 60), 2, 4, 7)
    with pytest.raises(ValueError):
        tmp.shard_major_qkv(torch.zeros(2, 6, 60), 3, 4, 5)


# -------------------------------------------------------- the engines


@pytest.mark.parametrize("name", list(tr.SCENARIOS))
def test_tp2_matches_jax_and_ranks_agree(ranks, name):
    jms, results = ranks
    kind, kw, traffic = tr.SCENARIOS[name]
    want = _jax_serve(jms[kind], kw, traffic)
    got0, got1 = results[0][name], results[1][name]
    for got in (got0, got1):
        assert got["tokens"] == want["tokens"], name
        assert got["states"] == want["states"]
        assert got["preemptions"] == want["preemptions"]
        assert got["spec"] == want["spec"]
        assert got["blocks_in_use"] == 0
        assert got["allocator"]["ok"]
    assert got0["allocator"] == got1["allocator"]
    if "cache" in want:
        assert got0["hits"] == got1["hits"] == want["hits"]
        assert got0["cache"] == got1["cache"] == want["cache"]
        assert sum(want["hits"][6:]) > 0 and want["cache"][3] >= 1
    if name == "preempt":
        assert want["preemptions"] > 0
    if name == "draft3":
        assert want["spec"][1] > 0


@pytest.mark.parametrize("name", ["dense", "weight_only", "lora"])
def test_rank_shards_concatenate_to_full(ranks, name):
    """Every rank's layer-0 tensors, concatenated along their split axes,
    give the (shard-major permuted) full tensors of the JAX model."""
    jms, results = ranks
    kind = tr.SCENARIOS[name][0]
    arrays = _arrays(jms[kind])
    parts = [results[r][name]["layer0"] for r in range(2)]
    names = set(parts[0])
    assert names == set(parts[1])
    ads = {}
    if name == "lora":
        dec = load_jax_gpt(arrays, tr.HEADS, device="cpu").decoder
        ads = {"t1": tr._adapter(dec, 1), "t2": tr._adapter(dec, 2)}
    for n in names:
        rule = tmp.serving_tp_spec(n)
        if n.startswith("lora_"):
            # the tenants loaded into slots 1 and 2 (alpha / r = 1)
            hook, kind = n[5:-2], n[-1]
            full = torch.stack([torch.zeros_like(torch.tensor(
                ads["t1"][hook][kind == "b"][0]))] + [torch.tensor(
                    ads[t][hook][kind == "b"][0]) for t in ("t1", "t2")])
        else:
            full = torch.tensor(arrays[n][0])
        if rule.permute:
            full = tmp.shard_major_qkv(full, 2, tr.HEADS, 8)
        if rule.mp is None:
            assert all(torch.equal(p[n], full) for p in parts), n
        else:
            assert torch.equal(torch.cat([p[n] for p in parts], rule.mp),
                               full), n


def test_clock_of_rank0_decides_expiry(ranks):
    _, results = ranks
    got0, got1 = results[0]["clock"], results[1]["clock"]
    assert got0 == got1
    assert got0["states"][0] == "expired"
    assert 0 < len(got0["tokens"][0]) < 16
    assert got0["states"][1:] == ["finished", "finished"]


@pytest.mark.parametrize("kw", [{}, dict(draft_k=3),
                                dict(ticks_per_dispatch=4)])
def test_tp1_without_group_equals_serving_engine(kw):
    tm = load_jax_gpt(_arrays(_jax_model()), tr.HEADS, device="cpu")
    ps = tr.prompts()
    want = ServingEngine(tm, device="cpu",
                         **dict(tr.BASE_KW, **kw)).generate_batch(ps, 8)
    eng = TPServingEngine(tm, tensor_parallel=1, device="cpu",
                          **dict(tr.BASE_KW, **kw))
    assert eng.generate_batch(ps, 8) == want
    assert eng.kv.blocks_in_use == 0


def test_refusals():
    tm = load_jax_gpt(_arrays(_jax_model()), tr.HEADS, device="cpu")
    with pytest.raises(ValueError, match="MoE decoder stack"):
        TPServingEngine(tm, tensor_parallel=1, expert_parallel=2,
                        device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        TPServingEngine(tm, tensor_parallel=3, device="cpu")
    with pytest.raises(ValueError, match="default process group of 2"):
        TPServingEngine(tm, tensor_parallel=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        TPServingEngine(tm, tensor_parallel=0, device="cpu")

    class Odd:                         # F = 30 does not split in 4
        decoder = FusedMultiTransformer(32, 4, 30, num_layers=1,
                                        device="cpu")
    with pytest.raises(ValueError, match="dim_feedforward"):
        TPServingEngine(Odd(), tensor_parallel=4, device="cpu")
    moe = dict(tr.MOE, num_expert=3)
    tmoe = load_jax_gpt(_arrays(_jax_model(moe=moe)), tr.HEADS, moe=moe,
                        device="cpu")
    with pytest.raises(ValueError, match="num_experts=3"):
        TPServingEngine(tmoe, tensor_parallel=1, expert_parallel=2,
                        device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here: nothing to refuse")
    tm = load_jax_gpt(_arrays(_jax_model()), tr.HEADS, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPServingEngine(tm, tensor_parallel=1)


def test_out_of_scope_raise():
    tm = load_jax_gpt(_arrays(_jax_model()), tr.HEADS, device="cpu")
    eng = TPServingEngine(tm, tensor_parallel=1, device="cpu",
                          **tr.BASE_KW)
    with pytest.raises(NotImplementedError, match="swap_weights"):
        eng.swap_weights([])
