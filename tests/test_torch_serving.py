"""The PyTorch port's ServingEngine against the JAX ServingEngine.

Both engines serve the same weights — built by the JAX model, carried
across by `paddle_tpu_torch.convert` — and must give token-identical
greedy outputs (fp32, CPU), including under preemption and at EOS.
Also: top-k=1 sampling equals greedy, every step takes the same input
shapes, the port imports neither jax nor paddle_tpu, and the default
device is the card.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.models.gpt import GPTForGeneration
from paddle_tpu_torch.serving.batcher import SamplingConfig
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.kv_cache import PagedKVCache

HEADS = 4


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


def _serve_both(models, prompts, max_new_tokens, **kw):
    jm, tm = models
    je = JaxEngine(jm, **kw)
    te = ServingEngine(tm, device="cpu", **kw)
    return (je.generate_batch(prompts, max_new_tokens=max_new_tokens),
            te.generate_batch(prompts, max_new_tokens=max_new_tokens),
            je, te)


def test_greedy_token_identical(models):
    prompts = [[3, 14, 15, 9, 2], [7, 8], list(range(1, 12)), [42]]
    want, got, je, te = _serve_both(models, prompts, 6, max_slots=4,
                                    block_size=8, max_seq_len=64,
                                    cache_dtype="float32")
    assert got == want
    assert te.steps_run == je.steps_run


def test_token_identical_under_preemption(models):
    """test_serving.py's preemption configuration: 6 requests over 4
    slots and 7 allocatable blocks of 4 tokens."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist()
               for n in (9, 5, 12, 3, 7, 10)]
    want, got, je, te = _serve_both(models, prompts, 8, max_slots=4,
                                    block_size=4, num_blocks=8,
                                    max_seq_len=32, cache_dtype="float32")
    assert te.scheduler.preemption_count > 0     # pressure was real
    assert te.scheduler.preemption_count == je.scheduler.preemption_count
    assert got == want
    assert te.kv.blocks_in_use == 0 and te.scheduler.num_active == 0


def test_eos_terminates_like_jax(models):
    prompts = [[5, 6, 7], [11, 3, 90, 4]]
    kw = dict(max_slots=2, block_size=8, max_seq_len=64,
              cache_dtype="float32")
    free_run, _, _, _ = _serve_both(models, prompts, 10, **kw)
    eos = free_run[0][2]            # stops request 0 by its 3rd token
    want, got, _, _ = _serve_both(models, prompts, 10, eos_token_id=eos,
                                  **kw)
    assert got == want
    for run, out in zip(free_run, got):
        cut = run.index(eos) + 1 if eos in run else len(run)
        assert out == run[:cut]
    assert len(got[0]) <= 3


def test_bf16_cache_token_identical(models):
    """The JAX engine's default pool dtype (bf16) under fp32 compute."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 193, n).tolist() for n in (6, 13, 2)]
    want, got, _, _ = _serve_both(models, prompts, 6, max_slots=2,
                                  block_size=4, max_seq_len=32)
    assert got == want


def test_top_k_one_sampling_equals_greedy(models):
    _, tm = models
    prompts = [[3, 14, 15, 9, 2], [7, 8], list(range(1, 12))]
    kw = dict(max_slots=2, block_size=8, max_seq_len=64,
              cache_dtype="float32", device="cpu")
    greedy = ServingEngine(tm, **kw).generate_batch(prompts, 6)
    sampled = ServingEngine(
        tm, sampling=SamplingConfig(strategy="sampling", top_k=1,
                                    temperature=0.7), seed=3,
        **kw).generate_batch(prompts, 6)
    assert sampled == greedy
    # a real sampling config is seed-deterministic
    hot = SamplingConfig(strategy="sampling", temperature=1.5, top_p=0.9)
    runs = [ServingEngine(tm, sampling=hot, seed=7, **kw).generate_batch(
        prompts, 6) for _ in range(2)]
    assert runs[0] == runs[1]


def test_step_inputs_have_fixed_shapes(models):
    """Admissions, ragged prompts and preemptions never change a step
    input's shape: [T] tokens/slots/positions, [S, MB] tables, [S]
    sample index."""
    _, tm = models
    eng = ServingEngine(tm, max_slots=4, block_size=4, num_blocks=8,
                        max_seq_len=32, cache_dtype="float32",
                        device="cpu")
    seen = set()
    step = eng._mixed_step

    def recording(*args):
        seen.add(tuple((tuple(a.shape), a.dtype) for a in args))
        return step(*args)

    eng._mixed_step = recording
    rng = np.random.RandomState(2)
    for _wave in range(2):
        prompts = [rng.randint(1, 193, int(n)).tolist()
                   for n in rng.randint(2, 14, 3)]
        eng.generate_batch(prompts, max_new_tokens=4)
    T, S = eng.token_budget, eng.kv.max_slots
    MB = eng.kv.max_blocks_per_slot
    assert eng.steps_run > 3
    assert seen == {(((T,), torch.int32), ((T,), torch.int32),
                     ((T,), torch.int32), ((S, MB), torch.int32),
                     ((S,), torch.int32))}


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package (so no
    module added later is missed), imports without jax or paddle_tpu."""
    code = ("import importlib, pkgutil, sys\n"
            "import paddle_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "need = {'paddle_tpu_torch.parallel.mp_layers',"
            " 'paddle_tpu_torch.parallel.hybrid_gpt',"
            " 'paddle_tpu_torch.parallel.moe_utils',"
            " 'paddle_tpu_torch.convert',"
            " 'paddle_tpu_torch.serving.distributed.tp_engine',"
            " 'paddle_tpu_torch.serving.distributed.transport',"
            " 'paddle_tpu_torch.serving.distributed.router',"
            " 'paddle_tpu_torch.serving.distributed.health',"
            " 'paddle_tpu_torch.serving.frontend',"
            " 'paddle_tpu_torch.serving.engine',"
            " 'paddle_tpu_torch.inference',"
            " 'paddle_tpu_torch.incubate.nn.generation',"
            " 'paddle_tpu_torch.serving.fleet',"
            " 'paddle_tpu_torch.serving.fleet.export',"
            " 'paddle_tpu_torch.serving.fleet.upgrade',"
            " 'paddle_tpu_torch.serving.fleet.autoscaler',"
            " 'paddle_tpu_torch.serving.fleet.controller'}\n"
            "assert need <= set(mods), need - set(mods)\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'paddle_tpu.'))"
            " or m == 'paddle_tpu']\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_device_is_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("the default device exists here: nothing to refuse")
    _, tm = models
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tm)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForGeneration(vocab_size=17, hidden_size=8, num_layers=1,
                         num_attention_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(1, 1, 8, num_blocks=3, block_size=4, max_slots=1,
                     max_blocks_per_slot=2)
    from paddle_tpu_torch.convert import load_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import GPTConfig, HybridGPT
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridGPT(GPTConfig(vocab_size=17, seq_len=8, d_model=8, n_heads=2,
                            n_layers=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_jax_hybrid_gpt({})
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForGeneration(vocab_size=17, hidden_size=8, num_layers=1,
                         num_attention_heads=2,
                         moe=dict(num_expert=2, top_k=1))
    # the grouped matmul follows its tensors: only a CPU tensor takes the
    # plain version, any other device launches a kernel or raises
    from paddle_tpu_torch.ops.grouped_matmul import grouped_expert_matmul
    with pytest.raises(ValueError, match="no kernel"):
        grouped_expert_matmul(torch.zeros(1, 2, 4, device="meta"),
                              torch.zeros(1, 4, 3, device="meta"))
