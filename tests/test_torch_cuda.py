"""Card-only checks of the PyTorch port (marker `cuda`), run on a
machine with the card by

    python -m pytest -m cuda tests/test_torch_*.py

Without a card every test here skips; the CPU parity tests live in the
other tests/test_torch_*.py files. This file imports torch and the port
only, no jax.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.gpt import GPTForGeneration
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving.engine import ServingEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dtype, device, seed=0):
    """A mixed decode/prefill flat axis with padding at the serving
    head geometry (H=16, Dh=64, BS=16), with a smaller T and context."""
    g = torch.Generator().manual_seed(seed)
    H, Dh, BS, S, MB, T = 16, 64, 16, 4, 16, 64
    NB = S * MB + 1
    lens = [256, 100, 37, 1]
    bt = torch.zeros(S, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(lens):
        nb = -(-n // BS)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    slots = list(range(S))                     # one decode per slot
    pos = [n - 1 for n in lens]
    slots += [1] * 40                          # a 40-token prefill chunk
    pos += list(range(60, 100))
    slots += [-1] * (T - len(slots))           # padding
    pos += [0] * (T - len(pos))
    q = torch.randn(T, H, Dh, generator=g).to(dtype)
    kp = torch.randn(NB, BS, H, Dh, generator=g).to(dtype)
    vp = torch.randn(NB, BS, H, Dh, generator=g).to(dtype)
    args = [q, kp, vp, bt, torch.tensor(slots, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32)]
    return [a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain(dtype, tol, cuda_device):
    """The kernel against the plain version on the card: fp32 at 1e-5;
    bf16 at 2e-2 (the plain version rounds logits and probabilities to
    bf16, the kernel keeps them fp32 — a few bf16 spacings apart)."""
    args = _case(dtype, cuda_device)
    before = tpa.launch_count
    got = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launch_count == before + 1
    ref = tpa.ragged_gather_reference(*args)
    valid = args[4] >= 0
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[valid].float(), ref[valid].float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_operands(cuda_device):
    q, kp, vp, bt, slots, pos = _case(torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tpa.ragged_paged_attention(q.half(), kp.bfloat16(), vp.bfloat16(),
                                   bt, slots, pos)
    with pytest.raises(TypeError):
        tpa.ragged_paged_attention(q, kp, vp, bt.long(), slots, pos)
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, bt, slots,
                                   pos)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 model served on the card (kernel path) and on the
    CPU (plain path) from the same weights gives the same greedy
    tokens, and the card run launched one kernel per layer per step."""
    torch.manual_seed(0)
    cpu = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                           num_attention_heads=2,
                           max_position_embeddings=128, device="cpu")
    card = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                            num_attention_heads=2,
                            max_position_embeddings=128,
                            device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 5, 30, 3)]
    kw = dict(max_slots=4, block_size=16, max_seq_len=64,
              cache_dtype="float32")
    want = ServingEngine(cpu, device="cpu", **kw).generate_batch(
        prompts, max_new_tokens=8)
    eng = ServingEngine(card, device=cuda_device, **kw)
    before = tpa.launch_count
    got = eng.generate_batch(prompts, max_new_tokens=8)
    assert got == want
    assert tpa.launch_count - before == eng.steps_run * 2
