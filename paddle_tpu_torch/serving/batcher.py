"""Token-budget batching + the sampling head of the serving engine.

Port of `paddle_tpu/serving/batcher.py`:

* `SamplingConfig` / `select_token` — greedy, or temperature / top-k /
  top-p sampling from an explicit `torch.Generator`;
* `next_pow2` / `round_up` / `choose_token_budget` / `prefill_chunk` —
  the power-of-two shape discipline of the flat step axis;
* `pack_step` — one engine iteration (decode tokens + prefill chunks)
  packed into the FIXED `[token_budget]` flat-token layout:

    token_ids    [T] int32  — decode tokens, then prefill-chunk tokens;
                              0 past num_tokens
    slot_ids     [T] int32  — owning slot per token; -1 = padding
    positions    [T] int32  — position of the token in its sequence
    sample_index [S] int32  — per slot, the flat index whose hidden
                              state samples that slot's next token;
                              -1 = no sample this step (mid-prefill)

Only the dense layout is ported (`verify_width=1`, no reserved decode
region); the logit penalties wait for a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    strategy: str = "greedy"       # "greedy" | "sampling"
    temperature: float = 1.0
    top_k: int = 0                 # 0 = off
    top_p: float = 1.0             # 1.0 = off


def filter_logits(logits, sc: SamplingConfig):
    """The temperature / top-k / top-p transform: sampling draws from
    `softmax(filter_logits(logits, sc))`. Filtered entries are set to
    -1e9 (finite, as in the JAX package)."""
    if sc.temperature != 1.0:
        logits = logits / max(sc.temperature, 1e-6)
    if sc.top_k and sc.top_k > 0:
        kth = torch.topk(logits, sc.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e9, logits)
    if sc.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p; the
        # cutoff is the SMALLEST kept logit
        keep = cum - probs < sc.top_p
        kth = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < kth, -1e9, logits)
    return logits


def select_token(logits, sc: SamplingConfig, generator=None):
    """logits [B, V] -> token [B] int64, on the logits' device.

    Greedy takes the first maximal index (as `jnp.argmax`). Sampling
    draws from `generator`, which must live on the logits' device; the
    draws differ from the JAX package's `jax.random` stream by design."""
    logits = logits.float()
    if sc.strategy == "greedy":
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, sc), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def next_pow2(n, lo=16):
    p = lo
    while p < n:
        p *= 2
    return p


def round_up(n, m):
    return ((n + m - 1) // m) * m


def choose_token_budget(max_slots, block_size, requested=None):
    """Per-step token budget: a power of two >= max(max_slots,
    2*block_size), so a full decode round always fits and prefill
    chunks cover at least two KV blocks per step. An explicit
    `requested` budget is rounded up to a power of two and floored at
    `max_slots` (a smaller budget would stall resident requests while
    they hold KV blocks)."""
    if requested is not None:
        return next_pow2(max(int(requested), max_slots), lo=1)
    return next_pow2(max(max_slots, 2 * block_size))


def prefill_chunk(remaining, budget_left):
    """Chunk size for one prefill slice under the remaining budget:
    the whole remainder when it fits, else the largest power of two
    <= budget_left."""
    remaining = int(remaining)
    budget_left = int(budget_left)
    if budget_left <= 0 or remaining <= 0:
        return 0
    if remaining <= budget_left:
        return remaining
    p = 1
    while p * 2 <= budget_left:
        p *= 2
    return p


@dataclasses.dataclass
class StepPlan:
    """Host-side plan for one mixed step (fixed-shape numpy arrays)."""
    token_ids: np.ndarray       # [T] int32
    slot_ids: np.ndarray        # [T] int32, -1 pad
    positions: np.ndarray       # [T] int32
    sample_index: np.ndarray    # [max_slots] int32, -1 = no sample
    num_tokens: int             # real tokens this step
    decode_slots: list          # slots that fed a decode token
    prefill_done: list          # slots whose prompt completed this step
    prefill_tokens: int
    decode_tokens: int


def pack_step(token_budget, max_slots, decode, prefills) -> StepPlan:
    """Pack decode entries + prefill chunks into the flat-token layout.

    decode: [(slot, token, position)] — one token per running decode,
        packed densely from index 0.
    prefills: [(slot, chunk_tokens: ndarray, start_pos, completes)],
        packed after the decodes; `completes` marks the chunk reaching
        the end of the prompt (its last token samples the slot's first
        output)."""
    token_ids = np.zeros(token_budget, np.int32)
    slot_ids = np.full(token_budget, -1, np.int32)
    positions = np.zeros(token_budget, np.int32)
    sample_index = np.full(max_slots, -1, np.int32)
    n = len(decode) + sum(len(c[1]) for c in prefills)
    if n > token_budget:
        raise ValueError(f"plan of {n} tokens exceeds token budget "
                         f"{token_budget}")
    i = 0
    decode_slots = []
    for slot, tok, pos in decode:
        token_ids[i] = int(tok)
        slot_ids[i] = slot
        positions[i] = pos
        sample_index[slot] = i
        decode_slots.append(slot)
        i += 1
    prefill_done = []
    n_prefill = 0
    for slot, chunk, start, completes in prefills:
        m = len(chunk)
        token_ids[i:i + m] = chunk
        slot_ids[i:i + m] = slot
        positions[i:i + m] = np.arange(start, start + m, dtype=np.int32)
        if completes:
            sample_index[slot] = i + m - 1
            prefill_done.append(slot)
        i += m
        n_prefill += m
    return StepPlan(token_ids=token_ids, slot_ids=slot_ids,
                    positions=positions, sample_index=sample_index,
                    num_tokens=i, decode_slots=decode_slots,
                    prefill_done=prefill_done, prefill_tokens=n_prefill,
                    decode_tokens=len(decode))
