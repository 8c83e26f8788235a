"""Token-budget batching + the sampling head of the serving engine.

Port of `paddle_tpu/serving/batcher.py`:

* `SamplingConfig` / `select_token` — greedy, or temperature / top-k /
  top-p sampling from an explicit `torch.Generator`, after the
  repetition / presence / frequency penalties of a per-slot token-count
  histogram (`apply_count_penalties`, `history_to_counts`,
  `apply_logit_penalties`);
* `next_pow2` / `round_up` / `choose_token_budget` / `prefill_chunk` —
  the power-of-two shape discipline of the flat step axis;
* `pack_step` — one engine iteration (decode tokens or speculative
  verify groups + prefill chunks) packed into the FIXED
  `[token_budget]` flat-token layout:

    token_ids    [T] int32  — decode tokens, then prefill-chunk tokens;
                              0 past num_tokens
    slot_ids     [T] int32  — owning slot per token; -1 = padding
    positions    [T] int32  — position of the token in its sequence
    sample_index [S] int32  — per slot, the flat index whose hidden
                              state samples that slot's next token;
                              -1 = no sample this step (mid-prefill)

With speculation (`verify_width` = draft_k + 1 > 1) the first
`max_slots * verify_width` flat tokens are a fixed verify region. The
sparse decode region is not ported (ROADMAP Queue 1).
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
    repetition_penalty: float = 1.0   # 1.0 = off (HF semantics)
    presence_penalty: float = 0.0     # 0.0 = off (additive, one-shot)
    frequency_penalty: float = 0.0    # 0.0 = off (count-scaled)
    penalty_window: int = 128      # tokens of context the penalties see


def needs_history(sc: SamplingConfig) -> bool:
    """True when a logit penalty is on (it needs each slot's token
    history)."""
    return (sc.repetition_penalty != 1.0 or sc.presence_penalty != 0.0
            or sc.frequency_penalty != 0.0)


def apply_count_penalties(logits, counts, sc: SamplingConfig):
    """Repetition / presence / frequency penalties from a token-count
    histogram. logits [..., V]; counts [..., Vb], the occurrences of
    each of Vb vocab bins in the context (token t falls in bin t % Vb;
    Vb == V is exact). Any leading batch shape: the verify head passes
    per-position [S, K, Vb] priors.

    * repetition (HF semantics): a seen token's logit is divided by the
      penalty when positive, multiplied by it when not;
    * presence: one subtraction per seen token;
    * frequency: a subtraction per occurrence (count-scaled)."""
    V, Vb = logits.shape[-1], counts.shape[-1]
    cnt = counts.to(logits.dtype)
    if Vb != V:
        cnt = cnt[..., torch.arange(V, device=logits.device) % Vb]
    seen = cnt > 0
    if sc.repetition_penalty != 1.0:
        rp = float(sc.repetition_penalty)
        logits = torch.where(
            seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    if sc.presence_penalty != 0.0:
        logits = logits - float(sc.presence_penalty) * seen.to(logits.dtype)
    if sc.frequency_penalty != 0.0:
        logits = logits - float(sc.frequency_penalty) * cnt
    return logits


def history_to_counts(history, vocab_bins, dtype=torch.float32):
    """[B, W] -1-padded token history -> [B, vocab_bins] counts: one
    scatter-add (padding adds weight 0 to bin 0)."""
    valid = history >= 0
    idx = torch.where(valid, history % int(vocab_bins), 0).long()
    out = torch.zeros((history.shape[0], int(vocab_bins)), dtype=dtype,
                      device=history.device)
    return out.scatter_add_(1, idx, valid.to(dtype))


def apply_logit_penalties(logits, history, sc: SamplingConfig):
    """The penalties from a [B, W] -1-padded token-history window:
    `apply_count_penalties` over its exact-vocab count histogram."""
    return apply_count_penalties(
        logits, history_to_counts(history, logits.shape[-1], logits.dtype),
        sc)


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


def select_token(logits, sc: SamplingConfig, generator=None, counts=None):
    """logits [B, V] -> token [B] int64, on the logits' device.

    With `counts` [B, Vb] and a penalty on, the penalties apply first
    (`apply_count_penalties`), then the strategy. Greedy takes the first
    maximal index (as `jnp.argmax`). Sampling draws from `generator`,
    which must live on the logits' device; the draws differ from the
    JAX package's `jax.random` stream by design."""
    logits = logits.float()
    if counts is not None and needs_history(sc):
        logits = apply_count_penalties(logits, counts, sc)
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


def choose_token_budget(max_slots, block_size, requested=None,
                        verify_width=1):
    """Per-step token budget: a power of two >= max(max_slots,
    2*block_size), so a full decode round always fits and prefill
    chunks cover at least two KV blocks per step. An explicit
    `requested` budget is rounded up to a power of two and floored at
    `max_slots` (a smaller budget would stall resident requests while
    they hold KV blocks).

    With speculation (`verify_width` = draft_k + 1 > 1) the first
    `max_slots * verify_width` flat tokens are the reserved verify
    region (see `pack_step`), so the floor rises to that region plus
    prefill room — a budget that left prefill no token would starve
    admission forever."""
    vw = int(verify_width)
    region = max_slots * vw
    if requested is not None:
        floor = max_slots if vw == 1 else region + 1
        return next_pow2(max(int(requested), floor), lo=1)
    if vw == 1:
        return next_pow2(max(max_slots, 2 * block_size))
    return next_pow2(region + 2 * block_size)


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
    decode_slots: list          # slots that fed decode/verify tokens
    prefill_done: list          # slots whose prompt completed this step
    prefill_tokens: int
    decode_tokens: int
    verify_width: int = 1       # 1 + draft_k (1 = no speculation)
    #: [(slot, [tokens], position)] as planned — the engine replays
    #: these against the verify scores to compute accept lengths
    decode_entries: list = dataclasses.field(default_factory=list)


def pack_step(token_budget, max_slots, decode, prefills,
              verify_width=1) -> StepPlan:
    """Pack decode entries + prefill chunks into the flat-token layout.

    decode: [(slot, token_or_tokens, position)] — one entry per running
        decode. A scalar token is the plain one-token decode; a list
        [last, d_1..d_k] is a speculative verify group (k <= draft_k
        proposed tokens after the last accepted one).
    prefills: [(slot, chunk_tokens: ndarray, start_pos, completes)];
        `completes` marks the chunk reaching the end of the prompt (its
        last token samples the slot's first output).

    With `verify_width == 1` decode tokens pack densely from index 0
    and prefill chunks follow. With speculation (`verify_width` =
    draft_k + 1 > 1) the first `max_slots * verify_width` flat tokens
    are a fixed verify region — slot s owns indices [s*vw, (s+1)*vw),
    padded with slot -1 at position 0 — so the step can reshape it to
    `[max_slots, vw]`; its decode slots get no `sample_index` (the
    verify scores stand in), and prefill packs after the region."""
    vw = int(verify_width)
    region = max_slots * vw if vw > 1 else 0
    token_ids = np.zeros(token_budget, np.int32)
    slot_ids = np.full(token_budget, -1, np.int32)
    positions = np.zeros(token_budget, np.int32)
    sample_index = np.full(max_slots, -1, np.int32)
    i = 0
    decode_slots = []
    decode_entries = []
    n_decode = 0
    for slot, tok, pos in decode:
        toks = [int(tok)] if np.isscalar(tok) or getattr(
            tok, "ndim", None) == 0 else [int(t) for t in tok]
        if len(toks) > vw:
            raise ValueError(
                f"decode group of {len(toks)} tokens exceeds the "
                f"verify width {vw}")
        base = slot * vw if vw > 1 else i
        token_ids[base:base + len(toks)] = toks
        slot_ids[base:base + len(toks)] = slot
        positions[base:base + len(toks)] = np.arange(
            pos, pos + len(toks), dtype=np.int32)
        if vw == 1:
            sample_index[slot] = base
            i += 1
        decode_slots.append(slot)
        decode_entries.append((slot, toks, int(pos)))
        n_decode += len(toks)
    if vw > 1:
        i = region
    n = max(n_decode, region) + sum(len(c[1]) for c in prefills)
    if n > token_budget:
        raise ValueError(f"plan of {n} tokens exceeds token budget "
                         f"{token_budget}")
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
                    decode_tokens=n_decode, verify_width=vw,
                    decode_entries=decode_entries)
