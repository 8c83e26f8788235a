"""Self-drafting for speculative decoding.

Port of `paddle_tpu/serving/draft.py`: the n-gram "prompt lookup"
proposer (the continuation of the most recent earlier occurrence of the
sequence's tail n-gram is the draft — no second model) and the two
acceptance rules that turn a verify step's scores into emitted tokens.
Correctness never depends on draft quality: the verify step scores
every proposed token against the real model, so a bad draft costs
speed, not output fidelity.

The proposer has two forms. `ngram_propose` is the host scan the
1-tick engine drafts with between steps; `ngram_propose_device` is its
tensor twin over a per-slot token ring (`ring_chronological`), which
the multi-tick decode loop runs between ticks without a host read.
Given the same trailing window the two propose the same tokens.
"""
from __future__ import annotations

import torch


def accept_length(fed_tokens, scored_tokens):
    """Longest accepted draft prefix for one verify group (greedy).

    `fed_tokens` = [last_accepted, d_1..d_k] as fed to the verify step;
    `scored_tokens[j]` = the model's greedy next token after fed token
    j. Returns m: d_1..d_m matched the model exactly, so the emitter
    takes `scored_tokens[:m + 1]` (the accepted drafts plus the model's
    correction after the last match)."""
    m = 0
    while m < len(fed_tokens) - 1 and \
            int(fed_tokens[m + 1]) == int(scored_tokens[m]):
        m += 1
    return m


def accept_length_sampled(fed_tokens, accept_flags):
    """Longest accepted draft prefix under rejection sampling.

    `accept_flags[j]` is the device's verdict on draft d_{j+1} (uniform
    u_j < p_j(d_{j+1}) against the target distribution at verify
    position j). Returns m: drafts d_1..d_m were accepted; the emitter
    then takes the residual resample at position m (a rejection there)
    or the bonus sample (every draft accepted, m == len(fed_tokens) -
    1). Same off-by-one contract as `accept_length`."""
    m = 0
    while m < len(fed_tokens) - 1 and bool(accept_flags[m]):
        m += 1
    return m


def ngram_propose(tokens, k, max_ngram=3, min_ngram=1):
    """Propose `k` draft tokens for the sequence `tokens`.

    Finds the longest trailing n-gram (n from `max_ngram` down to
    `min_ngram`) with an earlier occurrence in the sequence — the most
    recent occurrence wins — and copies the k tokens that followed it.
    Short continuations (or no match at all) are padded by repeating
    the last available token, so the caller always gets exactly `k`
    proposals."""
    k = int(k)
    if k <= 0:
        return []
    toks = [int(t) for t in tokens]
    n_t = len(toks)
    out = []
    for n in range(min(int(max_ngram), n_t - 1), int(min_ngram) - 1, -1):
        tail = toks[n_t - n:]
        for s in range(n_t - n - 1, -1, -1):
            if toks[s:s + n] == tail:
                out = toks[s + n:s + n + k]
                break
        if out:
            break
    pad = out[-1] if out else (toks[-1] if toks else 0)
    while len(out) < k:
        out.append(pad)
    return out


def ring_chronological(ring, count):
    """Circular per-slot token ring -> right-aligned chronological view.

    `ring` [S, W] holds each slot's last (up to) W tokens, token t of
    the sequence at column t % W; `count` [S] is the total sequence
    length. Returns `view` [S, W] with view[:, -1] each slot's newest
    token; only the last min(count, W) columns are meaningful. One
    gather, fixed shape."""
    W = ring.shape[1]
    idx = (count.long()[:, None]
           + torch.arange(W, device=ring.device)[None, :]) % W
    return torch.gather(ring, 1, idx)


def ngram_propose_device(view, length, k, max_ngram=3, min_ngram=1):
    """Tensor twin of `ngram_propose`, batched over slots.

    `view` [S, W] is the chronological window (`ring_chronological`),
    `length` [S] the true sequence length (columns before W -
    min(length, W) are never matched). Returns [S, k] proposals equal
    to the host proposer's on each slot's trailing W-token window.

    ml[j] is the length of the suffix match between the window ending at
    column j and the window's tail, capped at max_ngram and never
    crossing the valid region. The host takes the longest tail n-gram
    first and its most recent occurrence, which is the argmax of
    ml[j] * W + j over columns j <= W - 2 with ml[j] >= min_ngram. The
    continuation, clamped at the window's end, repeats the last
    available token, as the host's truncate-then-pad does."""
    k = int(k)
    S, W = view.shape
    dev = view.device
    j = torch.arange(W, device=dev)[None, :]                 # [1, W]
    L = torch.clamp(length.long(), max=W)[:, None]           # [S, 1]
    run = torch.ones((S, W), dtype=torch.bool, device=dev)
    ml = torch.zeros((S, W), dtype=torch.long, device=dev)
    for i in range(int(max_ngram)):
        # column j - i against the tail token at W - 1 - i; a column
        # before the valid region never matches
        shifted = torch.nn.functional.pad(view, (i, 0))[:, :W]
        run = run & (j - i >= W - L) & (shifted == view[:, W - 1 - i, None])
        ml = ml + run.long()
    cand = (ml >= int(min_ngram)) & (j <= W - 2)
    score = torch.where(cand, ml * W + j, -1)
    best = torch.argmax(score, dim=1)                        # [S]
    has = score.amax(dim=1) >= 0
    end = torch.where(has, best, W - 1)
    cont = torch.clamp(end[:, None] + 1
                       + torch.arange(k, device=dev)[None, :], max=W - 1)
    return torch.gather(view, 1, cont)
