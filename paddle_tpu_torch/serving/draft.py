"""Self-drafting for speculative decoding.

Port of the host half of `paddle_tpu/serving/draft.py`: the n-gram
"prompt lookup" proposer (the continuation of the most recent earlier
occurrence of the sequence's tail n-gram is the draft — no second
model, no device work) and the two acceptance rules that turn a verify
step's scores into emitted tokens. Correctness never depends on draft
quality: the verify step scores every proposed token against the real
model, so a bad draft costs speed, not output fidelity.

The device twins (`ring_chronological`, `ngram_propose_device`) belong
to the multi-tick decode loop, which waits for a later slice.
"""
from __future__ import annotations


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
