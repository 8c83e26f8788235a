"""Continuous-batching scheduler.

Port of `paddle_tpu/serving/scheduler.py` — FIFO admission over a
fixed set of slots, chunked prefill under a per-step token budget, and
block-pressure preemption against the paged KV cache:

* **Admission** — requests queue FIFO and take the lowest free slot.
  Prefill streams the prompt through the mixed step in budget-sized
  chunks; decodes are planned FIRST each step, prefill fills the rest.
* **Preemption** — when a decode cannot get its next KV block, the
  decode holding the MOST blocks is evicted (ties break toward the
  latest arrival). The victim re-enters the FRONT of the queue with its
  generated tokens folded into the prompt, so re-prefill resumes the
  sequence exactly. Prefill never preempts; it only takes free blocks.
* **Deadlines** — an optional absolute deadline per request; queued or
  resident requests past it expire and their blocks are reclaimed.
* **Speculation** — with `draft_k > 0` each decode feeds a verify group
  `[last token, d_1..d_k]` from `draft_fn`; the draft extends with FREE
  blocks only, and the engine reports how far the group got
  (`note_accept`), which rolls back the blocks rejected drafts claimed.
  With `device_draft` the multi-tick engine drafts on the device, so a
  decode is planned as `[last token]` alone.
* **Multi-tick preallocation** — `extend_for_ticks` maps FREE blocks
  ahead of a decode so a dispatch of several ticks appends without the
  host; the engine truncates back to what was emitted at harvest.

Pure host-side bookkeeping. The prefix-cache, adapter, migration and
tracing hooks of the JAX scheduler wait for later slices (ROADMAP.md).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Optional

import numpy as np

from . import batcher


@dataclasses.dataclass(eq=False)   # identity semantics: requests live
class Request:                     # in sets/queues across state moves
    req_id: int
    prompt: list                      # original prompt token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    deadline: Optional[float] = None  # absolute clock() time
    arrival: float = 0.0
    state: str = "queued"   # queued|prefill|decode|finished|expired|cancelled
    slot: int = -1
    output: list = dataclasses.field(default_factory=list)
    fed: int = 0                      # runtime-prompt tokens fed so far
    preemptions: int = 0
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def runtime_prompt(self):
        """What prefill must feed: the prompt plus any tokens already
        generated before a preemption dropped the KV blocks."""
        return self.prompt + self.output

    @property
    def done(self):
        return self.state in ("finished", "expired", "cancelled")


@dataclasses.dataclass
class Plan:
    decode: list        # [(slot, token, position)]
    prefills: list      # [(slot, chunk ndarray, start_pos, completes)]
    expired: list       # requests expired this round

    @property
    def empty(self):
        return not self.decode and not self.prefills


class Scheduler:
    def __init__(self, kv_cache, *, max_slots, token_budget,
                 clock=time.monotonic, draft_k=0, draft_fn=None,
                 device_draft=False):
        self.kv = kv_cache
        self.max_slots = max_slots
        self.token_budget = token_budget
        self.clock = clock
        # speculative decoding: each decode may carry up to draft_k
        # proposed tokens (draft_fn(sequence) -> draft_k ints)
        self.draft_k = int(draft_k)
        self.draft_fn = draft_fn
        # the multi-tick engine drafts inside its decode loop: plan()
        # feeds [last] alone, the device widens the group
        self.device_draft = bool(device_draft)
        self.queue = collections.deque()
        self.slots = [None] * max_slots
        self._ids = itertools.count()
        self.preemption_count = 0

    # ---------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens, eos_token_id=None,
               deadline=None):
        total = len(prompt) + max_new_tokens - 1  # last token never fed
        if total > self.kv.max_slot_tokens:
            raise ValueError(
                f"request needs {total} cached tokens; a slot holds at "
                f"most {self.kv.max_slot_tokens}")
        now = self.clock()
        req = Request(req_id=next(self._ids), prompt=list(prompt),
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id, deadline=deadline,
                      arrival=now, submit_time=now)
        self.queue.append(req)
        return req

    @property
    def num_active(self):
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self):
        return bool(self.queue) or self.num_active > 0

    # ------------------------------------------------------- internals
    def _free_slot(self, req):
        self.kv.release_slot(req.slot)
        self.slots[req.slot] = None
        req.slot = -1

    def _expire(self, now):
        expired = []
        for req in list(self.queue):
            if req.deadline is not None and now > req.deadline:
                self.queue.remove(req)
                req.state = "expired"
                req.finish_time = now
                expired.append(req)
        for req in list(self.slots):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._free_slot(req)
                req.state = "expired"
                req.finish_time = now
                expired.append(req)
        return expired

    def _admit(self):
        for slot in range(self.max_slots):
            if not self.queue:
                break
            if self.slots[slot] is None:
                req = self.queue.popleft()
                req.slot = slot
                req.state = "prefill"
                req.fed = 0
                self.slots[slot] = req

    def _preempt_victim(self, exclude):
        """Evict the decode holding the most blocks (tie: latest
        arrival). Returns the victim or None."""
        cands = [r for r in self.slots
                 if r is not None and r.state == "decode"
                 and r not in exclude]
        if not cands:
            return None
        victim = max(cands, key=lambda r: (self.kv.slot_num_blocks(
            r.slot), r.arrival))
        self._free_slot(victim)
        victim.state = "queued"
        victim.fed = 0
        victim.preemptions += 1
        self.preemption_count += 1
        self.queue.appendleft(victim)
        return victim

    # ------------------------------------------------- speculative draft
    def _draft_tokens(self, req, pos):
        """[last_token, d_1..d_k] for one decode's verify group.

        k starts at draft_k and shrinks to what is worth feeding: never
        past the request's remaining horizon, never past the slot's
        token capacity, and never past what FREE blocks can back — a
        speculative burst can't preempt a neighbour's accepted work."""
        k = min(self.draft_k,
                req.max_new_tokens - len(req.output) - 1,
                self.kv.max_slot_tokens - (pos + 1))
        if k > 0:
            # free-block extension only: shrink k to the free coverage
            while k > 0 and not self.kv.ensure_capacity(
                    req.slot, pos + 1 + k):
                fit = (self.kv.slot_num_blocks(req.slot)
                       + self.kv.allocator.num_free) \
                    * self.kv.block_size - (pos + 1)
                k = min(k - 1, fit) if fit > 0 else 0
        if k <= 0:
            return [req.output[-1]]
        draft = self.draft_fn(req.prompt + req.output)
        return [req.output[-1]] + [int(t) for t in draft[:k]]

    # ------------------------------------------- multi-tick preallocation
    def extend_for_ticks(self, slot, pos, n_ticks):
        """Pre-extend one decode slot's blocks so a multi-tick dispatch
        can append up to `n_ticks` tokens from `pos` without the host.
        The first token's block is already mapped by `plan()`; the rest
        take FREE blocks only, so a burst never evicts a neighbour.
        Returns the capacity `cap` (pos + 1 <= cap <= pos + n_ticks) the
        dispatch may fill; the engine truncates back to what was emitted
        at harvest."""
        k = min(int(n_ticks) - 1, self.kv.max_slot_tokens - (pos + 1))
        while k > 0 and not self.kv.ensure_capacity(slot, pos + 1 + k):
            fit = (self.kv.slot_num_blocks(slot)
                   + self.kv.allocator.num_free) \
                * self.kv.block_size - (pos + 1)
            k = min(k - 1, fit) if fit > 0 else 0
        return pos + 1 + max(k, 0)

    # ------------------------------------------------------------ plan
    def plan(self) -> Plan:
        """One engine iteration's work. Mutates scheduler/cache state
        (admissions, block allocation, preemptions, expiries)."""
        now = self.clock()
        expired = self._expire(now)
        self._admit()

        decode = []
        protected = set()
        # decodes first, oldest arrival first: block pressure falls on
        # the youngest/longest sequences, never the queue head
        decoders = sorted(
            (r for r in self.slots
             if r is not None and r.state == "decode"),
            key=lambda r: r.arrival)
        for req in decoders:
            if req.slot < 0:    # preempted by an earlier iteration
                continue
            # position of the token being fed = tokens already cached
            pos = int(self.kv.slot_lens[req.slot])
            while not self.kv.ensure_capacity(req.slot, pos + 1):
                if self._preempt_victim(protected | {req}) is None:
                    # nothing left to evict: preempt THIS decode
                    self._preempt_victim(protected)
                    break
            if req.slot < 0:
                continue
            protected.add(req)
            if self.draft_k > 0 and not self.device_draft:
                decode.append((req.slot, self._draft_tokens(req, pos),
                               pos))
            elif self.draft_k > 0:
                decode.append((req.slot, [req.output[-1]], pos))
            else:
                decode.append((req.slot, req.output[-1], pos))

        # with speculation the verify region is reserved up front (see
        # batcher.pack_step): prefill budget never depends on the mix
        reserved = len(decode) if self.draft_k == 0 \
            else self.max_slots * (self.draft_k + 1)
        budget_left = self.token_budget - reserved
        prefills = []
        prefillers = sorted(
            (r for r in self.slots
             if r is not None and r.state == "prefill"),
            key=lambda r: r.arrival)
        for req in prefillers:
            if budget_left <= 0:
                break
            tokens = req.runtime_prompt
            remaining = len(tokens) - req.fed
            chunk = batcher.prefill_chunk(remaining, budget_left)
            # prefill only uses FREE blocks — shrink to what fits
            while chunk > 0 and not self.kv.ensure_capacity(
                    req.slot, req.fed + chunk):
                fit = (self.kv.slot_num_blocks(req.slot)
                       + self.kv.allocator.num_free) \
                    * self.kv.block_size - req.fed
                chunk = min(chunk - 1, fit) if fit > 0 else 0
            if chunk <= 0:
                continue
            arr = np.asarray(tokens[req.fed:req.fed + chunk], np.int32)
            completes = req.fed + chunk == len(tokens)
            prefills.append((req.slot, arr, req.fed, completes))
            req.fed += chunk
            budget_left -= chunk
        return Plan(decode=decode, prefills=prefills, expired=expired)

    # ------------------------------------------------- post-step hooks
    def note_fed(self, plan: Plan):
        """Advance slot lengths for every token the step consumed.

        Speculative decodes are NOT advanced here: how far a verify
        group got is known only once the engine reads the accept length
        back, so `note_accept` owns that bookkeeping."""
        if self.draft_k == 0:
            for slot, _tok, pos in plan.decode:
                self.kv.slot_lens[slot] = pos + 1
        for slot, chunk, start, _completes in plan.prefills:
            self.kv.slot_lens[slot] = start + len(chunk)

    def note_accept(self, slot, new_len):
        """Record a verify group's outcome: `new_len` tokens of the slot
        are cached and valid; blocks allocated for rejected draft tokens
        beyond it are rolled back. Returns the blocks freed."""
        self.kv.slot_lens[slot] = new_len
        return self.kv.truncate_slot(slot, new_len)

    def finish(self, req, now=None):
        req.state = "finished"
        req.finish_time = self.clock() if now is None else now
        self._free_slot(req)

    def cancel(self, req, now=None):
        """Abort a queued or resident request: its blocks are reclaimed
        and it never produces another token. Returns False when the
        request already reached a terminal state."""
        if req.done:
            return False
        if req.state == "queued":
            try:
                self.queue.remove(req)
            except ValueError:
                return False
        elif req.slot >= 0:
            self._free_slot(req)
        req.state = "cancelled"
        req.finish_time = self.clock() if now is None else now
        return True
