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
* **Prefix cache** — with a `prefix_cache` (`prefix_cache.py`),
  admission adopts the cached blocks of the runtime prompt's head and
  prefill starts at the first uncached token (`Request.cache_hit_tokens`
  counts them); a completed prefill publishes the prompt's full blocks,
  a finish publishes prompt + output, and freeing a slot drops its
  locks on the tree.
* **Reserved decode region** — `reserve_region` (block-sparse decode)
  keeps the per-slot decode region's tokens out of the prefill budget
  at `draft_k == 0` too, as speculation does.
* **Adapters** — with an `adapter_cache` (`adapters.py`), admission pins
  the queue head's adapter into a device slot (`Request.adapter_slot`)
  and blocks at the head while every slot is pinned; `_free_slot` drops
  the pin on every path (finish, preempt, expire, cancel). Requests
  under a non-null adapter bypass the prefix cache: their K/V depends
  on the adapter, and the radix tree keys by token ids alone.
* **Migration** (disaggregated serving) — a request arriving from
  another replica (`submit_migrated`) joins the FRONT of the queue with
  its KV payload; admission imports the blocks into a slot
  (`kv.import_into_slot`) instead of prefilling, and waits at the head
  while the pool cannot cover them. `extract` releases a resident
  request that migrates away (the engine exported its blocks first).
  A prefill-role engine parks a request whose prompt is done in the
  `"handoff"` state, which plans neither prefill nor decode.

* **Tracing** — while `tracing._enabled`, intake, admission (a fresh
  prefill, a re-prefill after a preemption, or an import), preemption
  and every terminal state record a span event on the request's trace
  (`tracing.on_*`), stamped with `replica` (the owning engine's name).

Pure host-side bookkeeping.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Optional

import numpy as np

from . import batcher
from . import tracing as _tracing


@dataclasses.dataclass(eq=False)   # identity semantics: requests live
class Request:                     # in sets/queues across state moves
    req_id: int
    prompt: list                      # original prompt token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    deadline: Optional[float] = None  # absolute clock() time
    arrival: float = 0.0
    state: str = "queued"
    # queued|prefill|handoff|decode|finished|expired|cancelled|migrated
    slot: int = -1
    output: list = dataclasses.field(default_factory=list)
    fed: int = 0                      # runtime-prompt tokens fed so far
    preemptions: int = 0
    cache_hit_tokens: int = 0         # prefix-cache tokens skipped
    tenant: str = "default"           # the frontend's fairness lane
    adapter_id: object = None         # a registered LoRA adapter, or None
    adapter_slot: int = 0             # its pinned device slot (0 = null)
    # disaggregated serving: an inbound migration carries its KV payload
    # until admission imports it; a prefill-role engine counts the full
    # blocks already streamed ahead, so extraction ships only the tail
    ticket: Optional[object] = None
    shipped_blocks: int = 0
    trace_id: Optional[str] = None    # the request's fleet-wide trace
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    _last_token_time: Optional[float] = None   # the inter-token gap's base

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
                 device_draft=False, prefix_cache=None,
                 adapter_cache=None, reserve_region=False):
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
        # the radix prefix cache: admission skips cached prompt heads,
        # prefill completion and finish publish the written blocks
        self.prefix_cache = prefix_cache
        # the LoRA adapter cache: admission pins a request's adapter
        # into a device slot, `_free_slot` releases the pin
        self.adapters = adapter_cache
        # block-sparse decode reserves the per-slot decode region even
        # at draft_k == 0: prefill budgets treat it as spoken for
        self.reserve_region = bool(reserve_region)
        self.queue = collections.deque()
        self.slots = [None] * max_slots
        self._ids = itertools.count()
        self.preemption_count = 0
        # the replica label the tracing hooks stamp on span events; the
        # owning engine sets its name
        self.replica = None

    # ---------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens, eos_token_id=None,
               deadline=None, tenant="default", adapter_id=None,
               trace_id=None):
        total = len(prompt) + max_new_tokens - 1  # last token never fed
        if total > self.kv.max_slot_tokens:
            raise ValueError(
                f"request needs {total} cached tokens; a slot holds at "
                f"most {self.kv.max_slot_tokens}")
        if adapter_id is not None and self.adapters is None:
            raise ValueError("request names an adapter but the "
                             "scheduler has no adapter cache")
        now = self.clock()
        req = Request(req_id=next(self._ids), prompt=list(prompt),
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id, deadline=deadline,
                      arrival=now, submit_time=now, tenant=str(tenant),
                      adapter_id=adapter_id, trace_id=trace_id)
        self.queue.append(req)
        if _tracing._enabled:
            _tracing.on_submit(req, self.replica)
        return req

    def submit_migrated(self, ticket):
        """Queue a request migrated in from another replica: its KV
        payload rides `req.ticket` until a slot frees and the blocks fit,
        then admission imports the blocks instead of prefilling. Joins
        the FRONT of the queue — like a preemption victim, the request
        is mid-stream and its caller is waiting on the next token. The
        timing fields carry over."""
        total = len(ticket.prompt) + int(ticket.max_new_tokens) - 1
        if total > self.kv.max_slot_tokens:
            raise ValueError(
                f"migrated request needs {total} cached tokens; a slot "
                f"holds at most {self.kv.max_slot_tokens}")
        now = self.clock()
        req = Request(req_id=next(self._ids), prompt=list(ticket.prompt),
                      max_new_tokens=int(ticket.max_new_tokens),
                      eos_token_id=ticket.eos_token_id,
                      deadline=ticket.deadline, arrival=now,
                      submit_time=ticket.submit_time,
                      tenant=str(ticket.tenant), output=list(ticket.output),
                      cache_hit_tokens=int(ticket.cache_hit_tokens),
                      preemptions=int(ticket.preemptions), ticket=ticket,
                      adapter_id=ticket.adapter_id,
                      trace_id=ticket.trace_id)
        req.first_token_time = ticket.first_token_time
        self.queue.appendleft(req)
        if _tracing._enabled:
            _tracing.on_submit_migrated(req, self.replica, ts=now)
        return req

    @property
    def num_active(self):
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self):
        return bool(self.queue) or self.num_active > 0

    # ------------------------------------------------------- internals
    def _free_slot(self, req):
        if self.prefix_cache is not None:
            self.prefix_cache.unlock_slot(req.slot)
        if self.adapters is not None and req.adapter_id is not None:
            # every release path comes through here, so each admission's
            # pin is dropped exactly once; the adapter stays resident
            # until LRU eviction needs its slot
            self.adapters.release(req.adapter_id)
            req.adapter_slot = 0
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
        if _tracing._enabled:
            for req in expired:
                _tracing.on_terminal(req, "expired", self.replica, ts=now)
        return expired

    def _acquire_adapter(self, req):
        """Pin the queue head's adapter into a device slot. True on
        success (or no adapter); False when every slot is pinned by
        in-flight requests: admission then blocks at the head until one
        finishes."""
        if self.adapters is None or req.adapter_id is None:
            req.adapter_slot = 0
            return True
        slot_a = self.adapters.acquire(req.adapter_id)
        if slot_a is None:
            return False
        req.adapter_slot = int(slot_a)
        return True

    def _admit_migrated(self, slot):
        """Admit the migrated request at the queue head into `slot` by
        importing its transported blocks. False when it must wait: every
        adapter slot is pinned, or the free list (after prefix-cache
        eviction) cannot cover the blocks yet. It waits at the head on
        purpose: it is mid-stream, and resuming it beats admitting fresh
        prompts behind it."""
        req = self.queue[0]
        if not self._acquire_adapter(req):
            return False
        if not self.kv.import_into_slot(slot, req.ticket.slot_len,
                                        req.ticket.chunks):
            # release the fresh pin, so the retry cannot stack a second
            if self.adapters is not None and req.adapter_id is not None:
                self.adapters.release(req.adapter_id)
                req.adapter_slot = 0
            return False
        self.queue.popleft()
        req.slot = slot
        req.state = "decode"
        # the whole runtime prompt's K/V is resident: the next step feeds
        # output[-1] at position slot_len, as after a prefill
        req.fed = len(req.runtime_prompt)
        req.ticket = None
        self.slots[slot] = req
        if _tracing._enabled:
            _tracing.on_admitted(req, self.replica, kind="import",
                                 ts=self.clock())
        return True

    def _admit(self):
        for slot in range(self.max_slots):
            if not self.queue:
                break
            if self.slots[slot] is None:
                if self.queue[0].ticket is not None:
                    if not self._admit_migrated(slot):
                        break
                    continue
                if not self._acquire_adapter(self.queue[0]):
                    break
                req = self.queue.popleft()
                req.slot = slot
                req.state = "prefill"
                req.fed = 0
                self.slots[slot] = req
                if _tracing._enabled:
                    # a re-prefill resumes a preempted sequence (or a
                    # migrant that lost its blocks): its own kind, so
                    # the queue wait is observed on the first admission
                    # only
                    kind = ("re_prefill" if (req.output or req.preemptions)
                            else "prefill")
                    _tracing.on_admitted(req, self.replica, kind=kind,
                                         ts=self.clock())
                if self.prefix_cache is not None \
                        and req.adapter_id is None:
                    # a cached prompt head: adopt its blocks, count their
                    # K/V as resident, and prefill from the first
                    # uncached token (a preempted request's re-admission
                    # usually hits its own published blocks); adapter
                    # requests bypass the tree
                    hit = self.prefix_cache.lookup_and_adopt(
                        slot, req.runtime_prompt)
                    req.fed = hit
                    req.cache_hit_tokens += hit
                    self.kv.slot_lens[slot] = hit

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
        if _tracing._enabled:
            _tracing.on_preempted(victim, self.replica, ts=self.clock())
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
        take FREE blocks only (after evicting idle cached prefix blocks,
        as every allocation does), so a burst never preempts a
        neighbour.
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

        # with speculation (or the sparse decode region) the region is
        # reserved up front (see batcher.pack_step): prefill budget never
        # depends on the mix
        reserved = len(decode) \
            if self.draft_k == 0 and not self.reserve_region \
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
        for slot, chunk, start, completes in plan.prefills:
            self.kv.slot_lens[slot] = start + len(chunk)
            if completes and self.prefix_cache is not None:
                # the whole prompt's K/V is resident: publish its full
                # blocks, so that same-head requests admitted later hit
                # (base-model requests only: adapter K/V never enters
                # the token-keyed tree)
                req = self.slots[slot]
                if req is not None and req.adapter_id is None:
                    self.prefix_cache.insert(slot, req.runtime_prompt)

    def note_accept(self, slot, new_len):
        """Record a verify group's outcome: `new_len` tokens of the slot
        are cached and valid; blocks allocated for rejected draft tokens
        beyond it are rolled back. Returns the blocks freed."""
        self.kv.slot_lens[slot] = new_len
        return self.kv.truncate_slot(slot, new_len)

    def finish(self, req, now=None):
        req.state = "finished"
        req.finish_time = self.clock() if now is None else now
        if self.prefix_cache is not None and req.slot >= 0 \
                and req.adapter_id is None:
            # publish prompt + output (a conversation's next turn
            # replays it); only tokens whose K/V was written count — the
            # last emitted token was never fed
            n = int(self.kv.slot_lens[req.slot])
            self.prefix_cache.insert(req.slot,
                                     (req.prompt + req.output)[:n])
        self._free_slot(req)
        if _tracing._enabled:
            _tracing.on_terminal(req, "finished", self.replica,
                                 ts=req.finish_time)

    def extract(self, req, now=None):
        """Release a resident request that migrates away: its slot,
        blocks and prefix locks are reclaimed (the engine exported the
        payload first), and it reaches "migrated", terminal on this
        replica. Shared prefix blocks it had adopted stay cached."""
        if req.slot < 0:
            raise ValueError(f"request {req.req_id} is not resident")
        self._free_slot(req)
        req.state = "migrated"
        req.finish_time = self.clock() if now is None else now

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
        if _tracing._enabled:
            _tracing.on_terminal(req, "cancelled", self.replica,
                                 ts=req.finish_time)
        return True
