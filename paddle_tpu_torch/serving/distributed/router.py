"""Multi-replica router: prefix-affinity dispatch and disaggregated
prefill/decode serving.

Port of `paddle_tpu/serving/distributed/router.py`. `ReplicaRouter`
fronts N `ServingFrontend` replicas (one engine each, in one process,
driven by one asyncio loop) with the `submit()` / `stream()` surface of
a single frontend, and adds:

* **Prefix-affinity dispatch.** A replica's radix prefix cache pays off
  only when same-prefix requests land on it, so the router keeps a
  `ShadowRadixIndex`: a block-aligned token trie per replica of the
  prompts (and finished conversations) dispatched there. A request goes
  to the replica whose trie holds its longest prefix (at least one full
  KV block), ties and misses to the least loaded. The trie is an
  estimate: a stale hit costs a normal prefill, never correctness.
* **Queue-depth load balancing.** A replica's load is its frontend's
  queue, its engine's FIFO and resident slots, and the router's
  dispatches it has not admitted yet.
* **Health and lossless failover.** `ReplicaHealth` probes each
  frontend's step loop; dispatch skips dead replicas, and a stream in
  flight races its tokens against the replica's down event. On a death
  the request is submitted again elsewhere and the tokens the caller
  already has are suppressed: prompts can be prefilled again, and
  greedy tokens come out the same.
* **Disaggregated roles** (`roles=`, one of "mixed", "prefill",
  "decode" a replica). Prompts go to prefill-capable replicas; a
  prefill-role replica's completed KV blocks stream ahead to the decode
  replica chosen at dispatch (`transport`, by default
  `InProcessTransport()`), the request is handed off at its first token
  with a `MigrationTicket` and its stream goes on there. A loaded decode
  replica can shed live requests (`shed`, or automatically with
  `migration=`) to a lighter one; the shadow tries follow the KV.
* **Adapter affinity.** `register_adapter` registers a LoRA adapter on
  every replica; a request under an adapter prefers the replicas that
  hold it resident, and never enters the shadow tries (adapter K/V is
  never in a replica's prefix cache).

The router's counters (`stats()`) are always on. While
`profiler.metrics._enabled` is on it also records the router metrics of
`serving.metrics` (dispatches by replica and outcome, roles, migrations,
failovers, affinity hits, per-replica load, and the handoff latency);
while tracing is on it mints one trace id a request, records each
dispatch and failover on it, and closes it when the caller's stream
ends early (a deadline, a cancellation, an error).
"""
from __future__ import annotations

import asyncio
import heapq
import itertools

from ...profiler import metrics as _pmetrics
from .. import metrics as smetrics
from .. import tracing as _tracing
from ..frontend import (DeadlineExceeded, FrontendClosed, RequestCancelled,
                        RequestMigrated)
from .health import ReplicaHealth
from .transport import InProcessTransport

ROLES = ("mixed", "prefill", "decode")


def _outcome(e):
    """The router_requests outcome label of an attempt that raised `e`."""
    if isinstance(e, DeadlineExceeded):
        return "expired"
    if isinstance(e, RequestCancelled):
        return "cancelled"
    return "error"


def _close_outcome(e):
    """The trace outcome of a stream that ended by raising `e`: a
    caller's cancellation or abandonment (GeneratorExit) closes it
    "cancelled"."""
    if isinstance(e, DeadlineExceeded):
        return "expired"
    if isinstance(e, (RequestCancelled, GeneratorExit,
                      asyncio.CancelledError)):
        return "cancelled"
    return "error"


class NoReplicaAvailable(Exception):
    """Every replica is down (or none was configured)."""


class _ReplicaDied(Exception):
    """Internal: the dispatch replica died mid-stream (its down event)."""


#: exceptions that MAY mean the replica failed rather than the request: a
#: stopped or crashed frontend, or a step-loop error (the loop fails every
#: handle of its replica with it). The router confirms with a probe
#: before failing over: a live replica can raise RuntimeError for one
#: request (the engine-stall path), and treating that as a death would
#: let one oversized request mark every healthy replica down in turn.
_FAILOVER_ERRORS = (FrontendClosed, RuntimeError, _ReplicaDied)


class _ShadowNode:
    __slots__ = ("children", "stamp", "parent", "key")

    def __init__(self, stamp=0, parent=None, key=None):
        self.children = {}          # block token tuple -> _ShadowNode
        self.stamp = stamp
        self.parent = parent        # None once evicted (and for roots)
        self.key = key              # this node's chunk in parent.children


class ShadowRadixIndex:
    """The router's estimate of each replica's radix prefix cache.

    One trie per replica over block-aligned token chunks (the prefix
    cache's granularity: partial tail blocks are never cached, so they
    never count toward affinity either). Past `capacity_blocks` nodes on
    a replica the oldest-stamped leaves are evicted, roughly as the real
    cache's LRU does under pool pressure."""

    def __init__(self, block_size, capacity_blocks=4096):
        self.bs = int(block_size)
        self.cap = int(capacity_blocks)
        self._roots = {}                   # replica -> _ShadowNode
        self._counts = {}                  # replica -> node count
        self._heaps = {}                   # replica -> [(stamp, seq, node)]
        self._tick = itertools.count(1)
        self._seq = itertools.count()      # heap tie-breaker

    def _chunks(self, tokens):
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + self.bs])
                for i in range(0, len(toks) - self.bs + 1, self.bs)]

    def match(self, replica, tokens):
        """The longest cached-prefix estimate, in tokens (a block
        multiple). A match touches the path, keeping hot paths
        resident."""
        node = self._roots.get(replica)
        if node is None:
            return 0
        stamp = next(self._tick)
        n = 0
        for chunk in self._chunks(tokens):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            nxt.stamp = stamp
            n += self.bs
            node = nxt
        if n and not node.children:
            # the touched tail is a leaf: its fresh stamp goes into the
            # eviction heap, so the touch protects it
            self._push(replica, node)
        return n

    def insert(self, replica, tokens):
        root = self._roots.get(replica)
        if root is None:
            root = self._roots[replica] = _ShadowNode()
            self._counts[replica] = 0
            self._heaps[replica] = []
        stamp = next(self._tick)
        node = root
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                child = node.children[chunk] = _ShadowNode(stamp, node,
                                                           chunk)
                self._counts[replica] += 1
            child.stamp = stamp
            node = child
        if node is not root and not node.children:
            self._push(replica, node)
        self._evict(replica)

    def remove(self, replica, tokens):
        """Forget `tokens`' path on `replica`: the deepest matched nodes
        go bottom-up while they have no children, so a prefix that other
        inserted sequences extend survives and only this sequence's own
        suffix goes. Returns the nodes removed."""
        root = self._roots.get(replica)
        if root is None:
            return 0
        node, path = root, []
        for chunk in self._chunks(tokens):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            path.append(nxt)
            node = nxt
        removed = 0
        keep = root
        for node in reversed(path):
            parent = node.parent
            if (node.children or parent is None
                    or parent.children.get(node.key) is not node):
                keep = node
                break
            del parent.children[node.key]
            node.parent = None
            self._counts[replica] -= 1
            removed += 1
        if keep is not root and not keep.children:
            # the surviving tail just became a leaf: give the heap an
            # entry at its stamp
            self._push(replica, keep)
        return removed

    def on_migrate(self, src, dst, tokens):
        """A live request (prompt + generated output = `tokens`) moved
        from `src` to `dst`, blocks and all: its affinity moves with it,
        so later requests of the same head steer at the KV's new home."""
        self.remove(src, tokens)
        self.insert(dst, tokens)

    def drop(self, replica):
        """Forget a replica's whole trie (it died; its cache is gone)."""
        self._roots.pop(replica, None)
        self._counts.pop(replica, None)
        self._heaps.pop(replica, None)

    def size(self, replica):
        return self._counts.get(replica, 0)

    def _push(self, replica, node):
        heapq.heappush(self._heaps[replica],
                       (node.stamp, next(self._seq), node))

    def _evict(self, replica):
        # a lazy-deletion min-heap over leaf stamps: every live leaf's
        # latest stamp has an entry (pushed at creation and each touch),
        # so an eviction costs O(log n) amortized on the dispatch path
        heap = self._heaps.get(replica)
        root = self._roots.get(replica)
        while self._counts.get(replica, 0) > self.cap and heap:
            stamp, _, node = heapq.heappop(heap)
            parent = node.parent
            if (node.stamp != stamp or node.children or parent is None
                    or parent.children.get(node.key) is not node):
                continue                  # stale: touched, or gone
            del parent.children[node.key]
            node.parent = None
            self._counts[replica] -= 1
            if parent is not root and not parent.children:
                self._push(replica, parent)     # a new evictable leaf


class ReplicaRouter:
    """Prefix-affinity dispatch over N serving frontends, with
    disaggregated prefill/decode roles.

    Usage::

        router = ReplicaRouter([fe0, fe1, fe2],
                               roles=["prefill", "decode", "decode"])
        async with router:
            toks = await router.submit(prompt, max_new_tokens=32)
            async for tok in router.stream(prompt2, tenant="b"):
                ...

    `policy` is "affinity" (the shadow trie's longest prefix, then the
    least loaded) or "round_robin". `migration=True` (or a dict over
    `MIGRATION_DEFAULTS`) turns on automatic shedding between decode
    replicas."""

    #: auto-shed defaults (`migration=True`): a decode replica sheds one
    #: live request a tick while its load exceeds the lightest decode
    #: replica's by at least `imbalance`
    MIGRATION_DEFAULTS = {"imbalance": 4, "interval": 0.05,
                          "max_per_tick": 1}

    def __init__(self, frontends, *, policy="affinity",
                 shadow_capacity=4096, probe_interval=0.05,
                 roles=None, transport=None, migration=None):
        if not frontends:
            raise ValueError("ReplicaRouter needs at least one replica")
        if policy not in ("affinity", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        self.frontends = list(frontends)
        self.policy = policy
        self.health = ReplicaHealth(self.frontends)
        bs = {fe.engine.block_size for fe in self.frontends}
        if len(bs) != 1:
            raise ValueError(
                f"replicas disagree on block_size: {sorted(bs)}")
        n = len(self.frontends)
        roles = ["mixed"] * n if roles is None else [str(r) for r in roles]
        if len(roles) != n or any(r not in ROLES for r in roles):
            raise ValueError(f"roles must be one of mixed/prefill/decode "
                             f"per replica, got {roles}")
        for i, r in enumerate(roles):
            er = getattr(self.frontends[i].engine, "role", "mixed")
            if (r == "prefill") != (er == "prefill"):
                raise ValueError(
                    f"replica {i}: router role {r!r} but engine role "
                    f"{er!r}: a prefill replica needs an engine built with "
                    "role='prefill' (and only those hand off)")
        self.roles = roles
        self.disagg = any(r != "mixed" for r in roles)
        self._dispatch_targets = [i for i, r in enumerate(roles)
                                  if r in ("prefill", "mixed")]
        self._decode_targets = [i for i, r in enumerate(roles)
                                if r in ("decode", "mixed")]
        if self.disagg and (not self._dispatch_targets
                            or not self._decode_targets):
            raise ValueError(
                "a disaggregated fleet needs at least one prefill-capable "
                f"AND one decode-capable replica, got {roles}")
        self.transport = transport
        if self.disagg or migration:
            metas = {tuple(sorted(fe.engine.kv.kv_meta().items()))
                     for fe in self.frontends}
            if len(metas) != 1:
                raise ValueError(
                    "migration needs identical KV geometry on every "
                    f"replica, got {sorted(metas)}")
            if transport is None:
                self.transport = InProcessTransport()
        self.migration = None
        if migration:
            if not self.disagg:
                # the monolithic stream path has no RequestMigrated
                # handler: auto-shedding there would end healthy streams
                raise ValueError(
                    "migration= needs a disaggregated fleet (roles with "
                    "decode replicas); a monolithic fleet rebalances by "
                    "dispatch, not by moving live KV")
            self.migration = dict(self.MIGRATION_DEFAULTS)
            if isinstance(migration, dict):
                self.migration.update(migration)
        self.shadow = ShadowRadixIndex(bs.pop(),
                                       capacity_blocks=shadow_capacity)
        self.clock = self.frontends[0].engine.clock
        self.probe_interval = float(probe_interval)
        self._inflight = [0] * n
        # quiesced replicas (a drain): out of NEW dispatch and placement
        # but not marked down, so their in-flight requests finish there
        self._quiesced = set()
        self._rr = itertools.count()
        self._rr_decode = itertools.count()
        self._mseq = itertools.count()
        self._prober = None
        self._balancer = None
        self.dispatches = 0
        self.affinity_hits = 0
        self.adapter_affinity_hits = 0
        self.failovers = 0
        self.migrations = {"handoff": 0, "shed": 0}
        self.role_dispatches = {"mixed": 0, "prefill": 0, "decode": 0}

    # ---------------------------------------------------------- lifecycle
    async def start(self):
        for fe in self.frontends:
            await fe.start()
        loop = asyncio.get_running_loop()
        if self._prober is None:
            self._prober = loop.create_task(
                self.health.run(self.probe_interval))
        if self.migration and self._balancer is None:
            self._balancer = loop.create_task(self._balance_loop())
        return self

    async def stop(self):
        for task in (self._prober, self._balancer):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._prober = self._balancer = None
        for i, fe in enumerate(self.frontends):
            if self.health.probe(i):
                await fe.stop()

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, *exc):
        await self.stop()

    # ----------------------------------------------------------- dispatch
    def queue_depth(self, i):
        """The load the balancer compares: everything queued or resident
        on replica `i`, plus the router's dispatches its frontend has not
        admitted yet."""
        fe = self.frontends[i]
        sch = fe.engine.scheduler
        return (len(fe._fair) + len(sch.queue) + sch.num_active
                + self._inflight[i])

    def _export_depths(self):
        if _pmetrics._enabled:
            for i in range(len(self.frontends)):
                smetrics.ROUTER_REPLICA_QUEUE_DEPTH.labels(str(i)).set(
                    self.queue_depth(i))

    def _live(self, targets, exclude=()):
        return [i for i in targets if i not in exclude
                and i not in self._quiesced and self.health.alive(i)]

    def _shadow_note(self, idx, tokens, adapter_id):
        """Record `tokens` on replica `idx`'s trie unless the request runs
        under an adapter: adapter K/V never enters the replica's prefix
        cache, so the trie must not learn it (it would steer base prompts
        at KV that was never cached)."""
        if adapter_id is None:
            self.shadow.insert(idx, tokens)

    def _shadow_migrate(self, src, dst, tokens, adapter_id):
        if adapter_id is None:
            self.shadow.on_migrate(src, dst, tokens)

    def _adapter_holders(self, live, adapter_id):
        """The replicas of `live` whose adapter cache holds `adapter_id`
        resident now (an estimate, as the trie is: a stale pick costs one
        adapter load)."""
        out = []
        for i in live:
            cache = getattr(self.frontends[i].engine, "adapters", None)
            if cache is not None and cache.resident(adapter_id):
                out.append(i)
        return out

    def _least_loaded(self, cands):
        return min(cands, key=lambda i: (self.queue_depth(i), i))

    def _pick(self, prompt, adapter_id=None):
        """(replica index, affinity hit) for one prompt dispatch, among
        the prefill-capable replicas. Adapter affinity filters first (the
        replicas holding the adapter keep their warm slot); otherwise the
        trie's longest prefix, then the least loaded. Raises
        NoReplicaAvailable when every candidate is down."""
        live = self._live(self._dispatch_targets)
        if not live:
            raise NoReplicaAvailable(
                f"all {len(self._dispatch_targets)} prompt-dispatch "
                "replicas are down or quiesced")
        self.dispatches += 1
        if self.policy == "round_robin":
            idx = live[next(self._rr) % len(live)]
            self._shadow_note(idx, prompt, adapter_id)
            self._export_depths()
            return idx, False
        if adapter_id is not None:
            # adapter requests bypass the prefix cache, so the trie
            # neither matches nor learns them: residency and load decide
            holders = self._adapter_holders(live, adapter_id)
            if holders:
                live = holders
                self.adapter_affinity_hits += 1
                if _pmetrics._enabled:
                    smetrics.ROUTER_ADAPTER_AFFINITY_HITS.inc()
            idx = self._least_loaded(live)
            self._export_depths()
            return idx, bool(holders)
        hits = {i: self.shadow.match(i, prompt) for i in live}
        best = max(hits.values())
        affinity = best >= self.shadow.bs        # at least one full block
        idx = self._least_loaded(
            [i for i in live if hits[i] == best] if affinity else live)
        if affinity:
            self.affinity_hits += 1
            if _pmetrics._enabled:
                smetrics.ROUTER_AFFINITY_HITS.inc()
        # recorded at dispatch, not completion: concurrent requests of one
        # head converge on one replica before the first finishes prefill
        self.shadow.insert(idx, prompt)
        self._export_depths()
        return idx, affinity

    def _pick_decode(self, tokens, exclude=()):
        """The destination decode replica of a handoff or a shed: where
        the trie says the request's history already lives, else the
        least loaded. Raises NoReplicaAvailable when no decode-capable
        replica outside `exclude` is up."""
        live = self._live(self._decode_targets, exclude)
        if not live:
            raise NoReplicaAvailable(
                "no decode-capable replica available "
                f"(roles={self.roles}, excluded={sorted(exclude)})")
        if self.policy == "round_robin":
            return live[next(self._rr_decode) % len(live)]
        hits = {i: self.shadow.match(i, tokens) for i in live}
        best = max(hits.values())
        return self._least_loaded(
            [i for i in live if hits[i] == best] if best >= self.shadow.bs
            else live)

    # ---------------------------------------------------- load shedding
    def shed(self, idx, n=1):
        """Ask replica `idx` to shed up to `n` live decodes; their streams
        move on through `RequestMigrated`. Returns how many were
        flagged."""
        return self.frontends[idx].shed(n)

    def rebalance(self):
        """One auto-shed decision (the `migration=` policy, which the
        balance loop also runs): when the most loaded decode replica
        exceeds the least loaded by at least `imbalance`, it sheds
        `max_per_tick` requests. Returns the requests flagged."""
        if not self.migration:
            return 0
        live = self._live(self._decode_targets)
        if len(live) < 2:
            return 0
        depths = {i: self.queue_depth(i) for i in live}
        hi = max(live, key=lambda i: (depths[i], -i))
        lo = min(live, key=lambda i: (depths[i], i))
        if depths[hi] - depths[lo] < self.migration["imbalance"]:
            return 0
        return self.frontends[hi].shed(self.migration["max_per_tick"])

    # ----------------------------------------------------- fleet lifecycle
    def quiesce(self, idx):
        """Take replica `idx` out of NEW dispatch and placement while its
        in-flight requests finish (the graceful half of a drain; health
        stays up)."""
        self._quiesced.add(idx)

    def unquiesce(self, idx):
        self._quiesced.discard(idx)

    def is_drained(self, idx):
        """True when a replica holds no work anywhere on its path."""
        fe = self.frontends[idx]
        return (self._inflight[idx] == 0 and len(fe._fair) == 0
                and not fe._live and not fe.engine.scheduler.has_work)

    async def add_replica(self, frontend, role="mixed"):
        """Append one replica to the running fleet, with the checks of
        construction (block size, role, KV geometry of a migrating
        fleet); its frontend starts when the router runs. Indices are
        append-only. Returns the new index."""
        if role not in ROLES:
            raise ValueError(f"unknown replica role {role!r}")
        if frontend.engine.block_size != \
                self.frontends[0].engine.block_size:
            raise ValueError(
                f"replica block_size {frontend.engine.block_size} != "
                f"fleet's {self.frontends[0].engine.block_size}")
        er = getattr(frontend.engine, "role", "mixed")
        if (role == "prefill") != (er == "prefill"):
            raise ValueError(
                f"router role {role!r} but engine role {er!r}")
        if (self.disagg or self.migration) and \
                frontend.engine.kv.kv_meta() != \
                self.frontends[0].engine.kv.kv_meta():
            raise ValueError(
                "migration needs identical KV geometry on every replica: "
                "the new replica's kv_meta differs")
        idx = len(self.frontends)
        self.frontends.append(frontend)
        self.roles.append(str(role))
        self._inflight.append(0)
        if role in ("prefill", "mixed"):
            self._dispatch_targets.append(idx)
        if role in ("decode", "mixed"):
            self._decode_targets.append(idx)
        self.health.add(frontend)
        if self._prober is not None:
            await frontend.start()
        return idx

    async def _balance_loop(self):
        while True:
            await asyncio.sleep(self.migration["interval"])
            self.rebalance()

    # ---------------------------------------------------------- helpers
    def _count_role(self, role):
        self.role_dispatches[role] += 1
        if _pmetrics._enabled:
            smetrics.ROUTER_DISPATCH_ROLE.labels(role).inc()

    def _note_migration(self, reason):
        self.migrations[reason] += 1
        if _pmetrics._enabled:
            smetrics.ROUTER_MIGRATIONS.labels(reason).inc()

    def _fail_over(self, idx):
        """The bookkeeping of a replica's death on a failover path."""
        self.health.mark_down(idx)
        self.shadow.drop(idx)
        self.failovers += 1
        self._count(idx, "failover")
        if _pmetrics._enabled:
            smetrics.ROUTER_FAILOVERS.inc()

    def _version(self, idx):
        """Replica `idx`'s checkpoint version label (its engine's
        `weights_version`, "v0" until a swap)."""
        return getattr(self.frontends[idx].engine, "weights_version", "v0")

    def _count(self, idx, outcome):
        if _pmetrics._enabled:
            smetrics.ROUTER_REQUESTS.labels(
                str(idx), outcome, self._version(idx)).inc()

    def _rname(self, idx):
        """Replica `idx`'s name on trace events: its engine's."""
        return getattr(self.frontends[idx].engine, "name",
                       f"replica{idx}")

    def _tevent(self, trace_id, name, idx, **attrs):
        if _tracing._enabled:
            _tracing.TRACER.event(trace_id, name, replica=self._rname(idx),
                                  **attrs)

    def _tclose(self, trace_id, outcome):
        """Close a trace from the router's side of the stream (the caller
        abandoned it, a deadline, an error). The first terminal wins, so
        a finish or cancel the scheduler recorded stands."""
        if trace_id is not None and _tracing._enabled:
            _tracing.TRACER.finish(trace_id, outcome, replica="router")

    def _is_replica_death(self, idx, e):
        """True when replica `idx` is gone (fail over); False when it is
        still serving and this was one request's failure (the engine-stall
        RuntimeError), which is raised to the caller: sending the same
        request to identical replicas would stall them one by one."""
        return isinstance(e, _ReplicaDied) or not self.health.probe(idx)

    def _hold(self, idx):
        """Count a dispatch in replica `idx`'s load until its frontend
        admits it into the fair queue (from then on `queue_depth` sees it
        there). Returns the release, which the frontend calls at
        admission and the dispatch again when it ends; only the first
        call counts."""
        self._inflight[idx] += 1
        pending = [True]

        def release():
            if pending[0]:
                pending[0] = False
                self._inflight[idx] -= 1

        return release

    def _remaining(self, idx, deadline):
        """Seconds left before `deadline` (None: no deadline); raises
        DeadlineExceeded (counted on replica `idx`) when already past."""
        if deadline is None:
            return None
        remaining = deadline - self.clock()
        if remaining <= 0:
            self._count(idx, "expired")
            raise DeadlineExceeded()
        return remaining

    # ------------------------------------------------------------ serving
    def register_adapter(self, adapter_id, weights):
        """Register a LoRA adapter on EVERY replica: a migrating fleet
        needs it wherever a request can land (a failover prefills again
        under it, a ticket re-pins it at the destination)."""
        for fe in self.frontends:
            fe.engine.register_adapter(adapter_id, weights)
        return adapter_id

    async def submit(self, prompt, max_new_tokens=32, *,
                     tenant="default", timeout=None, adapter_id=None):
        """Run one request to completion (with failover); returns its
        generated token ids."""
        out = []
        async for tok in self.stream(prompt, max_new_tokens,
                                     tenant=tenant, timeout=timeout,
                                     adapter_id=adapter_id):
            out.append(tok)
        return out

    async def stream(self, prompt, max_new_tokens=32, *,
                     tenant="default", timeout=None, adapter_id=None):
        """Async generator of generated tokens. On a replica's death the
        request is submitted again to a live replica and the tokens the
        caller already has are suppressed. In a disaggregated fleet the
        stream spans the prefill replica, the handoff and the decode
        replica (and any shed hops): see `_stream_disagg`."""
        if self.disagg:
            async for tok in self._stream_disagg(
                    prompt, max_new_tokens, tenant, timeout, adapter_id):
                yield tok
            return
        deadline = (self.clock() + float(timeout)
                    if timeout is not None else None)
        delivered = 0
        # one trace id a request, minted before the dispatch loop: a
        # failover's re-dispatch records onto the same trace (its
        # "dispatched" event reopens a trace the dying replica's cancel
        # closed)
        trace_id = (_tracing.TRACER.mint(tenant=str(tenant))
                    if _tracing._enabled else None)
        try:
            while True:
                idx, _ = self._pick(prompt, adapter_id=adapter_id)
                self._count_role("mixed")
                self._tevent(trace_id, "dispatched", idx, role="mixed",
                             tenant=tenant, version=self._version(idx))
                remaining = self._remaining(idx, deadline)
                release = self._hold(idx)
                attempt_out = []
                try:
                    agen = self.frontends[idx].stream(
                        prompt, max_new_tokens, tenant=tenant,
                        timeout=remaining, on_admitted=release,
                        adapter_id=adapter_id, trace_id=trace_id)
                    async for tok in self._attempt(idx, agen,
                                                   attempt_out):
                        if len(attempt_out) > delivered:
                            delivered += 1
                            yield tok
                    # the replica finished it: publish the conversation to
                    # its trie (as the engine's finish published the
                    # blocks)
                    self._shadow_note(idx, list(prompt) + attempt_out,
                                      adapter_id)
                    self._count(idx, "finished")
                    return
                except _FAILOVER_ERRORS as e:
                    if not self._is_replica_death(idx, e):
                        self._count(idx, "error")
                        raise
                    self._fail_over(idx)
                    self._tevent(trace_id, "failover", idx,
                                 delivered=delivered)
                except Exception as e:
                    self._count(idx, _outcome(e))
                    raise
                finally:
                    release()
        except BaseException as e:
            self._tclose(trace_id, _close_outcome(e))
            raise

    async def _stream_disagg(self, prompt, max_new_tokens, tenant,
                             timeout, adapter_id=None):
        """The disaggregated pipeline as one token stream:

        1. **Prefill dispatch** over the prefill-capable replicas; for a
           prefill-role replica the handoff's destination is chosen up
           front, so completed KV blocks stream ahead over the transport
           while the prefill still runs.
        2. **Handoff** — the prefill frontend ends the attempt with
           `RequestMigrated(ticket)` after the first token; the ticket
           (host state and the tail blocks) ships to the destination,
           which imports the blocks and goes on with the stream.
        3. **Shed hops** — a loaded decode replica may end the attempt
           with another `RequestMigrated`; the request moves to a lighter
           decode replica (its trie entries with it).
        4. **Failover** — a replica's death restarts the pipeline from
           prefill (the KV died with the replica), the delivered tokens
           suppressed."""
        deadline = (self.clock() + float(timeout)
                    if timeout is not None else None)
        prompt = list(prompt)
        delivered = 0
        transport = self.transport
        inbox = [None, None]                # (dst, key) awaiting collect
        # one trace id for the whole pipeline: the prefill dispatch, the
        # stream-ahead, the ticket's transport, the decode admission,
        # shed hops and failover restarts (the ticket carries it)
        trace_id = (_tracing.TRACER.mint(tenant=str(tenant))
                    if _tracing._enabled else None)

        def _drop_inbox():
            if inbox[0] is not None:
                transport.drop(inbox[0], inbox[1])
                inbox[0] = inbox[1] = None

        def _route(didx):
            inbox[0], inbox[1] = didx, f"req{next(self._mseq)}"
            return inbox[1]

        try:
            while True:                     # the failover restart loop
                pidx, _ = self._pick(prompt, adapter_id=adapter_id)
                self._count_role("prefill")
                self._tevent(trace_id, "dispatched", pidx,
                             role=self.roles[pidx], tenant=tenant,
                             version=self._version(pidx))
                on_blocks = None
                didx = key = None
                if self.roles[pidx] == "prefill":
                    # the handoff is certain: choose its destination now,
                    # so completed blocks stream ahead of the ticket (a
                    # mixed replica decodes locally; streaming its KV
                    # would pay for a handoff that never comes)
                    didx = self._pick_decode(prompt)
                    key = _route(didx)
                    meta = self.frontends[pidx].engine.kv.kv_meta()

                    def on_blocks(chunk, p=pidx, d=didx, k=key, m=meta):
                        transport.send_chunk(p, d, k, m, chunk)
                remaining = self._remaining(pidx, deadline)
                release = self._hold(pidx)
                attempt_out = []
                try:
                    agen = self.frontends[pidx].stream(
                        prompt, max_new_tokens, tenant=tenant,
                        timeout=remaining, on_admitted=release,
                        on_blocks=on_blocks, adapter_id=adapter_id,
                        trace_id=trace_id)
                    async for tok in self._attempt(pidx, agen,
                                                   attempt_out):
                        if len(attempt_out) > delivered:
                            delivered += 1
                            yield tok
                    # finished on the dispatch replica (a mixed replica
                    # end to end, or EOS / the horizon at the first token)
                    _drop_inbox()
                    self._shadow_note(pidx, prompt + attempt_out,
                                      adapter_id)
                    self._count(pidx, "finished")
                    return
                except RequestMigrated as e:
                    ticket = e.ticket
                except _FAILOVER_ERRORS as e:
                    _drop_inbox()
                    if not self._is_replica_death(pidx, e):
                        self._count(pidx, "error")
                        raise
                    self._fail_over(pidx)
                    self._tevent(trace_id, "failover", pidx,
                                 delivered=delivered)
                    continue
                except Exception as e:
                    self._count(pidx, _outcome(e))
                    raise
                finally:
                    release()

                # migration out of the dispatch replica: a prefill handoff
                # (the destination already has the stream-ahead), or a
                # mixed replica shedding its live decode (destination
                # chosen now; every block rides the ticket)
                if didx is None:
                    path = list(ticket.prompt) + list(ticket.output)
                    didx = self._pick_decode(path, exclude=(pidx,))
                    key = _route(didx)
                    self._shadow_migrate(pidx, didx, path, adapter_id)
                    self._note_migration("shed")
                else:
                    self._note_migration("handoff")
                self._count(pidx, "migrated")
                hand_t0 = self.clock()
                transport.send_ticket(pidx, didx, key, ticket)
                restart = False
                while True:                 # the decode phase + shed hops
                    assembled = transport.collect(didx, key)
                    inbox[0] = inbox[1] = None
                    self._count_role("decode")
                    self._tevent(trace_id, "dispatched", didx,
                                 role="decode", tenant=tenant,
                                 version=self._version(didx))
                    history = (list(assembled.prompt)
                               + list(assembled.output))
                    self._shadow_note(didx, history, adapter_id)
                    self._remaining(didx, deadline)
                    release = self._hold(didx)
                    attempt_out = []
                    base = len(assembled.output)
                    gap_open = True
                    try:
                        agen = self.frontends[didx].stream_ticket(
                            assembled, on_admitted=release)
                        async for tok in self._attempt(didx, agen,
                                                       attempt_out):
                            if gap_open:
                                # the stream's gap the migration cost:
                                # the ticket's send to the destination's
                                # first token
                                gap_open = False
                                if _pmetrics._enabled:
                                    smetrics.SERVING_HANDOFF_LATENCY \
                                        .observe(self.clock() - hand_t0)
                            if base + len(attempt_out) > delivered:
                                delivered += 1
                                yield tok
                        self._shadow_note(didx, history + attempt_out,
                                          adapter_id)
                        self._count(didx, "finished")
                        return
                    except RequestMigrated as e:
                        # a shed: move to a lighter decode replica, the
                        # trie entries with the KV
                        t2, old = e.ticket, didx
                        path = list(t2.prompt) + list(t2.output)
                        didx = self._pick_decode(path, exclude=(old,))
                        self._shadow_migrate(old, didx, path, adapter_id)
                        self._note_migration("shed")
                        self._count(old, "migrated")
                        key = _route(didx)
                        hand_t0 = self.clock()
                        transport.send_ticket(old, didx, key, t2)
                        continue
                    except _FAILOVER_ERRORS as e:
                        if not self._is_replica_death(didx, e):
                            self._count(didx, "error")
                            raise
                        # the KV died with the replica: restart from
                        # prefill, the delivered tokens suppressed
                        self._fail_over(didx)
                        self._tevent(trace_id, "failover", didx,
                                     delivered=delivered)
                        restart = True
                        break
                    except Exception as e:
                        self._count(didx, _outcome(e))
                        raise
                    finally:
                        release()
                if not restart:
                    return
        except BaseException as e:
            # the caller abandoned the stream (possibly mid-handoff, the
            # ticket still in the inbox, which the finally drops), a
            # deadline, or an error: close the trace
            self._tclose(trace_id, _close_outcome(e))
            raise
        finally:
            _drop_inbox()

    async def _attempt(self, idx, agen, attempt_out):
        """One dispatch attempt on replica `idx`: forward the frontend's
        stream, racing the replica's down event (the rescue of requests
        stranded on a step loop that died without failing its
        handles)."""
        q = asyncio.Queue()

        async def pump():
            try:
                async for tok in agen:
                    q.put_nowait(("tok", tok))
                q.put_nowait(("done", None))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                q.put_nowait(("err", e))

        async def watch():
            await self.health.down_event(idx).wait()
            q.put_nowait(("down", None))

        loop = asyncio.get_running_loop()
        tasks = (loop.create_task(pump()), loop.create_task(watch()))
        try:
            while True:
                kind, val = await q.get()
                if kind == "tok":
                    attempt_out.append(val)
                    yield val
                elif kind == "done":
                    return
                elif kind == "err":
                    raise val
                else:                          # the down event fired
                    raise _ReplicaDied(f"replica {idx} died mid-stream")
        finally:
            # no awaits here: this also runs under GeneratorExit when the
            # caller abandons the stream. Cancelling the pump closes the
            # frontend's stream, whose own finally cancels the request.
            for t in tasks:
                t.cancel()

    def stats(self):
        """The router's counters (always on)."""
        out = {"dispatches": self.dispatches,
               "affinity_hits": self.affinity_hits,
               "adapter_affinity_hits": self.adapter_affinity_hits,
               "failovers": self.failovers,
               "roles": list(self.roles),
               "quiesced": sorted(self._quiesced),
               "versions": [self._version(i)
                            for i in range(len(self.frontends))],
               "migrations": dict(self.migrations),
               "role_dispatches": dict(self.role_dispatches),
               "health": self.health.snapshot(),
               "queue_depths": [self.queue_depth(i) for i in
                                range(len(self.frontends))]}
        if self.transport is not None:
            out["transport"] = {
                "bytes_sent": self.transport.bytes_sent,
                "bytes_received": self.transport.bytes_received,
                "blocks_sent": self.transport.blocks_sent,
                "tickets_sent": self.transport.tickets_sent}
        return out
