"""Async multi-tenant serving frontend over the continuous-batching engine.

Port of `paddle_tpu/serving/frontend.py`. `ServingFrontend` turns one
`ServingEngine` into a service: an asyncio API (`submit()` awaits the
whole completion, `stream()` yields each token) over one background
step-loop task that drives the engine, with

* **admission and backpressure** — a bounded `batcher.FairQueue`:
  `submit` / `stream` wait for space when the frontend is full, and the
  tenants' lanes are served round-robin, so one chatty tenant cannot
  starve the rest;
* **cancellation** — cancelling the consumer (or `handle.cancel()`)
  reclaims the request's slot, KV blocks and prefix-cache locks at the
  next step boundary;
* **deadlines** — `timeout=` becomes the scheduler's absolute deadline;
  expiry surfaces as `DeadlineExceeded` on the caller;
* **migration** (disaggregated serving) — `stream(on_blocks=)` hands a
  prefill's completed blocks out after each step, a prefill-role engine's
  stream ends with `RequestMigrated(ticket)` after the first token,
  `stream_ticket` admits a migrated-in request, and `shed()` flags live
  decodes for extraction toward a lighter replica.

Threading: all frontend and engine state is changed on the event loop's
thread, except `engine.step()`, which runs in the loop's default
executor so the loop stays responsive while the card works. While a
step is in flight the loop only flags intent (submissions land in the
fair queue, cancellations and sheds set a flag); the step loop applies
the flags between steps, so each engine is used by one thread at a
time. Several frontends in one loop step their engines from several
executor threads at once: their launches share the card, and the
kernels' builds and launch counters are thread-safe (`ops._build`,
`ops.paged_attention.count`). No CUDA call depends on a thread's current
device: every tensor and launch takes the engine's device.

The frontend adds scheduling, never arithmetic: its tokens are the
engine's `generate_batch` tokens.
"""
from __future__ import annotations

import asyncio

from .batcher import FairQueue

_DONE = object()


class DeadlineExceeded(Exception):
    """The request's deadline passed before it finished."""


class RequestCancelled(Exception):
    """The request was cancelled before it finished."""


class FrontendClosed(Exception):
    """The frontend was stopped while the request was in flight."""


class RequestMigrated(Exception):
    """The request left this replica mid-stream (a prefill handoff or a
    shed). Carries the `MigrationTicket` (KV blocks and host state) the
    router submits elsewhere; the tokens already streamed stay delivered
    (the ticket's `output` holds them, so the destination publishes only
    what comes after)."""

    def __init__(self, ticket):
        super().__init__("request migrated away")
        self.ticket = ticket


class FrontendHandle:
    """One in-flight request as a caller sees it."""

    def __init__(self, prompt, max_new_tokens, tenant, deadline,
                 adapter_id=None, trace_id=None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant
        self.deadline = deadline
        self.adapter_id = adapter_id      # LoRA adapter (None = base)
        self.trace_id = trace_id
        self.req = None               # the scheduler's Request once admitted
        self.queue = asyncio.Queue()  # tokens, then _DONE or an exception
        self.published = 0
        self.cancel_requested = False
        self.terminal = False
        # migration: an inbound request carries its ticket until engine
        # admission; a handoff-bound prefill streams its completed blocks
        # through `on_blocks`; `shed()` flags a live decode for
        # extraction at the next step boundary
        self.ticket = None
        self.on_blocks = None
        self.extract_requested = False

    @property
    def tokens(self):
        """Tokens generated so far (a live view once admitted)."""
        return list(self.req.output) if self.req is not None else []

    def cancel(self):
        """Ask for cancellation; applied at the next step boundary."""
        self.cancel_requested = True


class ServingFrontend:
    """Bounded async ingress over one `ServingEngine`.

    Usage::

        frontend = ServingFrontend(engine, max_pending=64)
        async with frontend:
            toks = await frontend.submit(prompt, max_new_tokens=64)
            async for tok in frontend.stream(prompt2, tenant="b"):
                ...
    """

    #: backoff for rounds in which the engine did no work while work
    #: remained: the loop sleeps IDLE_BACKOFF_S, doubling up to
    #: IDLE_BACKOFF_MAX_S, instead of spinning the executor
    IDLE_BACKOFF_S = 0.001
    IDLE_BACKOFF_MAX_S = 0.05

    def __init__(self, engine, *, max_pending=256, engine_queue_depth=None):
        self.engine = engine
        self.step_calls = 0           # executor dispatches of engine.step
        self._fair = FairQueue(max_pending)
        # how many requests may wait in the ENGINE's FIFO beyond the
        # resident slots: enough to keep every slot busy the moment one
        # frees, few enough that the frontend's lanes govern admission
        self._engine_depth = (engine.kv.max_slots if engine_queue_depth
                              is None else int(engine_queue_depth))
        self._live = []               # handles admitted to the engine
        self._wake = asyncio.Event()
        self._space = asyncio.Event()
        self._task = None
        self._closed = False

    # ---------------------------------------------------------- lifecycle
    async def start(self):
        if self._task is None:
            self._closed = False
            self._task = asyncio.get_running_loop().create_task(
                self._step_loop())
        return self

    async def stop(self):
        """Stop the step loop; in-flight requests get FrontendClosed."""
        self._closed = True
        self._wake.set()
        self._space.set()     # release the backpressure waiters to fail
        if self._task is not None:
            try:
                await self._task
            finally:
                self._task = None
        err = FrontendClosed("frontend stopped")
        while True:
            handle = self._fair.pop()
            if handle is None:
                break
            self._finish_handle(handle, err)
        for handle in list(self._live):
            if handle.req is not None:
                self.engine.cancel(handle.req)
            self._finish_handle(handle, err)
        self._live.clear()

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, *exc):
        await self.stop()

    # ------------------------------------------------------------ intake
    async def _enqueue(self, prompt, max_new_tokens, tenant, timeout,
                       adapter_id=None, trace_id=None):
        deadline = (self.engine.clock() + float(timeout)
                    if timeout is not None else None)
        handle = FrontendHandle(list(prompt), int(max_new_tokens),
                                str(tenant), deadline,
                                adapter_id=adapter_id, trace_id=trace_id)
        return await self._enqueue_handle(handle)

    async def _enqueue_handle(self, handle):
        if self._closed or self._task is None:
            raise FrontendClosed("frontend is not running")
        deadline = handle.deadline
        while not self._fair.push(handle.tenant, handle):
            # the bounded queue is full: wait until the step loop drains
            # space, but never past the request's own deadline (a handle
            # not yet in the fair queue escapes the admission-time
            # expiry checks)
            self._space.clear()
            if deadline is not None:
                remaining = deadline - self.engine.clock()
                if remaining <= 0:
                    raise DeadlineExceeded()
                try:
                    await asyncio.wait_for(self._space.wait(), remaining)
                except asyncio.TimeoutError:
                    raise DeadlineExceeded() from None
            else:
                await self._space.wait()
            if self._closed:
                raise FrontendClosed("frontend stopped while waiting")
        self._wake.set()
        return handle

    async def submit(self, prompt, max_new_tokens=32, *,
                     tenant="default", timeout=None, adapter_id=None):
        """Run one request to completion; returns its generated token
        ids. Cancelling the awaiting task cancels the request.
        `adapter_id` names a registered LoRA adapter (None = base)."""
        out = []
        async for tok in self.stream(prompt, max_new_tokens,
                                     tenant=tenant, timeout=timeout,
                                     adapter_id=adapter_id):
            out.append(tok)
        return out

    async def stream(self, prompt, max_new_tokens=32, *,
                     tenant="default", timeout=None, adapter_id=None,
                     on_admitted=None, on_blocks=None, trace_id=None):
        """Async generator of generated tokens, one decode step at a time
        (speculation can deliver several a step). Closing the generator,
        or cancelling its consumer, cancels the request and reclaims its
        resources. `on_admitted` is called once the request is in the
        fair queue (the router then stops counting the dispatch in its
        load estimate). `on_blocks` is called after each step with a
        `BlockChunk` of the KV blocks the prefill completed since the
        last call (the router ships them ahead to the handoff's
        destination). On a prefill-role engine the stream ends with
        `RequestMigrated(ticket)` once the first token is sampled."""
        handle = await self._enqueue(prompt, max_new_tokens, tenant,
                                     timeout, adapter_id=adapter_id,
                                     trace_id=trace_id)
        handle.on_blocks = on_blocks
        if on_admitted is not None:
            on_admitted()
        async for tok in self._consume(handle):
            yield tok

    async def stream_ticket(self, ticket, *, on_admitted=None):
        """Admit a migrated-in request: its KV blocks are imported at
        engine admission and the tokens stream on from where the source
        replica stopped (`published` starts past the ticket's delivered
        output, so nothing is sent twice). Deadline, tenant and
        backpressure behave as in `stream` (the ticket carries the
        original absolute deadline)."""
        handle = FrontendHandle(list(ticket.prompt),
                                int(ticket.max_new_tokens),
                                str(ticket.tenant), ticket.deadline,
                                adapter_id=ticket.adapter_id,
                                trace_id=ticket.trace_id)
        handle.ticket = ticket
        handle.published = len(ticket.output)
        await self._enqueue_handle(handle)
        if on_admitted is not None:
            on_admitted()
        async for tok in self._consume(handle):
            yield tok

    async def _consume(self, handle):
        try:
            while True:
                item = await handle.queue.get()
                if item is _DONE:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            if not handle.terminal:
                handle.cancel()
                self._wake.set()

    # --------------------------------------------------------- step loop
    def _finish_handle(self, handle, outcome):
        """Publish the terminal outcome (the sentinel or an exception)."""
        if handle.terminal:
            return
        handle.terminal = True
        handle.queue.put_nowait(outcome)

    def _apply_cancellations(self):
        # cancelled before admission: leave the fair queue now, so the
        # backpressure room it held frees at once
        queued = [h for h in self._fair.items() if h.cancel_requested]
        for handle in queued:
            self._fair.remove(handle)
            self._finish_handle(handle, RequestCancelled())
        if queued:
            self._space.set()
        for handle in list(self._live):
            if handle.cancel_requested and not handle.terminal:
                self.engine.cancel(handle.req)
                self._live.remove(handle)
                self._finish_handle(handle, RequestCancelled())

    def _admit_pending(self):
        """Drain the fair queue into the engine, keeping the engine's
        FIFO shallow so the frontend's fairness governs admission
        order."""
        sch = self.engine.scheduler
        now = self.engine.clock()
        while len(sch.queue) < self._engine_depth:
            handle = self._fair.pop()
            if handle is None:
                break
            if handle.cancel_requested:
                self._finish_handle(handle, RequestCancelled())
                continue
            # >=, not >: the idle wait sleeps max(0, deadline - now), so
            # a handle expiring exactly now must expire on this pass (a
            # frozen clock would otherwise spin forever)
            if handle.deadline is not None and now >= handle.deadline:
                self._finish_handle(handle, DeadlineExceeded())
                continue
            try:
                if handle.ticket is not None:
                    # the block import happens at the scheduler's next
                    # plan, between steps
                    handle.req = self.engine.submit_migrated(handle.ticket)
                    handle.ticket = None
                else:
                    handle.req = self.engine.submit(
                        handle.prompt, handle.max_new_tokens,
                        deadline=handle.deadline, tenant=handle.tenant,
                        adapter_id=handle.adapter_id,
                        trace_id=handle.trace_id)
            except ValueError as e:   # oversized or empty prompt, or a
                self._finish_handle(handle, e)   # mismatched KV geometry
                continue
            self._live.append(handle)
        self._space.set()

    def shed(self, n=1):
        """Flag up to `n` live decodes for extraction at the next step
        boundary (load shedding): each victim's stream ends with
        `RequestMigrated(ticket)` and the router re-places it on a
        lighter replica. Victims are the decodes with the most work left
        (max_new_tokens - generated), so one migration sheds the most
        future load; requests without a token yet are skipped. Returns
        how many were flagged."""
        cands = [h for h in self._live
                 if not h.terminal and not h.cancel_requested
                 and not h.extract_requested and h.req is not None
                 and h.req.state == "decode" and h.req.output]
        cands.sort(key=lambda h: (
            -(h.req.max_new_tokens - len(h.req.output)), h.req.arrival))
        picked = cands[:int(n)]
        for h in picked:
            h.extract_requested = True
        if picked:
            self._wake.set()
        return len(picked)

    def _apply_extractions(self):
        """Extract the shed-flagged decodes (between steps, on the loop's
        thread, as cancellations are). The tokens generated before the
        flag were published by the last `_publish`, so the migration
        comes after every delivered token."""
        for handle in list(self._live):
            if not handle.extract_requested or handle.terminal:
                continue
            req = handle.req
            if req is None or req.state != "decode" or not req.output:
                continue                 # not extractable (yet)
            self._live.remove(handle)
            ticket = self.engine.extract_request(req)
            self._finish_handle(handle, RequestMigrated(ticket))

    def _stream_blocks(self):
        """Ship the newly completed prefill blocks of handoff-bound
        requests (right after each step, before `_publish`, so the
        extraction's tail stays small)."""
        for handle in self._live:
            if handle.on_blocks is None or handle.terminal:
                continue
            req = handle.req
            if req is None or req.slot < 0 or req.state != "prefill":
                continue
            chunk = self.engine.export_unshipped(req)
            if chunk is not None:
                handle.on_blocks(chunk)

    def _publish(self):
        """Push new tokens and terminal states to the waiters. On a
        prefill-role engine a request in "handoff" (its first token
        sampled) is extracted here: its stream delivers the token first,
        then `RequestMigrated(ticket)`."""
        for handle in list(self._live):
            req = handle.req
            n = len(req.output)
            if n > handle.published:
                for tok in req.output[handle.published:n]:
                    handle.queue.put_nowait(tok)
                handle.published = n
            if req.done:
                self._live.remove(handle)
                if req.state == "finished":
                    self._finish_handle(handle, _DONE)
                elif req.state == "expired":
                    self._finish_handle(handle, DeadlineExceeded())
                else:
                    self._finish_handle(handle, RequestCancelled())
            elif req.state == "handoff":
                self._live.remove(handle)
                ticket = self.engine.extract_request(req)
                self._finish_handle(handle, RequestMigrated(ticket))

    def _next_pending_deadline(self):
        # handles in the frontend's queue never reach the scheduler's
        # expiry sweep, so the idle wait must wake for them
        soonest = None
        for h in self._fair.items():
            if h.deadline is not None and \
                    (soonest is None or h.deadline < soonest):
                soonest = h.deadline
        return soonest

    async def _step_loop(self):
        try:
            await self._step_loop_inner()
        except Exception as e:  # noqa: BLE001 — a step or engine failure
            # a dying step loop must not strand callers on queues nobody
            # will fill: fail every handle with the error and close
            self._closed = True
            self._space.set()
            while True:
                handle = self._fair.pop()
                if handle is None:
                    break
                self._finish_handle(handle, e)
            for handle in list(self._live):
                self._finish_handle(handle, e)
            self._live.clear()

    async def _step_loop_inner(self):
        loop = asyncio.get_running_loop()
        backoff = 0.0
        while not self._closed:
            self._apply_cancellations()
            self._apply_extractions()
            self._admit_pending()
            if self.engine.scheduler.has_work:
                self.step_calls += 1
                did = await loop.run_in_executor(None, self.engine.step)
                self._stream_blocks()
                self._publish()
                if did:
                    backoff = 0.0
                elif self.engine.scheduler.has_work:
                    # an engine stall: the block pool cannot cover the
                    # resident working set (ServingEngine.run raises
                    # here); fail the affected requests rather than spin
                    err = RuntimeError(
                        "serving engine stalled: KV block pool too small "
                        "for the resident working set")
                    for handle in list(self._live):
                        self.engine.cancel(handle.req)
                        self._live.remove(handle)
                        self._finish_handle(handle, err)
                else:
                    # the work drained between the check and the step:
                    # back off instead of spinning the executor
                    backoff = min(backoff * 2 or self.IDLE_BACKOFF_S,
                                  self.IDLE_BACKOFF_MAX_S)
                    await asyncio.sleep(backoff)
                continue
            # idle: the engine has no work, so `_admit_pending` drained
            # the fair queue; publish any observability the engine
            # deferred, then sleep until a submission or cancellation
            # wakes the loop, or the soonest frontend-held deadline
            self.engine.flush_observability()
            self._wake.clear()
            soonest = self._next_pending_deadline()
            try:
                if soonest is not None:
                    delay = max(0.0, soonest - self.engine.clock())
                    await asyncio.wait_for(self._wake.wait(), delay)
                else:
                    await self._wake.wait()
            except asyncio.TimeoutError:
                pass
