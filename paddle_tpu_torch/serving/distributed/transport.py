"""Block-granular KV transport between serving replicas.

Port of `paddle_tpu/serving/distributed/transport.py`. Disaggregated
prefill/decode serving moves a request's paged KV blocks between
replicas: a prefill-role replica streams the blocks it completes to a
decode-role replica while the prompt is still prefilling, hands the
request off at its first sampled token, and a loaded decode replica can
later shed a live request, blocks and all, to a sibling. The unit of
transfer is a pool block: its K/V payloads plus, for quantized pools,
the fp32 scale rows at the same coordinates, and with key summaries the
block's min/max rows. A block carries everything it needs, so shipping
it keeps every entry's dequantization and score bit-exact.

Three layers:

* **Codec** — `encode_chunk` / `decode_chunk` and `encode_state` /
  `decode_state`: a versioned wire format (magic `PTKV`, a
  length-prefixed JSON header with the pool geometry and each array's
  dtype and shape, then the raw C-order payloads). The header names
  arrays by their logical dtype, as the JAX package's codec does:
  `PagedKVCache.export_blocks` hands bf16 and fp8 payloads out as
  their bits (int16, uint8), and the codec writes them as "bfloat16"
  and "float8_e4m3fn" with the same bytes, and reads those names back
  as the bit dtypes. So a frame of this codec and a JAX frame of the
  same blocks are the same bytes, and each side decodes the other's,
  with no numpy extension for the 16- and 8-bit floats.
* **`MigrationTicket`** — the request's host state (prompt, generated
  output, horizon, deadline, timing) and the block chunks not yet
  streamed: what the destination's `ServingEngine.submit_migrated`
  needs to resume the request token for token under greedy decoding.
* **`KVTransport`** — the wire. `InProcessTransport` passes every
  chunk and ticket through the real codec, so the byte counts and
  bit-exactness are exercised on every transfer, landing in a
  per-(destination, key) inbox the router collects from.

Counters on the transport (`bytes_sent`, `bytes_received`,
`blocks_sent`, `tickets_sent`) are always on; block counts also ride
`PagedKVCache.blocks_exported` / `blocks_imported`. While
`profiler.metrics._enabled` is on the byte counts are mirrored into
`paddle_tpu_serving_kv_transport_bytes_total`, and while tracing is on
a ticket's send records a `migration_transport` span on its trace.
"""
from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

from ...profiler import metrics as _pmetrics
from .. import metrics as smetrics
from .. import tracing as _tracing

MAGIC = b"PTKV"
VERSION = 1

#: bit dtypes of the 16- and 8-bit float pools -> the logical dtype the
#: wire names (the JAX codec's `str(array.dtype)`), and back
_WIRE_NAMES = {"int16": "bfloat16", "uint8": "float8_e4m3fn"}
_BIT_DTYPES = {v: np.dtype(k) for k, v in _WIRE_NAMES.items()}


def _wire_name(dtype):
    name = np.dtype(dtype).name
    return _WIRE_NAMES.get(name, name)


def _host_dtype(name):
    return _BIT_DTYPES[name] if name in _BIT_DTYPES else np.dtype(name)


@dataclasses.dataclass
class BlockChunk:
    """A contiguous run of a slot's KV blocks in transit.

    `start` indexes the slot's block table (not the pool): a chunk
    covers table entries [start, start + count). `arrays` is what
    `PagedKVCache.export_blocks` produced and `import_blocks` takes, one
    `[count, L, ...]` array a pool tensor."""
    start: int
    count: int
    arrays: tuple


#: host-state fields of a ticket, in wire order (the chunks travel as
#: frames of their own)
_STATE_FIELDS = ("prompt", "output", "max_new_tokens", "eos_token_id",
                 "deadline", "tenant", "slot_len", "total_blocks",
                 "kv_meta", "submit_time", "first_token_time",
                 "cache_hit_tokens", "preemptions", "created_at",
                 "adapter_id", "trace_id")


@dataclasses.dataclass
class MigrationTicket:
    """Everything a destination engine needs to resume a live request.

    Built by `ServingEngine.extract_request`, consumed by
    `ServingEngine.submit_migrated`. `chunks` holds the blocks not yet
    streamed ahead (a prefill handoff: the tail past
    `Request.shipped_blocks`; a decode shed: all of them); the
    transport merges the streamed chunks back in, and `total_blocks`
    lets the importer check the coverage before it touches a pool.
    Timing fields carry over, so a request's TTFT is observed once and
    its inter-token gaps stay continuous across the move. `adapter_id`
    (a registered LoRA adapter, re-pinned at the destination) and
    `trace_id` are JSON-safe values carried as they are."""
    prompt: list
    output: list
    max_new_tokens: int
    eos_token_id: object
    deadline: object
    tenant: str
    slot_len: int
    total_blocks: int
    kv_meta: dict
    chunks: list
    submit_time: float = 0.0
    first_token_time: object = None
    cache_hit_tokens: int = 0
    preemptions: int = 0
    created_at: float = 0.0
    adapter_id: object = None
    trace_id: object = None

    def state_dict(self):
        d = {f: getattr(self, f) for f in _STATE_FIELDS}
        d["prompt"] = [int(t) for t in self.prompt]
        d["output"] = [int(t) for t in self.output]
        return d


# --------------------------------------------------------------- codec
def _frame(header, payloads):
    hj = json.dumps(header).encode("utf-8")
    return b"".join([MAGIC, struct.pack("<I", len(hj)), hj, *payloads])


def _unframe(data):
    if data[:4] != MAGIC:
        raise ValueError("not a PTKV frame (bad magic)")
    (hlen,) = struct.unpack_from("<I", data, 4)
    header = json.loads(data[8:8 + hlen].decode("utf-8"))
    if header.get("v") != VERSION:
        raise ValueError(f"unsupported PTKV version {header.get('v')}")
    return header, 8 + hlen


def encode_chunk(meta, chunk):
    """One block chunk -> wire bytes: the header (geometry, each array's
    logical dtype and shape) and the raw C-order payloads."""
    header = {
        "v": VERSION, "kind": "chunk", "meta": dict(meta),
        "start": int(chunk.start), "count": int(chunk.count),
        "arrays": [{"dtype": _wire_name(a.dtype), "shape": list(a.shape)}
                   for a in chunk.arrays],
    }
    payloads = [np.ascontiguousarray(a).tobytes() for a in chunk.arrays]
    return _frame(header, payloads)


def decode_chunk(data):
    """Wire bytes -> (meta, BlockChunk). The arrays are fresh, writable
    host copies in the pools' host dtypes (bf16 and fp8 as their
    bits)."""
    header, off = _unframe(data)
    if header.get("kind") != "chunk":
        raise ValueError(f"expected a chunk frame, got {header.get('kind')!r}")
    arrays = []
    for desc in header["arrays"]:
        dt = _host_dtype(desc["dtype"])
        shape = tuple(desc["shape"])
        n = int(np.prod(shape)) if shape else 1
        a = np.frombuffer(data, dtype=dt, count=n, offset=off)
        arrays.append(a.reshape(shape).copy())
        off += n * dt.itemsize
    return header["meta"], BlockChunk(start=int(header["start"]),
                                      count=int(header["count"]),
                                      arrays=tuple(arrays))


def encode_state(ticket):
    return _frame({"v": VERSION, "kind": "state",
                   "state": ticket.state_dict()}, [])


def decode_state(data):
    header, _ = _unframe(data)
    if header.get("kind") != "state":
        raise ValueError(f"expected a state frame, got {header.get('kind')!r}")
    return header["state"]


# ----------------------------------------------------------- transport
class KVTransport:
    """Pluggable block-granular transport between replicas.

    `send_chunk` ships one `BlockChunk` toward `(dst, key)` (the
    prefill's stream-ahead); `send_ticket` ships a ticket's host state
    and its remaining chunks (a handoff or a shed); `collect` pops the
    assembled ticket at the destination; `pending` / `drop` manage
    abandoned transfers. The byte and block counters are always on; the
    registry mirror records only while profiler metrics are on."""

    def __init__(self):
        self.bytes_sent = 0
        self.bytes_received = 0
        self.blocks_sent = 0
        self.tickets_sent = 0

    def _note(self, sent, received):
        self.bytes_sent += int(sent)
        self.bytes_received += int(received)
        if _pmetrics._enabled:
            smetrics.SERVING_KV_TRANSPORT_BYTES.labels("sent").inc(sent)
            smetrics.SERVING_KV_TRANSPORT_BYTES.labels("received").inc(
                received)

    def send_chunk(self, src, dst, key, meta, chunk):
        """One chunk toward (dst, key); `meta` is the source pool's
        `kv_meta()`."""
        raise NotImplementedError

    def send_ticket(self, src, dst, key, ticket):
        """A ticket's state and its unstreamed chunks toward (dst, key)."""
        raise NotImplementedError

    def collect(self, dst, key):
        """The assembled MigrationTicket at dst (state and every chunk, in
        table order); KeyError while the state frame has not arrived."""
        raise NotImplementedError

    def pending(self, dst, key):
        raise NotImplementedError

    def drop(self, dst, key):
        """Forget a transfer (the request finished or was cancelled
        before its handoff)."""
        raise NotImplementedError


class InProcessTransport(KVTransport):
    """The reference transport: a same-process inbox behind the real
    codec. Every chunk and ticket is encoded to bytes and decoded back,
    so byte accounting, the geometry header and bit-exactness are
    exercised on every transfer as a network transport would."""

    def __init__(self):
        super().__init__()
        self._inbox = {}            # (dst, key) -> {"state", "chunks"}

    def _box(self, dst, key):
        return self._inbox.setdefault((dst, key),
                                      {"state": None, "chunks": []})

    def send_chunk(self, src, dst, key, meta, chunk):
        data = encode_chunk(meta, chunk)
        self._note(len(data), len(data))
        meta, chunk = decode_chunk(data)
        self.blocks_sent += chunk.count
        self._box(dst, key)["chunks"].append(chunk)

    def send_ticket(self, src, dst, key, ticket):
        nb0 = self.bytes_sent
        for chunk in ticket.chunks:
            self.send_chunk(src, dst, key, ticket.kv_meta, chunk)
        data = encode_state(ticket)
        self._note(len(data), len(data))
        self.tickets_sent += 1
        self._box(dst, key)["state"] = decode_state(data)
        if _tracing._enabled:
            _tracing.on_transport(ticket.trace_id, src, dst,
                                  nbytes=self.bytes_sent - nb0,
                                  blocks=sum(c.count for c in ticket.chunks))

    def collect(self, dst, key):
        box = self._inbox.pop((dst, key), None)
        if box is None or box["state"] is None:
            raise KeyError(f"no complete ticket for ({dst!r}, {key!r})")
        chunks = sorted(box["chunks"], key=lambda c: c.start)
        return MigrationTicket(chunks=chunks, **box["state"])

    def pending(self, dst, key):
        return (dst, key) in self._inbox

    def drop(self, dst, key):
        self._inbox.pop((dst, key), None)
