"""Tensor- (x expert-) parallel serving engine over `torch.distributed`.

Port of `paddle_tpu/serving/distributed/tp_engine.py`. JAX drives a
virtual mesh from one controller; here every rank is a process that runs
the whole host loop of `serving.engine.ServingEngine` (scheduler,
allocator, prefix cache, drafter, adapter cache) on its own shard of the
weights and pools, as under `torchrun`: every rank calls `submit`,
`step`, `run` and `generate_batch` with the same arguments.

* **Heads split over `mp`.** The fused QKV out axis is permuted
  shard-major (`parallel.mp_layers.shard_major_qkv`), so a contiguous
  1/tp chunk is one rank's q, k and v heads; the step runs at
  `num_heads = H / tp`, and the paged kernels see the rank's head slice
  of q and of the pools.
* **KV pools at H / tp heads** (and their scales and key summaries).
  Block tables, the allocator and the prefix cache are whole on every
  rank and stay equal, because every rank makes the same decisions.
* **Row-parallel reductions**: the attention out product and ffn2 (each
  with its LoRA delta) are all-reduced over the `mp` group before their
  bias, and the block-sparse selection's scores before their max over a
  verify group (`engine._select`).
* **Experts split over `ep`** (MoE stacks, `expert_parallel > 1`): the
  token set is the same on every rank, so a rank runs its E / ep
  resident experts on its rows of the dispatch table and the partial
  combines are all-reduced over the `ep` group
  (`incubate.nn.fused_transformer._ffn_moe_tokens`).

Two things could make the ranks' host loops part, and the engine closes
both. Sampled tokens (and with speculation the verify outputs) are
broadcast from rank 0 after every step and every tick of the multi-tick
loop, before anything reads them, so every rank accepts, finishes and
preempts alike even if two reductions ever differed in a bit. The clock
that the scheduler reads (deadlines, arrival order) is rank 0's, taken
once a `step()` and once a `submit()` and broadcast; "auto" multi-tick
sizing takes rank 0's choice.

The engine never picks a backend: the caller's `init_process_group`
does. NCCL needs a card a rank; ranks that share one card run over gloo,
which stages CUDA tensors through the host. Ranks map as JAX's
`tp_ep_mesh` (`reshape(ep, tp)`): rank = ep_rank * tp + mp_rank.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ...parallel.mp_layers import serving_tp_spec, shard_tensor, tp_groups
from ..engine import ServingEngine


def rank_device(rank):
    """The default device of `rank`: `cuda:{rank % device_count}`. Raises
    without a card (pass `device="cpu"` to run on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "TPServingEngine needs a CUDA card for its default device and "
            "none is available; pass device='cpu' to run on the CPU")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


class TPServingEngine(ServingEngine):
    """`ServingEngine` over a `tensor_parallel` x `expert_parallel`
    process group: the default group, initialised by the caller, with
    that many ranks (without one, only 1 x 1). The host API is the base
    engine's."""

    def __init__(self, model, *, tensor_parallel=2, expert_parallel=1,
                 device=None, clock=time.monotonic, role="mixed", **kw):
        if role != "mixed":
            raise NotImplementedError(
                f"role={role!r} under tensor parallelism is not ported: a "
                "migration ticket would need every rank's heads gathered "
                "into one process")
        dec = model.decoder
        tp, ep = int(tensor_parallel), int(expert_parallel)
        if tp < 1 or ep < 1:
            raise ValueError(f"tensor_parallel/expert_parallel must be >= "
                             f"1, got {tp}/{ep}")
        n_exp = int(getattr(dec, "num_expert", 0))
        if ep > 1 and not n_exp:
            raise ValueError(
                "expert_parallel > 1 needs a MoE decoder stack "
                "(FusedMultiTransformerMoe)")
        if n_exp and n_exp % ep:
            raise ValueError(f"num_experts={n_exp} not divisible by "
                             f"expert_parallel={ep}")
        if dec.num_heads % tp:
            raise ValueError(f"num_heads={dec.num_heads} not divisible by "
                             f"tensor_parallel={tp}")
        if dec.dim_feedforward % tp:
            raise ValueError(
                f"dim_feedforward={dec.dim_feedforward} not divisible by "
                f"tensor_parallel={tp}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != tp * ep:
            raise ValueError(
                f"tensor_parallel={tp} x expert_parallel={ep} needs a "
                f"default process group of {tp * ep} ranks, got {world}")
        self.tensor_parallel, self.expert_parallel = tp, ep
        self._distributed = world > 1
        self.rank = dist.get_rank() if self._distributed else 0
        if self._distributed:
            (self.mp_group, self.ep_group, self.mp_rank,
             self.ep_rank) = tp_groups(tp, ep)
        else:
            self.mp_group = self.ep_group = None
            self.mp_rank = self.ep_rank = 0
        self._wall_clock = clock
        self._now = None
        super().__init__(
            model, device=rank_device(self.rank) if device is None
            else device,
            clock=self._step_clock if self._distributed else clock, **kw)
        # the dispatch EMAs and adapter load times read the rank's own
        # clock; only the scheduler's decisions need rank 0's
        self._timer = clock
        if self.adapters is not None:
            self.adapters.clock = clock
        self._shard_state()

    # ------------------------------------------------------- sharding
    def _shard_kw(self):
        dec = self.model.decoder
        return dict(tp=self.tensor_parallel, mp_rank=self.mp_rank,
                    ep=self.expert_parallel, ep_rank=self.ep_rank,
                    num_heads=dec.num_heads, head_dim=dec.head_dim)

    @torch.no_grad()
    def _shard_state(self):
        """Cut every layer's cast (and, with `moe_weight_dtype`,
        quantized) parameters to the rank's share by the engine's own
        name list, so weight-only scales and int8 / int4 expert stacks
        split by their rules; the embeddings, `ln_f` and the LM head stay
        whole. The adapter slot tensors are reallocated at the rank's
        widths, and each load's payload is cut by `prepare`."""
        kw = self._shard_kw()
        moe = self.num_experts > 0
        for pl in self._layers:
            for name in [n for n in pl if not n.startswith("lora_")]:
                pl[name] = shard_tensor(pl[name],
                                        serving_tp_spec(name, moe=moe), **kw)
        ad = self.adapters
        if ad is not None:
            ad.tensors = {n: shard_tensor(t, serving_tp_spec(n), **kw)
                          for n, t in ad.tensors.items()}
            ad.prepare = self._prepare_adapter
            for li, pl in enumerate(self._layers):
                pl.update(ad.layer_tensors(li))

    def _prepare_adapter(self, name, payload):
        """An adapter's full host payload of slot tensor `name` ([L, d_in,
        r] or [L, r, d_out]) cut to the rank's share."""
        return shard_tensor(payload, serving_tp_spec(name),
                            **self._shard_kw())

    # ------------------------------------------------------ mixed step
    def _step_cfg(self):
        """The rank's decoder config: its heads, its groups and, for a
        MoE stack, its place among the ep ranks. Starts from the base
        engine's, so engine-side expert bits compose with the split."""
        cfg = super()._step_cfg()
        return dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.tensor_parallel,
            mp_group=self.mp_group, ep_group=self.ep_group,
            ep_size=self.expert_parallel, ep_rank=self.ep_rank)

    def _sync_outputs(self, outs):
        """Rank 0's sampled outputs on every rank, in one broadcast."""
        if not self._distributed:
            return outs
        flat = torch.cat([o.reshape(-1).long() for o in outs])
        dist.broadcast(flat, src=0)
        synced, at = [], 0
        for o in outs:
            synced.append(flat[at:at + o.numel()].reshape(o.shape)
                          .to(o.dtype))
            at += o.numel()
        return tuple(synced)

    def _flight_extra(self):
        # the split rides every flight record, so a merged fleet trace
        # tells a TP x EP replica's step slices from a one-card sibling's
        return {"tp": self.tensor_parallel, "ep": self.expert_parallel}

    def _kv_bytes_per_token(self):
        # the rank's pools hold 1/tp of the heads: the gauge reports the
        # whole group's cost, as the JAX engine's sharded pools do
        return self.kv.kv_bytes_per_token * self.tensor_parallel

    # ------------------------------------------------------------ host
    def _broadcast(self, value, dtype):
        t = torch.tensor([value], dtype=dtype, device=self.device)
        dist.broadcast(t, src=0)
        return t.item()

    def _step_clock(self):
        return self._now

    def _sync_clock(self):
        if self._distributed:
            self._now = self._broadcast(self._wall_clock(), torch.float64)

    def submit(self, *args, **kw):
        # arrival times order decodes and preemption victims: rank 0's
        self._sync_clock()
        return super().submit(*args, **kw)

    def step(self):
        self._sync_clock()
        return super().step()

    def _auto_ticks(self, n_max):
        n = super()._auto_ticks(n_max)
        return int(self._broadcast(n, torch.int64)) if self._distributed \
            else n

    # --------------------------------------------------- out of scope
    def close(self, *, spill_prefix=None):
        if spill_prefix is not None and self._distributed:
            raise NotImplementedError(
                "close(spill_prefix=) under tensor parallelism is not "
                "ported (each rank holds a slice of every block)")
        return super().close(spill_prefix=spill_prefix)

    def extract_request(self, req):
        raise NotImplementedError(
            "extract_request under tensor parallelism is not ported (each "
            "rank holds a slice of every block)")

    def submit_migrated(self, ticket):
        raise NotImplementedError(
            "submit_migrated under tensor parallelism is not ported (each "
            "rank holds a slice of every block)")

    def swap_weights(self, *args, **kw):
        raise NotImplementedError(
            "swap_weights under tensor parallelism is not ported: it comes "
            "with the process-per-rank fleet (each rank would swap its "
            "shard between the same steps)")
