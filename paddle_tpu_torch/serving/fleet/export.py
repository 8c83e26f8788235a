"""Versioned boot bundles for serving replicas.

Port of `paddle_tpu/serving/fleet/export.py`, in its on-disk format
(`FORMAT` 1), so a bundle either package writes loads in the other:

    <root>/<version>/
        manifest.json       model config + engine knobs + kv_meta +
                            weight manifest + executable index
        weights.npz         the canonical checkpoint (`w00000`, ...),
                            in the model's `_gen_tensors()` order, as
                            the model holds it (before the engine's
                            compute-dtype cast or quantization)

Dtypes are numpy's names ("float32", "int8", "float16"); a bfloat16
parameter is written widened to float32, which is exact (numpy has no
bfloat16 of its own).

The JAX bundle also carries the mixed step's serialized executable, so
a replica boots without compiling. The port's engine is eager and has
no executable: `executables` is `{}`, `has_executable()` is False,
`executable()` returns None and `aot=` changes nothing. Its
counterpart of "no compile at boot" is that the kernels' libraries are
built once per source (`ops/_build.py`, keyed by `source_tag`): a boot
in a process that has built them runs no `nvcc` (`_build.nvcc_runs`
counts the compiles).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ...ops import _build

MANIFEST = "manifest.json"
WEIGHTS = "weights.npz"
FORMAT = 1


def default_bundle_root():
    """`build/paddle_tpu_torch/fleet_bundles` at the repository root,
    beside the built kernel libraries."""
    return str(_build.BUILD_DIR / "fleet_bundles")


def model_config(model):
    """The `GPTForGeneration` constructor kwargs a faithful rebuild
    needs (the JAX package's keys; a MoE stack also records its
    capacity factor and, for packed int4 experts, `moe_quant_bits`,
    which the JAX constructor takes too)."""
    dec = model.decoder
    weight_only = "WeightOnly" in type(dec).__name__
    cfg = {
        "vocab_size": int(model.vocab_size),
        "hidden_size": int(model.hidden_size),
        "num_layers": int(dec.num_layers),
        "num_attention_heads": int(dec.num_heads),
        "intermediate_size": int(dec.dim_feedforward),
        "max_position_embeddings": int(model.max_position_embeddings),
        "compute_dtype": str(model.compute_dtype),
        "weight_only": weight_only,
    }
    n_exp = int(getattr(dec, "num_expert", 0))
    if n_exp:
        cfg["moe"] = {"num_expert": n_exp, "top_k": int(dec.top_k),
                      "capacity_factor": float(dec.capacity_factor)}
        if weight_only and dec.moe_quant_bits:
            cfg["moe"]["moe_quant_bits"] = int(dec.moe_quant_bits)
    return cfg


def engine_config(engine):
    """The engine-constructor knobs a replica boot replays (the JAX
    package's keys, plus the tick, draft-ring and penalty-bin widths
    its engine takes too)."""
    kv = engine.kv
    ad = engine.adapters
    return {
        "max_slots": int(kv.max_slots),
        "block_size": int(engine.block_size),
        "num_blocks": int(kv.num_blocks),
        "max_seq_len": int(kv.max_blocks_per_slot * kv.block_size),
        "token_budget": int(engine.token_budget),
        "eos_token_id": engine.eos_token_id,
        "cache_dtype": str(kv.dtype),
        "kv_dtype": kv.kv_dtype,
        "draft_k": int(engine.draft_k),
        "draft_ngram": int(engine.draft_ngram),
        "draft_ring": int(engine.draft_ring),
        "penalty_vocab_bins": int(engine._penalty_bins),
        "ticks_per_dispatch": ("auto" if engine._ticks_auto
                               else int(engine.ticks_per_dispatch)),
        "prefix_caching": engine.prefix_cache is not None,
        "role": engine.role,
        "max_adapters": int(ad.max_adapters) if ad is not None else 0,
        "lora_rank": int(ad.rank) if ad is not None else 8,
        "lora_alpha": float(ad.alpha) if ad is not None else None,
        "moe_weight_dtype": engine.moe_weight_dtype,
        "sparse_blocks": engine.sparse_blocks,
        "sparse_recent": (int(engine._sparse_recent) if engine._sparse
                          else 2),
        "track_summaries": bool(engine._track_summaries),
        "sampling": dataclasses.asdict(engine.sampling),
        "tensor_parallel": int(getattr(engine, "tensor_parallel", 1)),
        "expert_parallel": int(getattr(engine, "expert_parallel", 1)),
    }


def _to_numpy(t):
    """A model tensor as a checkpoint entry: a host numpy array, bfloat16
    widened to float32 (exact; numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _as_host_tensor(a):
    """A checkpoint entry (a tensor, or a numpy array as bundles and
    `weights_from_model` give them) as a tensor; a bfloat16 numpy array
    (ml_dtypes', as a JAX-written bundle may hold) is widened to fp32,
    exactly."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def export_bundle(engine, path=None, *, version="v1", seed=0,
                  include_executable=True):
    """Write `engine`'s boot bundle for `version` under `path` (default
    `default_bundle_root()`); returns the bundle directory. The weights
    are the model's canonical tensors, so the boot replays the engine's
    own cast and quantization. `include_executable` is accepted for the
    JAX package's signature; the port writes no executable."""
    root = path if path is not None else default_bundle_root()
    bdir = os.path.join(str(root), str(version))
    os.makedirs(bdir, exist_ok=True)
    arrays = [_to_numpy(t) for t in engine.model._gen_tensors()]
    np.savez(os.path.join(bdir, WEIGHTS),
             **{f"w{i:05d}": a for i, a in enumerate(arrays)})
    manifest = {
        "format": FORMAT,
        "version": str(version),
        "seed": int(seed),
        "model": model_config(engine.model),
        "engine": engine_config(engine),
        "kv_meta": engine.kv.kv_meta(),
        "weights": [{"index": i, "shape": list(a.shape),
                     "dtype": str(a.dtype)} for i, a in enumerate(arrays)],
        "executables": {},
    }
    with open(os.path.join(bdir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return bdir


class FleetBundle:
    """A loaded boot bundle: the manifest and (lazily) the weights."""

    def __init__(self, path):
        self.path = str(path)
        with open(os.path.join(self.path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(
                f"bundle format {self.manifest.get('format')} != "
                f"supported {FORMAT} ({self.path})")
        self._weights = None

    @classmethod
    def load(cls, path):
        return cls(path)

    @property
    def version(self):
        return self.manifest["version"]

    def weights(self):
        """The canonical checkpoint as host numpy arrays (cached)."""
        if self._weights is None:
            z = np.load(os.path.join(self.path, WEIGHTS))
            self._weights = [z[f"w{i:05d}"] for i in range(len(z.files))]
        return self._weights

    def has_executable(self, role="mixed", tp=1):
        """False: the port runs no bundled executable (a JAX bundle's
        are not the port's to run)."""
        return False

    def executable(self, role="mixed", tp=1):
        return None

    @torch.no_grad()
    def build_model(self, device="cuda", dtype=torch.float32):
        """The model the manifest describes, on `device` with float
        parameters stored as `dtype`, holding the bundled weights. A
        tensor count or shape that does not fit raises."""
        from ...models.gpt import GPTForGeneration
        model = GPTForGeneration(**self.manifest["model"], device=device,
                                 dtype=dtype)
        tensors = model._gen_tensors()
        weights = self.weights()
        if len(tensors) != len(weights):
            raise ValueError(
                f"bundle holds {len(weights)} tensors, rebuilt model has "
                f"{len(tensors)} - manifest/model drift")
        for t, w in zip(tensors, weights):
            if tuple(t.shape) != tuple(w.shape):
                raise ValueError(f"bundle tensor {tuple(w.shape)} != model "
                                 f"tensor {tuple(t.shape)}")
            if t.is_floating_point() != np.issubdtype(w.dtype, np.floating):
                raise ValueError(f"bundle tensor {w.dtype} where the model "
                                 f"holds {t.dtype}")
        for t, w in zip(tensors, weights):
            t.copy_(_as_host_tensor(w))
        return model


def boot_engine_from_bundle(bundle, *, aot=True, warm_prefix=None,
                            name=None, model_factory=None, clock=None,
                            device=None, **overrides):
    """A `ServingEngine` (a `TPServingEngine` rank for a bundle exported
    from one) from `bundle` (a `FleetBundle` or a path), on `device`
    (default "cuda"): the model rebuilt from the manifest (or
    `model_factory()`), the engine built with the bundle's knobs and
    seed, then `overrides`. `warm_prefix` names a
    `RadixPrefixCache.spill` file to restore. `weights_version` is the
    bundle's version. `aot` changes nothing (no executable)."""
    if isinstance(bundle, str):
        bundle = FleetBundle(bundle)
    model = (model_factory() if model_factory is not None
             else bundle.build_model(device=device or "cuda"))
    ecfg = dict(bundle.manifest["engine"])
    tp = int(ecfg.pop("tensor_parallel", 1))
    ep = int(ecfg.pop("expert_parallel", 1))
    sampling_cfg = ecfg.pop("sampling", None)
    if sampling_cfg is not None:
        from ..batcher import SamplingConfig
        ecfg["sampling"] = SamplingConfig(**sampling_cfg)
    ecfg["seed"] = int(bundle.manifest.get("seed", 0))
    if clock is not None:
        ecfg["clock"] = clock
    if name is not None:
        ecfg["name"] = name
    if device is not None:
        ecfg["device"] = device
    ecfg.update(overrides)
    if tp > 1 or ep > 1:
        from ..distributed.tp_engine import TPServingEngine
        engine = TPServingEngine(model, tensor_parallel=tp,
                                 expert_parallel=ep, **ecfg)
    else:
        from ..engine import ServingEngine
        engine = ServingEngine(model, **ecfg)
    engine.weights_version = bundle.version
    if warm_prefix is not None and engine.prefix_cache is not None \
            and os.path.exists(warm_prefix):
        engine.prefix_cache.restore(warm_prefix)
    return engine
