"""The port's fleet control plane against the JAX package's.

At the port's test size (vocab 193, hidden 32, 2 layers, 4 heads, block
4, fp32 pools, CPU; JAX `GPTForGeneration`s at seeds 1234 ("v1") and
777 ("v2") carried across by `paddle_tpu_torch.convert.load_jax_gpt`),
tolerance 0 (tokens and weights are compared exactly), after
`tests/test_fleet.py`:

* **bundles**: a port bundle boots an engine that serves the exporting
  engine's tokens, runs no `nvcc` and carries no executable; the weights
  are the canonical `_gen_tensors()` bytes; manifest drift is refused;
  overrides and a warm prefix spill apply; a bfloat16 model round-trips
  exactly. A JAX-written bundle boots a port engine with the JAX
  engine's tokens, and a port-written bundle loads and boots in JAX's
  `FleetBundle` with the port's tokens.
* **weight swap**: a swapped engine equals a fresh v2 engine tensor for
  tensor and token for token, copies into the same buffers across
  swaps, leaves the model it was built from untouched, evicts the
  prefix cache, and refuses what JAX's refuses.
* **router plane and rolling upgrade**: quiesce, drain and
  `add_replica`; the upgrade refuses a one-replica fleet, streams
  requests each on exactly one version, and flips every replica.
* **autoscaler**: the port's and JAX's `SLOAutoscaler` over the ported
  fakes and one clock make the same decisions.
* **controller**: boot, upgrade, retire and LIFO scale-down; the
  `FLEET_*` registry equals JAX's under a shared clock.
"""
import asyncio
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.profiler import metrics as jpm
from paddle_tpu.serving import metrics as jsm
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving.distributed import ReplicaRouter as JaxRouter
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.frontend import ServingFrontend as JaxFrontend
from paddle_tpu.serving.slo import SLOMonitor as JaxSLOMonitor
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.models.gpt import GPTForGeneration
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.profiler import metrics as tpm
from paddle_tpu_torch.serving import metrics as tsm
from paddle_tpu_torch.serving.distributed import (NoReplicaAvailable,
                                                  ReplicaRouter,
                                                  TPServingEngine)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.fleet import (AutoscalerPolicy, FleetBundle,
                                            FleetController, SLOAutoscaler,
                                            boot_engine_from_bundle,
                                            export_bundle, rolling_upgrade,
                                            weights_from_bundle,
                                            weights_from_model)
from paddle_tpu_torch.serving.fleet.export import default_bundle_root
from paddle_tpu_torch.serving.frontend import ServingFrontend
from paddle_tpu_torch.serving.slo import SLOMonitor

VOCAB, HEADS = 193, 4
ENG_KW = dict(max_slots=4, block_size=4, num_blocks=64, max_seq_len=64,
              token_budget=64, cache_dtype="float32", seed=0,
              prefix_caching=True)
PROMPTS = [[2, 3, 5, 7, 11], [13, 17, 19], [23, 29, 31, 37]]
FLEET_METRICS = ("paddle_tpu_serving_fleet_replicas",
                 "paddle_tpu_serving_fleet_boots_total",
                 "paddle_tpu_serving_fleet_upgrades_total",
                 "paddle_tpu_serving_fleet_scale_events_total",
                 "paddle_tpu_serving_fleet_cold_start_seconds")


def _jax_model(seed):
    paddle.seed(seed)
    m = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
               num_attention_heads=HEADS, max_position_embeddings=128,
               compute_dtype="float32")
    m.eval()
    return m


def _port(jm):
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    return load_jax_gpt({n: np.asarray(t._data)
                         for n, t in zip(names, tensors)}, HEADS,
                        device="cpu")


@pytest.fixture(scope="module")
def models():
    """{"v1": (JAX model, port model), "v2": ...} and each version's
    reference tokens (a fresh port engine's, 6 and 8 new tokens; the
    JAX engine's, held equal)."""
    out = {}
    for version, seed in (("v1", 1234), ("v2", 777)):
        jm = _jax_model(seed)
        tm = _port(jm)
        refs = {n: _gen(_engine(tm), n=n) for n in (6, 8)}
        out[version] = (jm, tm, refs)
    jref = _gen(JaxEngine(out["v1"][0], **ENG_KW), n=8)
    assert jref == out["v1"][2][8]
    return out


def _engine(model, **kw):
    return ServingEngine(model, device="cpu", **dict(ENG_KW, **kw))


def _gen(engine, prompts=PROMPTS, n=8):
    return engine.generate_batch([list(p) for p in prompts],
                                 max_new_tokens=n)


@pytest.fixture
def metrics_on():
    """Recording on with empty registries in both packages, restored
    after (the switches are process-wide)."""
    was = (jpm._enabled, tpm._enabled)
    for pm in (jpm, tpm):
        pm.REGISTRY.reset()
        pm.enable()
    yield
    for pm, on in zip((jpm, tpm), was):
        pm.REGISTRY.reset()
        (pm.enable if on else pm.disable)()


# ------------------------------------------------------------- bundles


def test_bundle_boot_serves_the_exporting_engines_tokens(models, tmp_path):
    _, tm, refs = models["v1"]
    eng = _engine(tm)
    assert _gen(eng) == refs[8]
    bundle = FleetBundle(export_bundle(eng, str(tmp_path), version="v1"))
    assert bundle.version == "v1"
    assert not bundle.has_executable("mixed", 1)
    assert bundle.executable() is None
    assert bundle.manifest["executables"] == {}
    runs = _build.nvcc_runs
    boot = boot_engine_from_bundle(bundle, aot=True, device="cpu")
    assert _gen(boot) == refs[8]
    assert _build.nvcc_runs == runs
    assert boot.weights_version == "v1"
    w, version = weights_from_bundle(bundle.path)
    assert version == "v1" and len(w) == len(tm._gen_tensors())
    assert default_bundle_root().endswith(
        os.path.join("build", "paddle_tpu_torch", "fleet_bundles"))


def test_bundle_weights_are_canonical_and_validated(models, tmp_path):
    _, tm, _ = models["v1"]
    eng = _engine(tm)
    bundle = FleetBundle(export_bundle(eng, str(tmp_path)))
    tensors = tm._gen_tensors()
    weights = bundle.weights()
    assert len(weights) == len(tensors)
    for t, w in zip(tensors, weights):
        assert np.array_equal(t.numpy(), w)
    man = bundle.manifest
    assert [w["dtype"] for w in man["weights"]] == ["float32"] * len(weights)
    assert man["engine"]["block_size"] == 4
    assert man["kv_meta"] == eng.kv.kv_meta()
    bundle.manifest["model"]["num_layers"] = 3
    with pytest.raises(ValueError, match="tensor"):
        bundle.build_model(device="cpu")


def test_warm_boot_and_overrides(models, tmp_path):
    _, tm, refs = models["v1"]
    eng = _engine(tm)
    _gen(eng)
    bundle = FleetBundle(export_bundle(eng, str(tmp_path)))
    spill = str(tmp_path / "prefix.pkl")
    spilled = eng.close(spill_prefix=spill)
    assert spilled > 0
    warm = boot_engine_from_bundle(bundle, warm_prefix=spill, device="cpu")
    assert warm.prefix_cache.cached_blocks == spilled
    assert _gen(warm) == refs[8]
    boot = boot_engine_from_bundle(bundle, name="ovr", prefix_caching=False,
                                   device="cpu")
    assert boot.name == "ovr" and boot.prefix_cache is None


def test_jax_bundle_boots_in_the_port(models, tmp_path):
    jm, _, refs = models["v1"]
    jeng = JaxEngine(jm, **ENG_KW)
    bdir = jfleet.export_bundle(jeng, str(tmp_path), version="v7",
                                include_executable=False)
    boot = boot_engine_from_bundle(bdir, device="cpu")
    assert boot.weights_version == "v7"
    assert _gen(boot) == _gen(jeng) == refs[8]


def test_port_bundle_loads_in_jax(models, tmp_path):
    jm, tm, refs = models["v1"]
    bdir = export_bundle(_engine(tm, draft_k=2), str(tmp_path),
                         version="v3")
    jb = jfleet.FleetBundle(bdir)
    assert jb.version == "v3" and not jb.has_executable()
    for w, t in zip(jb.weights(), jm._gen_tensors()):
        assert np.array_equal(w, np.asarray(t._data))
    jeng = jfleet.boot_engine_from_bundle(jb, aot=False)
    assert jeng.draft_k == 2 and jeng.weights_version == "v3"
    assert _gen(jeng) == refs[8]


def test_model_config_rebuilds_bf16_and_int4_stacks(tmp_path):
    """A bfloat16 model's bundle holds its weights widened to float32
    (exact) and boots a bfloat16 model of the same bits; a weight-only
    MoE stack records its int4 experts."""
    torch.manual_seed(0)
    m = GPTForGeneration(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                         num_attention_heads=HEADS,
                         max_position_embeddings=64, device="cpu",
                         dtype=torch.bfloat16)
    bdir = export_bundle(_engine(m), str(tmp_path / "bf16"))
    b = FleetBundle(bdir)
    assert {w["dtype"] for w in b.manifest["weights"]} == {"float32"}
    back = b.build_model(device="cpu", dtype=torch.bfloat16)
    for x, y in zip(back._gen_tensors(), m._gen_tensors()):
        assert torch.equal(x, y)
    q = GPTForGeneration(vocab_size=VOCAB, hidden_size=32, num_layers=1,
                         num_attention_heads=HEADS,
                         max_position_embeddings=64, weight_only=True,
                         moe=dict(num_expert=4, top_k=2,
                                  capacity_factor=2.0, moe_quant_bits=4),
                         device="cpu")
    b = FleetBundle(export_bundle(_engine(q), str(tmp_path / "int4")))
    assert b.manifest["model"]["moe"] == dict(
        num_expert=4, top_k=2, capacity_factor=2.0, moe_quant_bits=4)
    dtypes = {w["dtype"] for w in b.manifest["weights"]}
    assert dtypes == {"float32", "int8", "float16"}
    for x, y in zip(b.build_model(device="cpu")._gen_tensors(),
                    q._gen_tensors()):
        assert torch.equal(x, y)


# ---------------------------------------------------------- weight swap


def _engine_tensors(eng):
    return {k: t.clone() for k, t in eng._weight_slots().items()}


def test_swap_equals_a_fresh_v2_engine(models):
    _, tm1, _ = models["v1"]
    _, tm2, refs2 = models["v2"]
    before = [t.clone() for t in tm1._gen_tensors()]
    eng = _engine(tm1)
    _gen(eng)                                    # live v1 traffic
    eng.swap_weights(weights_from_model(tm2), "v2")
    ptrs = {k: t.data_ptr() for k, t in eng._weight_slots().items()}
    eng.swap_weights(weights_from_model(tm1), "v3")
    eng.swap_weights(tm2._gen_tensors(), "v2")   # tensors are taken too
    assert {k: t.data_ptr() for k, t in
            eng._weight_slots().items()} == ptrs     # the same buffers
    fresh = _engine_tensors(_engine(tm2))
    for k, t in eng._weight_slots().items():
        assert t.dtype == fresh[k].dtype and torch.equal(t, fresh[k]), k
    assert _gen(eng) == refs2[8]
    assert eng.weights_version == "v2"
    for t, b in zip(tm1._gen_tensors(), before):      # model untouched
        assert torch.equal(t, b)


def test_swap_on_a_weight_only_stack():
    """Integer weights the engine shares with its model get the engine's
    own buffers at the first swap: the model stays as it was, and the
    swapped engine equals a fresh one."""
    torch.manual_seed(1)
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2,
              num_attention_heads=HEADS, max_position_embeddings=64,
              weight_only=True, compute_dtype="float32", device="cpu")
    m1, m2 = GPTForGeneration(**kw), GPTForGeneration(**kw)
    before = [t.clone() for t in m1._gen_tensors()]
    eng = _engine(m1)
    assert eng._layers[0]["qkv_w"].data_ptr() == m1.decoder.qkv_w.data_ptr()
    eng.swap_weights(weights_from_model(m2), "v2")
    fresh = _engine(m2)
    fresh_t = _engine_tensors(fresh)
    for k, t in eng._weight_slots().items():
        assert torch.equal(t, fresh_t[k]), k
    for t, b in zip(m1._gen_tensors(), before):
        assert torch.equal(t, b)
    assert _gen(eng) == _gen(fresh)


def test_swap_evicts_the_prefix_cache(models):
    _, tm1, _ = models["v1"]
    _, tm2, _ = models["v2"]
    eng = _engine(tm1)
    _gen(eng)
    assert eng.prefix_cache.cached_blocks > 0
    eng.swap_weights(weights_from_model(tm2), "v2")
    assert eng.prefix_cache.cached_blocks == 0


def test_swap_guard_rails(models):
    _, tm1, _ = models["v1"]
    _, tm2, _ = models["v2"]
    eng = _engine(tm1)
    w = weights_from_model(tm2)
    with pytest.raises(ValueError, match="tensors"):
        eng.swap_weights(w[:-1], "v2")
    with pytest.raises(ValueError, match="shape"):
        eng.swap_weights([np.zeros((3, 3), np.float32) for _ in w], "v2")
    bad = list(w)
    bad[0] = bad[0].astype(np.int32)
    with pytest.raises(ValueError, match="dtype"):
        eng.swap_weights(bad, "v2")
    assert eng.weights_version == "v0"         # unchanged on error
    torch.manual_seed(2)
    moe = GPTForGeneration(vocab_size=VOCAB, hidden_size=32, num_layers=1,
                           num_attention_heads=HEADS,
                           max_position_embeddings=64,
                           moe=dict(num_expert=4, top_k=2), device="cpu")
    qe = _engine(moe, moe_weight_dtype="int8")
    with pytest.raises(ValueError, match="quantized MoE"):
        qe.swap_weights(weights_from_model(moe), "v2")
    tp = TPServingEngine(tm1, tensor_parallel=1, device="cpu",
                         **dict(ENG_KW, prefix_caching=False))
    with pytest.raises(NotImplementedError, match="process-per-rank"):
        tp.swap_weights(w, "v2")


# ------------------------------------------------------ router plane


def _fes(model, n=2, **kw):
    return [ServingFrontend(_engine(model, name=f"r{i}", **kw),
                            max_pending=16) for i in range(n)]


def test_router_fleet_plane(models):
    """quiesce excludes from dispatch, quiescing all refuses, add_replica
    validates and appends, is_drained tracks live work."""
    _, tm, refs = models["v1"]
    fes = _fes(tm)
    router = ReplicaRouter(fes)
    bad = ServingFrontend(_engine(tm, block_size=8))
    good = ServingFrontend(_engine(tm, name="r2"))

    async def run():
        async with router:
            router.quiesce(0)
            for _ in range(3):
                await router.submit([2, 3, 5], max_new_tokens=2)
            router.quiesce(1)
            with pytest.raises(NoReplicaAvailable, match="quiesced"):
                await router.submit([2, 3], max_new_tokens=1)
            with pytest.raises(ValueError, match="block_size"):
                await router.add_replica(bad)
            with pytest.raises(ValueError, match="role"):
                await router.add_replica(good, role="oracle")
            assert await router.add_replica(good) == 2
            assert len(router.health) == 3
            assert router.is_drained(2)
            task = asyncio.ensure_future(
                router.submit(PROMPTS[0], max_new_tokens=8))
            await asyncio.sleep(0.01)
            assert not router.is_drained(2)
            out = await task
            for _ in range(200):
                if router.is_drained(2):
                    break
                await asyncio.sleep(0.005)
            assert router.is_drained(2)
            router.unquiesce(0)
            router.unquiesce(1)
            return out
    assert asyncio.run(run()) == refs[8][0]
    assert fes[0].engine.prefix_cache.cached_blocks == 0
    assert fes[1].engine.prefix_cache.cached_blocks > 0
    assert router.stats()["quiesced"] == []


def test_rolling_upgrade_refuses_a_single_replica(models):
    _, tm1, _ = models["v1"]
    _, tm2, _ = models["v2"]
    router = ReplicaRouter(_fes(tm1, 1))

    async def run():
        async with router:
            with pytest.raises(ValueError, match=">= 2"):
                await rolling_upgrade(router, weights_from_model(tm2), "v2")
    asyncio.run(run())


def test_rolling_upgrade_is_lossless_and_versions_flip(models):
    _, tm1, refs1 = models["v1"]
    _, tm2, refs2 = models["v2"]
    fes = _fes(tm1)
    for fe in fes:
        fe.engine.generate_batch([[7, 7]], max_new_tokens=1)
    router = ReplicaRouter(fes, probe_interval=0.02)
    w2 = weights_from_model(tm2)
    flips = []

    async def run():
        async with router:
            tasks = [asyncio.ensure_future(
                router.submit(list(p), max_new_tokens=6)) for p in PROMPTS]
            await asyncio.sleep(0.005)
            flipped = await rolling_upgrade(router, w2, "v2",
                                            on_flip=flips.append)
            outs = await asyncio.gather(*tasks)
            post = await asyncio.gather(
                *[router.submit(list(p), max_new_tokens=6)
                  for p in PROMPTS])
            return flipped, outs, post
    flipped, outs, post = asyncio.run(run())
    assert sorted(flipped) == [0, 1] == sorted(flips)
    assert post == refs2[6]
    assert router.stats()["versions"] == ["v2", "v2"]
    assert router.stats()["quiesced"] == []
    for o, r1, r2 in zip(outs, refs1[6], refs2[6]):
        assert o == r1 or o == r2            # never a mid-request mix


# ---------------------------------------------------------- autoscaler


class _FakeFE:
    class engine:
        flight = None


class _FakeRouter:
    class _FES:
        def __getitem__(self, i):
            return _FakeFE()
    frontends = _FES()

    def __init__(self):
        self.depths = {}

    def queue_depth(self, i):
        return self.depths.get(i, 0)


class _FakeController:
    def __init__(self, clock):
        self.router = _FakeRouter()
        self.clock = clock
        self.n = 1

    def active_replicas(self):
        return list(range(self.n))

    async def scale_up(self, reason):
        self.n += 1
        return self.n - 1

    async def scale_down(self, reason):
        self.n -= 1
        return self.n


def _scaler(scaler_cls, monitor_cls, **pol):
    clk = [100.0]
    mon = monitor_cls({"default": {"ttft_p95": 0.1}, "window_s": 1e9},
                      clock=lambda: clk[0])
    ctl = _FakeController(lambda: clk[0])
    pol = dict(dict(min_replicas=1, max_replicas=2, sustain_s=1.0,
                    recovery_s=2.0, cooldown_s=3.0), **pol)
    policy_cls = (AutoscalerPolicy if scaler_cls is SLOAutoscaler
                  else jfleet.AutoscalerPolicy)
    return clk, mon, ctl, scaler_cls(ctl, mon, clock=lambda: clk[0],
                                     policy=policy_cls(**pol))


async def _hysteresis(clk, mon, ctl, scaler):
    got = []
    mon.on_ttft("t", 5.0, clk[0])
    got.append(await scaler.step())             # not sustained
    clk[0] += 1.1
    got.append(await scaler.step())             # up
    mon.on_ttft("t", 5.0, clk[0])
    clk[0] += 1.5                               # inside the cooldown
    got.append(await scaler.step())
    mon._ttft.clear()                           # the burn ends
    mon.on_ttft("t", 0.01, clk[0])
    got.append(await scaler.step())             # not recovered yet
    clk[0] += 2.5
    got.append(await scaler.step())             # down
    clk[0] += 10.0                              # the min_replicas floor
    got.append(await scaler.step())
    return got


async def _max_replicas(clk, mon, ctl, scaler):
    mon.on_ttft("t", 5.0, clk[0])
    clk[0] += 1.1
    return [await scaler.step()]


async def _cost_gate(clk, mon, ctl, scaler):
    ctl.n = 2
    ctl.router.depths = {0: 40, 1: 40}
    scaler.mean_step_seconds = lambda: 0.05     # 80 / 1 x 0.05 >> 0.1
    mon.on_ttft("t", 0.01, clk[0])
    got = [await scaler.step()]                 # the recovery clock starts
    clk[0] += 2.5
    got.append(scaler.predict_ttft(-1))
    got.append(await scaler.step())             # the cost model blocks
    ctl.router.depths = {}
    clk[0] += 1.0
    got.append(await scaler.step())             # down
    return got


async def _predictions(clk, mon, ctl, scaler):
    ctl.n = 2
    ctl.router.depths = {0: 6, 1: 2}
    scaler.mean_step_seconds = lambda: 0.01
    return [scaler.queued_requests(), scaler.predict_ttft(),
            scaler.predict_ttft(+1), scaler.predict_inter_token(),
            scaler.evaluate()]


SCALER_CASES = {"hysteresis": ({}, _hysteresis),
                "max-replicas": (dict(max_replicas=1), _max_replicas),
                "cost-gate": ({}, _cost_gate),
                "predictions": ({}, _predictions)}


@pytest.mark.parametrize("case", sorted(SCALER_CASES))
def test_autoscaler_decides_as_jax(case):
    pol, script = SCALER_CASES[case]
    runs = []
    for scaler_cls, monitor_cls in ((SLOAutoscaler, SLOMonitor),
                                    (jfleet.SLOAutoscaler, JaxSLOMonitor)):
        clk, mon, ctl, scaler = _scaler(scaler_cls, monitor_cls, **pol)
        got = asyncio.run(script(clk, mon, ctl, scaler))
        runs.append((got, scaler.decisions, ctl.n))
    assert runs[0] == runs[1]
    if case == "hysteresis":
        assert [d["direction"] for d in runs[0][1]] == ["up", "down"]
    if case == "cost-gate":
        assert runs[0][0][1] > 0.1 and runs[0][0][2] is None


# ---------------------------------------------------------- controller


def _lifecycle(pkg, models, tmp_path):
    """Boot, upgrade and retire on a 2-replica fleet of `pkg` ("jax" or
    "torch") under a fixed controller clock; returns the served tokens
    and the controller's state."""
    jm1, tm1, _ = models["v1"]
    jm2, tm2, _ = models["v2"]
    if pkg == "jax":
        eng0 = JaxEngine(jm1, name="r0", **ENG_KW)
        bdir = jfleet.export_bundle(eng0, str(tmp_path / pkg), version="v1",
                                    include_executable=False)
        fes = [JaxFrontend(eng0, max_pending=16),
               JaxFrontend(JaxEngine(jm1, name="r1", **ENG_KW),
                           max_pending=16)]
        router = JaxRouter(fes, probe_interval=0.02)
        ctl = jfleet.FleetController(router, bdir, clock=lambda: 100.0,
                                     spill_dir=str(tmp_path / "jspill"))
        w2 = jfleet.weights_from_model(jm2)
    else:
        eng0 = _engine(tm1, name="r0")
        bdir = export_bundle(eng0, str(tmp_path / pkg), version="v1")
        fes = [ServingFrontend(eng0, max_pending=16),
               ServingFrontend(_engine(tm1, name="r1"), max_pending=16)]
        router = ReplicaRouter(fes, probe_interval=0.02)
        ctl = FleetController(router, bdir, clock=lambda: 100.0,
                              spill_dir=str(tmp_path / "tspill"))
        w2 = weights_from_model(tm2)

    async def run():
        async with router:
            idx = await ctl.boot_replica(probe_prompt=[1, 2, 3])
            await ctl.rolling_upgrade(w2, "v2")
            outs = await asyncio.gather(
                *[router.submit(list(p), max_new_tokens=6)
                  for p in PROMPTS])
            eng = router.frontends[idx].engine
            spilled = await ctl.retire(idx)
            after = await asyncio.gather(
                *[router.submit(list(p), max_new_tokens=6)
                  for p in PROMPTS])
            a = await ctl.scale_up("ttft_p95")
            down = await ctl.scale_down("recovered")
            return (idx, outs, after, eng.kv.blocks_in_use, spilled > 0,
                    a, down, ctl.active_replicas(), sorted(ctl.retired))
    return asyncio.run(run())


def test_controller_and_fleet_metrics_match_jax(models, tmp_path,
                                                metrics_on):
    got = _lifecycle("torch", models, tmp_path)
    want = _lifecycle("jax", models, tmp_path)
    assert got == want
    idx, outs, after, blocks, spilled, a, down, active, retired = got
    assert idx == 2 and outs == after == models["v2"][2][6]
    assert blocks == 0 and spilled and (a, down) == (3, 3)
    assert active == [0, 1] and retired == [2, 3]
    tsnap, jsnap = tpm.REGISTRY.snapshot(), jpm.REGISTRY.snapshot()
    for name in FLEET_METRICS:
        assert tsnap[name] == jsnap[name], name
    boots = dict(tsm.FLEET_BOOTS.samples())
    assert boots[("cold",)].value == 2 == jsm.FLEET_BOOTS.labels(
        "cold").value
    assert tsm.FLEET_UPGRADES.value == 3


def test_create_fleet_controller(models, tmp_path):
    _, tm, refs = models["v1"]
    cfg = tinf.Config().enable_continuous_batching(
        max_pending=16, num_replicas=2, **{k: v for k, v in ENG_KW.items()
                                          if k != "seed"})
    router, ctl = tinf.create_fleet_controller(
        cfg, tm, bundle_root=str(tmp_path), version="v5", device="cpu")
    assert ctl.bundle.version == "v5" and ctl.device == torch.device("cpu")
    with open(os.path.join(str(tmp_path), "v5", "manifest.json")) as f:
        assert json.load(f)["engine"]["max_slots"] == 4

    async def run():
        async with router:
            idx = await ctl.boot_replica()
            router.quiesce(0)
            router.quiesce(1)
            out = await router.submit(PROMPTS[0], max_new_tokens=8)
            return idx, out, router.frontends[idx].engine.weights_version
    assert asyncio.run(run()) == (2, refs[8][0], "v5")
