"""The port's block-sparse KV decode against the JAX package's.

`ServingEngine(sparse_blocks=B, sparse_recent=r)` keeps channel-wise
min/max key summaries of every pool block (updated on append), scores a
decode's blocks by an upper bound of q.k, and attends the decode region
through a shortened `[S, Bt]` table with compacted positions. At
tests/test_multitick.py's sizes (vocab 193, hidden 32, 2 layers, 4
heads, max_slots=4, block_size=4, fp32, CPU, the same weights carried
across by `paddle_tpu_torch.convert`):

* `select_blocks` equals the JAX step's own (taken from the closure of
  its step body) on random inputs from a numpy seed: shortened tables
  and compacted positions exactly, ties at the cut, slots with fewer
  than Bt blocks, K = 1 and K = 4;
* the summary update: chunks that write many entries of one block, a
  freed block taken again, against the keys in the pool and JAX's
  engine;
* `pack_step` / `choose_token_budget` with `reserve_region` equal JAX's;
* at full coverage the engine equals the dense engine; at real sparsity
  (`sparse_blocks=1`, `sparse_recent=1`) it equals JAX's sparse engine
  in tokens and candidate / selected block counts, with draft_k=3,
  under preemption, at 4 ticks and over an int8 pool;
* the bad knobs are refused as JAX refuses them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving import batcher as jb
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.serving import batcher as tb
from paddle_tpu_torch.serving.engine import ServingEngine, select_blocks
from paddle_tpu_torch.serving.kv_cache import SUMMARY_INIT

VOCAB, HEADS, NEW = 193, 4, 8


def _carry(jm):
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    arrays = {n: np.asarray(t._data) for n, t in zip(names, tensors)}
    return load_jax_gpt(arrays, HEADS, device="cpu")


@pytest.fixture(scope="module")
def models():
    """(jax model, port model on the CPU) with the same weights."""
    paddle.seed(1234)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32")
    jm.eval()
    return jm, _carry(jm)


def _prompts():
    """Prompts of 3-38 tokens: up to 10 blocks of 4 a slot."""
    rng = np.random.RandomState(5)
    return [rng.randint(1, VOCAB, n).tolist()
            for n in (30, 9, 38, 3, 21, 14)]


def _kw(**kw):
    return dict(dict(max_slots=4, block_size=4, max_seq_len=64,
                     cache_dtype="float32", seed=0), **kw)


def _jax(jm, **kw):
    eng = JaxEngine(jm, **_kw(**kw))
    return eng.generate_batch(_prompts(), max_new_tokens=NEW), eng


def _port(tm, **kw):
    eng = ServingEngine(tm, device="cpu", **_kw(**kw))
    return eng.generate_batch(_prompts(), max_new_tokens=NEW), eng


# ------------------------------------------------------- select_blocks


def _jax_select(jm, S, BS, MB, K, B, recent):
    """The JAX step's `select_blocks` for an engine of that geometry
    (its table width and recency window come from the engine)."""
    je = JaxEngine(jm, max_slots=S, block_size=BS, max_seq_len=MB * BS,
                   cache_dtype="float32", draft_k=K - 1, sparse_blocks=B,
                   sparse_recent=recent)
    step = je._step_body(je._step_cfg())
    free = dict(zip(step.__code__.co_freevars,
                    (c.cell_contents for c in step.__closure__)))
    return free["select_blocks"], je.sparse_table_width, je._sparse_recent


def _select_case(seed, S, K, BS, MB, NB, H, Dh, ties):
    """Random region inputs: positions (one slot short of Bt blocks,
    one at position 0), tables of distinct blocks, summaries; with
    `ties`, every slot's blocks 1..4 share one summary row, so their
    scores tie exactly and straddle the cut."""
    rng = np.random.RandomState(seed)
    q = rng.randn(S, K, H, Dh).astype(np.float32)
    last = rng.randint(0, MB * BS - K + 1, S)
    last[0], last[-1] = BS + 1, 0          # 2 blocks; a slot at pos 0
    pos = (last[:, None] + np.arange(K)[None, :]).astype(np.int32)
    bt = np.zeros((S, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    for s in range(S):
        n = int(pos[s].max()) // BS + 1
        bt[s, :n] = perm[s * MB:s * MB + n]
    smin = rng.randn(NB, H, Dh).astype(np.float32)
    smax = smin + rng.rand(NB, H, Dh).astype(np.float32)
    if ties:
        for s in range(S):
            smin[bt[s, 2:5]] = smin[bt[s, 1]]
            smax[bt[s, 2:5]] = smax[bt[s, 1]]
    return q, pos, bt, smin, smax


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_blocks_matches_jax(models, K, ties, seed):
    jm, _ = models
    S, BS, MB, NB, H, Dh = 4, 4, 16, 70, HEADS, 8
    fn, Bt, recent = _jax_select(jm, S, BS, MB, K, B=3, recent=1)
    q, pos, bt, smin, smax = _select_case(seed, S, K, BS, MB, NB, H, Dh,
                                          ties)
    want_bt, want_pos = fn(jnp.asarray(q), jnp.asarray(pos),
                           jnp.asarray(bt), jnp.asarray(smin),
                           jnp.asarray(smax))
    got_bt, got_pos = select_blocks(
        torch.from_numpy(q), torch.from_numpy(pos), torch.from_numpy(bt),
        torch.from_numpy(smin), torch.from_numpy(smax), Bt, recent, BS)
    assert got_bt.dtype == got_pos.dtype == torch.int32
    assert got_bt.shape == (S, Bt) and got_pos.shape == (S, K)
    np.testing.assert_array_equal(got_bt.numpy(), np.asarray(want_bt))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    # a slot of fewer than Bt blocks keeps them all, NULL-padded, and
    # its positions stay where they were
    n0 = int(pos[0].max()) // BS + 1
    assert n0 < Bt
    np.testing.assert_array_equal(got_bt[0, :n0].numpy(), bt[0, :n0])
    assert not got_bt[0, n0:].any()
    np.testing.assert_array_equal(got_pos[0].numpy(), pos[0])


def test_select_blocks_tie_goes_to_the_lower_index():
    """Four blocks of one score compete for two places: the two of the
    lower table index win (as jax.lax.top_k breaks ties)."""
    S, BS, MB, H, Dh = 1, 4, 8, 1, 2
    bt = torch.arange(1, MB + 1, dtype=torch.int32)[None]
    smin = torch.zeros(MB + 1, H, Dh)
    smax = torch.ones(MB + 1, H, Dh)
    smax[bt[0, 5]] = 2.0                     # one clear winner
    q = torch.ones(S, 1, H, Dh)
    pos = torch.tensor([[MB * BS - 1]], dtype=torch.int32)
    # Bt = 1 sink + 1 recent + 3 picked: block 5, then 1 and 2 of the
    # tied 1..4 and 6
    short, pos_c = select_blocks(q, pos, bt, smin, smax, 5, 1, BS)
    assert short.tolist() == [[1, 2, 3, 6, 8]]
    assert pos_c.tolist() == [[4 * BS + BS - 1]]


# ----------------------------------------------------------- summaries


def _summary_reference(kv, slot, n_tokens):
    """Each of the slot's blocks' min and max over its keys in the pool
    (entries 0 .. written - 1), per layer: [L, n, H, Dh] each."""
    BS = kv.block_size
    blocks = kv.slot_blocks(slot)
    lo, hi = [], []
    for j, b in enumerate(blocks):
        w = min(BS, n_tokens - j * BS)
        keys = kv.k_pool[:, b, :w].float()               # [L, w, H, Dh]
        lo.append(keys.amin(dim=1))
        hi.append(keys.amax(dim=1))
    return torch.stack(lo, 1), torch.stack(hi, 1)


def test_summaries_follow_the_pool(models):
    """After chunked prefills (one chunk writes up to every entry of a
    block) and decodes, and after preemption hands freed blocks to other
    requests (num_blocks=20), every resident slot's summary rows are the
    min / max of the keys its blocks hold; and JAX's engine of the same
    config keeps the same summaries (fp32 keys, to 1e-5)."""
    jm, tm = models
    kw = _kw(num_blocks=20, track_summaries=True)
    eng = ServingEngine(tm, device="cpu", **kw)
    je = JaxEngine(jm, **kw)
    for e in (eng, je):
        for p in _prompts():
            e.submit(p, NEW)
    checked = 0
    for _ in range(40):
        if not eng.scheduler.has_work:
            break
        eng.step()
        je.step()
        kv = eng.kv
        for slot, req in enumerate(eng.scheduler.slots):
            if req is None or not kv.slot_num_blocks(slot):
                continue
            n = int(kv.slot_lens[slot])
            if n == 0:
                continue
            lo, hi = _summary_reference(kv, slot, n)
            idx = torch.tensor(kv.slot_blocks(slot)[:lo.shape[1]])
            assert torch.equal(kv.k_sum_min[:, idx], lo)
            assert torch.equal(kv.k_sum_max[:, idx], hi)
            np.testing.assert_allclose(
                np.asarray(je.kv.k_sum_min)[:, idx.numpy()], lo.numpy(),
                rtol=1e-5, atol=1e-5)
            checked += 1
    assert eng.scheduler.preemption_count > 0 and checked > 20
    # rows start at the empty sentinel
    fresh = ServingEngine(tm, device="cpu", **kw).kv
    assert (fresh.k_sum_min == SUMMARY_INIT).all()
    assert (fresh.k_sum_max == -SUMMARY_INIT).all()


def test_kv_bytes_per_token_counts_summaries(models):
    _, tm = models
    plain = ServingEngine(tm, device="cpu", **_kw())
    tracked = ServingEngine(tm, device="cpu", **_kw(track_summaries=True))
    L, H, Dh, BS = 2, HEADS, 8, 4
    assert tracked.kv.kv_bytes_per_token == plain.kv.kv_bytes_per_token \
        + L * 2 * H * Dh * 4 // BS


# -------------------------------------------------------- region layout


def test_pack_step_reserve_region_matches_jax():
    decode = [(2, 7, 5), (0, 9, 3)]
    prefills = [(1, np.arange(4, dtype=np.int32), 0, False),
                (3, np.arange(3, dtype=np.int32) + 50, 6, True)]
    for vw in (1, 4):
        budget = 32 if vw > 1 else 16
        want = jb.pack_step(budget, 4, decode if vw == 1 else
                            [(s, [t, 1, 2], p) for s, t, p in decode],
                            prefills, verify_width=vw, reserve_region=True)
        got = tb.pack_step(budget, 4, decode if vw == 1 else
                           [(s, [t, 1, 2], p) for s, t, p in decode],
                           prefills, verify_width=vw, reserve_region=True)
        for name in ("token_ids", "slot_ids", "positions", "sample_index"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert got.prefill_done == want.prefill_done
        assert got.num_tokens == want.num_tokens
    # slot s's decode sits at flat index s and samples there
    sp = tb.pack_step(16, 4, decode, [], reserve_region=True)
    assert sp.slot_ids[:4].tolist() == [0, -1, 2, -1]
    assert sp.sample_index[2] == 2 and sp.sample_index[0] == 0
    with pytest.raises(ValueError):
        tb.pack_step(8, 4, decode, [(1, np.arange(5, dtype=np.int32), 0,
                                     False)], reserve_region=True)


def test_choose_token_budget_reserve_region_matches_jax():
    for slots in (1, 4, 8):
        for bs in (4, 16):
            for vw in (1, 4):
                for req in (None, 1, 5, 40):
                    assert tb.choose_token_budget(
                        slots, bs, req, verify_width=vw,
                        reserve_region=True) == jb.choose_token_budget(
                        slots, bs, req, verify_width=vw,
                        reserve_region=True)


# ------------------------------------------------------------- engines


def test_full_coverage_equals_dense(models):
    """sparse_blocks at the slot's whole table (16 blocks) selects every
    allocated block: the dense engine's tokens, nothing skipped."""
    jm, tm = models
    want, _ = _jax(jm)
    dense, _ = _port(tm)
    got, eng = _port(tm, sparse_blocks=16)
    assert got == dense == want
    assert eng.sparse_table_width == 16
    assert eng.sparse_skip_ratio() == 0.0
    assert eng.sparse_candidate_blocks > 0
    assert eng.kv.blocks_in_use == 0


@pytest.mark.parametrize("case", [
    dict(),
    dict(draft_k=3),
    dict(num_blocks=20),
    dict(ticks_per_dispatch=4),
    dict(kv_dtype="int8"),
    dict(kv_dtype="int8", draft_k=3, num_blocks=20),
], ids=["plain", "draft3", "preempt", "ticks4", "int8", "int8-draft3-preempt"])
def test_real_sparsity_matches_jax(models, case):
    jm, tm = models
    kw = dict(sparse_blocks=1, sparse_recent=1, **case)
    want, je = _jax(jm, **kw)
    got, eng = _port(tm, **kw)
    assert got == want
    assert eng.sparse_table_width == je.sparse_table_width
    assert eng.sparse_candidate_blocks == je.sparse_candidate_blocks
    assert eng.sparse_selected_blocks == je.sparse_selected_blocks
    assert 0.0 < eng.sparse_skip_ratio() < 1.0
    assert eng.scheduler.preemption_count == je.scheduler.preemption_count
    if "num_blocks" in case:
        assert eng.scheduler.preemption_count > 0
    assert eng.kv.blocks_in_use == 0


def test_sparse_draft_at_ticks_matches_one_tick(models):
    """draft_k=3 at 4 ticks over real sparsity: the port's loop feeds a
    decode's drafts past the clamp as padding (as `pack_step` leaves
    them), so each group's selection is the 1-tick engine's and the
    tokens equal JAX's 1-tick sparse engine's. (JAX's own loop feeds
    them, and their positions widen its selection's recency window.)"""
    jm, tm = models
    kw = dict(sparse_blocks=1, sparse_recent=1, draft_k=3)
    want, _ = _jax(jm, **kw)
    one, _ = _port(tm, **kw)
    got, eng = _port(tm, ticks_per_dispatch=4, **kw)
    assert got == one == want
    assert eng.device_ticks_run > eng.dispatches_run


def test_bad_knobs_refused_as_jax(models):
    jm, tm = models
    for bad in (dict(sparse_blocks=0), dict(sparse_blocks=-2),
                dict(sparse_blocks=2, track_summaries=False)):
        with pytest.raises(ValueError, match="sparse_blocks"):
            JaxEngine(jm, **_kw(**bad))
        with pytest.raises(ValueError, match="sparse_blocks"):
            ServingEngine(tm, device="cpu", **_kw(**bad))
    # the recency window covers a verify group's writes; "auto" takes
    # the untuned default, 8
    eng = ServingEngine(tm, device="cpu", **_kw(sparse_blocks="auto",
                                                sparse_recent=1, draft_k=7))
    je = JaxEngine(jm, **_kw(sparse_blocks=8, sparse_recent=1, draft_k=7))
    assert (eng.sparse_blocks, eng._sparse_recent,
            eng.sparse_table_width) == (8, 3, 12) == (
        je.sparse_blocks, je._sparse_recent, je.sparse_table_width)
    assert eng.token_budget == je.token_budget
