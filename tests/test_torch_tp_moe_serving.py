"""The port's TP x EP serving of MoE stacks against the JAX package's.

A MoE stack's experts split over the `ep` ranks and each expert's FFN
over the `mp` ranks (`parallel.mp_layers.SERVING_MOE_TP_SPECS`). CPU
ranks over gloo (`torch_tp_ranks.run_ranks`: one spawn of two ranks for
(tp, ep) = (1, 2) and (2, 1), one of four for (2, 2)) serve the prompts
of tests/test_torch_tp_serving.py on a 4-expert top-2 stack (capacity
factor 2.0, so nothing is dropped), and JAX's
`TPServingEngine(tensor_parallel=tp, expert_parallel=ep)` serves them on
the conftest's virtual devices, on the same weights, in fp32. Tolerance
0: tokens, the routing counts (the same on every rank: the token set and
the routing are replicated, so they are not reduced) and
`moe_dropped_total == 0`, float experts, engine-side int8 experts and
draft_k=3 at (2, 2); every rank's tokens, counts and allocator ledger
equal every other's.
"""
import numpy as np
import pytest

import torch_tp_ranks as tr
from test_torch_tp_serving import _arrays, _jax_model, _jax_serve


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(tp, ep): each rank's results}, and the JAX model."""
    jm = _jax_model(moe=tr.MOE)
    out = {}
    for (tp, ep), cases in tr.MOE_SCENARIOS.items():
        d = tmp_path_factory.mktemp(f"moe_tp{tp}_ep{ep}")
        np.savez(d / "moe.npz", **_arrays(jm))
        jobs = [dict(name=name, model="moe", tp=tp, ep=ep, kw=kw,
                     traffic="batch") for name, kw in cases]
        out[(tp, ep)] = tr.run_ranks(tp * ep, str(d), jobs)
    return jm, out


_CASES = [(tp, ep, name, kw) for (tp, ep), cases in
          tr.MOE_SCENARIOS.items() for name, kw in cases]


@pytest.mark.parametrize("tp,ep,name,kw", _CASES,
                         ids=[c[2] for c in _CASES])
def test_tp_ep_matches_jax_and_ranks_agree(ranks, tp, ep, name, kw):
    jm, out = ranks
    want = _jax_serve(jm, kw, "batch", tp=tp, ep=ep)
    results = [r[name] for r in out[(tp, ep)]]
    assert want["moe_dropped"] == 0
    for got in results:
        assert got["tokens"] == want["tokens"]
        assert got["states"] == want["states"]
        assert got["spec"] == want["spec"]
        assert got["moe_counts"] == want["moe_counts"]
        assert got["moe_dropped"] == 0
        assert got["blocks_in_use"] == 0
        assert got["allocator"] == results[0]["allocator"]
    assert sum(want["moe_counts"]) > 0
