"""paddle_tpu_torch's hybrid-parallel step on 8 gloo ranks against the
JAX package's on its 8-device CPU mesh, at ``_dryrun_multichip_inproc``'s
own config (``__graft_entry__.py:135-199``): ``default_axes(8)`` =
(pp 2, dp 2, tp 2), interleaved VPP at v 2, the zero-bubble schedule,
ZeRO-1 and Megatron-SP (which the reference honours in GPipe only, so
here it is set and not used), ``n_micro`` 4, llama_tiny at 8 layers,
hidden 128, FFN 256, vocabulary 512, batch 32 x 65.

Both start from the reference's ``H.setup`` params (carried to each rank
by ``hybrid_params_from_numpy``) and take one step on the same batch;
the ranks' params, m and v are gathered back (``hybrid_params_to_numpy``)
and compared leaf by leaf, in float32 (``torch_hybrid_ranks``: loss 1e-5
relative, leaves 1e-4 relative by norm).  The step's traffic
goes through ``distributed.collective`` (its counters move), and the
in-flight forward graphs stay within the reference's ring of 2·v·pp.
"""
import numpy as np
import pytest

import jax

from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import llama_tiny

import torch_hybrid_ranks as R

DIMS = H.default_axes(8)
V = 2
CFG = dict(num_hidden_layers=2 * DIMS[0] * V, hidden_size=128,
           intermediate_size=256, vocab_size=512)
STEP = dict(n_micro=2 * DIMS[0], sp=True, schedule="zb")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


def test_dryrun_config_matches_the_reference(ranks):
    assert DIMS == (2, 2, 2)
    cfg = llama_tiny(**CFG)
    mesh = H.build_mesh(8, *DIMS)
    params, opt = H.setup(cfg, mesh, n_virtual=V, zero1=True)
    batch = 4 * DIMS[1] * (2 * DIMS[0])
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, 65)).astype(np.int64)
    ranks.submit("hybrid_step", cfg_kw=CFG, dims=DIMS,
                 np_params=R.reference_tree(params), ids=ids, step_kw=STEP,
                 n_virtual=V, zero1=True)
    loss, params, opt = H.build_train_step(
        cfg, mesh, n_virtual=V, zero1=True, **STEP)(params, opt, ids)
    results = ranks.collect()
    assert np.isfinite(float(loss))
    R.assert_matches_reference(
        results, float(loss), {"params": R.reference_tree(params),
                               "m": R.reference_tree(opt.m),
                               "v": R.reference_tree(opt.v)}, DIMS, V)
    for r in results:
        c = r["counters"]
        # tp all-reduces and gathers, sp reduce-scatters (ZeRO-1's over
        # dp), and the pipeline's messages, all through the module
        assert min(c[op][0] for op in ("all_reduce", "all_gather",
                                       "reduce_scatter", "isend")) > 0
        assert r["max_in_flight"] <= 2 * V * DIMS[0]
    assert sum(r["counters"]["isend"][1] for r in results) == \
        sum(r["counters"]["irecv"][1] for r in results)
