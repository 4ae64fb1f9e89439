"""paddle_tpu_torch's interleaved (VPP) 1F1B with tensor parallelism on
8 gloo ranks at (pp 2, dp 2, tp 2), v 2, as ``tests/
test_pipeline_schedules.py::TestLlamaHybrid1F1B::test_interleaved_with_tp``
runs the JAX package (llama_tiny, 8 layers, hidden 64, 4/4 heads,
vocabulary 128, batch 8 x 33, ``n_micro`` 4, no sp), without remat on either side (the
dryrun test holds remat across a mesh).

One step from the reference's ``H.setup(..., n_virtual=2)`` params
against the reference's on its 8-device CPU mesh: the loss, and the
gathered params, m and v (``torch_hybrid_ranks``'s tolerances); over
three steps the loss falls, as the reference test asserts.
"""
import numpy as np
import pytest

from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import llama_tiny

import torch_hybrid_ranks as R

DIMS = (2, 2, 2)
CFG = dict(num_hidden_layers=8, hidden_size=64, intermediate_size=128,
           vocab_size=128, num_attention_heads=4, num_key_value_heads=4)
STEP = dict(n_micro=4, sp=False, schedule="1f1b", remat=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


def test_interleaved_with_tp_matches_the_reference(ranks):
    cfg = llama_tiny(**CFG)
    mesh = H.build_mesh(8, *DIMS)
    params, opt = H.setup(cfg, mesh, n_virtual=2)
    ids = np.random.default_rng(1).integers(0, 128, (8, 33)).astype(np.int64)
    ranks.submit("hybrid_step", cfg_kw=CFG, dims=DIMS,
                 np_params=R.reference_tree(params), ids=ids, step_kw=STEP,
                 n_virtual=2, steps=3)
    loss, params, opt = H.build_train_step(cfg, mesh, n_virtual=2, **STEP)(
        params, opt, ids)
    results = ranks.collect()
    R.assert_matches_reference(
        results, float(loss), {"params": R.reference_tree(params),
                               "m": R.reference_tree(opt.m),
                               "v": R.reference_tree(opt.v)}, DIMS, 2)
    losses = results[0]["losses"]
    assert losses[2] < losses[1] < losses[0]
    assert max(r["max_in_flight"] for r in results) <= 2 * 2 * 2
