"""paddle_tpu_torch's 1F1B pipeline on 8 gloo ranks at (pp 4, dp 2,
tp 1), as ``tests/test_pipeline_schedules.py::TestLlamaHybrid1F1B::
test_1f1b_matches_gpipe`` runs the JAX package (llama_tiny, 8 layers,
hidden 64, 4/4 heads, vocabulary 128, batch 8 x 33, ``n_micro`` 4),
without remat on either side (the dryrun test holds remat across the
mesh; here it would only add the checkpoint's recompute).

One 1F1B step against the reference's 1F1B step on its 8-device CPU
mesh from the same params: the loss, and the gathered params, m and v,
in float32 (``torch_hybrid_ranks``'s tolerances).  Then the port's GPipe
against its 1F1B over two steps, losses within the reference test's
2e-4; each device holds at most pp forward graphs under 1F1B and all
n_micro under GPipe (the reference's ring of stage inputs, and AD's).
"""
import numpy as np
import pytest

from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import llama_tiny

import torch_hybrid_ranks as R

DIMS = (4, 2, 1)
CFG = dict(num_hidden_layers=8, hidden_size=64, intermediate_size=128,
           vocab_size=128, num_attention_heads=4, num_key_value_heads=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


def test_1f1b_matches_the_reference_and_gpipe(ranks):
    cfg = llama_tiny(**CFG)
    mesh = H.build_mesh(8, *DIMS)
    params, opt = H.setup(cfg, mesh)
    ids = np.random.default_rng(0).integers(0, 128, (8, 33)).astype(np.int64)
    np_params = R.reference_tree(params)
    kw = dict(cfg_kw=CFG, dims=DIMS, np_params=np_params, ids=ids, steps=2)
    ranks.submit("hybrid_steps", runs=[
        dict(kw, step_kw=dict(n_micro=4, sp=False, remat=False,
                              schedule=sched)) for sched in ("1f1b", "gpipe")])
    loss, params, opt = H.build_train_step(
        cfg, mesh, n_micro=4, sp=False, remat=False, schedule="1f1b")(
            params, opt, ids)
    one, gpipe = zip(*ranks.collect())
    R.assert_matches_reference(
        one, float(loss), {"params": R.reference_tree(params),
                           "m": R.reference_tree(opt.m),
                           "v": R.reference_tree(opt.v)}, DIMS)
    np.testing.assert_allclose([r["losses"] for r in gpipe],
                               [r["losses"] for r in one], rtol=2e-4)
    assert one[0]["losses"][1] < one[0]["losses"][0]
    assert max(r["max_in_flight"] for r in one) <= DIMS[0]
    assert max(r["max_in_flight"] for r in gpipe) == 4
