"""paddle_tpu_torch's Megatron-SP under GPipe on 8 gloo ranks at (pp 1,
dp 2, tp 4) against the JAX package on its 8-device CPU mesh, and the
same with a pipeline at (pp 2, dp 2, tp 2): llama_tiny at hidden 64,
4/4 heads (tp 4 splits them one a rank), FFN 128, vocabulary 128,
batch 8 x 33, sp on (the sequence, 32, splits over tp), without remat on
either side (the dryrun test holds remat across a mesh).

One step each from the reference's params: the loss, and the gathered
params, m and v (``torch_hybrid_ranks``'s tolerances).  Under sp every
tp rank holds a quarter of the sequence between the layers: the
sequence all-gathers and reduce-scatters go through the collective
module, and the layer norms' gradients are summed over tp.
"""
import numpy as np
import pytest

from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import llama_tiny

import torch_hybrid_ranks as R

CFG = dict(hidden_size=64, intermediate_size=128, vocab_size=128,
           num_attention_heads=4, num_key_value_heads=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


@pytest.mark.parametrize("dims,layers,n_micro", [((1, 2, 4), 2, 1),
                                                 ((2, 2, 2), 4, 2)],
                         ids=["pp1_dp2_tp4", "pp2_dp2_tp2"])
def test_gpipe_sp_matches_the_reference(ranks, dims, layers, n_micro):
    kw = dict(CFG, num_hidden_layers=layers)
    cfg = llama_tiny(**kw)
    mesh = H.build_mesh(8, *dims)
    params, opt = H.setup(cfg, mesh)
    ids = np.random.default_rng(2).integers(0, 128, (8, 33)).astype(np.int64)
    step_kw = dict(n_micro=n_micro, sp=True, schedule="gpipe", remat=False)
    ranks.submit("hybrid_step", cfg_kw=kw, dims=dims,
                 np_params=R.reference_tree(params), ids=ids,
                 step_kw=step_kw)
    loss, params, opt = H.build_train_step(cfg, mesh, **step_kw)(
        params, opt, ids)
    results = ranks.collect()
    R.assert_matches_reference(
        results, float(loss), {"params": R.reference_tree(params),
                               "m": R.reference_tree(opt.m),
                               "v": R.reference_tree(opt.v)}, dims)
    for r in results:
        assert r["counters"]["reduce_scatter"][0] > 0     # sp's
