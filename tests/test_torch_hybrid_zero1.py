"""paddle_tpu_torch's ZeRO-1 with gradient accumulation on 8 gloo ranks
at (pp 1, dp 8, tp 1) against the JAX package on its 8-device CPU mesh:
llama_tiny at 2 layers, hidden 64, FFN 128, vocabulary 128, batch
16 x 33, ``grad_accum`` 2, ``zero1``, without remat on either side (the
dryrun test holds remat across a mesh).

Each dp rank keeps the float32 AdamW m and v of its eighth of every
leaf that 8 divides (the rest whole); after one step the gathered
params, m and v equal the reference's (``torch_hybrid_ranks``'s
tolerances), the gradients travel as reduce-scatters and the updated
parts as all-gathers over dp, and the rank's state is an eighth of the
whole.
"""
import numpy as np
import pytest

from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import llama_tiny

import torch_hybrid_ranks as R

DIMS = (1, 8, 1)
CFG = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
           vocab_size=128)
STEP = dict(grad_accum=2, sp=False, remat=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


def test_zero1_with_grad_accum_matches_the_reference(ranks):
    cfg = llama_tiny(**CFG)
    mesh = H.build_mesh(8, *DIMS)
    params, opt = H.setup(cfg, mesh, zero1=True)
    ids = np.random.default_rng(3).integers(0, 128, (16, 33)).astype(
        np.int64)
    ranks.submit("hybrid_step", cfg_kw=CFG, dims=DIMS,
                 np_params=R.reference_tree(params), ids=ids, step_kw=STEP,
                 zero1=True)
    loss, params, opt = H.build_train_step(cfg, mesh, zero1=True, **STEP)(
        params, opt, ids)
    results = ranks.collect()
    R.assert_matches_reference(
        results, float(loss), {"params": R.reference_tree(params),
                               "m": R.reference_tree(opt.m),
                               "v": R.reference_tree(opt.v)}, DIMS)
    whole = sum(a.size for a in R.flat(results[0]["params"]).values())
    part = sum(a.size for a in R.flat(results[0]["m"]).values())
    assert part == whole // 8            # every leaf here divides by 8
    for r in results:
        c = r["counters"]
        assert c["reduce_scatter"][0] == c["all_gather"][0] > 0
