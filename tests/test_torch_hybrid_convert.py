"""``models/convert.py`` carries the JAX package's hybrid trees to the
ranks of a mesh and back: the reference's ``H.setup`` params (stage
leaves ``[pp, lps, ...]``, or ``[pp, v, lps, ...]`` interleaved) and its
AdamW m and v, ZeRO-1's dp-sharded ones included, cut into the 8 ranks'
shards by ``hybrid_params_from_numpy(..., rank=, mesh=)`` and gathered
back by ``hybrid_params_to_numpy`` bit for bit, on each mesh of the
hybrid tests.  Each rank holds the layers of its virtual stages
{c·pp + p}, its tp column or row slice of each matrix, and under ZeRO-1
its flat 1/dp of each state leaf that dp divides.
"""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import llama_tiny as j_llama_tiny
from paddle_tpu_torch.models import (hybrid_params_from_numpy,
                                     hybrid_params_to_numpy)
from paddle_tpu_torch.models import llama_hybrid as TH

KW = dict(num_hidden_layers=8, hidden_size=64, intermediate_size=128,
          vocab_size=128, num_attention_heads=4, num_key_value_heads=4)


def np_tree(tree, fill=None):
    """The tree as float32 numpy; ``fill`` replaces each leaf by distinct
    values (a zero AdamW state would round-trip vacuously)."""
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) if fill is None else
                   rng.standard_normal(a.shape).astype(np.float32)), tree)


@pytest.mark.parametrize("dims,v,zero1", [
    ((2, 2, 2), 2, True), ((4, 2, 1), 1, False), ((1, 2, 4), 1, False),
    ((1, 8, 1), 1, True), ((2, 2, 2), 1, False)],
    ids=["dryrun_222_v2_zero1", "pp4_dp2", "tp4_dp2", "dp8_zero1",
         "222"])
def test_rank_shards_round_trip(dims, v, zero1):
    cfg = j_llama_tiny(**KW)
    mesh = H.build_mesh(8, *dims)
    params, opt = H.setup(cfg, mesh, n_virtual=v, zero1=zero1)
    trees = {"params": np_tree(params), "m": np_tree(opt.m, fill=True)}
    pmesh = dict(zip(("pp", "dp", "tp"), dims))
    shards = [hybrid_params_from_numpy(trees["params"], device="cpu",
                                       rank=r, mesh=pmesh, n_virtual=v)
              for r in range(8)]
    states = [hybrid_params_from_numpy(trees["m"], device="cpu", rank=r,
                                       mesh=pmesh, n_virtual=v, zero1=zero1)
              for r in range(8)]
    for key, got in (("params", hybrid_params_to_numpy(
            shards, mesh=pmesh, n_virtual=v)),
            ("m", hybrid_params_to_numpy(states, mesh=pmesh, n_virtual=v,
                                         like=shards))):
        want = trees[key]
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w)
    pp, dp, tp = dims
    L = KW["num_hidden_layers"]
    for r, (tree, state) in enumerate(zip(shards, states)):
        assert len(tree["stages"]) == L // pp
        assert tree["stages"][0]["q"].shape == (64, 64 // tp)
        assert tree["stages"][0]["o"].shape == (64 // tp, 64)
        assert tree["embed"].shape == (128, 64 // tp)
        assert tree["head"].shape == (64, 128 // tp)
        for p, s in zip(TH.tree_leaves(tree), TH.tree_leaves(state)):
            n = p.numel() // dp if zero1 and p.numel() % dp == 0 \
                else p.numel()
            assert s.numel() == n and s.dtype == torch.float32
        # the layers of stage p, chunk by chunk: virtual stages c·pp + p
        p = r // (dp * tp)
        assert TH.rank_layers(L, pp, p, v) == [
            (c * pp + p) * (L // (pp * v)) + i for c in range(v)
            for i in range(L // (pp * v))]


def test_single_device_tree_takes_any_stage_layout():
    """Without a mesh the whole model, in model order, whatever the
    reference's stage layout: a (pp 2, v 2) tree equals the pp 1 tree of
    the same layers."""
    cfg = j_llama_tiny(**KW)
    params = np_tree(H.init_params(cfg, 2, jax.random.key(0),
                                   n_virtual=2))
    tree = hybrid_params_from_numpy(params, device="cpu")
    assert len(tree["stages"]) == 8
    lps = 2
    for k, a in params["stages"].items():
        for li, lp in enumerate(tree["stages"]):
            kv, i = divmod(li, lps)
            c, p = divmod(kv, 2)
            np.testing.assert_array_equal(lp[k].numpy(), a[p, c, i])
    back = hybrid_params_to_numpy(tree)
    assert back["stages"]["q"].shape == (1, 8, 64, 64)
