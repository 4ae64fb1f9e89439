"""paddle_tpu_torch's expert-parallel MoE training (``models/moe_llm``)
on 8 gloo ranks against the JAX package's on its 8-device CPU mesh
(``tests/test_moe_ring.py:149``): ``moe_tiny(num_hidden_layers=2,
num_experts=4, top_k=2, vocab_size=128)`` at (dp 2, ep 4) and (dp 4,
ep 2), 5 SGD steps at lr 1e-2 on one [4, 33] batch (sharded over dp on
both sides), and with 2 shared experts at (dp 2, ep 4), one step.

Both sides start from the reference's ``setup`` params, carried to each
rank's shard with ``moe_params_from_numpy(rank=, mesh=)`` and gathered
back with ``moe_params_to_numpy(mesh=)``.  Compared in float32: every
step's loss and ``loss_fn`` on every rank, 1e-5 relative; every
gathered param after the steps, 1e-4 relative + 1e-6 absolute (f32
sums in another order; routing is identical, no two seeded
probabilities come near a tie).
Each rank's shard holds E / ep experts and 1/ep of the shared experts'
inner dim, every other leaf whole; the converters' round trip is exact.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from paddle_tpu.models import moe_llm as JM
from paddle_tpu_torch.models import (moe_params_from_numpy,
                                     moe_params_to_numpy)

import torch_hybrid_ranks as R

LR = 1e-2
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
CFG = dict(num_hidden_layers=2, num_experts=4, top_k=2, vocab_size=128)
RUNS = {"dp2_ep4": ((2, 4), 0, 5), "dp4_ep2": ((4, 2), 0, 5),
        "dp2_ep4_shared": ((2, 4), 2, 1)}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _reference(dims, shared):
    """The reference's config, mesh and setup params (numpy)."""
    cfg = JM.moe_tiny(num_shared_experts=shared, **CFG)
    mesh = JM.build_mesh(8, *dims)
    return cfg, mesh, JM.setup(cfg, mesh)


def _reference_steps(cfg, mesh, params, steps, ids):
    step = JM.build_train_step(cfg, mesh, lr=LR)
    placed = jax.device_put(jnp.asarray(ids), NamedSharding(mesh,
                                                            P("dp", None)))
    losses = []
    for _ in range(steps):
        loss, params = step(params, placed)
        losses.append(float(loss))
    return losses, _np_tree(params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pool = R.RankPool(8, tmp_path_factory.mktemp("gloo"))
    try:
        ids = np.random.default_rng(0).integers(0, 128, (4, 33)).astype(
            np.int64)
        refs = {name: _reference(dims, shared)
                for name, (dims, shared, _) in RUNS.items()}
        np_params = {name: _np_tree(ref[2]) for name, ref in refs.items()}
        # the ranks run while the reference compiles and steps
        pool.submit("moe_llm_ep_runs", runs=[
            dict(cfg_kw=dict(CFG, num_shared_experts=shared), dims=dims,
                 np_params=np_params[name], ids=ids, steps=steps, lr=LR)
            for name, (dims, shared, steps) in RUNS.items()])
        steps = {name: _reference_steps(*refs[name], RUNS[name][2], ids)
                 for name in RUNS}
        ranks = list(zip(*pool.collect()))
        yield {name: (np_params[name], *steps[name], ranks[i])
               for i, name in enumerate(RUNS)}
    finally:
        pool.close()


def _gathered(results, dims):
    """The ranks' trees (numpy, stacked [L, ...]) in the reference's
    layout: dp row 0's ep shards concatenated along ``EP_DIM``."""
    from paddle_tpu_torch.models.moe_llm import EP_DIM
    row0 = [r["params"] for r in results[:dims[1]]]
    layers = {k: np.concatenate([t["layers"][k] for t in row0],
                                axis=EP_DIM[k] + 1) if k in EP_DIM
              else row0[0]["layers"][k] for k in row0[0]["layers"]}
    return dict(row0[0], layers=layers)


@pytest.mark.parametrize("name", list(RUNS))
def test_steps_match_reference(runs, name):
    _, losses, after, results = runs[name]
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    if len(losses) > 1:
        assert losses[-1] < losses[0]
    got, want = R.flat(_gathered(results, RUNS[name][0])), R.flat(after)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **PARAM_TOL)
    # the dp rows' copies of every leaf stay equal
    ep = RUNS[name][0][1]
    for i, r in enumerate(results):
        same = R.flat(results[i % ep]["params"])
        for key, a in R.flat(r["params"]).items():
            np.testing.assert_array_equal(a, same[key], err_msg=key)


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_fn_is_the_global_loss(runs, name):
    """``loss_fn`` of the starting params is the reference's first loss
    on every rank, whatever the rank's dp row."""
    _, losses, _, results = runs[name]
    for r in results:
        np.testing.assert_allclose(r["loss_fn"], losses[0], rtol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_each_rank_holds_its_shard(runs, name):
    (dp, ep), shared, _ = RUNS[name]
    h = f = 128
    for r in runs[name][3]:
        s = r["shapes"]
        assert s["w1"] == (4 // ep, h, f) and s["w2"] == (4 // ep, f, h)
        assert s["b1"] == (4 // ep, f) and s["b2"] == (4 // ep, h)
        assert s["q"] == (h, h) and s["gate"] == (h, 4)
        assert s["embed"] == (128, h) and s["head"] == (h, 128)
        if shared:
            assert s["sw1"] == (h, 2 * f // ep)
            assert s["sw2"] == (2 * f // ep, h)
        else:
            assert "sw1" not in s


@pytest.mark.parametrize("dims", [(2, 4), (4, 2), (8, 1), (1, 4)])
def test_convert_round_trip_is_exact(runs, dims):
    """Every rank's shard of the reference's tree (the shared-expert
    model's), gathered back, is the tree bit for bit."""
    np_params = runs["dp2_ep4_shared"][0]
    mesh = dict(zip(("dp", "ep"), dims))
    shards = [moe_params_from_numpy(np_params, device="cpu", rank=r,
                                    mesh=mesh) for r in range(dims[0] *
                                                              dims[1])]
    back = moe_params_to_numpy(shards, mesh=mesh)
    got, want = R.flat(back), R.flat(np_params)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ep = dims[1]
    for r, tree in enumerate(shards):
        lp = tree["layers"][0]
        j = r % ep
        np.testing.assert_array_equal(
            lp["w1"].numpy(), np_params["layers"]["w1"][0][
                j * 4 // ep:(j + 1) * 4 // ep])
        np.testing.assert_array_equal(
            lp["sw2"].numpy(), np_params["layers"]["sw2"][0][
                j * 256 // ep:(j + 1) * 256 // ep])
