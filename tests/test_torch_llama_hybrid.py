"""paddle_tpu_torch single-device Llama training (``models/llama_hybrid``)
against the JAX package's ``llama_hybrid`` at pp = dp = tp = 1.

Both sides start from the reference ``init_params(cfg, 1,
jax.random.key(0), jnp.float32)`` (carried across with
``hybrid_params_from_numpy``) and take the same int64 token batch (numpy,
from a seed).  On the CPU the JAX ``sdpa`` runs ``_xla_sdpa``; the port's
runs the plain flash forward/backward (``flash_mha`` on CPU tensors).

Compared, leaf by leaf (``hybrid_params_to_numpy``), in float32:
  * loss: 1e-6 relative (measured: identical);
  * every grad: 1e-4 relative + 2e-6 absolute (measured <= 1.2e-6 on
    O(1) entries);
  * params after 1 and 3 AdamW steps: 1e-4 relative + 2e-5 absolute —
    Adam divides by sqrt(v), so an update near an O(1e-7) grad
    difference can move by ~1e-5 (measured <= 5.2e-6);
  * AdamW m and v after 1 and 3 steps: 1e-4 relative + 1e-6 absolute.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import llama_tiny as j_llama_tiny
from paddle_tpu_torch.models import (hybrid_params_from_numpy,
                                     hybrid_params_to_numpy, llama_tiny)
from paddle_tpu_torch.models import llama_hybrid as TH

KW = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
          num_attention_heads=4, num_key_value_heads=2, vocab_size=128)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def assert_trees_close(port_tree, jax_tree, what, **tol):
    got = hybrid_params_to_numpy(port_tree)
    want = to_np(jax_tree)
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(paths) == len(jax.tree_util.tree_leaves(got))
    for (path, w), g in zip(paths, jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(
            g, w, err_msg=f"{what}{jax.tree_util.keystr(path)}", **tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_llama_tiny(**KW)
    params = H.init_params(jcfg, 1, jax.random.key(0), jnp.float32)
    ids = np.random.default_rng(0).integers(0, 128, (4, 17)).astype(np.int64)
    mesh = H.build_mesh(1, pp=1, dp=1, tp=1)
    return jcfg, llama_tiny(**KW), to_np(params), ids, mesh


def port_params(np_params):
    return hybrid_params_from_numpy(np_params, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(setup, remat):
    jcfg, tcfg, np_params, ids, mesh = setup
    jloss, jgrads = jax.value_and_grad(H.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(ids),
        jcfg, mesh, 1, remat, False)
    tloss, tgrads = TH.value_and_grad(port_params(np_params),
                                      torch.from_numpy(ids), tcfg,
                                      remat=remat)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert_trees_close(tgrads, jgrads, "grad", **GRAD_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_match_jax(setup, remat):
    """params, m and v after 1 and after 3 steps, and each step's loss."""
    jcfg, tcfg, np_params, ids, mesh = setup
    jstep = H.build_train_step(jcfg, mesh, remat=remat, sp=False)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jo = H.init_adamw(jp)
    tstep = TH.build_train_step(tcfg, remat=remat, device="cpu")
    tp = port_params(np_params)
    to = TH.init_adamw(tp)
    for i in range(3):
        jl, jp, jo = jstep(jp, jo, jnp.asarray(ids))
        tl, tp, to = tstep(tp, to, ids)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert to.step == int(jo.step) == i + 1
        if i in (0, 2):
            assert_trees_close(tp, jp, f"params, step {i + 1}", **PARAM_TOL)
            assert_trees_close(to.m, jo.m, f"m, step {i + 1}", **MOMENT_TOL)
            assert_trees_close(to.v, jo.v, f"v, step {i + 1}", **MOMENT_TOL)
    assert float(tl) < float(TH.value_and_grad(
        port_params(np_params), torch.from_numpy(ids), tcfg,
        remat=False)[0])


def test_params_round_trip_and_layout(setup):
    _, tcfg, np_params, _, _ = setup
    tree = port_params(np_params)
    assert isinstance(tree["stages"], list) and len(tree["stages"]) == 2
    leaves = TH.tree_leaves(tree)
    # one owned leaf per layer weight: no views into a stacked tensor
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    assert all(t._base is None for t in leaves)
    back = hybrid_params_to_numpy(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's shapes and scales
    own = TH.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(hybrid_params_to_numpy(own)),
                    jax.tree_util.tree_leaves(np_params)):
        assert a.shape == b.shape
        assert abs(a.std() - b.std()) <= 0.15 * b.std() + 1e-6


@pytest.mark.parametrize("kwargs,error", [
    (dict(mesh={"pp": 2, "dp": 1, "tp": 1}), "ProcessMesh"),
    (dict(mesh={"tp": 2}), "ProcessMesh"),
    (dict(zero1=True), None), (dict(schedule="1f1b"), None),
    (dict(n_virtual=2), "requires schedule='1f1b'"),
    (dict(remat="attn"), None)],
    ids=["pp2", "tp2", "zero1", "1f1b", "vpp", "remat_attn"])
def test_left_out_options_raise(setup, kwargs, error):
    """The hybrid options are ported: a mesh of pp or tp above 1 is a
    ProcessMesh of processes (a mapping of sizes raises), n_virtual > 1
    without a 1F1B schedule raises the reference's ValueError, and on one
    device zero1, schedule="1f1b" (GPipe at pp = 1, as in the reference)
    and remat="attn" take a step equal to the plain one."""
    _, tcfg, np_params, ids, _ = setup
    if error is not None:
        with pytest.raises(ValueError, match=error):
            TH.build_train_step(tcfg, device="cpu", **kwargs)
        return
    losses = []
    for kw in (kwargs, {}):
        tp = port_params(np_params)
        loss, tp, _ = TH.build_train_step(tcfg, device="cpu", **kw)(
            tp, TH.init_adamw(tp), ids)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    cfg = llama_tiny(**KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        TH.setup(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TH.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        TH.build_train_step(cfg)
    params, opt = TH.setup(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert opt.m["head"].dtype == torch.float32 and opt.step == 0
