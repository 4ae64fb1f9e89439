"""paddle_tpu_torch MoE training (``models/moe_llm``) against the JAX
package's ``paddle_tpu.models.moe_llm`` on one device.

Both sides start from the reference ``init_params(cfg,
jax.random.key(0), jnp.float32)`` (carried across with
``moe_params_from_numpy``) and take the same int64 token batch (numpy,
from a seed); the MoE FFN runs the default "sort" dispatch on both.
Configurations: ``moe_tiny`` (2 layers, the reference's unrolled loop)
here; ``moe_tiny`` with 2 shared experts in
``test_torch_moe_llm_shared.py`` and 17 narrow layers (the reference's
``lax.scan`` branch) in ``test_torch_moe_llm_scan.py``, one file each
under the 20 s budget.

Compared, leaf by leaf (``moe_params_to_numpy``), in float32:
  * loss (CE + the router aux term): 1e-5 relative;
  * every grad: 1e-4 relative + 2e-6 absolute (f32 sums in another
    order; routing is identical, no two of the seeded probabilities
    come near a tie);
  * params after 1 and 3 SGD steps at lr 0.1 (the reference's update,
    with a rate large enough that the steps move the params):
    1e-4 relative + 1e-6 absolute.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import moe_llm as JM
from paddle_tpu_torch.models import (moe_params_from_numpy,
                                     moe_params_to_numpy)
from paddle_tpu_torch.models import moe_llm as TM

LR = 0.1
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def assert_trees_close(port_tree, jax_tree, what, **tol):
    got = moe_params_to_numpy(port_tree)
    want = to_np(jax_tree)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k in ("embed", "norm", "head"):
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **tol)
    for k in want["layers"]:
        np.testing.assert_allclose(got["layers"][k], want["layers"][k],
                                   err_msg=f"{what} layers.{k}", **tol)


def check_against_jax(**kw):
    """Loss, grads and params after 1 and 3 SGD steps of ``moe_tiny(**kw)``
    on both sides, from the reference's init."""
    jcfg, tcfg = JM.moe_tiny(**kw), TM.moe_tiny(**kw)
    mesh = JM.build_mesh(1, dp=1, ep=1)
    np_params = to_np(jax.jit(lambda k: JM.init_params(jcfg, k, jnp.float32))(
        jax.random.key(0)))
    ids = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 17)).astype(np.int64)

    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, i: JM.loss_fn(p, i, jcfg, mesh)))(jparams, jnp.asarray(ids))
    params = moe_params_from_numpy(np_params, device="cpu")
    assert params["layers"][0]["gate"].dtype == torch.float32
    tloss, tgrads = TM.value_and_grad(params, torch.from_numpy(ids), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert_trees_close(tgrads, jgrads, "grad", **GRAD_TOL)

    jstep = JM.build_train_step(jcfg, mesh, lr=LR)
    tstep = TM.build_train_step(tcfg, lr=LR, device="cpu")
    for n in range(3):
        jl, jparams = jstep(jparams, jnp.asarray(ids))
        tl, params = tstep(params, ids)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        if n in (0, 2):
            assert_trees_close(params, jparams, f"params after {n + 1}",
                               **PARAM_TOL)


def test_moe_tiny_matches_jax():
    check_against_jax()


def test_presets_and_single_device_rules():
    for fn in ("moe_tiny", "qwen2_moe_a14b", "deepseek_moe_16b"):
        assert vars(getattr(TM, fn)()) == vars(getattr(JM, fn)())
    assert TM.build_mesh() == {"dp": 1, "ep": 1}
    # more than one rank needs that many processes (test_torch_moe_llm_ep.py
    # runs them); a mapping serves one device
    with pytest.raises(ValueError, match="world of 2 processes"):
        TM.build_mesh(dp=1, ep=2)
    assert TM.param_shardings({"dp": 1, "ep": 1})["layers"]["w1"] == \
        (None, "ep", None, None)
    with pytest.raises(ValueError, match="ProcessMesh"):
        TM.build_train_step(TM.moe_tiny(), {"dp": 2, "ep": 1}, device="cpu")
    params = TM.setup(TM.moe_tiny(num_shared_experts=2, dtype="bfloat16"),
                      device="cpu")
    lp = params["layers"][0]
    assert lp["w1"].dtype == torch.bfloat16 and lp["gate"].dtype == \
        torch.float32
    assert lp["sw1"].shape == (128, 256) and lp["sw2"].shape == (256, 128)

