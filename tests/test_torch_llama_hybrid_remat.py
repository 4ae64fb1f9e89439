"""paddle_tpu_torch's ``remat="attn"`` (keep the attention's output,
recompute the rest of each layer) against the JAX package's
``llama_hybrid`` at pp = dp = tp = 1, where ``jax.checkpoint`` saves
only the ``"attn_out"`` name.

Both start from the reference ``init_params`` (carried across with
``hybrid_params_from_numpy``) and take the same int64 token batch.
Compared in float32: the loss (1e-6 relative), every grad (1e-4
relative + 2e-6 absolute) and the params, m and v after two steps (the
single-device tolerances of ``test_torch_llama_hybrid.py``).

The plain attention forward (``_flash_fwd_xla``, what K1 is on the
card) runs once per layer per step under ``remat="attn"`` and twice
under ``remat=True``; its backward once either way.  The three remat
modes give the same grads.
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
from paddle_tpu_torch.ops.pallas import flash_attention as FA

KW = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
          num_attention_heads=4, num_key_value_heads=2, vocab_size=128)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_llama_tiny(**KW)
    params = H.init_params(jcfg, 1, jax.random.key(0), jnp.float32)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       params)
    ids = np.random.default_rng(0).integers(0, 128, (4, 17)).astype(np.int64)
    return jcfg, llama_tiny(**KW), np_params, ids, H.build_mesh(1)


def close(port_tree, jax_tree, what, **tol):
    got = jax.tree_util.tree_leaves(hybrid_params_to_numpy(port_tree))
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax_tree))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"{what} leaf {i}", **tol)


def counting(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = FA._flash_fwd_xla, FA._flash_bwd_xla

    def f(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def b(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    monkeypatch.setattr(FA, "_flash_fwd_xla", f)
    monkeypatch.setattr(FA, "_flash_bwd_xla", b)
    return calls


def test_remat_attn_matches_jax(setup, monkeypatch):
    jcfg, tcfg, np_params, ids, mesh = setup
    jloss, jgrads = jax.value_and_grad(H.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(ids),
        jcfg, mesh, 1, "attn", False)
    calls = counting(monkeypatch)
    tloss, tgrads = TH.value_and_grad(
        hybrid_params_from_numpy(np_params, device="cpu"),
        torch.from_numpy(ids), tcfg, remat="attn")
    L = KW["num_hidden_layers"]
    assert calls == {"fwd": L, "bwd": L}
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    close(tgrads, jgrads, "grad", **GRAD_TOL)


def test_remat_attn_train_steps_match_jax(setup):
    jcfg, tcfg, np_params, ids, mesh = setup
    jstep = H.build_train_step(jcfg, mesh, remat="attn", sp=False)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jo = H.init_adamw(jp)
    tstep = TH.build_train_step(tcfg, remat="attn", device="cpu")
    tp = hybrid_params_from_numpy(np_params, device="cpu")
    to = TH.init_adamw(tp)
    for _ in range(2):
        jl, jp, jo = jstep(jp, jo, jnp.asarray(ids))
        tl, tp, to = tstep(tp, to, ids)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    close(tp, jp, "params", **PARAM_TOL)
    close(to.m, jo.m, "m", **MOMENT_TOL)
    close(to.v, jo.v, "v", **MOMENT_TOL)


@pytest.mark.parametrize("remat,fwd", [("attn", 1), (True, 2), (False, 1)])
def test_attention_runs_per_layer_per_step(setup, monkeypatch, remat, fwd):
    """The plain attention forward per step: L under "attn" and False,
    2·L under True; the grads of every mode equal remat=False's."""
    _, tcfg, np_params, ids, _ = setup
    L = KW["num_hidden_layers"]
    _, want = TH.value_and_grad(
        hybrid_params_from_numpy(np_params, device="cpu"),
        torch.from_numpy(ids), tcfg, remat=False)
    calls = counting(monkeypatch)
    step = TH.build_train_step(tcfg, remat=remat, device="cpu")
    params = hybrid_params_from_numpy(np_params, device="cpu")
    step(params, TH.init_adamw(params), ids)
    assert calls == {"fwd": fwd * L, "bwd": L}
    _, got = TH.value_and_grad(
        hybrid_params_from_numpy(np_params, device="cpu"),
        torch.from_numpy(ids), tcfg, remat=remat)
    for g, w in zip(TH.tree_leaves(got), TH.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-8)
