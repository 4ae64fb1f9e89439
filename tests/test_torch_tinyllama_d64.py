"""A narrow TinyLlama-1.1B-shaped model (head_dim 64: hidden 256, 4 q
heads over 1 kv head, 2 layers, rms eps 1e-5) through the port's
training step and serving engine, against the JAX package on the CPU.

TinyLlama-1.1B's published config.json has head_dim 64 (hidden 2048, 32
q / 4 kv heads): on the card its attention runs the K1/K2 and K8
kernels built for head_dim 64 (``chip_smoke.py`` phases 15 and 16).  On
the CPU the port's wrappers run their plain versions and the JAX
package its XLA paths.  Compared, in float32: the loss (1e-6 relative)
and every gradient (1e-4 relative + 2e-6 absolute, as
``test_torch_llama_hybrid.py``) of one training step from the same
params and tokens, and the engine's greedy tokens (identical) for a
batch of ragged prompts through prefill and paged decode.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import llama_hybrid as H
from paddle_tpu.models.llama import LlamaForCausalLM
from paddle_tpu.models.llama import llama_tiny as j_llama_tiny
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving.request import GenerationConfig as JGen
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import hybrid_params_from_numpy, llama_tiny
from paddle_tpu_torch.models import llama_hybrid as TH
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving.request import GenerationConfig as TGen
from test_torch_llama_hybrid import GRAD_TOL, assert_trees_close, to_np

KW = dict(num_hidden_layers=2, hidden_size=256, intermediate_size=512,
          num_attention_heads=4, num_key_value_heads=1, vocab_size=256,
          rms_norm_eps=1e-5)


def test_head_dim_is_tinyllamas():
    assert llama_tiny(**KW).head_dim == 64 == 2048 // 32


def test_train_step_matches_jax():
    jcfg = j_llama_tiny(**KW)
    np_params = to_np(H.init_params(jcfg, 1, jax.random.key(3), jnp.float32))
    ids = np.random.default_rng(3).integers(0, 256, (2, 33)).astype(np.int64)
    mesh = H.build_mesh(1, pp=1, dp=1, tp=1)
    jloss, jgrads = jax.value_and_grad(H.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(ids),
        jcfg, mesh, 1, True, False)
    tloss, tgrads = TH.value_and_grad(
        hybrid_params_from_numpy(np_params, device="cpu"),
        torch.from_numpy(ids), llama_tiny(**KW), remat=True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert_trees_close(tgrads, jgrads, "grad", **GRAD_TOL)


def test_engine_greedy_tokens_match_jax():
    paddle.seed(4)
    jmodel = LlamaForCausalLM(j_llama_tiny(**KW))
    np_state = {k: np.asarray(v)
                for k, v in jmodel.functional_state().items()}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (37, 5, 20, 64)]
    kw = dict(max_slots=3, page_size=16, max_model_len=128)
    je = j_create_engine(jmodel, **kw)
    te = t_create_engine(llama_tiny(**KW),
                         TC.state_from_numpy(np_state, device="cpu"),
                         device="cpu", **kw)
    jreqs = [je.submit(p, JGen(max_new_tokens=10)) for p in prompts]
    treqs = [te.submit(p, TGen(max_new_tokens=10)) for p in prompts]
    je.run_until_complete()
    te.run_until_complete()
    for j, t in zip(jreqs, treqs):
        assert len(t.output_tokens) == 10
        assert t.output_tokens == j.output_tokens
