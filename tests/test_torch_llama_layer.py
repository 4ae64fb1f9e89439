"""``paddle_tpu_torch.models.llama.LlamaForCausalLM`` — the nn.Layer
model, trained through the eager Paddle API — against the reference's at
``llama_tiny`` (2 layers, hidden 128, 4/2 heads), on the reference's
weights carried over with ``layer_state_from_numpy``: state keys letter
for letter, logits and loss (rtol 1e-4), every gradient and every param
after 3 AdamW steps (relative norm 1e-4, per leaf); with a key-padding
mask too (the masked attention route).  ``functional_state()`` has the
keys of ``init_state``; ``recompute`` raises."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from torch_op_parity import cpu_place, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)
TOL = 1e-4


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    J.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    prev = T.device._current
    T.set_device("cpu")
    try:
        tm = TL.LlamaForCausalLM(TL.llama_tiny())
    finally:
        T.device._current = prev
    TC.layer_state_from_numpy(tm, state)
    return jm, tm, state


IDS = rng(0).integers(0, 512, (2, 17)).astype(np.int64)


def test_state_keys_match_the_reference(pair):
    jm, tm, _ = pair
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert list(tm.functional_state()) == list(jm.functional_state())
    gen = torch.Generator().manual_seed(0)
    assert sorted(tm.functional_state()) == sorted(
        TC.init_state(TL.llama_tiny(), gen, device="cpu"))


def _step(M, m, crit, opt, ids, mask=None):
    logits = m(M.to_tensor(ids[:, :-1]), attn_mask=mask)
    loss = crit(logits, M.to_tensor(ids[:, 1:]))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    opt.step()
    opt.clear_grad()
    return logits.numpy(), float(loss), grads


def test_training_matches_the_reference(pair):
    jm, tm, _ = pair
    runs = []
    for M, m in ((J, jm), (T, tm)):
        crit = (JL if M is J else TL).LlamaPretrainingCriterion()
        opt = M.optimizer.AdamW(1e-3, parameters=m.parameters())
        runs.append([_step(M, m, crit, opt, IDS) for _ in range(3)])
    for k, ((jl, jloss, jg), (tl, tloss, tg)) in enumerate(zip(*runs)):
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL,
                                   err_msg=f"logits, step {k}")
        assert abs(tloss - jloss) <= TOL * abs(jloss), (k, tloss, jloss)
        for n in jg:
            assert rel(tg[n], jg[n]) <= TOL, (k, n, rel(tg[n], jg[n]))
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        assert rel(p.numpy(), jp[n].numpy()) <= TOL, n
    assert runs[1][-1][1] < runs[1][0][1]


def test_padding_mask_route_matches_the_reference(pair):
    """A bool key-padding mask [B, 1, 1, S] goes to the masked flash
    attention (K8 on the card); the visible rows agree."""
    jm, tm, _ = pair
    mask = np.ones((2, 1, 1, 16), bool)
    mask[1, :, :, 12:] = False
    outs = []
    for M, m in ((J, jm), (T, tm)):
        with M.no_grad():
            outs.append(m(M.to_tensor(IDS[:, :-1]),
                          attn_mask=M.to_tensor(mask)).numpy())
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs[1][1, :12], outs[0][1, :12], rtol=TOL,
                               atol=TOL)


def test_bf16_config_and_recompute():
    cfg = TL.llama_tiny(dtype="bfloat16", num_hidden_layers=1)
    m = TL.LlamaForCausalLM(cfg)
    assert all(p.dtype == T.bfloat16 for p in m.parameters())
    out = m(T.to_tensor(IDS[:, :8]))
    assert out.dtype == T.bfloat16 and np.isfinite(out.numpy()).all()
    with pytest.raises(NotImplementedError, match="recompute"):
        TL.LlamaForCausalLM(TL.llama_tiny(recompute=True))
