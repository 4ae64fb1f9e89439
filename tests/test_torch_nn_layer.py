"""The port's ``nn.Layer`` and its core layers against the reference's:
a model of the core layers on the same weights (loaded from numpy)
gives the same outputs, gradients and running statistics;
``state_dict`` keys match and round-trip; hooks, modes, dtype casts, the
functional bridge and the initializers' scales behave alike (the
optimizers: ``test_torch_optimizer.py``).  f32 tolerance rtol 1e-5 /
atol 1e-6 (gradients through the model 1e-4 / 1e-5)."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_op_parity import cpu_place, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)


def _np(t):
    return np.asarray(t.numpy(), np.float64)


def close(a, b, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(_np(b), _np(a), rtol=rtol, atol=atol,
                               err_msg=what)


def model(M):
    nn = M.nn
    return nn.Sequential(
        ("emb", nn.Embedding(20, 8, padding_idx=0)),
        ("fc1", nn.Linear(8, 16)),
        ("ln", nn.LayerNorm(16)),
        ("act", nn.GELU()),
        ("drop", nn.Dropout(0.5)),
        ("fc2", nn.Linear(16, 12)),
        ("rms", nn.RMSNorm(12)),
        ("silu", nn.Silu()),
    )


def conv_like(M):
    nn = M.nn
    return nn.Sequential(nn.BatchNorm2D(3), nn.GroupNorm(1, 3),
                         nn.Flatten(), nn.Linear(3 * 16, 4),
                         nn.LeakyReLU(0.1), nn.Softmax())


def same_weights(jm, tm, seed=0):
    gen = rng(seed)
    state = {k: gen.standard_normal(v.shape).astype(np.float32)
             for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: J.to_tensor(v) for k, v in state.items()})
    T.models.convert.layer_state_from_numpy(tm, state)
    return state


def test_state_dict_keys_and_round_trip():
    jm, tm = model(J), model(T)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    state = same_weights(jm, tm)
    back = {k: v.numpy() for k, v in tm.state_dict().items()}
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    tm2 = model(T)
    missing, unexpected = tm2.set_state_dict(tm.state_dict())
    assert not missing and not unexpected
    for k, v in tm2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    with pytest.raises(ValueError, match="shape mismatch"):
        tm2.set_state_dict({"fc1.weight": T.zeros([2, 2])})
    fs = tm.functional_state()
    tm2.load_functional_state({k: v * 2 for k, v in fs.items()})
    np.testing.assert_allclose(tm2.fc1.weight.numpy(),
                               2 * state["fc1.weight"])
    assert not tm2.fc1.weight.stop_gradient and tm2.fc1.weight.is_leaf
    cl_j, cl_t = conv_like(J), conv_like(T)
    assert list(cl_t.state_dict()) == list(cl_j.state_dict())


def test_core_layers_match_reference():
    jm, tm = model(J), model(T)
    same_weights(jm, tm)
    ids = rng(1).integers(0, 20, (4, 5)).astype(np.int64)
    outs = []
    for M, m in ((J, jm), (T, tm)):
        m.eval()
        out = m(M.to_tensor(ids))
        (out * out).sum().backward()
        outs.append((out, {n: p.grad for n, p in m.named_parameters()}))
    (jo, jg), (to, tg) = outs
    close(jo, to, what="output")
    for n in jg:
        close(jg[n], tg[n], rtol=1e-4, atol=1e-5, what=n)


def test_norm_layers_and_running_stats_match_reference():
    jm, tm = conv_like(J), conv_like(T)
    same_weights(jm, tm, seed=2)
    x = rng(3).standard_normal((5, 3, 4, 4)).astype(np.float32)
    res = []
    for M, m in ((J, jm), (T, tm)):
        m.train()
        y1 = m(M.to_tensor(x))
        m.eval()
        y2 = m(M.to_tensor(x))
        res.append([y1, y2, m[0]._mean, m[0]._variance])
    for a, b in zip(*res):
        close(a, b, rtol=1e-4, atol=1e-5)


def test_layer_modes_hooks_and_casts():
    m = model(T)
    assert m.training and m.fc1.training
    m.eval()
    assert not m.training and not m.drop.training
    m.train()
    calls = []
    h1 = m.fc1.register_forward_pre_hook(
        lambda layer, inp: calls.append("pre"))
    h2 = m.fc1.register_forward_post_hook(
        lambda layer, inp, out: out * 0)
    out = m.fc1(T.ones([2, 8]))
    assert calls == ["pre"] and float(out.abs().sum()) == 0.0
    h1.remove()
    h2.remove()
    assert float(m.fc1(T.ones([2, 8])).abs().sum()) > 0
    m.bfloat16()
    assert all(p.dtype == T.bfloat16 for p in m.parameters())
    assert all(not p.stop_gradient and p.is_leaf for p in m.parameters())
    m.astype("float32")
    assert m.fc1.weight.dtype == T.float32
    m.to(dtype="float16")
    assert m.fc2.bias.dtype.name == "float16"
    assert len(m.parameters()) == len(list(m.named_parameters())) == \
        len(model(J).parameters())
    m.clear_gradients()


def test_initializers_match_reference_in_distribution():
    """Shapes, dtypes and the init scales of the reference (JAX streams
    cannot be reproduced)."""
    I = T.nn.initializer
    cases = [(I.Constant(0.5), 0.5, 0.0), (I.Normal(1.0, 2.0), 1.0, 2.0),
             (I.Uniform(-1, 1), 0.0, (1 / 3) ** 0.5),
             (I.XavierUniform(), 0.0, (2 / (200 + 300)) ** 0.5),
             (I.XavierNormal(), 0.0, (2 / (200 + 300)) ** 0.5),
             (I.KaimingNormal(), 0.0, (2 / 200) ** 0.5),
             (I.KaimingUniform(), 0.0, (2 / 200) ** 0.5),
             (I.TruncatedNormal(0.0, 1.0), 0.0, 0.8796)]
    for init, mu, sd in cases:
        w = init([200, 300], "float32")
        assert w.shape == (200, 300) and w.dtype == torch.float32
        assert abs(float(w.mean()) - mu) < 0.02 * max(sd, 1.0)
        assert abs(float(w.std()) - sd) < 0.03 * max(sd, 0.1)
    q = I.Orthogonal()([6, 6])
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(6), atol=1e-5)
    a = I.Assign(np.arange(6.0))([2, 3])
    np.testing.assert_array_equal(a.numpy(), np.arange(6.0).reshape(2, 3))
