"""The port's autograd (on ``torch.autograd``) against the reference's
tape: ``paddle.grad`` with ``create_graph`` (``tests/
test_double_backward.py``'s cases), its semantics, a gradient-penalty
training step, ``jacobian``/``hessian``, ``PyLayer``, ``no_grad``,
saved-tensor hooks, gradient accumulation on the handle, and the op
registry's hooks (AMP, op statistics, ``FLAGS_check_nan_inf``).  Values
in f32, rtol 1e-5 / atol 1e-5 unless stated."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_op_parity import cpu_place, rng, same

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(5)
XV = R.standard_normal((3, 4)).astype(np.float32)
YV = R.standard_normal((3, 4)).astype(np.float32)


def _grad_cases(M):
    out = {}
    x = M.to_tensor(2.0, stop_gradient=False)
    (g,) = M.grad(x ** 3, x, create_graph=True)
    (g2,) = M.grad(g, x, create_graph=True)
    (g3,) = M.grad(g2, x)
    out["cubic"] = [g, g2, g3]
    x = M.to_tensor(3.0, stop_gradient=False)
    y = M.to_tensor(5.0, stop_gradient=False)
    (gx,) = M.grad(x * y + x ** 2, x, create_graph=True)
    (gxx,) = M.grad(gx, x, retain_graph=True)
    (gxy,) = M.grad(gx, y)
    out["mixed"] = [gx, gxx, gxy]
    xv = M.to_tensor(np.linspace(-1.5, 1.5, 7).astype(np.float32),
                     stop_gradient=False)
    (g,) = M.grad(M.sin(xv).sum(), xv, create_graph=True)
    out["elementwise"] = M.grad(g.sum(), xv)
    x = M.to_tensor(XV, stop_gradient=False)
    w = M.to_tensor(YV.T.copy(), stop_gradient=False)
    (gx,) = M.grad((x @ w).pow(2).sum(), x, create_graph=True)
    out["matmul"] = M.grad(gx.sum(), w)
    x = M.to_tensor(2.0, stop_gradient=False)
    s = M.to_tensor(4.0, stop_gradient=False)
    (g,) = M.grad(x ** 3, x, grad_outputs=s, create_graph=True)
    out["seeded"] = [g, *M.grad(g, s)]
    x = M.to_tensor(3.0, stop_gradient=False)
    y = M.to_tensor(5.0, stop_gradient=False)
    out["no_grad_vars"] = M.grad(x * y, x, no_grad_vars=[y])
    out["unused_zero"] = M.grad(x * 2, [x, y])
    return out


def test_grad_create_graph_matches_reference():
    ref, port = _grad_cases(J), _grad_cases(T)
    for k in ref:
        same(ref[k], port[k], rtol=1e-5, atol=1e-5)


def test_grad_semantics():
    x = T.to_tensor(2.0, stop_gradient=False)
    (g,) = T.grad(x ** 3, x)
    assert g.stop_gradient
    (g2,) = T.grad(g, x, allow_unused=True)
    assert g2 is None                      # disconnected, not zeros
    (g,) = T.grad(x ** 3, x, create_graph=True)
    assert not g.stop_gradient
    (again,) = T.grad(x ** 3, x, create_graph=True)
    np.testing.assert_allclose(float(g), float(again))
    z = x ** 2
    T.grad(z, x)
    with pytest.raises(RuntimeError):
        T.grad(z, x)                       # graph consumed
    y = T.to_tensor(5.0, stop_gradient=False)
    T.grad(x * y, x, no_grad_vars=[y])
    assert not y.stop_gradient


def test_gradient_penalty_training_step_decreases():
    """WGAN-GP shape: a loss of grad-of-output, backward to the params."""
    T.seed(0)
    D = T.nn.Sequential(T.nn.Linear(4, 16), T.nn.Tanh(), T.nn.Linear(16, 1))
    opt = T.optimizer.Adam(learning_rate=1e-2, parameters=D.parameters())
    gen = rng(0)
    losses = []
    for _ in range(15):
        x = T.to_tensor(gen.standard_normal((8, 4)).astype("float32"),
                        stop_gradient=False)
        (gx,) = T.grad(D(x).sum(), x, create_graph=True)
        gp = ((gx.pow(2).sum(axis=1).sqrt() - 1.0) ** 2).mean()
        gp.backward()
        # every weight has a gradient (the last bias has no path to gx:
        # torch leaves its grad unset, and the optimizer skips it)
        assert all(p.grad is not None for p in D.parameters()
                   if len(p.shape) == 2)
        opt.step()
        opt.clear_grad()
        losses.append(float(gp))
    assert losses[-1] < losses[0]


def test_jacobian_and_hessian_match_reference():
    outs = []
    for M in (J, T):
        x = M.to_tensor(np.array([1.0, 2.0, 3.0], np.float32),
                        stop_gradient=False)
        j_rec = M.autograd.jacobian(x * x, x)
        j_fn = M.autograd.jacobian(lambda t: M.sin(t) * t, x)
        h = M.autograd.hessian(lambda t: (t ** 3).sum(), x)
        jb = M.autograd.jacobian(lambda t: t ** 2,
                                 M.to_tensor(XV[:, :3]), batch_axis=0)
        outs.append([j_rec, j_fn, h, jb])
    same(*outs)


def _cube_layer(M):
    class Cube(M.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x ** 3 * k, x * 0 + 1

        @staticmethod
        def backward(ctx, dy, dz):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x ** 2 * ctx.k
    return Cube


def test_pylayer_matches_reference():
    outs = []
    for M in (J, T):
        x = M.to_tensor(XV, stop_gradient=False)
        y, z = _cube_layer(M).apply(x, 2.0)
        assert not y.stop_gradient
        (y.sum() + z.sum()).backward()
        outs.append([y, x.grad])
    same(*outs)
    with T.no_grad():
        x = T.to_tensor(XV, stop_gradient=False)
        y, _ = _cube_layer(T).apply(x, 2.0)
    assert y.stop_gradient


def test_no_grad_and_grad_modes():
    x = T.to_tensor(XV, stop_gradient=False)
    with T.no_grad():
        assert (x * 2).stop_gradient
        with T.enable_grad():
            assert not (x * 2).stop_gradient
    assert T.is_grad_enabled()

    @T.no_grad()
    def f(t):
        return t * 2
    assert f(x).stop_gradient
    T.set_grad_enabled(False)
    try:
        assert not T.is_grad_enabled()
        assert (x + 1).stop_gradient
    finally:
        T.set_grad_enabled(True)


def test_saved_tensors_hooks_see_handles():
    packed, unpacked = [], []

    def pack(t):
        assert isinstance(t, T.Tensor)
        packed.append(t.shape)
        return t

    def unpack(t):
        unpacked.append(t.shape)
        return t

    x = T.to_tensor(XV, stop_gradient=False)
    with T.autograd.saved_tensors_hooks(pack, unpack):
        y = (x * x).sum()
    y.backward()
    assert packed and len(unpacked) == len(packed)
    np.testing.assert_allclose(x.grad.numpy(), 2 * XV, rtol=1e-6)


def test_grad_accumulates_on_the_handle():
    """Two backward passes add up; a rebind of the data (what an
    optimizer step does) keeps the gradient on the handle; clear_grad
    drops it."""
    w = T.to_tensor(XV, stop_gradient=False)
    (w * 2).sum().backward()
    (w * 3).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), np.full_like(XV, 5.0))
    w._set_data(w._data * 0.5)
    assert not w.stop_gradient and w.is_leaf
    np.testing.assert_allclose(w.grad.numpy(), np.full_like(XV, 5.0))
    (w * 1).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), np.full_like(XV, 6.0))
    w.clear_grad()
    assert w.grad is None
    h = T.to_tensor(XV)
    h.stop_gradient = False
    (h * h).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), 2 * XV, rtol=1e-6)


def test_registry_hooks_match_reference():
    """The registry's AMP hook (O1: white-list ops to bf16, black-list to
    f32), its op statistics and FLAGS_check_nan_inf behave alike."""
    from paddle_tpu.profiler import statistic as JS
    from paddle_tpu_torch.profiler import statistic as TS
    for M, stat in ((J, JS), (T, TS)):
        x, y = M.to_tensor(XV), M.to_tensor(YV.T.copy())
        with M.amp.auto_cast(level="O1", dtype="bfloat16"):
            mm, ex = M.matmul(x, y), M.exp(x.astype("bfloat16"))
        assert mm.dtype.name == "bfloat16" and ex.dtype.name == "float32"
        stat.reset()
        stat.enable_collection()
        try:
            M.add(M.multiply(x, 2.0), x)
        finally:
            stat.disable_collection()
        spans = {(e.name, e.call) for e in stat.op_summary()}
        assert {("multiply", 1), ("add", 1)} <= spans, spans
        stat.reset()
        M.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError, match="log"):
                M.log(M.to_tensor(np.array([-1.0], np.float32)))
        finally:
            M.set_flags({"FLAGS_check_nan_inf": False})
