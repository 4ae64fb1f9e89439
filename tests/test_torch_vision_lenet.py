"""``paddle_tpu_torch.vision.models.LeNet`` and ``jit.train_step``
against the reference, at ``bench.py``'s LeNet size (batch 64 x 1 x
28 x 28, SGD lr 0.01).

- LeNet, eager: state keys letter for letter; logits, loss and every
  gradient at each of 3 steps, and every param after them, within
  relative norm 1e-4.
- ``train_step``: n calls, and one ``multi_step(n)`` call, leave the
  params and BatchNorm buffers of a conv + BN model exactly where n
  eager steps leave them (the same ops in the same order).
- LeNet's ``train_step(...).multi_step(2)`` against the reference's
  compiled scan: the last loss and the params within 1e-4.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch.vision.models import LeNet as TLeNet
from torch_model_parity import carry, check_runs, check_state, rel, \
    reference_init, train_both
from torch_op_parity import cpu_place, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)
TOL = 1e-4
R = rng(3)
X = R.standard_normal((64, 1, 28, 28)).astype(np.float32)
Y = R.integers(0, 10, (64,)).astype(np.int64)


def _pair():
    with reference_init():
        jm = JLeNet()
    tm = TLeNet()
    carry(jm, tm)
    return jm, tm


def _sgd(M, m):
    return M.optimizer.SGD(learning_rate=0.01, parameters=m.parameters())


def _ce(M, m, x, y):
    out = m(x)
    return out, M.nn.functional.cross_entropy(out, y)


def test_lenet_training_matches_the_reference():
    jm, tm = _pair()
    jrun, trun = train_both(jm, tm, _sgd, _ce, (X, Y), 3)
    check_runs(jrun, trun, TOL)
    check_state(jm, tm, TOL)
    assert trun[-1][1] < trun[0][1]


def _bn_model():
    nn = T.nn
    T.seed(1)
    return nn.Sequential(nn.Conv2D(1, 4, 3, padding=1), nn.BatchNorm2D(4),
                         nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(),
                         nn.Linear(4 * 14 * 14, 10))


def _copy(src, dst):
    dst.set_state_dict({k: v.numpy() for k, v in src.state_dict().items()})


def _loss(m, x, y):
    return T.nn.functional.cross_entropy(m(x), y)


@pytest.mark.parametrize("form", ["calls", "multi_step"])
def test_train_step_equals_the_eager_loop(form):
    n = 3
    eager, stepped = _bn_model(), _bn_model()
    _copy(eager, stepped)
    x, y = T.to_tensor(X), T.to_tensor(Y)
    opt = T.optimizer.Momentum(0.1, 0.9, parameters=eager.parameters())
    for _ in range(n):
        loss = _loss(eager, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    step = T.jit.train_step(stepped, T.optimizer.Momentum(
        0.1, 0.9, parameters=stepped.parameters()), _loss)
    if form == "calls":
        for _ in range(n):
            last = step(X, Y)
    else:
        last = step.multi_step(n)(x, y)
    assert last.stop_gradient and float(last) == float(loss)
    for (k, a), b in zip(eager.state_dict().items(),
                         stepped.state_dict().values()):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=k)
    assert "1._mean" in eager.state_dict()
    assert not np.allclose(eager.state_dict()["1._mean"].numpy(), 0)


def test_lenet_multi_step_matches_the_reference():
    jm, tm = _pair()
    losses = []
    for M, m in ((J, jm), (T, tm)):
        step = M.jit.train_step(m, _sgd(M, m), lambda m, a, b, M=M:
                                M.nn.functional.cross_entropy(m(a), b))
        losses.append(float(step.multi_step(2)(M.to_tensor(X),
                                                M.to_tensor(Y))))
    assert abs(losses[1] - losses[0]) <= TOL * abs(losses[0]), losses
    check_state(jm, tm, TOL)
    assert rel(losses[1], losses[0]) <= TOL
