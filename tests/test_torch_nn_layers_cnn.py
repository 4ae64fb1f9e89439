"""The port's convolution, pooling and loss layers (``nn/layer_conv.py``,
``layer_pool.py``, ``layer_loss.py``) against the reference's, class by
class: the state keys letter for letter (the weights carried with
``layer_state_from_numpy``), the forward, and the gradients of
sum(out * c) in every float input and every parameter (the reference's
layers built with ``torch_model_parity.reference_init``).  f32; forward
rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5.  Each module's
classes are all covered (``test_every_class_is_covered``)."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_model_parity import carry, reference_init
from torch_op_parity import cpu_place, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(8)


def f(*shape, lo=None, hi=None):
    if lo is None:
        return R.standard_normal(shape).astype(np.float32)
    return R.uniform(lo, hi, shape).astype(np.float32)


class Label(np.ndarray):
    """An input that is not differentiated."""


def label(a):
    return np.asarray(a).view(Label)


def labels(n, k):
    return label(R.integers(0, k, (n,)).astype(np.int64))


SIGN = label(np.where(R.random(6) > 0.5, 1.0, -1.0).astype(np.float32))

# class name -> (constructor args, kwargs, inputs)
CASES = {
    # layer_conv
    "Conv1D": ((3, 4, 3), dict(padding=1), [f(2, 3, 9)]),
    "Conv2D": ((3, 4, 3), dict(stride=2, padding=1), [f(2, 3, 9, 9)]),
    "Conv2D#grouped_no_bias": ((4, 6, 3), dict(groups=2, bias_attr=False,
                                               dilation=2), [f(2, 4, 9, 9)]),
    "Conv3D": ((2, 3, 2), dict(padding=1), [f(1, 2, 4, 5, 5)]),
    "Conv2DTranspose": ((3, 4, 3), dict(stride=2, padding=1,
                                        output_padding=1), [f(2, 3, 5, 5)]),
    # layer_pool
    "MaxPool1D": ((3,), dict(stride=2, padding=1), [f(2, 3, 10)]),
    "MaxPool2D": ((3,), dict(stride=2, padding=1, ceil_mode=True),
                  [f(2, 3, 10, 10)]),
    "AvgPool1D": ((3,), dict(stride=2, exclusive=False), [f(2, 3, 10)]),
    "AvgPool2D": ((2,), dict(padding=1), [f(2, 3, 9, 9)]),
    "AdaptiveAvgPool1D": ((4,), {}, [f(2, 3, 10)]),
    "AdaptiveAvgPool2D": (((1, 1),), {}, [f(2, 3, 7, 7)]),
    "AdaptiveMaxPool2D": ((3,), {}, [f(2, 3, 9, 9)]),
    # layer_loss
    "CrossEntropyLoss": ((), dict(label_smoothing=0.1),
                         [f(6, 5), labels(6, 5)]),
    "MSELoss": ((), {}, [f(6, 5), f(6, 5)]),
    "L1Loss": ((), dict(reduction="sum"), [f(6, 5), f(6, 5)]),
    "NLLLoss": ((), {}, [np.log(f(6, 5, lo=0.05, hi=1.0)), labels(6, 5)]),
    "BCELoss": ((), {}, [f(6, 5, lo=0.05, hi=0.95),
                         label(f(6, 5, lo=0, hi=1))]),
    "BCEWithLogitsLoss": ((), {}, [f(6, 5), label(f(6, 5, lo=0, hi=1))]),
    "SmoothL1Loss": ((), dict(delta=0.5), [f(6, 5), f(6, 5)]),
    "KLDivLoss": ((), dict(reduction="batchmean"),
                  [np.log(f(6, 5, lo=0.05, hi=1.0)), f(6, 5, lo=0.05, hi=1)]),
    "MarginRankingLoss": ((), dict(margin=0.2), [f(6), f(6), SIGN]),
    "HingeEmbeddingLoss": ((), {}, [f(6), SIGN]),
    "CosineEmbeddingLoss": ((), dict(margin=0.1), [f(6, 5), f(6, 5), SIGN]),
    "TripletMarginLoss": ((), dict(margin=0.5), [f(6, 5), f(6, 5),
                                                   f(6, 5)]),
}


def _run(M, name, state=None):
    args, kw, inputs = CASES[name]
    with reference_init():
        layer = getattr(M.nn, name.split("#")[0])(*args, **kw)
    xs = [M.to_tensor(np.asarray(a), stop_gradient=isinstance(a, Label))
          for a in inputs]
    if state is not None:
        carry(state, layer)
    out = layer(*xs)
    c = M.to_tensor(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32))
    (out * c).sum().backward()
    grads = [x.grad.numpy() for x in xs if not x.stop_gradient]
    grads += [p.grad.numpy() for p in layer.parameters()]
    return layer, out.numpy(), grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_the_reference(name):
    jl, jout, jgrads = _run(J, name)
    _, tout, tgrads = _run(T, name, state=jl)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    assert len(tgrads) == len(jgrads)
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5,
                                   err_msg=f"grad {i}")


def test_every_class_is_covered():
    from paddle_tpu.nn import layer_conv, layer_loss, layer_pool
    want = set(layer_pool.__all__) | set(layer_loss.__all__) | {
        "Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"}
    assert want == {n.split("#")[0] for n in CASES}
    for n in want:
        assert getattr(T.nn, n).__module__.startswith("paddle_tpu_torch.nn")
    assert [n for n in dir(layer_conv) if n.startswith("Conv")] == sorted(
        ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"])
