"""``paddle_tpu_torch.nn.functional`` against the reference's
``nn/functional.py``: every one of its ops — the convolutions, pools,
resampling and attention in ``test_torch_nn_functional_conv.py`` — forward
values and dtypes and, where the reference differentiates, gradients —
on seeded numpy inputs, f32, rtol 1e-5 / atol 1e-5 unless a spec states
its own; variants of one op are keyed ``op#variant``.  The op inventory
must equal the reference's.  The random ops run their deterministic
(eval) forms against the reference and their training forms by
statistics."""
import numpy as np
import pytest

import paddle_tpu_torch as T
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as TOPS
from torch_op_parity import Spec, check, cpu_place, ops_of, reference, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(3)
TOL = (1e-5, 1e-5)


def f(*shape, lo=None, hi=None):
    if lo is not None:
        return R.uniform(lo, hi, shape).astype(np.float32)
    return R.standard_normal(shape).astype(np.float32)


def i64(lo, hi, *shape):
    return R.integers(lo, hi, shape).astype(np.int64)


def S(*args, **kw):
    kw.setdefault("tol", TOL)
    return Spec(*args, **kw)


X = f(3, 6)
IMG = f(2, 4, 7, 7)
PROB = f(3, 6, lo=0.05, hi=0.95)
LAB = i64(0, 6, 3)
LAB_IGN = np.array([1, -100, 4], np.int64)
D = (0,)

SPECS = {
    # activations
    **{n: S(X, diff=D) for n in (
        "relu", "relu6", "silu", "sigmoid", "tanh", "softmin", "selu",
        "hardswish", "hardsigmoid", "hardshrink", "softshrink",
        "tanhshrink", "softplus", "softsign", "mish", "elu", "celu")},
    "gelu": S(X, diff=D),
    "gelu#tanh": S(X, approximate=True, diff=D),
    "softmax": S(X, axis=0, diff=D),
    "log_softmax": S(X, diff=D),
    "leaky_relu": S(X, 0.2, diff=D),
    "hardtanh": S(X, -0.5, 0.5, diff=D),
    "prelu": S(IMG, f(4), diff=(0, 1)),
    "rrelu": S(X, training=False, diff=D),
    "glu": S(X, diff=D),
    "maxout": S(f(2, 6, 3), 3, diff=D),
    # linear family
    "linear": S(f(2, 3, 5), f(5, 4), f(4), diff=(0, 1, 2)),
    "embedding": S(i64(0, 10, 2, 3), f(10, 4), padding_idx=2, diff=(1,)),
    "one_hot": S(i64(0, 5, 4), 5),
    "bilinear": S(f(3, 4), f(3, 5), f(2, 4, 5), f(2), diff=(0, 1, 2, 3)),
    "dropout": S(X, 0.3, training=False, mode="downscale_in_infer",
                 diff=D),
    "dropout2d": S(IMG, 0.3, training=False, diff=D),
    "alpha_dropout": S(X, 0.3, training=False, diff=D),
    # normalization
    "layer_norm": S(f(2, 3, 6), [6], f(6), f(6), diff=(0, 2, 3)),
    "rms_norm": S(f(2, 3, 6), f(6), diff=(0, 1)),
    "batch_norm": S(IMG, f(4), f(4, lo=0.5, hi=1.5), f(4), f(4),
                    training=True, diff=(0, 3, 4)),
    "batch_norm#eval": S(IMG, f(4), f(4, lo=0.5, hi=1.5), training=False,
                         diff=D),
    "group_norm": S(IMG, 2, f(4), f(4), diff=(0, 2, 3)),
    "instance_norm": S(IMG, None, None, f(4), f(4), diff=(0, 3, 4)),
    "local_response_norm": S(IMG, 3, diff=D),
    "normalize": S(X, diff=D),
    # losses
    "cross_entropy": S(X, LAB, diff=D),
    "cross_entropy#ignore_weight": S(X, LAB_IGN, f(6, lo=0.5, hi=2),
                                     diff=D),
    "cross_entropy#smooth_sum": S(X, LAB, reduction="sum",
                                  label_smoothing=0.1, diff=D),
    "cross_entropy#soft": S(X, PROB / PROB.sum(1, keepdims=True),
                            soft_label=True, diff=(0, 1)),
    "nll_loss": S(np.log(PROB), LAB_IGN, diff=D),
    "mse_loss": S(X, f(3, 6), diff=(0, 1)),
    "l1_loss": S(X, f(3, 6), reduction="sum", diff=(0, 1)),
    "smooth_l1_loss": S(X, f(3, 6), diff=(0, 1)),
    "binary_cross_entropy": S(PROB, f(3, 6, lo=0, hi=1), diff=(0, 1)),
    "binary_cross_entropy_with_logits": S(
        X, f(3, 6, lo=0, hi=1), None, "mean", f(6, lo=0.5, hi=2),
        diff=(0, 1, 4)),
    "kl_div": S(np.log(PROB), f(3, 6, lo=0.1, hi=1), reduction="batchmean",
                diff=(0, 1)),
    "margin_ranking_loss": S(f(5), f(5), np.sign(f(5)), margin=0.1,
                             diff=(0, 1)),
    "hinge_embedding_loss": S(f(5), np.sign(f(5)), diff=D),
    "cosine_similarity": S(X, f(3, 6), axis=1, diff=(0, 1)),
    "cosine_embedding_loss": S(X, f(3, 6), np.array([1, -1, 1], np.int64),
                               diff=(0, 1)),
    "triplet_margin_loss": S(X, f(3, 6), f(3, 6), swap=True, diff=(0, 1, 2)),
    "square_error_cost": S(X, f(3, 6), diff=(0, 1)),
    "log_loss": S(PROB, f(3, 6, lo=0, hi=1), diff=D),
    # misc
    "label_smooth": S(PROB, epsilon=0.2, diff=D),
    "npair_loss": S(f(4, 5), f(4, 5), np.array([0, 1, 0, 2], np.int64),
                    diff=(0, 1)),
    "pad_sequence": S([f(3, 2), f(5, 2), f(1, 2)], padding_value=-1.0),
    "temporal_shift": S(f(4, 8, 2, 2), 2, diff=D),
}
RANDOM = ("rrelu", "gumbel_softmax", "dropout", "dropout2d",
          "alpha_dropout")


def test_op_inventory_matches_reference():
    from test_torch_nn_functional_conv import SPECS as CONV_SPECS
    ref = ops_of(JOPS, "paddle_tpu.nn.functional")
    port = ops_of(TOPS, "paddle_tpu_torch.nn.functional")
    assert port == ref
    assert set(ref) <= {k.split("#")[0] for k in (*SPECS, *CONV_SPECS)} \
        | set(RANDOM)


@pytest.fixture(scope="module")
def ref():
    return reference({k: JOPS[k.split("#")[0]].__op_body__ for k in SPECS},
                     SPECS)


@pytest.mark.parametrize("key", sorted(SPECS))
def test_op_matches_reference(key, ref):
    check(ref[key], TOPS[key.split("#")[0]], SPECS[key], key)


def test_random_ops_in_training_mode():
    """Dropout keeps 1-p of the entries (scaled by 1/(1-p)); rrelu's
    slopes lie in [lower, upper]; gumbel_softmax rows sum to one and
    its hard form is one-hot."""
    x = T.ones([200, 100])
    out = TF.dropout(x, p=0.3).numpy()
    assert abs((out != 0).mean() - 0.7) < 0.02
    np.testing.assert_allclose(out[out != 0], 1 / 0.7, rtol=1e-6)
    out2 = TF.dropout2d(T.ones([50, 40, 2, 2]), p=0.5).numpy()
    assert abs((out2[:, :, 0, 0] != 0).mean() - 0.5) < 0.05
    assert (out2 == out2[:, :, :1, :1]).all()
    a = TF.alpha_dropout(x, p=0.2).numpy()
    assert len(np.unique(a.round(5))) == 2
    slopes = TF.rrelu(-x, training=True).numpy() / -1.0
    assert slopes.min() >= 1 / 8 - 1e-6 and slopes.max() <= 1 / 3 + 1e-6
    g = TF.gumbel_softmax(T.to_tensor(f(8, 5)), hard=True).numpy()
    np.testing.assert_allclose(g.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(g, np.round(g), atol=1e-6)


def test_embedding_sparse_waits_with_selected_rows():
    w = T.to_tensor(f(4, 2))
    with pytest.raises(NotImplementedError, match="sparse"):
        TF.embedding(T.to_tensor(np.array([1], np.int64)), w, sparse=True)
