"""The port's optimizers and gradient clips against the reference's:
SGD, Momentum, Adam, AdamW (with f32 master weights for bf16 params),
Adagrad, Adadelta, RMSProp and Lamb take the same 3 steps on the same
params and gradients, under ``ClipGradByGlobalNorm``, ``ClipGradByNorm``
and ``ClipGradByValue``; AdamW's decay is decoupled; state dicts
round-trip; the LR schedulers give the same rates.  f32 tolerance rtol
1e-5 / atol 1e-6; bf16 params within one bf16 ulp (rtol 2^-7), their
master weights rtol 1e-5."""
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


SHAPES = [(6, 5), (5,), (3, 4)]


def _params(M, dtype):
    gen = rng(10)
    ps = []
    for i, s in enumerate(SHAPES):
        p = M.create_parameter(list(s), "float32")
        p.set_value(M.to_tensor(gen.standard_normal(s).astype(np.float32)))
        p.name = f"p{i}"
        ps.append(p)
    if dtype != "float32":
        for p in ps:
            if M is J:
                p._data = p._data.astype(J.bfloat16.np_dtype)
            else:
                p._set_data(p._data.to(torch.bfloat16))
    return ps


OPTS = {
    "sgd": lambda O, ps, clip: O.SGD(0.1, ps, weight_decay=0.01,
                                     grad_clip=clip),
    "momentum": lambda O, ps, clip: O.Momentum(0.05, 0.9, ps,
                                               use_nesterov=True,
                                               grad_clip=clip),
    "adam": lambda O, ps, clip: O.Adam(0.01, parameters=ps,
                                       weight_decay=0.01, grad_clip=clip),
    "adamw": lambda O, ps, clip: O.AdamW(
        0.01, parameters=ps, weight_decay=0.1, grad_clip=clip,
        apply_decay_param_fun=lambda n: n != "p1"),
    "adagrad": lambda O, ps, clip: O.Adagrad(0.1, parameters=ps,
                                             grad_clip=clip),
    "adadelta": lambda O, ps, clip: O.Adadelta(1.0, parameters=ps,
                                               grad_clip=clip),
    "rmsprop": lambda O, ps, clip: O.RMSProp(0.01, momentum=0.5,
                                             centered=True, parameters=ps,
                                             grad_clip=clip),
    "lamb": lambda O, ps, clip: O.Lamb(0.01, parameters=ps,
                                       grad_clip=clip),
}
CLIPS = {"none": lambda nn: None,
         "global": lambda nn: nn.ClipGradByGlobalNorm(1.0),
         "norm": lambda nn: nn.ClipGradByNorm(0.5),
         "value": lambda nn: nn.ClipGradByValue(0.3)}


def _run_steps(M, name, clip, dtype, steps=3):
    ps = _params(M, dtype)
    opt = OPTS[name](M.optimizer, ps, CLIPS[clip](M.nn))
    if M is J:
        # the reference's per-param loop (the same _update_param math as
        # its fused jitted step, without a compile per optimizer)
        opt._fused_step_broken = True
    gen = rng(11)
    for _ in range(steps):
        loss = None
        for p in ps:
            g = M.to_tensor(gen.standard_normal(p.shape).astype(np.float32))
            term = (p.astype("float32") * g).sum() * 3.0
            loss = term if loss is None else loss + term
        loss.backward()
        opt.step()
        opt.clear_grad()
    return ps, opt


@pytest.mark.parametrize("name,clip,dtype", [
    *[(n, "none", "float32") for n in sorted(OPTS)],
    ("sgd", "global", "float32"), ("adamw", "global", "float32"),
    ("momentum", "norm", "float32"), ("adam", "value", "float32"),
    ("adamw", "global", "bfloat16"), ("sgd", "none", "bfloat16"),
])
def test_optimizer_steps_match_reference(name, clip, dtype):
    (jp, jo), (tp, to) = (_run_steps(M, name, clip, dtype) for M in (J, T))
    rtol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    for a, b in zip(jp, tp):
        assert a.dtype.name == b.dtype.name == dtype
        close(a, b, rtol=rtol, atol=1e-6, what=f"{name} {a.name}")
    if dtype == "bfloat16":      # the f32 master weights, tight
        assert set(to._master_weights) == set(jo._master_weights)
        for k, m in jo._master_weights.items():
            np.testing.assert_allclose(to._master_weights[k].numpy(),
                                       np.asarray(m), rtol=1e-5, atol=1e-6)
    js, ts = jo.state_dict(), to.state_dict()
    assert set(js) == set(ts)
    for k in js:
        if k != "@step":
            close(js[k], ts[k], rtol=1e-4, atol=1e-6, what=k)


def test_adamw_decay_is_decoupled():
    """AdamW moves a zero-gradient param by lr*wd*param alone; Adam's L2
    decay goes through the moments."""
    for M in (J, T):
        p = M.create_parameter([3], "float32")
        p.set_value(M.to_tensor(np.array([1.0, -2.0, 4.0], np.float32)))
        opt = M.optimizer.AdamW(0.1, parameters=[p], weight_decay=0.5)
        (p * 0.0).sum().backward()
        opt.step()
        np.testing.assert_allclose(p.numpy(), [0.95, -1.9, 3.8], rtol=1e-6)


def test_optimizer_state_dict_round_trip_and_lr_schedulers():
    ps, opt = _run_steps(T, "adamw", "none", "float32", steps=2)
    ps2, opt2 = _run_steps(T, "adamw", "none", "float32", steps=0)
    opt2.set_state_dict(opt.state_dict())
    assert opt2._step_count == 2
    for k, v in opt._accumulators.items():
        for s, a in v.items():
            np.testing.assert_array_equal(opt2._accumulators[k][s].numpy(),
                                          a.numpy())
    for name, kw in (("CosineAnnealingDecay", dict(learning_rate=0.1,
                                                   T_max=5)),
                     ("LinearWarmup", dict(learning_rate=0.1,
                                           warmup_steps=3, start_lr=0.0,
                                           end_lr=0.1)),
                     ("StepDecay", dict(learning_rate=0.1, step_size=2))):
        js = getattr(J.optimizer.lr, name)(**kw)
        ts = getattr(T.optimizer.lr, name)(**kw)
        for _ in range(6):
            assert js() == pytest.approx(ts())
            js.step()
            ts.step()
    sched = T.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt3 = T.optimizer.SGD(sched, parameters=_params(T, "float32"))
    assert opt3.get_lr() == pytest.approx(0.1)
    sched.step()
    assert opt3.get_lr() == pytest.approx(0.05)
