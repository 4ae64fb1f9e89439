"""Op registry + dispatch.

Ports ``paddle_tpu/ops/registry.py``: ``op`` registers a function of
torch tensors as a framework op, ``OPS`` is the op inventory and
``apply_op`` dispatches one call — Tensor handles unwrapped, the AMP
hook (``amp/auto_cast.py``), the op body, the outputs wrapped back into
handles, the op statistics (``profiler/statistic.py``) and the
``FLAGS_check_nan_inf`` scan.  Autograd needs nothing here: the body's
torch ops record torch's graph, and an output requires grad exactly when
the reference would give it a grad node.

The reference's eager jit cache (``:75-260``) and fused backward replay
exist to amortise JAX tracing; torch dispatches each op eagerly, so they
have no counterpart.  Their ``eager_cache_*`` counters are registered
and stay at zero, as the compile ledger does.
"""
from __future__ import annotations

import functools
import time as _time
from typing import Callable

import torch

from ..amp.auto_cast import maybe_amp_cast
from ..profiler import statistic as _stat
from .. import observability as _obs

__all__ = ["op", "OPS", "apply_op"]

# name -> public wrapper: the introspectable op inventory
OPS: dict[str, Callable] = {}

for _name, _help in (
        ("eager_cache_hits_total", "eager dispatch cache hits"),
        ("eager_cache_misses_total",
         "eager dispatch cache misses that traced a new executable"),
        ("eager_cache_evictions_total", "eager dispatch cache evictions")):
    _obs.counter(_name, _help)
_obs.counter("eager_cache_uncacheable_total",
             "dispatches that could not use the eager cache", ("reason",))
_obs.gauge("eager_cache_size", "live entries in the eager dispatch cache")
_obs.counter("eager_cache_retraces_total",
             "new-signature traces per op (retrace-log entries)", ("op",))


def op(fn=None, *, name: str | None = None, external: bool = False):
    """Register ``fn`` (a function of torch tensors) as a framework op.
    external=True marks runtime-registered ops from outside the framework
    op surface."""
    def deco(body):
        opname = name or body.__name__

        @functools.wraps(body)
        def wrapper(*args, **kwargs):
            return apply_op(opname, body, args, kwargs)

        wrapper.__op_body__ = body
        wrapper.__op_name__ = opname
        wrapper.__op_external__ = external
        OPS[opname] = wrapper
        return wrapper

    return deco(fn) if fn is not None else deco


def _unwrap(x, tensor_cls):
    if isinstance(x, tensor_cls):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(i, tensor_cls) for i in x)
    if isinstance(x, dict):
        return {k: _unwrap(v, tensor_cls) for k, v in x.items()}
    return x


def wrap(t: torch.Tensor):
    """A handle over an op's output (no copy, graph kept)."""
    from ..framework.tensor import Tensor
    out = Tensor.__new__(Tensor)
    out._data = t
    out._grad = None
    out._views = None
    out._sg = True
    out.persistable = False
    out.trainable = False
    out.name = f"generated_tensor_{Tensor._next_name_id}"
    Tensor._next_name_id += 1
    return out


def _wrap_outputs(out):
    if isinstance(out, torch.Tensor):
        return wrap(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap_outputs(o) for o in out)
    return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for i in x:
            yield from _tensors(i)


def _enforce_note(e, opname, args):
    """PADDLE_ENFORCE-style context: the failing op and a summary of its
    tensor inputs, as a PEP-678 note (the exception is unchanged)."""
    from ..framework.tensor import Tensor
    descs = []
    for x in _unwrap(list(args), Tensor):
        if isinstance(x, torch.Tensor):
            if len(descs) >= 6:
                descs.append("...")
                break
            descs.append(f"{str(x.dtype).replace('torch.', '')}"
                         f"{list(x.shape)}")
    e.add_note(f"[paddle_tpu_torch] raised while running op '{opname}' "
               f"(tensor inputs: {', '.join(descs) or 'none'})")
    return e


def apply_op(opname, body, args, kwargs):
    from ..framework.tensor import Tensor

    args, kwargs = maybe_amp_cast(opname, args, kwargs)
    a2 = _unwrap(args, Tensor)
    k2 = _unwrap(kwargs, Tensor) if kwargs else kwargs
    try:
        if _stat.ENABLED:
            t0 = _time.perf_counter()
            out = body(*a2, **k2)
            for t in _tensors(out):
                if t.is_cuda:
                    torch.cuda.synchronize(t.device)
                    break
            _stat.record_span(opname, _time.perf_counter() - t0, "op")
        else:
            out = body(*a2, **k2)
    except Exception as e:
        raise _enforce_note(e, opname, args)
    _maybe_check_nan_inf(opname, out)
    return _wrap_outputs(out)


def _maybe_check_nan_inf(opname, out):
    """Per-op output NaN/Inf scan (reference FLAGS_check_nan_inf; level 3
    logs instead of raising)."""
    from ..flags import FLAGS
    if not FLAGS.get("FLAGS_check_nan_inf"):
        return
    for a in _tensors(out):
        if not (a.is_floating_point() or a.is_complex()):
            continue
        bad = int((~torch.isfinite(a.detach())).sum())
        if bad:
            msg = (f"Operator {opname} output contains {bad} "
                   f"NaN/Inf value(s) (shape {list(a.shape)})")
            if FLAGS.get("FLAGS_check_nan_inf_level", 0) >= 3:
                import logging
                logging.getLogger("paddle_tpu_torch").warning(msg)
            else:
                raise FloatingPointError(msg)
