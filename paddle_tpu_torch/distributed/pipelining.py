"""GPipe pipeline parallelism: every forward, then every backward.

Ports ``paddle_tpu/distributed/pipelining.py`` (``spmd_pipeline``).  The
reference runs the fill-drain as one ``lax.scan`` over (microbatches +
stages - 1) ticks inside a ``shard_map`` and differentiates through it,
so the backward pipeline comes from JAX's AD.  Across processes there is
no AD through another rank's work: the backward is scheduled by hand, in
the tick executor of :mod:`.pipeline_schedules`, with the GPipe
placement (forward of microbatch j at tick j + s; backward at the mirror
tick, last microbatch first).  Every microbatch's graph stays alive
until its backward, as AD through the reference's scan keeps every
microbatch's residuals.
"""
from __future__ import annotations

from typing import Callable

from .pipeline_schedules import pipeline_1f1b

__all__ = ["spmd_pipeline"]


def spmd_pipeline(stage_fn: Callable, first_fn: Callable, last_fn: Callable,
                  stage_params, first_params, last_params, aux, group,
                  act_shape, act_dtype):
    """The GPipe pass of this stage: ``(loss_sum, d_stage, d_first,
    d_last)`` as :func:`~.pipeline_schedules.pipeline_1f1b` returns them
    (``stage_params`` is a list of one chunk)."""
    return pipeline_1f1b(stage_fn, first_fn, last_fn, stage_params,
                         first_params, last_params, aux, group, act_shape,
                         act_dtype, schedule="gpipe")
