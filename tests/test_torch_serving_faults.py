"""paddle_tpu_torch fault injection and self-healing against the JAX engine.

Mirrors the tp=1 engine cases of ``tests/test_faults.py``.  The
``FaultPlan`` grammar and firing sequences must equal the reference's
for the same spec and seed.  Every engine case drives both engines
(one JAX ``llama_tiny`` model's weights; the port on the CPU, every
kernel's plain version) through an ``EngineSupervisor`` under the same
plan: a poisoned decode step (and a watchdog-declared stall) rebuilds
the runner and replays every in-flight request with the unfaulted
tokens (plain, speculative and int8-KV engines) — tokens, finish
reasons, counters and the pool census equal the reference's.  The other
sites (budget, failed rebuild, ``page_alloc``, ``slow_step``, NaN
logits) are in ``test_torch_serving_faults_sites.py``.
"""
import numpy as np
import pytest

from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.serving import EngineSupervisor as JSupervisor
from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import InjectedFault as JInjectedFault
from paddle_tpu.serving import fault_plan_from_flags as j_plan_from_flags
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.serving import (EngineSupervisor, FaultPlan,
                                      InjectedFault, NonFiniteLogitsError,
                                      fault_plan_from_flags)
from test_torch_serving_preempt import (  # noqa: F401  (tiny: a fixture)
    JGen, TGen, engines, tiny)

P1 = [1, 2, 3, 4, 5, 6, 7, 8]
P2 = [1, 2, 3, 4, 5, 6, 9, 10]
STATS = ("recoveries", "quarantines", "replayed_requests",
         "faults_injected", "decode_steps", "host_syncs", "pages_in_use",
         "pages_allocated", "prefix_hits", "prefix_misses", "cached_tokens",
         "cached_pages", "decode_traces", "spec_proposed",
         "spec_verify_steps")


# ------------------------------------------------------------ FaultPlan
SPEC = ("seed=5,step_raise@3,nan_logits~0.3:slot=1,slow_step@2:seconds=0.01,"
        "page_alloc~0.5:times=1,spill_fail@1:times=3:req=4")


def _checks(plan):
    """One fixed sequence of seam checks; the params each firing
    returns, then the plan's own census."""
    rng = np.random.RandomState(0)
    sites = ("step_raise", "nan_logits", "slow_step", "page_alloc",
             "spill_fail", "conn_reset")
    fired = []
    for i in range(200):
        site = sites[rng.randint(len(sites))]
        ctx = {"slot": int(rng.randint(3)), "req": int(rng.randint(6)),
               "step": i}
        fired.append((i, site, plan.check(site, **ctx)))
    return fired, plan.stats(), dict(plan.injected), repr(plan)


def test_fault_plan_fires_as_the_reference():
    got = _checks(FaultPlan.from_spec(SPEC))
    assert got == _checks(JFaultPlan.from_spec(SPEC))
    assert sum(p is not None for _, _, p in got[0]) > 10


def test_fault_plan_add_chain_fires_as_the_reference():
    def plan(cls):
        return (cls(seed=3).add("step_raise", at=2, times=3)
                .add("nan_logits", p=0.25, phase="decode")
                .add("slow_step", at=5, seconds=0.2))
    assert _checks(plan(FaultPlan)) == _checks(plan(JFaultPlan))


@pytest.mark.parametrize("bad", [
    dict(at=1, p=0.5), dict(), dict(at=0)])
def test_fault_plan_add_validation(bad):
    for cls in (FaultPlan, JFaultPlan):
        with pytest.raises(ValueError):
            cls().add("x", **bad)


@pytest.mark.parametrize("spec", ["step_raise", "nan_logits=3"])
def test_fault_plan_spec_rejects_bad_entries(spec):
    for cls in (FaultPlan, JFaultPlan):
        with pytest.raises(ValueError, match="site@N or site~P"):
            cls.from_spec(spec)


def test_fault_plan_from_flags(tiny, monkeypatch):
    assert fault_plan_from_flags() is None       # empty flag: no plan
    monkeypatch.setitem(FLAGS, "FLAGS_serving_fault_plan", SPEC)
    monkeypatch.setitem(JFLAGS, "FLAGS_serving_fault_plan", SPEC)
    assert _checks(fault_plan_from_flags()) == _checks(j_plan_from_flags())
    _, te = engines_with_faults(tiny, None)
    assert te.faults is not None and repr(te.faults) == \
        repr(FaultPlan.from_spec(SPEC))


def test_flags_are_the_reference_flags_the_port_reads():
    """Each registered flag has the reference's default and type; a
    reference flag whose feature is not ported is unknown to the port,
    so setting it raises instead of being ignored."""
    from paddle_tpu.flags import _DEFS as JDEFS
    from paddle_tpu_torch.flags import _DEFS, set_flags
    # the serving engine's 10, and the front end's, the observability
    # stack's and the sanitizer's 24, and the eager Paddle API's 3
    assert len(_DEFS) == 37
    for name in ("FLAGS_serving_slo_ttft_ms", "FLAGS_serving_slo_tpot_ms",
                 "FLAGS_serving_slo_e2e_ms", "FLAGS_serving_slo_objective",
                 "FLAGS_serving_shed_burn_rate",
                 "FLAGS_serving_shed_max_priority",
                 "FLAGS_serving_watchdog_seconds",
                 "FLAGS_serving_usage_meter",
                 "FLAGS_serving_usage_max_tenants",
                 "FLAGS_serving_request_log", "FLAGS_serving_exemplars_k",
                 "FLAGS_serving_fair_share",
                 "FLAGS_obs_timeseries_interval_s",
                 "FLAGS_obs_timeseries_capacity", "FLAGS_obs_fleet_window",
                 "FLAGS_obs_profile_interval_s", "FLAGS_obs_capture_dir",
                 "FLAGS_obs_capture_min_interval_s", "FLAGS_obs_capture_max",
                 "FLAGS_metrics_dir", "FLAGS_trace_buffer_size",
                 "FLAGS_flight_recorder_size", "FLAGS_resource_peak_tflops",
                 "FLAGS_resource_memory_poll_steps", "FLAGS_sanitizer",
                 "FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level",
                 "FLAGS_strict_view_semantics"):
        assert name in _DEFS, name
    for name, (t, default, _) in _DEFS.items():
        assert JDEFS[name][:2] == (t, default), name
    for name in ("FLAGS_host_trace", "FLAGS_tpu_matmul_precision",
                 "FLAGS_comm_timeout_seconds"):
        assert name in JDEFS
        with pytest.raises(ValueError, match="unknown flag"):
            set_flags({name: JDEFS[name][1]})


def test_error_types():
    # pre-existing callers catch ValueError / RuntimeError
    assert issubclass(NonFiniteLogitsError, ValueError)
    assert issubclass(InjectedFault, RuntimeError)
    assert issubclass(JInjectedFault, RuntimeError)


# --------------------------------------------------------- engine cases
def engines_with_faults(s, faults, **kw):
    kw.setdefault("num_pages", 64)
    return engines(s, faults=faults, **kw)


def _drive(sup, reqs, max_steps=500):
    steps = 0
    while not all(r.is_finished() for r in reqs) and steps < max_steps:
        sup.step()
        steps += 1
    assert all(r.is_finished() for r in reqs), "supervised loop stuck"


def _both(s, faults, script, max_recoveries=3, **kw):
    """Run ``script(engine, supervisor, gen_cls) -> requests`` on both
    engines under the same plan; return both sides."""
    je, te = engines_with_faults(s, faults, **kw)
    jsup = JSupervisor(je, max_recoveries=max_recoveries)
    tsup = EngineSupervisor(te, max_recoveries=max_recoveries)
    return (je, jsup, script(je, jsup, JGen)), (te, tsup,
                                                script(te, tsup, TGen))


def _same(j, t, keys=STATS):
    (je, jsup, jreqs), (te, tsup, treqs) = j, t
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert [(r.finish_reason, r.replays) for r in treqs] == \
        [(r.finish_reason, r.replays) for r in jreqs]
    js, ts = je.stats(), te.stats()
    assert {k: ts.get(k) for k in keys} == {k: js.get(k) for k in keys}
    assert te.blocks.pool_accounting() == je.blocks.pool_accounting()
    assert te.blocks.pool_accounting()["leak"] == 0
    assert {k: v for k, v in tsup.stats().items() if k != "last_error"} \
        == {k: v for k, v in jsup.stats().items() if k != "last_error"}
    return ts


def _two(n):
    def script(eng, sup, gen_cls):
        reqs = [eng.submit(P1, gen_cls(max_new_tokens=n)),
                eng.submit(P2, gen_cls(max_new_tokens=n))]
        _drive(sup, reqs)
        return reqs
    return script


RECOVERY = {
    "plain_cache_on": dict(enable_prefix_cache=True),
    "spec_k2_sync4": dict(spec_k=2, sync_interval=4),
    "kv_quant": dict(kv_quant=True),
}


@pytest.mark.parametrize("mode", list(RECOVERY))
def test_poisoned_step_recovers_with_parity(mode, tiny):
    """A poisoned decode step rebuilds the runner ONCE and replays both
    in-flight requests (a shared prefix through the prefix cache) with
    the unfaulted greedy tokens."""
    kw = RECOVERY[mode]
    _, clean = engines_with_faults(tiny, None, **kw)
    want = _two(10)(clean, EngineSupervisor(clean), TGen)
    j, t = _both(tiny, [("step_raise", dict(at=5))], _two(10), **kw)
    ts = _same(j, t)
    te, _, treqs = t
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in want]
    assert ts["recoveries"] == 1 and ts["replayed_requests"] == 2
    assert ts["quarantines"] == 0
    assert ts["faults_injected"] == {"step_raise": 1}
    assert all(r.finish_reason == "length" for r in treqs)


def test_stall_recovery_declared_by_watchdog_flag(tiny):
    def script(eng, sup, gen_cls):
        req = eng.submit(P1, gen_cls(max_new_tokens=12))
        for _ in range(4):
            sup.step()
        sup.note_stall()                 # what the watchdog calls
        _drive(sup, [req])
        return [req]
    j, t = _both(tiny, None, script)
    ts = _same(j, t)
    assert ts["recoveries"] == 1
    assert t[1].stats()["last_error"].startswith("stall")


def test_recover_frees_the_dead_runner_first(tiny):
    """recover() releases the old pools before it builds the new runner
    (a full-size pool is never held twice), keeps the released runner
    in place when the rebuild fails, and re-attaches nothing stale."""
    _, te = engines_with_faults(tiny, None)
    old = te.runner
    seen = []
    from paddle_tpu_torch.serving import engine as E
    real = E.ModelRunner

    def spy(*a, **kw):
        seen.append(old.kpool is None and old.state is None)
        return real(*a, **kw)
    E.ModelRunner = spy
    try:
        req = te.submit(P1, TGen(max_new_tokens=6))
        te.step()
        te.recover()
    finally:
        E.ModelRunner = real
    assert seen == [True] and te.runner is not old
    te.run_until_complete(max_steps=100)
    assert req.finish_reason == "length" and req.replays == 1
