"""paddle_tpu_torch's observability stack against the JAX package's.

Unit level: ``traceparent`` parsing and formatting round-trip alike,
and the time-series, profiling and capture modules produce the
reference's JSON shapes; the resource tracker prices an H100 at its
dense bf16 peak and samples a CPU engine's memory as host RSS alone.

Engine level: one JAX ``llama_tiny`` model's weights drive both
engines (the port's on the CPU), each with a UsageMeter, a RequestLog,
an SLOTracker and its own injected clock, through the same traffic —
two tenants decoding, then a priority-1 arrival with every slot taken
under ``FLAGS_serving_fair_share``.  Both must preempt the same
(heaviest-page-second) tenant's request, and give the same per-tenant
usage table (page-seconds included), request-log cause totals, SLO
verdicts, flight-recorder event sequence, and span names and parents
for every request.  The ring fetch's wall seconds (the host-sync share
of a request's timeline) are pinned to 0 in both engines, so every
attributed second comes from the injected clock.
"""
import json
import time
import types

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
import paddle_tpu.serving.engine as jengine_mod
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import SLOConfig as JSLOConfig
from paddle_tpu.serving import SLOTracker as JSLOTracker
from paddle_tpu.serving import create_engine as j_create_engine
import paddle_tpu_torch.observability as tobs
import paddle_tpu_torch.serving.engine as tengine_mod
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.observability import resources as TR
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import SLOConfig as TSLOConfig
from paddle_tpu_torch.serving import SLOTracker as TSLOTracker
from paddle_tpu_torch.serving import create_engine as t_create_engine

PAGE = 8


# ------------------------------------------------------------ unit level
TRACEPARENTS = [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",
    "00-xyz7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c", "", None, 42,
]


def test_traceparent_round_trips_equal():
    for header in TRACEPARENTS:
        j, t = (jobs.parse_traceparent(header),
                tobs.parse_traceparent(header))
        assert (None if t is None else tuple(t)) == \
            (None if j is None else tuple(j)), header
        if t is not None:
            assert tobs.format_traceparent(t) == \
                jobs.format_traceparent(j)
            assert tobs.parse_traceparent(tobs.format_traceparent(t)) == t
    ctx = tobs.tracer().start_span("unit").context
    assert tobs.parse_traceparent(tobs.format_traceparent(ctx)) == ctx


def _shape(obj):
    """A JSON document's shape: keys and value kinds, not values."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_shape(obj[0])] if obj else []
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return type(obj).__name__
    return "number"


def _timeseries_doc(obs):
    now = [0.0]
    store = obs.TimeSeriesStore(capacity=16, clock=lambda: now[0])
    level = iter([0.0, 2.0, 3.0, 0.5, 0.2])
    store.add_source("pressure", lambda: next(level))
    store.add_rate("pressure_rate", of="pressure")
    store.add_rule(obs.AlertRule("pressure_high", "pressure", above=1.0,
                                 min_samples=1))
    fired = []
    cap = obs.DiagnosticCapture(dir_=None, min_interval_s=0.0,
                                max_captures=4, clock=lambda: now[0])
    cap.attach(store)
    for t in (1.0, 2.0, 3.0, 4.0, 5.0):
        now[0] = t
        store.tick()
        fired.append(store.firing())
    bundle = cap.recent()[0]
    bundle = {k: v for k, v in bundle.items()
              if k not in ("flight", "resources")}
    return {"windows": store.windows(), "state": store.state(),
            "firing": fired, "capture_index": cap.index(),
            "bundle": bundle}


def test_timeseries_and_capture_give_the_reference_documents():
    j, t = _timeseries_doc(jobs), _timeseries_doc(tobs)
    assert json.loads(json.dumps(t)) == json.loads(json.dumps(j))


def _profile_doc(obs):
    prof = obs.SamplingProfiler(0.01, phases=lambda: {})
    for t in (1.0, 2.0):
        prof.sample(t)
    return {"snapshot": prof.snapshot(), "stats": prof.stats(),
            "chrome": prof.chrome_events()}


def test_profiling_gives_the_reference_shapes():
    j, t = _profile_doc(jobs), _profile_doc(tobs)
    assert _shape(t) == _shape(j)
    assert t["stats"]["samples"] == j["stats"]["samples"] == 2


def test_resource_tracker_prices_the_h100():
    assert TR._peak_flops("NVIDIA H100 80GB HBM3") == 989.0e12
    tr = TR.ResourceTracker()
    tr.set_model(n_params=8_030_261_248,
                 device_kind="NVIDIA H100 80GB HBM3", device=None)
    snap = tr.snapshot()["throughput"]
    assert snap["peak_flops"] == 989.0e12
    # a CPU engine's memory sample is host RSS alone (no device entry)
    tr.set_model(n_params=1, device_kind=None, device="cpu")
    tr.sample_memory()
    mem = tr.snapshot()["memory"]
    assert mem["devices"] == {} and mem["host_rss_bytes"] > 0
    assert mem["samples"] == 1
    # the reference's sections and fields (their maps' keys — jits, ops,
    # devices, pool gauges — depend on what else ran in the process)
    got, want = tr.snapshot(), jobs.ResourceTracker().snapshot()
    assert set(got) == set(want)
    for section in ("memory", "compiles", "goodput", "throughput"):
        assert set(got[section]) == set(want[section]), section


# ---------------------------------------------------------- engine level
@pytest.fixture(scope="module")
def weights():
    paddle.seed(7)
    m = LlamaForCausalLM(llama_tiny())
    m.eval()
    return m, {k: np.asarray(v) for k, v in m.functional_state().items()}


SLO = dict(ttft_s=0.015, tpot_s=0.012, e2e_s=0.15, objective=0.9)


def _prompts():
    rng = np.random.RandomState(4)
    return (rng.randint(1, 512, 5 * PAGE + 3).tolist(),    # tenant a
            rng.randint(1, 512, PAGE + 2).tolist(),         # tenant b
            rng.randint(1, 512, 6).tolist())                # priority 1


def _drive(engine, gen_cls, clock):
    """a at step 0, b at step 1 (the most recently admitted, the victim
    without fair share), a priority-1 arrival at step 4 with both slots
    taken; 10 ms of engine clock per step."""
    pa, pb, pc = _prompts()
    reqs = []
    for step in range(200):
        if step == 0:
            reqs.append(engine.submit(pa, gen_cls(max_new_tokens=10),
                                      tenant="a"))
        elif step == 1:
            reqs.append(engine.submit(pb, gen_cls(max_new_tokens=10),
                                      tenant="b"))
        elif step == 4:
            reqs.append(engine.submit(pc, gen_cls(max_new_tokens=5),
                                      tenant="c", priority=1))
        engine.step()
        clock[0] += 0.01
        if step > 4 and not engine.scheduler.has_work():
            return reqs
    raise AssertionError("traffic did not finish")


def _spans(obs, reqs):
    """Per request: the sorted (span name, parent span name) pairs of its
    trace."""
    spans = obs.tracer().spans()
    out = []
    for r in reqs:
        mine = [s for s in spans if s.trace_id == r.root_span.trace_id]
        names = {s.span_id: s.name for s in mine}
        out.append(sorted((s.name, names.get(s.parent_id))
                          for s in mine))
    return out


def _run(pkg, monkeypatch):
    clock = [0.0]
    usage = pkg.usage(max_tenants=8)
    log = pkg.requestlog(k=4)
    slo = pkg.slo(pkg.slo_config(**SLO))
    engine = pkg.create(clock=lambda: clock[0], usage=usage,
                        requestlog=log, slo=slo)
    pkg.obs.flight_recorder().clear()
    reqs = _drive(engine, pkg.gen, clock)
    flight = [(e["category"], e["event"])
              for e in pkg.obs.flight_recorder().snapshot()]
    snap = log.snapshot()
    exemplars = {d: [(r["dimension"], r["score_s"], r["tenant"])
                     for r in lst]
                 for d, lst in snap["exemplars"]["by_dimension"].items()}
    return types.SimpleNamespace(
        tokens=[r.output_tokens for r in reqs],
        preemptions=[r.preemptions for r in reqs],
        finish=[r.finish_reason for r in reqs],
        usage=usage.snapshot(),
        causes=snap["attribution_totals_s"],
        log={k: snap[k] for k in ("finished", "requests_tracked",
                                  "conservation_max_delta")},
        exemplars=exemplars, slo=slo.stats(), flight=flight,
        spans=_spans(pkg.obs, reqs), stats=engine.stats())


@pytest.fixture(scope="module")
def runs(weights):
    m, np_state = weights
    mp = pytest.MonkeyPatch()
    # the ring fetch's wall seconds charge the host-sync share of each
    # timeline: pin them (and every span time) to 0 in both engines
    still = types.SimpleNamespace(perf_counter=lambda: 0.0,
                                  sleep=time.sleep,
                                  monotonic=time.monotonic)
    mp.setattr(jengine_mod, "time", still)
    mp.setattr(tengine_mod, "time", still)
    mp.setitem(JFLAGS, "FLAGS_serving_fair_share", True)
    mp.setitem(TFLAGS, "FLAGS_serving_fair_share", True)
    kw = dict(max_slots=2, page_size=PAGE, num_pages=40, max_model_len=64,
              enable_prefix_cache=True, preempt=True)
    from paddle_tpu.observability.requestlog import RequestLog as JLog
    from paddle_tpu.observability.usage import UsageMeter as JUsage
    from paddle_tpu_torch.observability.requestlog import RequestLog as TLog
    from paddle_tpu_torch.observability.usage import UsageMeter as TUsage
    jpkg = types.SimpleNamespace(
        obs=jobs, gen=JGen, usage=JUsage, requestlog=JLog,
        slo=JSLOTracker, slo_config=JSLOConfig,
        create=lambda **k: j_create_engine(m, **kw, **k))
    tpkg = types.SimpleNamespace(
        obs=tobs, gen=TGen, usage=TUsage, requestlog=TLog,
        slo=TSLOTracker, slo_config=TSLOConfig,
        create=lambda **k: t_create_engine(
            TL.llama_tiny(), TC.state_from_numpy(np_state, device="cpu"),
            device="cpu", **kw, **k))
    try:
        yield _run(jpkg, mp), _run(tpkg, mp)
    finally:
        mp.undo()


def test_fair_share_picks_the_same_victim(runs):
    j, t = runs
    assert t.tokens == j.tokens and t.finish == j.finish
    # tenant a holds the most page-seconds: it is preempted, not b (the
    # most recently admitted, the choice without fair share)
    assert t.preemptions == j.preemptions == [1, 0, 0]
    for key in ("preemptions", "spilled_pages", "restored_pages",
                "decode_steps", "prefix_hits"):
        assert t.stats[key] == j.stats[key], key


def test_usage_table_is_the_reference_table(runs):
    j, t = runs
    assert t.usage == j.usage
    assert set(t.usage["tenants"]) == {"a", "b", "c"}
    assert t.usage["tenants"]["a"]["page_seconds"] > \
        t.usage["tenants"]["b"]["page_seconds"] > 0
    cons = t.usage["conservation"]
    assert cons["device_delta"] == 0 and cons["host_delta"] == 0
    assert cons["host_page_seconds"] > 0   # the spill tier was charged


def test_requestlog_and_slo_agree(runs):
    j, t = runs
    assert t.causes == j.causes
    assert t.log == j.log and t.log["conservation_max_delta"] == 0
    assert t.causes["preempted"] > 0 and t.causes["decode"] > 0
    assert t.exemplars == j.exemplars
    assert t.slo == j.slo
    assert sum(t.slo["violations"].values()) > 0
    assert sum(t.slo["good"].values()) > 0


def test_span_names_and_parents_agree(runs):
    j, t = runs
    assert t.spans == j.spans
    names = {n for per_req in t.spans for n, _ in per_req}
    assert {"request", "scheduler.queue_wait", "engine.prefill",
            "engine.decode", "engine.preempt_spill",
            "engine.resume"} <= names
    assert t.flight == j.flight


def test_dump_writes_the_side_files(weights, tmp_path):
    """``obs.dump()`` writes quant.json and lora.json for the engine
    that registered itself last, as the reference's does."""
    from paddle_tpu_torch.serving import AdapterStore, random_adapter
    _, np_state = weights
    cfg = TL.llama_tiny()
    store = AdapterStore(cfg, capacity=2, rank=4)
    store.register("a1", random_adapter(cfg, 4, seed=1))
    engine = t_create_engine(cfg, TC.state_from_numpy(np_state,
                                                      device="cpu"),
                             device="cpu", max_slots=2, page_size=PAGE,
                             max_model_len=64, quant="int8",
                             kv_quant=True, lora=store)
    out = tobs.dump(str(tmp_path))
    files = {p.name for p in tmp_path.iterdir()}
    assert out == str(tmp_path)
    assert {"metrics.prom", "metrics.json", "retraces.json", "trace.json",
            "flight.json", "resources.json", "quant.json",
            "lora.json"} <= files
    quant = json.loads((tmp_path / "quant.json").read_text())
    assert quant == engine.quant_snapshot()
    assert quant["weight_kind"] == "int8" and quant["kv_quant"]
    lora = json.loads((tmp_path / "lora.json").read_text())
    assert lora["bank_bytes_device"] == engine.runner.lora_bank_bytes()
    tobs.set_active_quant(None)
    tobs.set_active_lora(None)
