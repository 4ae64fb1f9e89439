"""paddle_tpu_torch's serving watchdog against the JAX package's.

A stall is injected by not stepping an engine that holds an active
request, and the watchdog is driven by explicit ``check(now)`` calls on
an injected clock — no thread, no sleep, no wall-clock race.  On both
packages the same check sequence must trip exactly one stall episode
past ``stall_seconds``, write one hang dump, latch until progress
resumes, and hand the supervisor a stall recovery that replays the
request to the tokens of an undisturbed run.
"""
import json
import pathlib

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu.serving import EngineSupervisor as JSupervisor
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu.serving import Watchdog as JWatchdog
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import EngineSupervisor as TSupervisor
from paddle_tpu_torch.serving import GenerationConfig as TGen
from paddle_tpu_torch.serving import Watchdog as TWatchdog
from paddle_tpu_torch.serving import create_engine as t_create_engine

KW = dict(max_slots=2, page_size=8, num_pages=32, max_model_len=64)
PROMPT = list(range(3, 14))


@pytest.fixture(scope="module")
def weights():
    paddle.seed(9)
    m = LlamaForCausalLM(llama_tiny())
    m.eval()
    return m, {k: np.asarray(v) for k, v in m.functional_state().items()}


def _stall(engine, sup, gen_cls, watchdog_cls, dump_dir):
    """Check times (s) on the injected clock; the engine steps only
    where the script says so."""
    req = engine.submit(PROMPT, gen_cls(max_new_tokens=8))
    sup.step()                                    # admitted, decoding
    wd = watchdog_cls(engine, 1.0, dump_dir=str(dump_dir),
                      clock=lambda: 0.0)
    wd.on_stall = sup.note_stall
    seen = []
    for now in (0.0, 0.4, 0.9, 1.2, 1.6, 3.0):    # no step: stalled
        seen.append((now, wd.check(now), wd.state()["stalled"]))
    stalls_before_resume = wd.stalls
    pending = sup.stats()["stall_pending"]
    sup.step()                           # the stall recovery
    seen.append((3.5, wd.check(3.5), wd.state()["stalled"]))
    sup.step()                           # progress: the episode clears
    seen.append((3.6, wd.check(3.6), wd.state()["stalled"]))
    while not req.is_finished():
        sup.step()
    dump = json.loads(pathlib.Path(wd.last_dump_path).read_text())
    return dict(seen=seen, stalls=stalls_before_resume, pending=pending,
                dumps=sorted(p.name for p in dump_dir.iterdir()),
                dump_keys=sorted(dump), dump_active=dump["active_slots"],
                stalled_for=dump["stalled_for_s"],
                flight_events=[e["event"] for e in dump["flight"]["events"]
                               if e["category"] == "watchdog"],
                tokens=list(req.output_tokens),
                finish=req.finish_reason, replays=req.replays,
                recoveries=sup.stats()["recoveries"])


def test_injected_stall_trips_the_watchdog_on_both(weights, tmp_path):
    m, np_state = weights
    je = j_create_engine(m, **KW)
    te = t_create_engine(TL.llama_tiny(), TC.state_from_numpy(
        np_state, device="cpu"), device="cpu", **KW)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _stall(je, JSupervisor(je, max_recoveries=2), JGen, JWatchdog,
                  tmp_path / "j")
    got = _stall(te, TSupervisor(te, max_recoveries=2), TGen, TWatchdog,
                 tmp_path / "t")
    assert got == want
    # tripped once, past 1 s of no progress, latched until a step
    assert [s[1] for s in got["seen"]] == [False, False, False, True,
                                           False, False, False, False]
    assert [s[2] for s in got["seen"]] == [False, False, False, True,
                                           True, True, True, False]
    assert got["stalls"] == 1 and got["pending"]
    assert got["dumps"] == ["watchdog_1.json"] and got["dump_active"] == 1
    assert got["flight_events"][-1] == "stall"
    # the stall recovery replayed the request without changing its tokens
    assert got["recoveries"] == 1 and got["replays"] == 1
    undisturbed = t_create_engine(
        TL.llama_tiny(), TC.state_from_numpy(np_state, device="cpu"),
        device="cpu", **KW).submit(PROMPT, TGen(max_new_tokens=8))
    assert got["tokens"] == undisturbed.result()
    assert got["finish"] == "length"
