"""The port's user entry points take a model, as the reference's do:
``generate(model, ...)`` (and ``model.generate``), ``create_engine(
model)`` / ``Engine(model)`` and ``serve(model=...)`` on a port
``LlamaForCausalLM`` carrying the reference model's weights give the
reference's greedy tokens, token for token; the ``(state, config)``
forms keep working and give the same tokens."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import create_engine as j_create_engine
from paddle_tpu.serving.request import GenerationConfig as JGen
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import ServingClient, serve
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving.engine import Engine as TEngine
from paddle_tpu_torch.serving.request import GenerationConfig as TGen
from torch_op_parity import cpu_place, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)
KW = dict(max_slots=2, page_size=8, max_model_len=64)
NEW = 6


@pytest.fixture(scope="module")
def pair():
    J.seed(3)
    jm = JL.LlamaForCausalLM(JL.llama_tiny())
    jm.eval()
    prev = T.device._current
    T.set_device("cpu")
    try:
        tm = TL.LlamaForCausalLM(TL.llama_tiny())
    finally:
        T.device._current = prev
    TC.layer_state_from_numpy(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


PROMPTS = rng(6).integers(1, 512, (2, 9)).astype(np.int64)


def test_generate_takes_a_model(pair):
    jm, tm = pair
    want = np.asarray(JG.generate(jm, PROMPTS, max_new_tokens=NEW))
    lengths = np.array([9, 6], np.int32)
    want_len = np.asarray(JG.generate(jm, PROMPTS, max_new_tokens=NEW,
                                      lengths=lengths))
    for got in (TG.generate(tm, PROMPTS, max_new_tokens=NEW),
                T.models.generate(tm, T.to_tensor(PROMPTS),
                                  max_new_tokens=NEW),
                tm.generate(PROMPTS, max_new_tokens=NEW),
                TG.generate(tm.functional_state(), tm.config, PROMPTS,
                            max_new_tokens=NEW, device="cpu")):
        np.testing.assert_array_equal(got.numpy(), want)
    got = TG.generate(tm, PROMPTS, max_new_tokens=NEW,
                      lengths=T.to_tensor(lengths))
    np.testing.assert_array_equal(got.numpy(), want_len)


def _engine_tokens(engine, gen_cls):
    reqs = [engine.submit(p.tolist(), gen_cls(max_new_tokens=NEW))
            for p in PROMPTS]
    while engine.scheduler.has_work():
        engine.step()
    return [r.output_tokens for r in reqs]


def test_create_engine_and_serve_take_a_model(pair):
    jm, tm = pair
    want = _engine_tokens(j_create_engine(jm, **KW), JGen)
    te = t_create_engine(tm, **KW)
    assert te.device.type == "cpu"
    assert _engine_tokens(te, TGen) == want
    assert _engine_tokens(TEngine(tm, **KW), TGen) == want
    state_form = t_create_engine(tm.config, tm.functional_state(),
                                 device="cpu", **KW)
    assert _engine_tokens(state_form, TGen) == want
    with pytest.raises(ValueError):
        t_create_engine(tm, tm.functional_state())
    server = serve(model=tm, **KW)
    try:
        client = ServingClient(server.address, timeout=30.0)
        got = [client.completion(p.tolist(), max_tokens=NEW)["choices"][0]
               ["token_ids"] for p in PROMPTS]
    finally:
        server.stop(drain_timeout=10.0)
    assert got == want
    with pytest.raises(ValueError, match="not both"):
        serve(model=tm, state=tm.functional_state(), start=False)
