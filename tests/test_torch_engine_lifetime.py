"""A closed or dropped engine is freed.

The observability slots (``quant.json``, ``lora.json``) hold engines
and workers weakly, and ``Engine.close()`` and ``EngineWorker.stop()``
clear the slots that hold them, so once its last reference is dropped
the engine and its state tensors are collected, closed or not.  Each case holds a weakref to the engine and to
one of its state tensors and requires both dead after ``gc.collect()``:
dense, ``kv_quant``, ``quant="int8"`` and multi-LoRA engines, and the
engine of a stopped server.  A slot that holds another engine stays.
The reference has no ``close()``: this is the port's own release path,
so no reference runs here."""
import gc
import weakref

import pytest
import torch

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import GenerationConfig, create_engine, serve
from paddle_tpu_torch.serving.lora import AdapterStore, random_adapter

CFG = TL.llama_tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_key_value_heads=2)
KW = dict(device="cpu", max_slots=2, page_size=8, max_model_len=64)


def _engine(mode):
    state = TC.init_state(CFG, torch.Generator().manual_seed(3),
                          device="cpu")
    kw = dict(KW)
    if mode == "kv_quant":
        kw["kv_quant"] = True
    elif mode == "int8":
        kw["quant"] = "int8"
    elif mode == "lora":
        store = AdapterStore(CFG, capacity=2)
        store.register("a", random_adapter(CFG, 4, seed=1), alpha=8.0)
        kw["lora"] = store
    eng = create_engine(CFG, state, **kw)
    req = eng.submit([1, 2, 3], GenerationConfig(max_new_tokens=2),
                     **({"adapter": "a"} if mode == "lora" else {}))
    eng.run_until_complete(max_steps=50)
    assert req.finish_reason == "length"
    return eng


def _refs(eng):
    tensor = next(iter(eng.runner.state.values())) \
        if hasattr(eng.runner, "state") else None
    return weakref.ref(eng), (weakref.ref(tensor) if tensor is not None
                              else None)


def _assert_freed(refs):
    gc.collect()
    eng_ref, tensor_ref = refs
    assert eng_ref() is None, gc.get_referrers(eng_ref())[:3]
    if tensor_ref is not None:
        assert tensor_ref() is None


@pytest.mark.parametrize("mode", ["dense", "kv_quant", "int8", "lora"])
def test_closed_engine_is_freed(mode):
    eng = _engine(mode)
    refs = _refs(eng)
    eng.close()
    del eng
    _assert_freed(refs)
    assert obs.active_quant() is None and obs.active_lora() is None


@pytest.mark.parametrize("mode", ["kv_quant", "int8", "lora"])
def test_dropped_engine_is_freed_without_close(mode):
    eng = _engine(mode)
    refs = _refs(eng)
    assert (obs.active_lora() if mode == "lora" else obs.active_quant()) \
        is eng
    del eng
    _assert_freed(refs)
    assert obs.active_quant() is None and obs.active_lora() is None


def test_stopped_servers_engine_is_freed():
    eng = _engine("lora")
    refs = _refs(eng)
    server = serve(engine=eng)
    server.stop(drain_timeout=5.0)
    eng.close()
    del eng, server
    _assert_freed(refs)


def test_close_keeps_another_engines_slot():
    first, second = _engine("int8"), _engine("int8")
    assert obs.active_quant() is second
    first.close()
    assert obs.active_quant() is second
    second.close()
    assert obs.active_quant() is None
