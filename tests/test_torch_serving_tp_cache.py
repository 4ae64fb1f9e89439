"""paddle_tpu_torch's tensor-parallel serving engine at tp=4 against the
JAX engine at the same mesh: greedy parity, prefix-cache eviction under
pool pressure, and the mesh's resource report.

Mirrors the tp=4 scenarios of ``tests/test_serving_tp.py`` (the tp=2
ones are in ``test_torch_serving_tp.py``), on the reference's tp test
model and weights, the port's ranks as gloo processes on the CPU.
"""
import numpy as np
import pytest

from paddle_tpu.observability.resources import resource_tracker as j_tracker
from paddle_tpu.serving import GenerationConfig as JGen
from paddle_tpu_torch.observability.resources import resource_tracker
from paddle_tpu_torch.serving import create_engine as t_create_engine
from paddle_tpu_torch.serving import GenerationConfig as TGen

from torch_serving_tp import (cpu_ranks, greedy, one_shot, pair,
                              port_state, same_requests, same_stats,
                              tp_model)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    with cpu_ranks(4):
        yield


@pytest.fixture(scope="module")
def model():
    return tp_model()


def test_mesh_one_shot_greedy_parity_tp4(model):
    """Greedy parity at tp=4, every rank in step."""
    one_shot(model, 4)


def test_mesh_prefix_cache_eviction_under_pressure(model):
    """LRU eviction under pool pressure at tp=4: a disjoint request
    reclaims parked pages from the head-sharded pools, to the JAX
    engine's tokens and counters."""
    a = np.arange(1, 17).astype(np.int32)       # 2 full pages, ps=8
    d = np.arange(40, 64).astype(np.int32)      # disjoint, 3 pages
    je, te = pair(model, max_slots=1, page_size=8, num_pages=4,
                  max_model_len=32, enable_prefix_cache=True, mesh=4)
    for eng, gen in ((je, JGen), (te, TGen)):
        ra = eng.submit(a, gen(max_new_tokens=8))
        eng.run_until_complete(max_steps=100)
        assert eng.stats()["cached_pages"] == 2
        rd = eng.submit(d, gen(max_new_tokens=8))
        eng.run_until_complete(max_steps=100)
        eng.reqs = [ra, rd]
    same_requests(je.reqs, te.reqs)
    assert te.stats()["prefix_evictions"] >= 1
    assert te.decode_traces == 1
    same_stats(je, te)


def test_mesh_info_and_resource_snapshot(model):
    """``mesh_info`` lists every rank's device, mesh position and
    footprints (each rank's pool 1/4 of the tp=1 pool), the engine's
    resource snapshot embeds it, and the process's resource tracker
    carries each rank's mesh position, as the reference's do."""
    _, np_state, tcfg = model
    kw = dict(max_slots=2, page_size=8, max_model_len=64)
    prompt = [np.arange(1, 9).astype(np.int32)]
    eng1 = t_create_engine(tcfg, port_state(np_state), device="cpu", **kw)
    full = eng1.runner.mesh_info()["devices"][0]["kv_pool_bytes"]
    je, eng = pair(model, mesh=4, **kw)
    greedy(je, prompt, [4], JGen)
    greedy(eng, prompt, [4], TGen)
    info, jinfo = eng.runner.mesh_info(), je.runner.mesh_info()
    assert info["tp"] == jinfo["tp"] == 4 and info["axis"] == "tp"
    assert len(info["devices"]) == 4
    for i, (dev, jdev) in enumerate(zip(info["devices"], jinfo["devices"])):
        assert dev["tp"] == i and dev["device"] == f"cpu:{i}"
        for key in ("kv_pool_bytes", "weight_bytes", "lora_bank_bytes"):
            assert dev[key] == jdev[key]
    assert info["devices"][0]["kv_pool_bytes"] == full // 4
    snap = eng.resource_snapshot()
    assert snap["mesh"]["tp"] == 4 and len(snap["mesh"]["devices"]) == 4
    tracked = resource_tracker().snapshot()["memory"]["devices"]
    jtracked = j_tracker().snapshot()["memory"]["devices"]
    for dev, jdev in zip(info["devices"], jinfo["devices"]):
        assert tracked[dev["device"]]["mesh"] == {"tp": dev["tp"]} \
            == jtracked[jdev["device"]]["mesh"]
