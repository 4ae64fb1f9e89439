"""paddle_tpu_torch preempt -> spill -> resume in the serving modes.

The deferred-sync, int8-KV-page and LoRA modes of
``test_torch_serving_preempt.py``'s overload scenario against the JAX
engine, the bytes an int8 page spills (its int8 values and f32 scales,
never a dequantized copy), the runner's page read/write (bf16 pages
travel as CPU tensors: numpy has no bfloat16), and LoRA chains that
re-register under their adapter's own root when a request is
preempted.
"""
import pytest
import torch

from test_torch_serving_preempt import (  # noqa: F401  (tiny: a fixture)
    CFG, TGen, check_preempt_mode, engines, overload, tiny)
from paddle_tpu_torch.models import convert as TC
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving.engine import Engine

MODES = {
    "deferred_sync": dict(enable_prefix_cache=True, sync_interval=4),
    "kv_quant": dict(enable_prefix_cache=False, quant="int8",
                     kv_quant=True),
    "lora_cache_on": dict(enable_prefix_cache=True, lora=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_preempt_spill_resume_matches_jax_engine_modes(tiny, mode):
    check_preempt_mode(tiny, MODES[mode])


def test_int8_pages_spill_quantized_bytes(tiny):
    """int8 pages spill as int8 bytes + f32 scales (never dequantized):
    (hd + 4) / (4 hd) of the f32 pages' bytes, on the same pages."""
    dense_j, dense = engines(tiny, preempt=True)
    quant_j, quant = engines(tiny, preempt=True, quant="int8",
                             kv_quant=True)
    overload(dense, TGen)
    overload(quant, TGen)
    hd = TL.llama_tiny(**CFG).head_dim
    d, q = dense.blocks, quant.blocks
    assert q.spilled_pages == d.spilled_pages >= 1
    assert q.spill_bytes * 4 * hd == d.spill_bytes * (hd + 4)
    assert q.spill_bytes == q.spilled_pages * quant._page_bytes() \
        == q.spilled_pages * quant_j._page_bytes()
    assert d.spill_bytes == d.spilled_pages * dense_j._page_bytes()
    snap = quant.quant_snapshot()
    assert snap["spill_bytes_dense_estimate"] == \
        q.spilled_pages * quant._page_bytes(dense=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_read_write_page_roundtrip(tiny, dtype):
    """A page read to the host and written into another pool row comes
    back bit for bit; bf16 pages (which numpy cannot hold) travel as CPU
    tensors and price at the reference's bytes."""
    state = TC.state_from_numpy(tiny["np_state"], device="cpu",
                                dtype=dtype)
    eng = Engine(config=TL.llama_tiny(**CFG), state=state, device="cpu",
                 max_slots=2, page_size=4, max_model_len=128)
    r = eng.runner
    gen = torch.Generator().manual_seed(0)
    r.kpool.copy_(torch.randn(r.kpool.shape, generator=gen))
    r.vpool.copy_(torch.randn(r.vpool.shape, generator=gen))
    page = r.read_page(3)
    assert all(t.device.type == "cpu" and t.dtype == dtype for t in page)
    assert sum(t.nbytes for t in page) == eng._page_bytes()
    r.write_page(7, *page)
    assert torch.equal(r.kpool[:, 7], r.kpool[:, 3])
    assert torch.equal(r.vpool[:, 7], r.vpool[:, 3])
    r.kpool[:, 3] = 0                   # the host copy is a copy
    assert not torch.equal(page[0], r.kpool[:, 3])


def test_int8_page_restore_needs_scales(tiny):
    _, te = engines(tiny, kv_quant=True)
    page = te.runner.read_page(2)
    assert len(page) == 4 and page[2].dtype == torch.float32
    assert sum(t.nbytes for t in page) == te._page_bytes()
    with pytest.raises(ValueError, match="scales"):
        te.runner.write_page(5, *page[:2])
    te.runner.write_page(5, *page)


def test_lora_chains_replay_from_their_own_roots(tiny):
    """A preempted adapter request's committed chunks re-register under
    the adapter's root: its resume matches them, a dense request with
    the same tokens does not."""
    _, te = engines(tiny, preempt=True, enable_prefix_cache=True,
                    lora=True)
    reqs = overload(te, TGen, "alpha", n_new=12)
    assert te.preemptions == 1
    roots = {key[0] for key in te.blocks._index
             if not isinstance(key[0], int) or key[0] < 0}
    assert roots == {(-1, "alpha"), -1}
    victim = next(r for r in reqs if r.preemptions)
    assert victim.prefill_cached_tokens > 0    # its resume hit the cache
    hits = te.blocks.prefix_hits
    dense = te.submit(victim.resume_tokens()[:8].tolist(),
                      TGen(max_new_tokens=2))
    te.run_until_complete(max_steps=100)
    assert dense.num_cached_tokens == 0 and te.blocks.prefix_hits == hits
