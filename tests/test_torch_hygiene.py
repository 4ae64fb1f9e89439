"""The port stands alone: no JAX, no reference package, no silent CPU.

``paddle_tpu_torch`` and ``chip_smoke.py`` must import neither ``jax``
nor anything of ``paddle_tpu`` (importing the reference pulls in jax and
turns on x64 for the whole process), and the entry points must run on
CUDA unless the caller asks for the CPU — without a card they raise.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_reference_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, paddle_tpu_torch.serving, paddle_tpu_torch.models, "
            "paddle_tpu_torch.models.llama_hybrid, "
            "paddle_tpu_torch.ops.pallas.flash_mask, "
            "paddle_tpu_torch.ops.pallas.lora_matmul, "
            "paddle_tpu_torch.nn.quant, paddle_tpu_torch.serving.lora, "
            "paddle_tpu_torch.nn.functional_extra2, "
            "paddle_tpu_torch.serving.parallel.layers, "
            "paddle_tpu_torch.serving.parallel.mesh, "
            "paddle_tpu_torch.serving.parallel.runner, "
            "paddle_tpu_torch.serving.parallel.worker, "
            "paddle_tpu_torch.ops.pallas.decode_attention, "
            "paddle_tpu_torch.models.generation, "
            "paddle_tpu_torch.models.moe_llm, "
            "paddle_tpu_torch.distributed.moe, "
            "paddle_tpu_torch.ops.pallas.grouped_ffn, "
            "paddle_tpu_torch.ops.pallas.rms_norm, "
            "paddle_tpu_torch.incubate.nn.functional, "
            "paddle_tpu_torch.flags, paddle_tpu_torch.serving.faults, "
            "paddle_tpu_torch.serving.spec, "
            "paddle_tpu_torch.serving.supervisor, "
            "paddle_tpu_torch.serving.server, "
            "paddle_tpu_torch.serving.router, "
            "paddle_tpu_torch.serving.client, "
            "paddle_tpu_torch.serving.watchdog, "
            "paddle_tpu_torch.serving.slo, "
            "paddle_tpu_torch.serving.lora.batch, "
            "paddle_tpu_torch.observability.tracing, "
            "paddle_tpu_torch.observability.resources, "
            "paddle_tpu_torch.observability.usage, "
            "paddle_tpu_torch.observability.requestlog, "
            "paddle_tpu_torch.observability.timeseries, "
            "paddle_tpu_torch.observability.profiling, "
            "paddle_tpu_torch.observability.capture, "
            "paddle_tpu_torch.sanitizer, "
            "paddle_tpu_torch.sanitizer.lockset, "
            "paddle_tpu_torch.sanitizer.findings, "
            "paddle_tpu_torch.distributed.env, "
            "paddle_tpu_torch.distributed.mesh, "
            "paddle_tpu_torch.distributed.collective, "
            "paddle_tpu_torch.distributed.mp_ops, "
            "paddle_tpu_torch.distributed.pipelining, "
            "paddle_tpu_torch.distributed.pipeline_schedules, "
            "paddle_tpu_torch.ops.ring_attention, "
            "paddle_tpu_torch.framework.dtype, "
            "paddle_tpu_torch.framework.random, "
            "paddle_tpu_torch.framework.tensor, "
            "paddle_tpu_torch.framework.tensor_methods, "
            "paddle_tpu_torch.device, paddle_tpu_torch.autograd.tape, "
            "paddle_tpu_torch.autograd.functional, "
            "paddle_tpu_torch.autograd.py_layer, "
            "paddle_tpu_torch.amp.auto_cast, "
            "paddle_tpu_torch.profiler.statistic, "
            "paddle_tpu_torch.ops.registry, paddle_tpu_torch.ops.math, "
            "paddle_tpu_torch.ops.reduction, "
            "paddle_tpu_torch.ops.manipulation, "
            "paddle_tpu_torch.ops.creation, "
            "paddle_tpu_torch.ops.comparison, "
            "paddle_tpu_torch.ops.indexing, paddle_tpu_torch.nn.layer, "
            "paddle_tpu_torch.nn.initializer, "
            "paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.nn.layer_common, "
            "paddle_tpu_torch.nn.layer_norm, paddle_tpu_torch.nn.clip, "
            "paddle_tpu_torch.optimizer.optimizer, "
            "paddle_tpu_torch.optimizer.optimizers, "
            "paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.models.llama; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")


def test_entry_points_default_to_cuda():
    _no_card()
    from paddle_tpu_torch.models import init_state, llama_tiny, \
        state_from_numpy
    from paddle_tpu_torch.serving import Engine, create_engine
    cfg = llama_tiny(num_hidden_layers=1)
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_engine(cfg, state)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(config=cfg, state=state)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy({"w": np.zeros(3, np.float32)})
    # the serving modes too: no quantization, no bank without a card
    from paddle_tpu_torch.serving import AdapterStore
    store = AdapterStore(cfg, capacity=1, rank=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_engine(cfg, state, quant="int8", kv_quant=True, lora=store)
    # one-shot generation too, whatever the mode
    from paddle_tpu_torch.models import generate
    for kw in ({}, {"cache": "paged"}, {"weight_quant": "int8"},
               {"num_beams": 2}):
        with pytest.raises(RuntimeError, match="CUDA"):
            generate(state, cfg, np.zeros((1, 4), np.int64),
                     max_new_tokens=2, **kw)
    # MoE training too
    from paddle_tpu_torch.models import moe_llm
    mcfg = moe_llm.moe_tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        moe_llm.setup(mcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        moe_llm.init_params(mcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        moe_llm.build_train_step(mcfg)
    # the CPU is taken only when asked for
    engine = create_engine(cfg, state, device="cpu", max_model_len=32)
    assert engine.device.type == "cpu"
    assert engine.kpool.device.type == "cpu"


def test_front_end_and_mask_helpers_default_to_cuda():
    """The HTTP server's ``serve`` builds its engine on CUDA unless told
    otherwise, and so does the flashmask interval helper that takes a
    device (it made CPU tensors by default before)."""
    _no_card()
    from paddle_tpu_torch.models import init_state, llama_tiny
    from paddle_tpu_torch.ops.pallas import flash_mask as FM
    from paddle_tpu_torch.serving import serve
    cfg = llama_tiny(num_hidden_layers=1)
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, state, max_model_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        FM.sliding_window_intervals(64, 8)
    assert FM.sliding_window_intervals(64, 8, device="cpu").device.type \
        == "cpu"
    srv = serve(cfg, state, device="cpu", max_model_len=32)
    try:
        assert srv.worker.engine.device.type == "cpu"
    finally:
        srv.stop(drain_timeout=5.0)


def test_parallel_env_defaults_to_nccl_on_cuda():
    """``init_parallel_env()`` means NCCL on this process's card, and
    raises without one; gloo serves only ``device="cpu"``.  A gloo group
    refuses CUDA tensors (no gloo on the card's tensors)."""
    _no_card()
    import torch.distributed as dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import llama_hybrid as TH
    with pytest.raises(RuntimeError, match="CUDA"):
        D.init_parallel_env()
    with pytest.raises(RuntimeError, match="CUDA"):
        D.init_parallel_env(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TH.setup(TH.LlamaConfig(num_hidden_layers=1), mesh=None)
    assert not dist.is_initialized()


def test_serving_mesh_defaults_to_cuda():
    """A serving mesh means one process per CUDA card: ``mesh_devices``
    and ``create_engine(mesh=2)`` with no device raise without a card,
    before any worker starts; the workers' entry lives in the port
    (a spawned worker imports that module, so nothing of the caller's
    ``__main__`` or of JAX)."""
    _no_card()
    import multiprocessing
    from paddle_tpu_torch.models import init_state, llama_tiny
    from paddle_tpu_torch.serving import create_engine
    from paddle_tpu_torch.serving.parallel import mesh_devices
    from paddle_tpu_torch.serving.parallel import worker as W
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        mesh_devices(2)
    cfg = llama_tiny(num_hidden_layers=1)
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    children = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="CUDA"):
        create_engine(cfg, state, mesh=2)
    assert set(multiprocessing.active_children()) == children
    assert W._worker_main.__module__ == \
        "paddle_tpu_torch.serving.parallel.worker"
