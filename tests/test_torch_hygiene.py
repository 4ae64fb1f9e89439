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
            "paddle_tpu_torch.ops.pallas.flash_mask; "
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
    # the CPU is taken only when asked for
    engine = create_engine(cfg, state, device="cpu", max_model_len=32)
    assert engine.device.type == "cpu"
    assert engine.kpool.device.type == "cpu"
