"""Dense checkpoint -> quantized serving state conversion.

Ports ``paddle_tpu/serving/quantize.py``.  Only the per-projection
matmul weights (q/k/v/o, gate/up/down) become
:class:`~paddle_tpu_torch.ops.pallas.quant_matmul.QuantizedWeight`
leaves; embeddings and norms (gathers and elementwise ops) and
``lm_head`` (its logits feed the greedy argmax, where weight error moves
emitted tokens the most) stay dense.  The conversion runs on whatever
device the state lives on.
"""
from __future__ import annotations

# only the per-projection matmul weights are quantized; everything else
# (embeddings, norms, lm_head) stays dense
from ..models.llama import MATMUL_KEYS
from ..nn.quant import weight_quantize
from ..ops.pallas.quant_matmul import QuantizedWeight

__all__ = ["quantize_state"]


def quantize_state(state: dict, kind: str = "int8", skip=()) -> dict:
    """Convert a dense llama state dict into a quantized serving state.

    Every per-projection matmul weight becomes a ``QuantizedWeight``
    (``kind="int8"``: int8 values + per-output-channel f32 scale;
    ``kind="int4"``: the same, nibble-packed ``[K/2, N]``).  ``skip``
    names key suffixes to keep dense.  Leaves that are already
    ``QuantizedWeight`` pass through untouched, so the conversion is
    idempotent.  The returned dict drops nothing."""
    if kind not in ("int8", "int4"):
        raise ValueError(
            f"quant kind must be 'int8' or 'int4', got {kind!r}")
    algo = f"weight_only_{kind}"
    skip = tuple(skip)
    out = {}
    for name, arr in state.items():
        if (not name.endswith(MATMUL_KEYS)
                or (skip and name.endswith(skip))
                or isinstance(arr, QuantizedWeight)):
            out[name] = arr
            continue
        if kind == "int4" and arr.shape[0] % 2:
            raise ValueError(
                f"{name!r}: int4 nibble packing needs an even K, got "
                f"{arr.shape[0]}")
        q, scale = weight_quantize(arr, algo)
        out[name] = QuantizedWeight(q, scale, kind=kind, k=arr.shape[0])
    return out
