"""paddle_tpu_torch int4 serving against the JAX engine, at tp=1.

The int4 half of ``test_torch_serving_quant.py``'s engine matrix: the
port engine's greedy tokens, token for token against the JAX engine in
float32 on one ``llama_tiny`` model, for int4 weights x int8 KV pages
off/on x prefix cache off/on.
"""
import pytest

from test_torch_serving_quant import (  # noqa: F401  (tiny: a fixture)
    _modes, check_engine_matches_jax_engine, tiny)

MODES = _modes("int4")


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(tiny, mode):  # noqa: F811
    check_engine_matches_jax_engine(tiny, MODES[mode])
