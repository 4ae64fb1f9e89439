"""paddle_tpu_torch biased flash attention (K8 with a dense bias) against
the JAX package's streamed long-sequence kernels, forced on at S 256
with ``flash_attention._FORCE_STREAM``: the cases of
``test_torch_flash_mask_bias.py`` (every broadcast shape of the bias,
whose streamed dbias kernel reduces in-kernel), at the same tolerances.
"""
import pytest

from test_torch_flash_mask_bias import CASES, check_bias_case
from test_torch_flash_mask_grad import interpret_mode


@pytest.fixture
def streamed():
    with interpret_mode(stream=True):
        yield


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_biased_grads_match_jax_stream_kernels(streamed, case, monkeypatch):
    check_bias_case(case, monkeypatch)
