"""paddle_tpu_torch MoE training against the JAX package's ``moe_llm``
at ``moe_tiny`` with 2 shared experts (DeepSeekMoE's always-on dense
FFN, ``sw1``/``sw2``).  The check and its tolerances are
``test_torch_moe_llm.check_against_jax``'s."""
from test_torch_moe_llm import check_against_jax


def test_shared_experts_match_jax():
    check_against_jax(num_shared_experts=2)
