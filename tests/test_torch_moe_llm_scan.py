"""paddle_tpu_torch MoE training against the JAX package's ``moe_llm``
at 17 narrow layers: the reference runs more than 16 layers under
``lax.scan``, the port in the same Python loop as shallow stacks.  The
check and its tolerances are ``test_torch_moe_llm.check_against_jax``'s."""
from test_torch_moe_llm import check_against_jax


def test_seventeen_layers_match_jax_scan():
    check_against_jax(num_hidden_layers=17, hidden_size=64,
                      moe_intermediate_size=32, num_attention_heads=2,
                      num_key_value_heads=2, vocab_size=128)
