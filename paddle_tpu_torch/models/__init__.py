"""Models of the port: Llama config, layer math, the nn.Layer model,
model state, one-shot generation; the MoE model is ``models.moe_llm``."""
from .convert import (hybrid_params_from_numpy,  # noqa: F401
                      hybrid_params_to_numpy, init_state,
                      layer_state_from_numpy,
                      moe_params_from_numpy, moe_params_to_numpy,
                      shard_serving_adapter, shard_serving_state,
                      state_from_numpy)
from .generation import (GenerationConfig, build_generate_fn,  # noqa: F401
                         build_generate_fn_beam, build_generate_fn_paged,
                         generate, generate_from_state)
from .generation import quantize_state as quantize_generation_state  # noqa
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaPretrainingCriterion, llama3_8b, llama_tiny)
