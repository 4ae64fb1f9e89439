"""Models of the port: Llama config, layer math and model state."""
from .convert import (hybrid_params_from_numpy,  # noqa: F401
                      hybrid_params_to_numpy, init_state, state_from_numpy)
from .generation import GenerationConfig  # noqa: F401
from .llama import LlamaConfig, llama3_8b, llama_tiny  # noqa: F401
