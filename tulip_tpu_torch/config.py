"""Static model configuration, shared with the JAX package.

``tulip_tpu.config`` is pure Python; its ``model_config_from_args`` imports
jax and is deliberately not re-exported here.
"""

from tulip_tpu.config import (  # noqa: F401
    ModelConfig, StageConfig, _resolve_window, model_config,
)

__all__ = ["ModelConfig", "StageConfig", "model_config", "_resolve_window"]
