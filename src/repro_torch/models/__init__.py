from . import layers
from .model import (
    decode_step, forward, init_cache, init_params, params_from_jax, schema,
)

__all__ = ["layers", "decode_step", "forward", "init_cache", "init_params",
           "params_from_jax", "schema"]
