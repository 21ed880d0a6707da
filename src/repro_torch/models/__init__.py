from . import layers
from .model import (
    decode_step, forward, forward_with_aux, init_cache, init_params, lm_loss,
    params_from_jax, prefill, schema,
)

__all__ = ["layers", "decode_step", "forward", "forward_with_aux",
           "init_cache", "init_params", "lm_loss", "params_from_jax",
           "prefill", "schema"]
