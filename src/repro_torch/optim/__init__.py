"""AdamW and int8 gradient compression with error feedback: functional,
over the port's parameter dicts, as the reference's ``repro.optim``."""

from . import grad_compress
from .adamw import AdamWConfig, global_norm, init, schedule, update

__all__ = ["AdamWConfig", "global_norm", "grad_compress", "init",
           "schedule", "update"]
