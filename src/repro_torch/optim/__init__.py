"""Optimizer substrate of the port: AdamW with schedules and clipping,
and int8 gradient compression with error feedback."""

from . import adamw, compress
from .adamw import AdamWConfig, AdamWState, make_train_step

__all__ = ["adamw", "compress", "AdamWConfig", "AdamWState",
           "make_train_step"]
