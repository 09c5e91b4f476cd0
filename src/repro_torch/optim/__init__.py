"""Optimizer substrate of the port: AdamW with schedules and clipping
(gradient compression comes with the LM slice)."""

from . import adamw
from .adamw import AdamWConfig, AdamWState, make_train_step

__all__ = ["adamw", "AdamWConfig", "AdamWState", "make_train_step"]
