"""Checkpoints: the port's own train-state files, and the interchange of
JAX-package variables into the port's ``state_dict``."""

from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .from_jax import state_dict_from_jax

__all__ = ["latest_checkpoint", "load_checkpoint", "save_checkpoint",
           "state_dict_from_jax"]
