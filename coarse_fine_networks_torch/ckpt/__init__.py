"""Checkpoints: the port's own train-state files, the interchange of
JAX-package variables into the port's ``state_dict``, and strict loading
for serving and conversion."""

from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .from_jax import state_dict_from_jax
from .strict import checkpoint_tensors, load_strict

__all__ = ["checkpoint_tensors", "latest_checkpoint", "load_checkpoint",
           "load_strict", "save_checkpoint", "state_dict_from_jax"]
