"""Utilities of the port (counterpart of ``coarse_fine_networks_tpu/utils``):
so far the drivers' logger."""

from .logging import get_logger

__all__ = ["get_logger"]
