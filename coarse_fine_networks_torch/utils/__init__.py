"""Utilities of the port (counterpart of ``coarse_fine_networks_tpu/utils``):
the drivers' logger and progress count, the card's peaks with the count of
a program's work (:mod:`.hw`), and tracing and step timing
(:mod:`.profiling`)."""

from .logging import Progress, get_logger

__all__ = ["get_logger", "Progress"]
