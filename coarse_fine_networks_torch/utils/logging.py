"""The port's logger (counterpart of
``coarse_fine_networks_tpu/utils/logging.py``): the drivers log to
``cfn_torch``; the command lines attach a handler to it so that a user
sees those lines."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "cfn_torch") -> logging.Logger:
    """``name``'s logger with one stdout handler at INFO (added on the first
    call only), not propagating to the root logger."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
