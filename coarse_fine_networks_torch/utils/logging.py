"""The port's logger and progress count (counterpart of
``coarse_fine_networks_tpu/utils/logging.py``): the drivers log to
``cfn_torch``; the command lines attach a handler to it so that a user
sees those lines."""

from __future__ import annotations

import logging
import sys
import time


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


class Progress:
    """A progress count that logs ``name n/total (rate it/s)`` at every
    ``log_every``-th item and at ``total`` (``coarse_fine_networks_tpu/
    utils/logging.py``'s ``Progress``, through the port's logger)."""

    def __init__(self, name: str, total: int, log_every: int = 50,
                 logger: logging.Logger | None = None):
        self.name = name
        self.total = total
        self.log_every = log_every
        self.logger = logger or get_logger()
        self.start = time.time()
        self.n = 0

    def update(self, n: int = 1) -> None:
        """Count ``n`` more items, and log where the count reaches a
        multiple of ``log_every`` or ``total``."""
        self.n += n
        if self.n % self.log_every == 0 or self.n == self.total:
            rate = self.n / max(time.time() - self.start, 1e-9)
            self.logger.info("%s %d/%d (%.2f it/s)", self.name, self.n,
                             self.total, rate)
