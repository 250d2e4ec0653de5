"""The port's ``Progress`` against the JAX package's: the same log lines at
the same counts (the rate aside), through each package's logger."""

import logging

import pytest

from coarse_fine_networks_tpu.utils import Progress as JaxProgress
from coarse_fine_networks_torch.utils import Progress, get_logger


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        # the message without its rate, which depends on the clock
        self.lines.append(record.getMessage().rsplit(" (", 1)[0])


def _run(cls, logger, total, log_every, steps):
    rec = _Records()
    logger.addHandler(rec)
    try:
        p = cls("epoch", total, log_every=log_every, logger=logger)
        for n in steps:
            p.update(n)
    finally:
        logger.removeHandler(rec)
    return rec.lines, p.n


@pytest.mark.parametrize("total,log_every,steps", [
    (7, 3, [1] * 7),            # every third item, and the total
    (10, 5, [2, 3, 1, 4]),      # counts that jump past a multiple
    (4, 50, [1, 1, 1, 1]),      # only the total
    (6, 2, [1] * 8),            # past the total: multiples still log
])
def test_progress_logs_what_the_jax_progress_logs(total, log_every, steps):
    jax_logger = logging.getLogger("test_progress_jax")
    port_logger = logging.getLogger("test_progress_port")
    for lg in (jax_logger, port_logger):
        lg.setLevel(logging.INFO)
        lg.propagate = False
    got = _run(Progress, port_logger, total, log_every, steps)
    ref = _run(JaxProgress, jax_logger, total, log_every, steps)
    assert got == ref
    assert got[0], "no line logged"


def test_progress_defaults_to_the_port_logger():
    """Without a logger it logs to ``cfn_torch``, with its rate."""
    rec = _Records()
    logger = get_logger()
    logger.addHandler(rec)
    try:
        p = Progress("steps", 2, log_every=1)
        p.update()
        p.update()
    finally:
        logger.removeHandler(rec)
    assert p.logger is logger
    assert rec.lines == ["steps 1/2", "steps 2/2"]
