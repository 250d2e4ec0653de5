"""Input boundary of the port: the device half of the clip transforms
(counterpart of ``coarse_fine_networks_tpu/data``; the host data pipeline
is not ported yet)."""

from .transforms import CHARADES_MEAN, CHARADES_STD, device_normalize

__all__ = ["CHARADES_MEAN", "CHARADES_STD", "device_normalize"]
