"""Metrics: streaming per-class average precision, the
``Charades_v1_localize`` CSV and its evaluation (counterpart of
``coarse_fine_networks_tpu/metrics``)."""

from .ap import APMeter
from .charades_eval import evaluate_localization
from .localize import LocalizeCSVWriter, subsample_25

__all__ = ["APMeter", "LocalizeCSVWriter", "evaluate_localization",
           "subsample_25"]
