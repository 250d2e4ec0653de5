"""Target transforms (API parity with ``transforms/target_transforms.py`` —
imported but unused by the reference drivers, SURVEY.md §2 #21; counterpart
of ``coarse_fine_networks_tpu/data/target_transforms.py``)."""

from __future__ import annotations


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, target):
        return [t(target) for t in self.transforms]


class ClassLabel:
    def __call__(self, target):
        return target["label"]


class VideoID:
    def __call__(self, target):
        return target["video_id"]
