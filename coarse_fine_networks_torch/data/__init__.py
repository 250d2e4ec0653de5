"""Input pipeline of the port (counterpart of
``coarse_fine_networks_tpu/data``): Charades annotations, clip sampling
with native decoding (:mod:`.native`: a host entropy decoder, then an
IDCT-and-colour kernel and a crop-resize kernel on the card, or their
plain versions on the CPU; the ``.cfnpack`` packs) or Pillow, the
Kinetics-style pretraining corpus, the host transforms, pooled collate
buffers, the threaded loader, the device prefetcher, the device half of
the transforms (uint8 frames normalised on the card), and the submodules
:mod:`.multithumos`, :mod:`.temporal_transforms` and
:mod:`.target_transforms`, not exported here, as the JAX package exports
them."""

from .annotations import make_dataset, rasterize_annotations
from .dataset import CharadesDataset, collate_clips, collate_coarse
from .device_prefetch import DevicePrefetcher, overlap_iter
from .kinetics import (KineticsDataset, collate_kinetics,
                       generate_mini_kinetics)
from .loader import PrefetchLoader
from .transforms import (CHARADES_MEAN, CHARADES_STD, CenterCrop,
                         CenterCropScaled, Compose, CornerCrop,
                         MultiScaleCornerCrop, MultiScaleRandomCrop,
                         MultiScaleRandomCropMultigrid, Normalize,
                         RandomHorizontalFlip, RandomVerticalFlip, Scale,
                         ToArray, device_normalize)

__all__ = [
    "CHARADES_MEAN",
    "CHARADES_STD",
    "CenterCrop",
    "CenterCropScaled",
    "CharadesDataset",
    "Compose",
    "CornerCrop",
    "DevicePrefetcher",
    "KineticsDataset",
    "MultiScaleCornerCrop",
    "MultiScaleRandomCrop",
    "MultiScaleRandomCropMultigrid",
    "Normalize",
    "PrefetchLoader",
    "RandomHorizontalFlip",
    "RandomVerticalFlip",
    "Scale",
    "ToArray",
    "collate_clips",
    "collate_coarse",
    "collate_kinetics",
    "device_normalize",
    "generate_mini_kinetics",
    "make_dataset",
    "overlap_iter",
    "rasterize_annotations",
]
