"""Spatial clip transforms (counterpart of
``coarse_fine_networks_tpu/data/transforms.py``).

Host half: Pillow decode-side crops and resizes to uint8, with the
reference's per-clip protocol (``randomize_parameters(crop_size)`` once per
clip, then the same transform on every frame).  Every random transform
draws from the global :mod:`random` module in the JAX package's order, so a
seeded driver run samples the same clips.  Device half:
:func:`device_normalize` (ToTensor, Normalize and the deferred horizontal
flip, batched on the card, so the host ships uint8 frames).
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

# Charades channel statistics (``train_fine.py:48-49`` of the reference)
CHARADES_MEAN = (0.413, 0.368, 0.338)
CHARADES_STD = (0.131, 0.125, 0.132)


class Compose:
    """Apply ``transforms`` in order; randomise each of them per clip."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img

    def randomize_parameters(self, c_size=0, index=0):
        for t in self.transforms:
            t.randomize_parameters(c_size, index)


class _Static:
    def randomize_parameters(self, c_size=0, index=0):
        pass


class ToArray(_Static):
    """PIL image → float32 ``(H, W, C)`` in [0, 1] (ToTensor ÷
    ``norm_value``, channels-last)."""

    def __init__(self, norm_value: float = 255.0):
        self.norm_value = norm_value

    def __call__(self, img):
        a = np.asarray(img, dtype=np.float32)
        if a.ndim == 2:
            a = a[:, :, None]
        return a / self.norm_value


class Normalize(_Static):
    """``(x − mean) / std`` per channel."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


class Scale(_Static):
    """Resize so that the smaller edge is ``size`` (an int), or to ``size``
    (a pair)."""

    def __init__(self, size, interpolation=Image.BILINEAR):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        if not isinstance(self.size, int):
            return img.resize(tuple(self.size), self.interpolation)
        w, h = img.size
        if (w <= h and w == self.size) or (h <= w and h == self.size):
            return img
        if w < h:
            return img.resize((self.size, int(self.size * h / w)),
                              self.interpolation)
        return img.resize((int(self.size * w / h), self.size),
                          self.interpolation)


def _pair(size):
    return (int(size), int(size)) if np.isscalar(size) else size


class CenterCrop(_Static):
    """Crop ``size`` at the centre."""

    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, img):
        w, h = img.size
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return img.crop((x1, y1, x1 + tw, y1 + th))


class CenterCropScaled(_Static):
    """The largest centred square, resized to ``size``: the val and
    extraction pipeline."""

    def __init__(self, size, interpolation=Image.BILINEAR):
        self.size = _pair(size)
        self.interpolation = interpolation

    def __call__(self, img):
        crop = min(img.size)
        w, h = img.size
        x1 = int(round((w - crop) / 2.0))
        y1 = int(round((h - crop) / 2.0))
        img = img.crop((x1, y1, x1 + crop, y1 + crop))
        return img.resize(self.size, self.interpolation)


def _corner_box(position: str, width: int, height: int, crop: int):
    """Crop box (left, top, right, bottom) of a named corner or the
    centre."""
    if position == "c":
        x1 = int(round((width - crop) / 2.0))
        y1 = int(round((height - crop) / 2.0))
    elif position == "tl":
        x1, y1 = 0, 0
    elif position == "tr":
        x1, y1 = width - crop, 0
    elif position == "bl":
        x1, y1 = 0, height - crop
    elif position == "br":
        x1, y1 = width - crop, height - crop
    else:
        raise ValueError(position)
    return (x1, y1, x1 + crop, y1 + crop)


class CornerCrop:
    """A square 28 pixels short of the smaller edge at one of five
    positions (chosen by ``index``), resized to ``size``."""

    POSITIONS = ("c", "tl", "tr", "bl", "br")

    def __init__(self, size, crop_position: Optional[str] = None,
                 interpolation=Image.BILINEAR):
        self.size = size
        self.crop_position = crop_position
        self.interpolation = interpolation

    def __call__(self, img):
        w, h = img.size
        crop = min(w - 28, h - 28)
        img = img.crop(_corner_box(self.crop_position, w, h, crop))
        return img.resize((int(self.size), int(self.size)),
                          self.interpolation)

    def randomize_parameters(self, c_size=0, index=0):
        self.crop_position = self.POSITIONS[index]


class RandomHorizontalFlip:
    """Mirror with probability 1/2.  ``deferred=True`` leaves the pixels
    alone and exposes :attr:`flipped`, which the batch carries to
    :func:`device_normalize`."""

    def __init__(self, deferred: bool = False):
        self.p = 1.0
        self.deferred = deferred

    def __call__(self, img):
        if self.p < 0.5 and not self.deferred:
            if isinstance(img, np.ndarray):
                return np.ascontiguousarray(img[:, ::-1])
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    @property
    def flipped(self) -> bool:
        return self.p < 0.5

    def randomize_parameters(self, c_size=0, index=0):
        self.p = random.random()


class RandomVerticalFlip:
    """Flip upside down with probability 1/2."""

    def __init__(self):
        self.p = 1.0

    def __call__(self, img):
        if self.p < 0.5:
            if isinstance(img, np.ndarray):
                return np.ascontiguousarray(img[::-1])
            return img.transpose(Image.FLIP_TOP_BOTTOM)
        return img

    def randomize_parameters(self, c_size=0, index=0):
        self.p = random.random()


class MultiScaleCornerCrop:
    """A square of a random scale of the smaller edge at a random corner or
    the centre, resized to ``size``."""

    def __init__(self, scales, size, interpolation=Image.BILINEAR,
                 crop_positions=("c", "tl", "tr", "bl", "br")):
        self.scales = scales
        self.size = size
        self.interpolation = interpolation
        self.crop_positions = crop_positions
        self.scale = scales[0]
        self.crop_position = crop_positions[0]

    def __call__(self, img):
        crop = int(min(img.size) * self.scale)
        w, h = img.size
        if self.crop_position == "c":
            # the reference's floor-division centre box
            cx, cy, half = w // 2, h // 2, crop // 2
            box = (cx - half, cy - half, cx + half, cy + half)
        else:
            box = _corner_box(self.crop_position, w, h, crop)
        return img.crop(box).resize((self.size, self.size),
                                    self.interpolation)

    def randomize_parameters(self, c_size=0, index=0):
        self.scale = self.scales[random.randint(0, len(self.scales) - 1)]
        # the reference draws the position with the scales' count
        self.crop_position = self.crop_positions[
            random.randint(0, len(self.scales) - 1)]


class MultiScaleRandomCrop:
    """A square of a random scale of the smaller edge at a random
    position, resized to ``size``."""

    def __init__(self, scales, size, interpolation=Image.BILINEAR):
        self.scales = scales
        self.size = size
        self.interpolation = interpolation
        self.scale = scales[0]
        self.tl_x = 0.0
        self.tl_y = 0.0

    def __call__(self, img):
        crop = int(min(img.size) * self.scale)
        w, h = img.size
        x1 = int(self.tl_x * (w - crop))
        y1 = int(self.tl_y * (h - crop))
        img = img.crop((x1, y1, x1 + crop, y1 + crop))
        return img.resize((self.size, self.size), self.interpolation)

    def randomize_parameters(self, c_size=0, index=0):
        self.scale = self.scales[random.randint(0, len(self.scales) - 1)]
        self.tl_x = random.random()
        self.tl_y = random.random()


class MultiScaleRandomCropMultigrid(MultiScaleRandomCrop):
    """:class:`MultiScaleRandomCrop` whose output size is set per clip
    (``c_size``, the multigrid schedule's crop; the initial size when 0):
    the train pipeline."""

    def __init__(self, scales, size, interpolation=Image.BILINEAR):
        super().__init__(scales, size, interpolation)
        self.init_size = size

    def randomize_parameters(self, c_size=0, index=0):
        self.size = c_size if c_size else self.init_size
        super().randomize_parameters(c_size, index)


def device_normalize(clips_u8: torch.Tensor, flip: torch.Tensor,
                     mean: Sequence[float] = CHARADES_MEAN,
                     std: Sequence[float] = CHARADES_STD,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 ``(B, T, H, W, 3)`` → ``(x/255 − mean)/std`` in f32, cast to
    ``out_dtype`` (the trunk's compute dtype, so no separate convert pass),
    with the clips where ``flip (B,)`` is true mirrored along W.  Runs on
    the clips' device."""
    dev = clips_u8.device
    x = clips_u8.to(torch.float32) / 255.0
    x = ((x - torch.tensor(mean, dtype=torch.float32, device=dev))
         / torch.tensor(std, dtype=torch.float32, device=dev)).to(out_dtype)
    flip = torch.as_tensor(flip, dtype=torch.bool, device=dev)
    return torch.where(flip[:, None, None, None, None], torch.flip(x, (3,)),
                       x)
