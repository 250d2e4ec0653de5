"""Device half of the clip transforms (counterpart of
``device_normalize`` in ``coarse_fine_networks_tpu/data/transforms.py``):
ToTensor, Normalize and the per-clip horizontal flip, batched on the
device, so the host ships uint8 frames."""

from __future__ import annotations

from typing import Sequence

import torch

# Charades channel statistics (``coarse_fine_networks_tpu/train/config.py``)
CHARADES_MEAN = (0.413, 0.368, 0.338)
CHARADES_STD = (0.131, 0.125, 0.132)


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
