"""Driver configuration (counterpart of
``coarse_fine_networks_tpu/train/config.py``): one dataclass with the knobs
the reference keeps as module constants, the per-version tables, and one
field of the port's own, ``device`` (``"cuda"`` by default; tests pass
``"cpu"``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Per-version tables (train_fine.py:59-61 of the reference)
CROP_SIZE = {"S": 160, "M": 224, "XL": 312}
RESIZE_SIZE = {"S": (180.0, 225.0), "M": (256.0, 320.0), "XL": (360.0, 450.0)}
GAMMA_TAU = {"S": 6, "M": 5, "XL": 5}


@dataclasses.dataclass
class DriverConfig:
    anno: str                      # charades.json path
    root: str                      # per-frame JPEG root
    save_dir: str = "models"
    x3d_version: str = "M"
    num_classes: int = 157
    batch_size: int = 8
    val_batch_size: Optional[int] = None
    init_lr: float = 0.01
    lr_milestones: Sequence[int] = (15, 20, 25)
    warmup_steps: int = 0
    lr_schedule: str = "multistep"  # "multistep" | "cosine"
    total_steps: Optional[int] = None   # cosine horizon (None: derived)
    cosine_final_lr: float = 0.0
    label_smoothing: float = 0.0
    max_epochs: int = 200
    frames: int = 80 * 4
    crops: int = 1
    dropout: float = 0.5
    base_bn_splits: int = 1
    weight_decay: float = 1e-5
    momentum: float = 0.9
    grad_clip: Optional[float] = None  # global-L2 clip; None: none
    train_phases_per_val: int = 4
    num_steps_per_update: int = 1  # gradient accumulation
    ckpt_every: int = 1000
    log_every_frac: int = 2        # log every 1/2 epoch
    kinetics_ckpt: Optional[str] = None  # reference .pt or the port's .ckpt
    resume: bool = True
    num_workers: int = 4
    prefetch: int = 4
    device_prefetch: int = 2  # batches staged on the device ahead
    pack_dir: Optional[str] = None     # .cfnpack containers (data/native.py)
    stem_s2d_input: bool = False   # TPU layout option: off on the card
    record_trajectory: bool = False  # (step, lr, loss) per step in results
    fine_feat_dir: Optional[str] = None
    fusion_lr_mult: Optional[float] = None
    align_corners: bool = True     # fine: True; coarse driver: False
    compute_dtype: str = "float32"
    remat: bool = False            # recompute each bottleneck in backward
    mesh_devices: Optional[int] = None  # > 1: data-parallel ranks
    min_frames: Optional[int] = None
    crop_size_override: Optional[int] = None
    pad_t_multiple: Optional[int] = 16
    pad_label_multiple: Optional[int] = 64
    t_lim_inference: int = 1000    # chunked long-video eval
    val_bucket: bool = True        # geometric val padding buckets
    val_length_sorted: bool = True  # val videos ordered by length
    seed: int = 0
    max_steps: Optional[int] = None
    max_val_batches: Optional[int] = None
    localize_csv: Optional[str] = None
    debug_nans: bool = False       # autograd anomaly detection
    multigrid: bool = False
    multigrid_epochs_per_phase: int = 1
    device: str = "cuda"

    @property
    def crop_size(self) -> int:
        return self.crop_size_override or CROP_SIZE[self.x3d_version]

    @property
    def gamma_tau(self) -> int:
        return GAMMA_TAU[self.x3d_version]

    @property
    def scales(self) -> Tuple[float, float]:
        """Random-crop scale range: the published crop/resize ratio of the
        version (M: 224/(256, 320)), independent of
        ``crop_size_override``."""
        r = RESIZE_SIZE[self.x3d_version]
        base = CROP_SIZE[self.x3d_version]
        return tuple(base / s for s in r)
