"""Shared command-line plumbing (counterpart of
``coarse_fine_networks_tpu/cli/common.py``): the JAX package's flags and
defaults, plus ``--device``, the port's way to pick the card or the CPU
(the JAX package picks its platform with ``JAX_PLATFORMS``).
``--mesh-devices N`` trains on N data-parallel ranks
(:func:`..parallel.mesh.run_data_parallel`)."""

from __future__ import annotations

import argparse

from ..train.config import DriverConfig
from ..utils import get_logger


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--anno", default="data/charades.json",
                   help="Charades annotation json")
    p.add_argument("--root", required=True, help="per-frame JPEG root")
    p.add_argument("--save-dir", default="models")
    p.add_argument("--version", default="M", choices=["S", "M", "XL"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--frames", type=int, default=80 * 4)
    p.add_argument("--max-epochs", type=int, default=200)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--kinetics-ckpt", default=None,
                   help="x3d_multigrid_kinetics .pt or the port's .ckpt")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="data-parallel ranks: N > 1 spawns N processes "
                        "(rank r on cuda:(r %% device_count); NCCL when each "
                        "has a card of its own, else gloo), each loading its "
                        "rows of every global batch; under torchrun, the "
                        "world size")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation micro-steps per update "
                        "(the reference's num_steps_per_update)")
    p.add_argument("--device", default="cuda",
                   help="torch device the driver runs on (cuda, cpu)")
    return p


def to_config(args, **overrides) -> DriverConfig:
    """The driver configuration of parsed ``args``, then ``overrides``;
    attaches the drivers' log handler."""
    get_logger()
    cfg = DriverConfig(
        anno=args.anno, root=args.root, save_dir=args.save_dir,
        x3d_version=args.version, frames=args.frames,
        max_epochs=args.max_epochs, warmup_steps=args.warmup_steps,
        kinetics_ckpt=args.kinetics_ckpt, num_workers=args.num_workers,
        mesh_devices=args.mesh_devices, compute_dtype=args.dtype,
        remat=args.remat, resume=not args.no_resume,
        debug_nans=args.debug_nans, max_steps=args.max_steps,
        num_steps_per_update=args.accum_steps, device=args.device,
    )
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    if args.lr is not None:
        cfg.init_lr = args.lr
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
