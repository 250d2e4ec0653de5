"""``python -m coarse_fine_networks_torch.cli.train_fine --root <jpegs>``

Fine-stream training (the reference's ``python train_fine.py``): X3D-M,
per-frame localisation, from ``--kinetics-ckpt``.
"""

from ..train import fine_driver
from .common import base_parser, to_config


def main(argv=None):
    p = base_parser("Train the Fine stream (X3D-M, per-frame localisation)")
    args = p.parse_args(argv)
    cfg = to_config(
        args,
        batch_size=args.batch_size or 8,     # train_fine.py:44
        init_lr=args.lr or 0.01,             # train_fine.py:46
        lr_milestones=(15, 20, 25),          # train_fine.py:72
        train_phases_per_val=4,              # train_fine.py:147
        align_corners=True,                  # train_fine.py:199
    )
    return fine_driver.run(cfg)


if __name__ == "__main__":
    main()
