"""``python -m coarse_fine_networks_torch.cli.pretrain_kinetics --root
<jpegs> --anno <kinetics.json>``

Kinetics-style pretraining of the fine stream (``task='class'``): the
checkpoint the detection drivers start from; pass the saved
``kinetics_x3d_*.ckpt`` as their ``--kinetics-ckpt``.
"""

from ..train import kinetics_driver
from .common import base_parser, to_config


def main(argv=None):
    p = base_parser("Pretrain the Fine stream on a Kinetics-style corpus")
    p.add_argument("--classes", type=int, default=400)
    args = p.parse_args(argv)
    cfg = to_config(
        args,
        num_classes=args.classes,
        batch_size=args.batch_size or 32,
        init_lr=args.lr or 0.1,
        lr_milestones=(30, 60, 80),
        frames=16,
    )
    return kinetics_driver.run(cfg)


if __name__ == "__main__":
    main()
