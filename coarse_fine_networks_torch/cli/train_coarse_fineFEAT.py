"""``python -m coarse_fine_networks_torch.cli.train_coarse_fineFEAT --root
<jpegs> --fine-feat-dir <dir>``

Coarse-stream training on cached fine features (the reference's
``train_coarse_fineFEAT.py``), with the 10× fusion learning rate and the
``Charades_v1_localize`` CSV written at each validation.
"""

from ..train import coarse_driver
from .common import base_parser, to_config


def main(argv=None):
    p = base_parser("Train the Coarse stream with Grid Pool + fusion")
    p.add_argument("--fine-feat-dir", required=True)
    p.add_argument("--localize-csv", default="localize_corr_v1.csv")
    args = p.parse_args(argv)
    cfg = to_config(
        args,
        batch_size=args.batch_size or 6,     # train_coarse_fineFEAT.py:45
        init_lr=args.lr or 0.02,             # :47
        lr_milestones=(15, 25, 35),          # :143
        train_phases_per_val=2,              # :162
        align_corners=False,                 # :226 (no align_corners)
        fusion_lr_mult=10.0,                 # :137-141
        fine_feat_dir=args.fine_feat_dir,
        localize_csv=args.localize_csv,
        val_batch_size=1,                    # :74
    )
    return coarse_driver.run(cfg)


if __name__ == "__main__":
    main()
