"""``python -m coarse_fine_networks_torch.cli.extract_fineFEAT --root
<jpegs> --save-feat-dir <dir> --fine-ckpt <ckpt>``

Cached fine-feature extraction (the reference's ``extract_fineFEAT.py``);
``--fine-ckpt`` is a reference ``.pt`` or the port's
``fine_charades_*.ckpt``.
"""

from ..train import extract_driver
from .common import base_parser, to_config


def main(argv=None):
    p = base_parser("Extract global-tower fine features for the Coarse stage")
    p.add_argument("--save-feat-dir", required=True)
    p.add_argument("--fine-ckpt", default=None,
                   help="trained fine checkpoint (fine_charades_*.ckpt/.pt)")
    args = p.parse_args(argv)
    cfg = to_config(args, frames=80, batch_size=1)  # extract_fineFEAT.py:40,61
    return extract_driver.run(cfg, args.save_feat_dir, args.fine_ckpt)


if __name__ == "__main__":
    main()
