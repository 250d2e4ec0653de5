"""``python -m coarse_fine_networks_torch.cli.pack_dataset --root <jpegs>
--out <packs>``

Pack per-frame JPEG directories into ``.cfnpack`` containers (the JAX
package's ``cli/pack_dataset.py``, flag for flag, and the same files): one
indexed container per video, which the drivers read with
``DriverConfig(pack_dir=...)`` (a video without a pack reads its JPEG
files).  It needs no card.
"""

from __future__ import annotations

import argparse

from ..data import native


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="per-frame JPEG root")
    p.add_argument("--out", required=True, help="output .cfnpack directory")
    p.add_argument("--vids", nargs="*", default=None,
                   help="subset of video ids (default: every dir under root)")
    p.add_argument("--no-skip-existing", action="store_true")
    args = p.parse_args(argv)
    n = native.pack_directory(args.root, args.out, vids=args.vids,
                              skip_existing=not args.no_skip_existing)
    print(f"packed {n} videos -> {args.out}")
    return n


if __name__ == "__main__":
    main()
