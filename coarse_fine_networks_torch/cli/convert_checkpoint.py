"""Checkpoint conversion: a reference torch ``.pt`` ↔ the port's ``.ckpt``
(counterpart of ``coarse_fine_networks_tpu/cli/convert_checkpoint.py``).

    # reference .pt → the port's .ckpt
    python -m coarse_fine_networks_torch.cli.convert_checkpoint \\
        --input models/fine_charades_039000_SAVE.pt --model fine \\
        --output models/fine_charades_039000.ckpt

    # the port's .ckpt → a reference state_dict (.pt)
    python -m coarse_fine_networks_torch.cli.convert_checkpoint \\
        --input models/fine_charades_001000.ckpt --model fine \\
        --output exported.pt --to-torch

The port's names and layouts are the reference's, so nothing is renamed:
the tensors are checked, key for key and shape for shape, against the
model ``--model`` names (X3D-M/S or XL, the class count and the batch-norm
splits taken from the file), and rewrapped.  The JAX package's flax-msgpack
``.ckpt`` is not read here: JAX variables cross into the port through
``ckpt.state_dict_from_jax``.
"""

from __future__ import annotations

import argparse


def _model(sd: dict, kind: str, version: str):
    """The port's module whose ``state_dict`` ``sd`` should be: a fine
    stream with its logits head where ``sd`` has one (else the global
    tower), or a coarse stream; the class count from ``fc2``."""
    from ..models import CoarseNet, FineNet

    n_classes = sd["fc2.weight"].shape[0] if "fc2.weight" in sd else 157
    if kind == "coarse":
        return CoarseNet(version, n_classes)
    return FineNet(version, n_classes, global_tower="fc2.weight" not in sd)


def checked(sd: dict, kind: str) -> dict:
    """``sd`` without the reference's ``num_batches_tracked`` counters,
    once it loads strictly into the port's ``kind`` model at X3D-M's (and
    S's) or XL's widths; raises with the X3D-M model's mismatches
    otherwise."""
    from ..ckpt import load_strict

    first = None
    for version in ("M", "XL"):
        model = _model(sd, kind, version)
        try:
            load_strict(model, sd)
        except ValueError as e:
            first = first or e
            continue
        own = model.state_dict()
        return {k: v for k, v in sd.items() if k in own}
    raise first


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model", default="fine", choices=["fine", "coarse"])
    p.add_argument("--to-torch", action="store_true",
                   help="export the port's checkpoint to a torch "
                        "state_dict")
    args = p.parse_args(argv)

    from ..ckpt import checkpoint_tensors, save_checkpoint

    sd = checked(checkpoint_tensors(args.input), args.model)
    if args.to_torch:
        save_checkpoint(args.output, {"model_state_dict": sd})
    else:
        save_checkpoint(args.output, {"variables": sd, "step": 0,
                                      "scheduler": {"epoch": 0}})
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
