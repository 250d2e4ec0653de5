"""End-to-end demo on generated data, on the port: no Charades download.

Runs the three-stage pipeline at toy scale:

    1. train the Fine stream a few steps,
    2. extract the fine-feature cache (both splits),
    3. train the Coarse stream (Grid Pool + fusion), write the
       Charades_v1_localize CSV and score it with the port's evaluator.

    python -m coarse_fine_networks_torch.examples.demo_synthetic \
        [workdir] [--device cuda|cpu]

The counterpart of ``examples/demo_synthetic.py`` at its shapes (6 videos
of 48 frames at 64², batch 2, 8 frames, 32² crops, 3 steps, f32), on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

from ..data.synthetic import generate_mini_charades
from ..metrics import evaluate_localization
from ..train import coarse_driver, extract_driver, fine_driver
from ..train.config import DriverConfig


def demo_config(root: str, device: str) -> DriverConfig:
    """The demo's configuration over a mini-Charades tree it writes under
    ``root``."""
    anno = generate_mini_charades(root, num_videos=6, num_frames=48, hw=64)
    return DriverConfig(
        anno=anno, root=os.path.join(root, "frames"),
        save_dir=os.path.join(root, "models"),
        batch_size=2, val_batch_size=1, frames=8, min_frames=10,
        crop_size_override=32, max_epochs=2, train_phases_per_val=1,
        num_workers=2, ckpt_every=1, max_steps=3, pad_t_multiple=4,
        pad_label_multiple=8, resume=False, compute_dtype="float32",
        device=device)


def main(argv=None, cfg: DriverConfig | None = None) -> dict:
    """Run the three stages; ``cfg`` replaces the demo's configuration (its
    tree, its ``save_dir``, its steps: features and the CSV go beside
    ``save_dir``).  Returns each stage's result and the CSV's mAP."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if cfg is None:
        root = args.workdir or tempfile.mkdtemp(prefix="cfn_demo_")
        print(f"workdir: {root}", flush=True)
        cfg = demo_config(root, args.device)
    work = os.path.dirname(os.path.abspath(cfg.save_dir))

    print("== stage 1: fine training ==", flush=True)
    fine_res = fine_driver.run(cfg)
    print("fine:", fine_res, flush=True)

    print("== stage 2: feature extraction ==", flush=True)
    feat_dir = os.path.join(work, "fine_feats")
    fine_ckpt = os.path.join(cfg.save_dir, sorted(
        c for c in os.listdir(cfg.save_dir) if c.startswith("fine"))[-1])
    n = extract_driver.run(cfg, feat_dir, fine_ckpt)
    print(f"extracted {n} videos -> {feat_dir}", flush=True)

    print("== stage 3: coarse training + localisation ==", flush=True)
    csv_path = os.path.join(work, "localize.csv")
    coarse_res = coarse_driver.run(dataclasses.replace(
        cfg, fine_feat_dir=feat_dir, align_corners=False,
        fusion_lr_mult=10.0, localize_csv=csv_path))
    print("coarse:", coarse_res, flush=True)

    with open(cfg.anno) as f:
        m_ap, _ = evaluate_localization(csv_path, json.load(f),
                                        num_classes=cfg.num_classes)
    print(f"Charades_v1_localize mAP (the port's evaluator): {m_ap:.4f}",
          flush=True)
    return {"fine": fine_res, "extracted": n, "coarse": coarse_res,
            "map": m_ap}


if __name__ == "__main__":
    main()
