"""Rank bodies for the port's data-parallel tests: module-level functions
that :func:`coarse_fine_networks_torch.parallel.mesh.spawn` runs in each
rank (over gloo on the CPU).  They import torch and the port only, so a
rank starts in seconds.

A configuration is a dict: ``kind`` (``"fine"`` or ``"coarse"``),
``splits``, ``dropout``, ``accum``, ``clip``, ``env`` (e.g. the composite
route's ``CFN_MM_BN_TRAIN``), ``seed`` and ``lr``; :func:`make_batch` draws
its global batch from the seed with numpy, :func:`train_step` runs one
step on this rank's rows (the whole batch outside a group).
"""

import os
from unittest import mock

import numpy as np
import torch

from coarse_fine_networks_torch.models import (CoarseNet, FineNet,
                                               init_parameters,
                                               set_bn_splits)
from coarse_fine_networks_torch.models import x3d
from coarse_fine_networks_torch.parallel import mesh
from coarse_fine_networks_torch.train import TrainState, make_train_step

B, T, HW, TF, TL, N_CLASSES = 8, 4, 64, 8, 16, 7
x3d_blocks = x3d.get_blocks
BANKS = (("layer1", 24), ("layer2", 48), ("layer3", 96), ("layer4", 192),
         ("conv5", 432))


def make_batch(cfg):
    """The global numpy batch (``accum`` micro-steps stacked in front when
    above 1); the last three samples have masked label frames, so the
    ranks' ``Σmasks`` differ, and the coarse batch masked fine frames."""
    rng = np.random.RandomState(cfg["seed"] + 100)

    def one():
        masks = np.ones((B, TL), np.float32)
        masks[-3:, TL - 5:] = 0
        out = {"clips": rng.rand(B, T, HW, HW, 3).astype(np.float32),
               "labels": (rng.rand(B, TL, N_CLASSES) > 0.8)
               .astype(np.float32),
               "masks": masks}
        if cfg["kind"] == "coarse":
            feat_mask = np.ones((B, TF), np.float32)
            feat_mask[-2:, 6:] = 0
            out["feats"] = {k: rng.rand(B, TF, 7, 7, c).astype(np.float32)
                            for k, c in BANKS}
            out["feat_mask"] = feat_mask
            out["meta"] = np.tile(np.array([[0, T, TF, 1]], np.int32),
                                  (B, 1))
        return out

    mbs = [one() for _ in range(cfg["accum"])]
    if cfg["accum"] == 1:
        return mbs[0]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)
    return stack(*mbs)


def make_model(cfg):
    """The configuration's model: seeded, or with ``cfg["state"]`` loaded;
    ``cfg["blocks"]`` (bottlenecks a stage) cuts the depth."""
    gen = torch.Generator().manual_seed(cfg["seed"])
    with mock.patch.object(x3d, "get_blocks",
                           lambda v: cfg.get("blocks") or x3d_blocks(v)):
        if cfg["kind"] == "coarse":
            model = CoarseNet("M", N_CLASSES, dropout_rate=cfg["dropout"])
        else:
            model = FineNet("M", N_CLASSES, dropout_rate=cfg["dropout"],
                            global_tower=False)
    model = init_parameters(model, gen)
    if cfg["splits"] > 1:
        set_bn_splits(model, cfg["splits"])
    if "state" in cfg:
        model.load_state_dict(cfg["state"], strict=True)
    return model


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def train_step(cfg):
    """One train step of ``cfg`` on this rank's rows: the global loss, the
    reduced gradients, the state after the update (parameters and running
    statistics) and this rank's probabilities."""
    old = {k: os.environ.get(k) for k in cfg["env"]}
    os.environ.update(cfg["env"])
    try:
        model = make_model(cfg)
        step = make_train_step(model, align_corners=cfg["kind"] == "fine",
                               fusion_lr_mult=(10.0 if cfg["kind"] ==
                                               "coarse" else None),
                               accum_steps=cfg["accum"],
                               grad_clip=cfg["clip"])
        batch = mesh.shard_batch(_torch(make_batch(cfg)),
                                 leading_accum=cfg["accum"] > 1)
        state = TrainState.create(model)
        gen = torch.Generator().manual_seed(cfg["seed"] + 7)
        state, metrics = step(state, batch, cfg["lr"], gen)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"loss": float(metrics["loss"]),
            "cls_loss": float(metrics["cls_loss"]),
            "loc_loss": float(metrics["loc_loss"]),
            "grads": {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()},
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "probs": metrics["probs"]}


def train_steps(cfgs):
    """:func:`train_step` of each configuration in turn."""
    return [train_step(c) for c in cfgs]


def rank_checks(n):
    """In each rank: its ``(rank, world)``, its rows of ``arange(n)`` (and
    of a micro-stacked ``(2, n)`` batch, ``leading_accum``), the rows
    gathered to rank 0, the sum of ``rank + 1`` over the ranks and its
    gradient, and the error a split batch norm raises on a local batch its
    split count does not divide (``n/world = 4`` rows, ``n = 8`` splits:
    the global batch divides, the local one does not)."""
    from coarse_fine_networks_torch.models.layers import SubBatchNorm

    rows = mesh.shard_batch({"a": torch.arange(n),
                             "b": {"c": torch.arange(n) * 10}})
    accum = mesh.shard_batch(torch.arange(2 * n).reshape(2, n),
                             leading_accum=True)
    x = torch.tensor(float(mesh.rank() + 1), requires_grad=True)
    total = mesh.all_reduce_sum(x)
    (total * (mesh.rank() + 1)).backward()
    bn = SubBatchNorm(3, num_splits=n).train()
    try:
        bn(torch.randn(n // mesh.world(), 2, 2, 2, 3))
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"shard": mesh.process_shard(), "rows": rows, "accum": accum,
            "gathered": mesh.gather_rows(rows), "total": float(total),
            "grad": float(x.grad), "raised": raised,
            "backend": mesh.backend()}


def reweight_inputs(seed=0, b=2, tf=8, tc=3, hw=3, c=5):
    """Inputs of the fusion's reweight aggregation, from a numpy seed; the
    last fine frames of sample 1 masked."""
    rng = np.random.RandomState(seed)
    mask = np.ones((b, tf), np.float32)
    mask[1, tf - 3:] = 0
    return {"feat": rng.randn(b, tf, hw, hw, c).astype(np.float32),
            "gate": rng.rand(b, tf, hw, hw).astype(np.float32),
            "align": rng.rand(b, tf, tc).astype(np.float32),
            "mask": mask,
            "w": rng.randn(b, tc, hw, hw, c).astype(np.float32)}


def sequence_reweight(inputs):
    """This rank's shard of fine time through
    ``sequence_sharded_reweight``; the output, and the gradient of
    ``Σ out·w`` for this rank's feat and gate shards (each rank's loss its
    share, ``Σ out·w / world``, the port's data-parallel convention)."""
    from coarse_fine_networks_torch.parallel import (
        sequence_sharded_reweight, shard_time)

    x = {k: shard_time(torch.from_numpy(v)) for k, v in inputs.items()
         if k != "w"}
    feat = x["feat"].clone().requires_grad_(True)
    gate = x["gate"].clone().requires_grad_(True)
    out = sequence_sharded_reweight(feat, gate, x["align"], x["mask"])
    ((out * torch.from_numpy(inputs["w"])).sum() / mesh.world()).backward()
    return {"out": out.detach(), "dfeat": feat.grad, "dgate": gate.grad}


def torchrun_rank():
    """What ``mesh.run_data_parallel`` gives a process that ``torchrun``
    started (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in
    its environment) for ``mesh_devices = 2`` on the CPU: its rank, the
    group's size and backend, and the sum of ``rank + 1`` over the
    ranks."""
    import types

    import torch.distributed as dist

    def body(cfg):
        total = mesh.all_reduce_sum(torch.tensor(float(mesh.rank() + 1)))
        return [mesh.rank(), mesh.world(), mesh.backend(), float(total)]

    try:
        return mesh.run_data_parallel(
            body, types.SimpleNamespace(mesh_devices=2, device="cpu"))
    finally:
        dist.destroy_process_group()
