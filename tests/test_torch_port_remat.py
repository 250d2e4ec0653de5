"""``remat`` in the port: each bottleneck recomputed in the backward
(``torch.utils.checkpoint``, non-reentrant), the batch norms' statistics
updated once a step (``models.layers.frozen_stats``), on the CPU in f32.

* The guard: under ``frozen_stats`` no ``SubBatchNorm`` moves its
  statistics, by any of its three entries (``forward``,
  ``train_scale_bias``, ``train_mm_entry``); a rematted training step runs
  every bottleneck's forward twice and updates each norm once.
* ``remat=True`` against ``remat=False`` in training, ``FineNet`` and
  ``CoarseNet`` at X3D-M's full depth and width, B2 T8 32², on all three
  bottleneck routes (act; the composite, ``CFN_MM_BN_TRAIN=1``; split batch
  norm at two splits): the loss, every gradient and every statistic equal
  exactly (the recomputed forward repeats the first bit for bit on the
  CPU).
* The port's ``FineNet(remat=True)`` against the JAX package's from the
  same variables (as ``tests/test_model_variants.py::
  test_remat_stage_matches_plain`` runs it), one bottleneck a stage: eval
  output and gradients, train output and statistics within 1e-4, train
  gradients within the layout spread (``test_torch_port_variants.py``).

The drivers' ``remat=True`` runs are in ``test_torch_port_coarse_driver.py``,
``test_torch_port_fine_driver.py`` and ``test_torch_port_kinetics.py``.
"""

import numpy as np
import pytest
import torch

import jax

from coarse_fine_networks_torch.ckpt import load_strict, state_dict_from_jax
from coarse_fine_networks_torch.models import (CoarseNet, FineNet,
                                               SubBatchNorm, frozen_stats,
                                               init_parameters,
                                               set_bn_splits)
from coarse_fine_networks_torch.models import layers

from _torch_port_util import jax_variables
from test_torch_port_variants import _hold

torch.set_num_threads(2)
B, T, H, N_CLASSES = 2, 8, 32, 7
BANKS = (("layer1", 24), ("layer2", 48), ("layer3", 96), ("layer4", 192),
         ("conv5", 432))


def test_frozen_stats_holds_every_entry():
    """Each of the norm's three training entries updates the split
    statistics outside ``frozen_stats`` and leaves them inside."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 4, 8, generator=gen)
    w1 = torch.randn(8, 6, generator=gen)
    w_dw = torch.randn(3, 3, 3, 6, generator=gen)
    entries = {
        "forward": (8, lambda bn: bn(x)),
        "train_scale_bias": (8, lambda bn: bn.train_scale_bias(x)),
        "train_mm_entry": (6, lambda bn: bn.train_mm_entry(x, w1, w_dw, 1)),
    }
    for name, (c, run) in entries.items():
        bn = SubBatchNorm(c).train()
        before = {k: v.clone() for k, v in bn.state_dict().items()}
        with frozen_stats():
            with frozen_stats():
                run(bn)
            run(bn)  # the outer context still holds
        assert layers.stats_frozen() is False
        for k, v in bn.state_dict().items():
            assert torch.equal(v, before[k]), (name, k)
        run(bn)
        moved = bn.state_dict()
        assert not torch.equal(moved["split_bn.running_mean"],
                               before["split_bn.running_mean"]), name
        assert torch.equal(moved["bn.running_mean"], before["bn.running_mean"])


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    clips = torch.from_numpy(rng.rand(B, T, H, H, 3).astype(np.float32))
    if kind == "fine":
        return (clips,)
    mask = np.ones((B, 16), np.float32)
    mask[1, 12:] = 0
    feats = {k: torch.from_numpy(rng.rand(B, 16, 7, 7, c).astype(np.float32))
             for k, c in BANKS}
    return (clips, feats, torch.from_numpy(mask),
            torch.tensor([[0, T, 16, 1], [0, T, 12, 1]]))


def _model(kind, remat, splits):
    m = (FineNet("M", N_CLASSES, dropout_rate=0.0, global_tower=False,
                 remat=remat) if kind == "fine" else
         CoarseNet("M", N_CLASSES, dropout_rate=0.0, remat=remat))
    init_parameters(m, torch.Generator().manual_seed(1))
    return set_bn_splits(m, splits).train()


def _step(model, args):
    """One training forward and the backward of ``Σ out·g``; its loss."""
    model.zero_grad(set_to_none=True)
    out = model(*args)
    g = torch.from_numpy(np.random.RandomState(9).randn(
        *out.shape).astype(np.float32))
    loss = torch.sum(out * g)
    loss.backward()
    return loss.item()


@pytest.mark.parametrize("kind", ["fine", "coarse"])
@pytest.mark.parametrize("route", ["act", "composite", "split"])
def test_remat_equals_plain_training(kind, route, monkeypatch):
    monkeypatch.setenv("CFN_MM_BN_TRAIN", "1" if route == "composite"
                       else "0")
    counts = {"moved": 0, "held": 0}
    update = SubBatchNorm._update_split_stats

    def counted(self, *a):
        counts["held" if layers.stats_frozen() else "moved"] += 1
        return update(self, *a)

    monkeypatch.setattr(SubBatchNorm, "_update_split_stats", counted)
    splits = 2 if route == "split" else 1
    args = _inputs(kind, 3)
    runs = {}
    for remat in (False, True):
        counts.update(moved=0, held=0)
        m = _model(kind, remat, splits)
        loss = _step(m, args)
        runs[remat] = (loss, {k: p.grad.clone() for k, p in
                              m.named_parameters()},
                       {k: v.clone() for k, v in m.state_dict().items()},
                       dict(counts))
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs[False], runs[True]
    assert l1 == l0
    assert set(g1) == set(g0)
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k
    # every norm moved once; the recomputation reached the bottlenecks'
    # norms and held them back
    assert c0["held"] == 0 and c1["moved"] == c0["moved"] > 0
    assert c1["held"] > 0


def test_remat_is_off_without_gradients():
    """Under ``no_grad`` a rematted model runs each block once (nothing
    to recompute) and gives the plain model's output."""
    args = _inputs("fine", 4)
    with torch.no_grad():
        got = _model("fine", True, 1)(*args)
        ref = _model("fine", False, 1)(*args)
    assert torch.equal(got, ref)


@pytest.fixture
def one_block_a_stage(monkeypatch):
    from coarse_fine_networks_tpu.models import fine as jfine
    from coarse_fine_networks_torch.models import x3d

    for mod in (jfine, x3d):
        monkeypatch.setattr(mod, "get_blocks", lambda version: [1, 1, 1, 1])


@pytest.mark.parametrize("task", ["loc", "class"])
def test_remat_matches_jax_remat(task, one_block_a_stage):
    from coarse_fine_networks_tpu.models import FineNet as JFine

    jm = JFine(version="M", n_classes=N_CLASSES, dropout_rate=0.0, task=task,
               remat=True, trunk_layout="plain")
    x = np.random.RandomState(5).rand(B, 16, 64, 64, 3).astype(np.float32)
    v = jax_variables(jm, jax.numpy.asarray(x), seed=6, train=False)
    pm = load_strict(FineNet("M", N_CLASSES, task=task, dropout_rate=0.0,
                             global_tower=False, remat=True),
                     state_dict_from_jax(v))
    (got,) = _hold(jm, v, pm, (x,), seed=7)
    assert got.shape == (B, 16 if task == "loc" else 1, N_CLASSES)
