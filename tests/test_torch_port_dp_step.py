"""One data-parallel train step over 2 ranks against the port's
one-process step on the global batch, and against the JAX package's step
on its 8-device mesh.

X3D-M at full width, 7 classes, the global batch B8 T4 64² (label length
16), each rank holding 4 rows; the ranks are 2 processes spawned over gloo
on the CPU (``mesh.spawn``), each running ``_torch_port_dp.train_step``.
Four configurations, each with dropout 0.5 (the masks drawn for the global
batch) and masked label frames on the last three samples (the ranks'
``Σmasks`` differ): the fine stream by the act route at one split, at two
splits (the split route) with ``accum_steps = 2`` and a gradient clip of
0.5, by the composite route (``CFN_MM_BN_TRAIN=1``, the kernels' plain
twins on the CPU) with ``accum_steps = 2`` and the clip, and the coarse
stream (banks at T_f=8, masked fine frames) by the act route with a clip
of 1.0.

Tolerances, N ranks against one process:

* the global loss within 1e-5 relative, and each loss term likewise;
* every running statistic within 1e-4 relative (``rtol``, with an
  absolute floor of 1e-6);
* the summed gradients within 2.5e-2 relative L2 per stage (stem, layer1-4
  and the head; the coarse stream's fusion modules each a stage), and per
  tensor within 0.2 of the tensor's largest magnitude; tensors whose
  gradient is below 1e-4 of the largest gradient are left out (the coarse
  stream's Grid Pool and fusion biases: sums that cancel to 1e-8 of it,
  and the gates' ``at2`` biases to 6e-6–2.5e-5 of it, whose relative
  change under either run's rounding is 0.04–0.7).  The parameters after the update follow from the gradients (the
  first step's update is ``lr·(g + wd·p0)``, a few f32 ulps of most
  weights at these rates, so it is held through ``g``); both ranks hold
  the same parameters bit for bit.

Measured reason for the gradient bounds: the reductions run in another
order on 2 ranks (each rank's Σx and Σx² before the sum over ranks), so a
relu input within a rounding of 0 can take the other branch, and batch
norm over 128 elements a channel at layer4 carries it into every gradient
upstream.  The one-process step itself moves as much under a 1-ulp change
of its input (the clips times 1 + 2⁻²³): 1.2e-2 to 1.6e-2 relative L2 per
stage and up to 8.1e-2 per tensor (conv5.weight); the 2-rank steps here
are 3e-3 to 2.2e-2 per stage and at most 0.167 per tensor off the
one-process step (the coarse stream's conv5.weight; the fine stream's at
most 6.7e-2).  The forward quantities are not moved: the losses agree
to 5e-7 and the running statistics to 5e-6.  A missing reduction (local
statistics, an unsummed gradient, a local loss normaliser) moves the loss
by 1e-3 or more and the gradients by O(1).  Faults planted in a copy of
the package fail the per-tensor bound: the statistics' all-reduce passing
its gradient on unreduced moves the stem's tensors alone by 0.30-0.94 of
their largest magnitude in all four configurations, and the composite's
backward without its ``S1``/``⟨W, xᵀdam⟩`` reduction moves the stem's and
layer1's by 0.21-0.42.

Against JAX: the fine stream at two splits with one bottleneck a stage
(``get_blocks`` patched in both packages, as in
``tests/test_torch_port_variants.py``), dropout 0, from the same weights
(``state_dict_from_jax``), the JAX package's ``make_train_step`` on
``FineNet(trunk_layout="plain", bn_splits=2)`` with the batch sharded over
its 8-device mesh (one row a device; XLA reduces the split statistics over
it), at ``tests/test_torch_port_fine_step.py``'s tolerances (the loss
within 1e-4 relative, the split statistics within 1e-3 of the JAX tensor's
largest magnitude, each update within 0.1 of the JAX update's largest
magnitude, the updates within 2.5e-2 relative L2 per stage)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.parallel import make_mesh, shard_batch
from coarse_fine_networks_tpu.parallel.mesh import replicate
from coarse_fine_networks_tpu.train import TrainState as JTrainState
from coarse_fine_networks_tpu.train import make_train_step as jmake_step
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.parallel import mesh

import _torch_port_dp as dp
from _torch_port_util import jax_variables

torch.set_num_threads(2)

OFF = {"CFN_MM_BN_TRAIN": "0"}
CONFIGS = {
    "act": dict(kind="fine", splits=1, dropout=0.5, accum=1, clip=None,
                env=OFF, seed=1, lr=0.01),
    "split_accum_clip": dict(kind="fine", splits=2, dropout=0.5, accum=2,
                             clip=0.5, env=OFF, seed=2, lr=0.01),
    "composite_accum_clip": dict(kind="fine", splits=1, dropout=0.5,
                                 accum=2, clip=0.5,
                                 env={"CFN_MM_BN_TRAIN": "1"}, seed=3,
                                 lr=0.01),
    "coarse": dict(kind="coarse", splits=1, dropout=0.5, accum=1, clip=1.0,
                   env=OFF, seed=4, lr=0.02),
}
JAX_CFG = dict(kind="fine", splits=2, dropout=0.0, accum=1, clip=None,
               env=OFF, seed=5, lr=0.01, blocks=[1, 1, 1, 1])
STAGE_TOL, TENSOR_TOL, NEGLIGIBLE = 2.5e-2, 0.2, 1e-4


def _stage(name):
    top = name.split(".")[0]
    if top.startswith(("layer", "rw", "mix", "pool")):
        return top
    return "stem" if top in ("conv1_s", "conv1_t", "bn1") else "head"


def _jax_model_and_variables():
    """The JAX FineNet of ``JAX_CFG`` (plain layout, one bottleneck a
    stage) with numpy-filled variables."""
    from unittest import mock

    from coarse_fine_networks_tpu.models import fine as jfine
    from coarse_fine_networks_tpu.models.fine import FineNet as JFine

    jm = JFine(version="M", n_classes=dp.N_CLASSES, dropout_rate=0.0,
               bn_splits=2, trunk_layout="plain")
    with mock.patch.object(jfine, "get_blocks", lambda v: [1, 1, 1, 1]):
        v = jax_variables(jm, jnp.zeros((1, dp.T, dp.HW, dp.HW, 3)),
                          seed=JAX_CFG["seed"], train=False)
    return jm, v


@pytest.fixture(scope="module")
def runs():
    """One-process results of every configuration here, and the 2-rank
    results of every configuration and of the JAX one from one spawn,
    which runs while this process takes the one-process steps (each
    configuration sets ``CFN_MM_BN_TRAIN`` itself)."""
    jm, v = _jax_model_and_variables()
    jcfg = dict(JAX_CFG, state=state_dict_from_jax(v))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mesh.spawn, dp.train_steps, 2,
                            list(CONFIGS.values()) + [jcfg], device="cpu")
        one = {k: dp.train_step(c) for k, c in CONFIGS.items()}
        return {"one": one, "ranks": ranks.result(), "jax": (jm, v, jcfg)}


def _hold(got, ref):
    """Gradients ``got`` within ``STAGE_TOL`` relative L2 per stage and
    ``TENSOR_TOL`` per tensor of ``ref``, leaving out the negligible
    ones."""
    big = max(g.abs().max().item() for g in ref.values())
    stage, over = {}, {}
    for k, want in ref.items():
        if want.abs().max().item() <= NEGLIGIBLE * big:
            continue
        d = (got[k] - want).double()
        acc = stage.setdefault(_stage(k), [0.0, 0.0])
        acc[0] += float(torch.sum(d ** 2))
        acc[1] += float(torch.sum(want.double() ** 2))
        scale = want.abs().max().item()
        if d.abs().max() > TENSOR_TOL * scale:
            over[k] = d.abs().max().item() / scale
    assert not over, over
    rel = {s: (e / n) ** 0.5 for s, (e, n) in stage.items()}
    assert max(rel.values()) <= STAGE_TOL, rel


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_ranks_equal_one_process(runs, name):
    ref = runs["one"][name]
    i = list(CONFIGS).index(name)
    params = set(ref["grads"])
    for r in range(2):
        got = runs["ranks"][r][i]
        for k in ("loss", "cls_loss", "loc_loss"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        for k, want in ref["state"].items():
            if k in params:
                continue
            if want.is_floating_point():
                torch.testing.assert_close(got["state"][k], want, rtol=1e-4,
                                           atol=1e-6, msg=k)
            else:
                assert torch.equal(got["state"][k], want), k
        _hold(got["grads"], ref["grads"])
    # both ranks hold the same state after the step
    for k, v0 in runs["ranks"][0][i]["state"].items():
        assert torch.equal(v0, runs["ranks"][1][i]["state"][k]), k


def test_two_ranks_match_jax_mesh_step(runs):
    jm, v, jcfg = runs["jax"]
    from unittest import mock

    from coarse_fine_networks_tpu.models import fine as jfine

    batch = dp.make_batch(jcfg)
    jmesh = make_mesh()
    with mock.patch.object(jfine, "get_blocks", lambda ver: [1, 1, 1, 1]):
        jstep = jmake_step(jm, align_corners=True, donate=False)
        js, jmet = jstep(replicate(JTrainState.create(v), jmesh),
                         shard_batch(jax.tree.map(jnp.asarray, batch),
                                     jmesh),
                         jnp.float32(jcfg["lr"]), jax.random.PRNGKey(0))
    ref = state_dict_from_jax({"params": jax.device_get(js.params),
                               "batch_stats": jax.device_get(
                                   js.batch_stats)})
    p0 = jcfg["state"]
    for r in range(2):
        got = runs["ranks"][r][len(CONFIGS)]
        np.testing.assert_allclose(got["loss"], float(jmet["loss"]),
                                   rtol=1e-4)
        stage, over = {}, {}
        for k, want in ref.items():
            g = got["state"][k]
            if "split_bn" in k:
                err = ((g - want).abs().max() / want.abs().max()).item()
                assert err <= 1e-3, (k, err)
            elif "running" in k:
                assert torch.equal(g, p0[k]), k
            else:
                d = (g - p0[k]).double(), (want - p0[k]).double()
                e = float((d[0] - d[1]).abs().max() / d[1].abs().max())
                if e > 0.1:
                    over[k] = e
                acc = stage.setdefault(_stage(k), [0.0, 0.0])
                acc[0] += float(torch.sum((d[0] - d[1]) ** 2))
                acc[1] += float(torch.sum(d[1] ** 2))
        assert not over, over
        rel = {s: (e / n) ** 0.5 for s, (e, n) in stage.items()}
        assert max(rel.values()) <= 2.5e-2, rel
