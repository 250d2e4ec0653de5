"""The port's coarse train step against the JAX package's, one step through
the kernels.

X3D-M at full width, cut to 7 classes, B=2, T=8, 64², T_f=16, label length
32, lr 0.02, fusion learning rate ×10, dropout 0.  The JAX side is
``make_train_step`` on ``CoarseNet(trunk_layout="fold4",
dw_impl="interpret")``: the stem and layer1 run the Pallas kernels under
the interpreter, and layer1's training entry is the matmul-fused composite
``dw_fold4_mm_bn_train`` (``resolve_mm_train_impl`` returns ``'interpret'``
for ``dw_impl='interpret'`` whatever ``CFN_MM_BN_TRAIN`` says): the ``mm``
modes of K1/K4, K2/K9 and the ``mm`` modes of K6/K10.  The port's step runs
every bottleneck through its act route (the plain versions of its act-mode
kernels on the CPU), so layer1 is held against the other route of the same
function.  Both start from the same weights (via
``state_dict_from_jax``) and the same numpy batch.

Tolerances:

* the loss within 1e-4 relative, and each new split statistic (a forward
  quantity) within 1e-3 of the JAX tensor's largest magnitude;
* each parameter's update ``p1 − p0`` within 5e-2 of the JAX update's
  largest magnitude (``TENSOR_TOL``), but for the three tensors named in
  ``FLIP_TOL``, held at 0.2;
* the updates within 2.5e-2 relative L2 per stage (stem, layer1-4, Grid
  Pool, fusion, head).

Measured reason for both update limits (``tests/_torch_port_layout_spread.py``
prints every number here): one relu input within f32 rounding of 0 takes
the other branch when the bn1 apply is computed as ``x·sc + bi`` (the fused
entry, as in the Pallas kernels) rather than ``(x − μ)·r·γ + β`` (the JAX
fold4 model's layers 2-4), and batch norm over 96 (layer3) or 24 (layer4)
elements carries that one element into every gradient upstream.  On this
batch the JAX package's own fold4 and plain layouts disagree by 1.0e-3
(head) to 4.3e-2 per stage, and per tensor by more than 5e-2 in 112
tensors, up to 0.42 in layer4.6.bn1, the block that holds their flip.  The
port against fold4: per stage at most 1.53e-2 (layer2), 4.1e-4 at layer4
and 7.3e-5 at the head; per tensor at most 4.1e-2 outside block layer3.3,
which holds the port's flip, and there 0.128 (bn1.bias), 0.103
(conv1.weight) and 0.058 (bn1.weight), against the JAX layouts' own 0.033,
0.046 and 0.071 in the same tensors.  A fault of wiring or of a kernel,
even in one small tensor such as a bn1 bias fed by the entry's ``dbi``,
moves that tensor's update by O(1)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.train import TrainState as JTrainState
from coarse_fine_networks_tpu.train import make_train_step as jmake_step
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.train import TrainState, make_train_step

from _torch_port_util import COARSE, coarse_batch, coarse_models, t

torch.set_num_threads(2)

TENSOR_TOL = 5e-2
FLIP_TOL = {"layer3.3.bn1.bias": 0.2, "layer3.3.conv1.weight": 0.2,
            "layer3.3.bn1.weight": 0.2}


def test_one_step_matches_jax_fold4_kernels():
    jm, v, pm = coarse_models("fold4", "interpret")
    batch = coarse_batch(1)
    p0 = {k: x.clone() for k, x in pm.state_dict().items()}

    jstep = jmake_step(jm, align_corners=False,
                       fusion_lr_mult=COARSE["fusion_lr_mult"], donate=False)
    js, jmet = jstep(JTrainState.create(v), jax.tree.map(jnp.asarray, batch),
                     jnp.float32(COARSE["lr"]), jax.random.PRNGKey(0))
    step = make_train_step(pm, align_corners=False,
                           fusion_lr_mult=COARSE["fusion_lr_mult"])
    state, met = step(TrainState.create(pm), jax.tree.map(t, batch),
                      COARSE["lr"])

    loss, jloss = met["loss"].item(), float(jmet["loss"])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert state.step == 1

    ref = state_dict_from_jax({"params": js.params,
                               "batch_stats": js.batch_stats})
    got = pm.state_dict()
    params = dict(pm.named_parameters())
    assert set(ref) == set(got)
    stats_err, update_err, stage = {}, {}, {}
    for k, r in ref.items():
        if k in params:
            d = (got[k] - p0[k]).double(), (r - p0[k]).double()
            update_err[k] = float((d[0] - d[1]).abs().max()
                                  / d[1].abs().max())
            acc = stage.setdefault(_stage(k), [0.0, 0.0])
            acc[0] += float(torch.sum((d[0] - d[1]) ** 2))
            acc[1] += float(torch.sum(d[1] ** 2))
        elif "split_bn" in k:
            stats_err[k] = ((got[k] - r).abs().max() / r.abs().max()).item()
        else:  # bn.running_* change only through aggregation
            assert torch.equal(got[k], p0[k]), k
    worst = max(stats_err.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-3, worst
    assert set(FLIP_TOL) <= set(update_err)
    over = {k: e for k, e in update_err.items()
            if e > FLIP_TOL.get(k, TENSOR_TOL)}
    assert not over, over
    rel = {g: (e / n) ** 0.5 for g, (e, n) in stage.items()}
    assert set(rel) == {"stem", "layer1", "layer2", "layer3", "layer4",
                        "pool_1", "fusion", "head"}
    assert max(rel.values()) <= 2.5e-2, rel


def _stage(name):
    top = name.split(".")[0]
    if top.startswith(("rw", "mix")):
        return "fusion"
    if top.startswith(("layer", "pool_")):
        return top
    return "stem" if top in ("conv1_s", "conv1_t", "bn1") else "head"
