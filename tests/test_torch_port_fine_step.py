"""The port's fine-stream train step with split batch norm against the JAX
package's, one step through the kernels.

X3D-M at full width, cut to 7 classes, B=4, T=8, 64², label length 32, lr
0.01, ``align_corners=True`` (the fine driver's), dropout 0, two batch-norm
splits.  The JAX side is ``make_train_step`` on ``FineNet(trunk_layout=
"fold4", dw_impl="interpret", bn_splits=2)``: the stem and layer1 run the
Pallas kernels (the plain modes of K1/K4, K8 and the plain modes of K6/K10)
under the interpreter; the port's step runs every bottleneck through the
plain versions of its kernels on the CPU.  Both start from the same
weights (via ``state_dict_from_jax``) and the same numpy batch.

Tolerances:

* the loss within 1e-5 relative, and each new split statistic (a forward
  quantity) within 1e-3 of the JAX tensor's largest magnitude;
* each parameter's update ``p1 − p0`` within 0.1 of the JAX update's
  largest magnitude (``TENSOR_TOL``), but for the tensor named in
  ``FLIP_TOL``, held at 0.2;
* the updates within 2.5e-2 relative L2 per stage (stem, layer1-4, head).

Measured (``tests/_torch_port_layout_spread.py fine`` prints every number
here): the JAX package's own fold4 and plain layouts, the same math, give
losses 1.9e-6 relative apart, updates 8.9e-3 (head) to 4.8e-2 per stage
apart, and per tensor more than 0.1 apart in 21 tensors (up to 0.44 in
layer1.0's SE ``fc1``): batch norm over 2·8·2·2 = 64 elements per split at
layer4 and over 64 frames in the head amplifies f32 rounding in another
order, and a relu input within a rounding of 0 takes the other branch.
The port against fold4: the loss 1.3e-6 relative apart, per stage at most
1.45e-2 (stem), per tensor at most 7.5e-2 but in ``layer4.1.conv1.weight``,
0.131.  A fault of wiring or of a kernel, even in one small tensor such as
a bias, moves that tensor's update by O(1)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.train import TrainState as JTrainState
from coarse_fine_networks_tpu.train import make_train_step as jmake_step
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.train import TrainState, make_train_step

from _torch_port_util import FINE, fine_batch, fine_models, t

torch.set_num_threads(2)

TENSOR_TOL = 0.1
FLIP_TOL = {"layer4.1.conv1.weight": 0.2}
STAGES = {"stem", "layer1", "layer2", "layer3", "layer4", "head"}


def _stage(name):
    top = name.split(".")[0]
    if top.startswith("layer"):
        return top
    return "stem" if top in ("conv1_s", "conv1_t", "bn1") else "head"


def test_one_step_split_bn_matches_jax_fold4_kernels():
    jm, v, pm = fine_models("fold4", "interpret")
    batch = fine_batch(1)
    p0 = {k: x.clone() for k, x in pm.state_dict().items()}

    jstep = jmake_step(jm, align_corners=True, donate=False)
    js, jmet = jstep(JTrainState.create(v), jax.tree.map(jnp.asarray, batch),
                     jnp.float32(FINE["lr"]), jax.random.PRNGKey(0))
    step = make_train_step(pm, align_corners=True)
    state, met = step(TrainState.create(pm), jax.tree.map(t, batch),
                      FINE["lr"])

    loss, jloss = met["loss"].item(), float(jmet["loss"])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
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
            assert got[k].shape == r.shape == (
                FINE["splits"] * got[k.replace("split_bn", "bn")].shape[0],)
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
    assert set(rel) == STAGES
    assert max(rel.values()) <= 2.5e-2, rel
