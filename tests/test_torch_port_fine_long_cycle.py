"""The port's fine-stream training through a short multigrid long cycle
against the JAX package's.

X3D-M at full width, cut to 7 classes, B=4, T=8, 64², label length 32, lr
0.01, ``align_corners=True``, dropout 0, a new numpy batch each step: two
steps at two batch-norm splits, the transition to one split (the
schedule's rebuild of the split statistics; in the port in place on the
module, with the optimizer kept; in JAX on the statistics tree with a
re-cloned module), two steps at one split, then the split statistics
aggregated into the eval statistics and the eval step on the last batch.
The JAX side is the plain layout (the same math as the fold4 trunk); the
port's step runs its kernels' plain versions on the CPU, so the first two
steps take the split route (``ops/dw_conv.py``) and the last two the fused
act-mode entry (``ops/dw_act.py``).

Tolerances: the loss of step 0 within 1e-4, every step and the eval loss
within 5e-3.  Measured (``tests/_torch_port_layout_spread.py fine``): the
JAX package's own fold4 and plain layouts end step 2 3.0e-3 apart (a relu
input within f32 rounding of 0 takes the other branch in one of them, and
batch norm over 64 elements per split at layer4 carries it); the port is
at most 1.4e-3 from plain (step 3) and 2.6e-6 at step 0."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.models.surgery import \
    set_bn_splits as jset_splits
from coarse_fine_networks_tpu.train import TrainState as JTrainState
from coarse_fine_networks_tpu.train import make_eval_step as jmake_eval
from coarse_fine_networks_tpu.train import make_train_step as jmake_step
from coarse_fine_networks_tpu.train.steps import bn_aggregated as jbn_agg
from coarse_fine_networks_torch.models import SubBatchNorm
from coarse_fine_networks_torch.train import (LongCycleSchedule, TrainState,
                                              bn_aggregated, make_eval_step,
                                              make_train_step)

from _torch_port_util import FINE, fine_batch, fine_models, t

torch.set_num_threads(2)


def test_two_phase_long_cycle_matches_jax_plain_layout():
    jm, v, pm = fine_models("plain", "lax")
    jstep = jmake_step(jm, align_corners=True, donate=False)
    step = make_train_step(pm, align_corners=True)
    js, state = JTrainState.create(v), TrainState.create(pm)
    # phases C then D of the long cycle: two splits, then one
    sched = LongCycleSchedule(8, 64, 2, epochs_per_phase=1)
    assert sched.phase(2).bn_split_scale == FINE["splits"]
    losses, jlosses = [], []
    for i in range(4):
        if i == 2:
            assert sched.transition(3, pm) == 1
            js = js.replace(batch_stats=jset_splits(js.batch_stats, 1))
            jm = jm.clone(bn_splits=1)
            jstep = jmake_step(jm, align_corners=True, donate=False)
            bns = [m for m in pm.modules() if isinstance(m, SubBatchNorm)]
            assert {m.num_splits for m in bns} == {1}
            assert all(m.split_bn.running_mean.shape == (m.num_features,)
                       for m in bns)
        batch = fine_batch(10 + i)
        js, jmet = jstep(js, jax.tree.map(jnp.asarray, batch),
                         jnp.float32(FINE["lr"]), jax.random.PRNGKey(0))
        state, met = step(state, jax.tree.map(t, batch), FINE["lr"])
        losses.append(met["loss"].item())
        jlosses.append(float(jmet["loss"]))
    print("port:", losses, "\njax: ", jlosses)
    assert state.step == 4
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], jlosses[0], atol=1e-4)
    np.testing.assert_allclose(losses, jlosses, atol=5e-3)

    ev = make_eval_step(pm, align_corners=True)(
        bn_aggregated(state), jax.tree.map(t, batch))
    jev = jmake_eval(jm, align_corners=True)(
        jbn_agg(js), jax.tree.map(jnp.asarray, batch))
    assert ev["probs"].shape == jev["probs"].shape == (
        FINE["b"], FINE["tl"], FINE["n_classes"])
    np.testing.assert_allclose(ev["loss"].item(), float(jev["loss"]),
                               atol=5e-3)
