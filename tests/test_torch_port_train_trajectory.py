"""The port's coarse train step against the JAX package's over a 4-step
trajectory.

X3D-M at full width, cut to 7 classes, B=2, T=8, 64², T_f=16, label length
32, lr 0.02, fusion learning rate ×10, dropout 0, a new numpy batch each
step.  The JAX side is ``make_train_step`` on the plain CPU layout (the
same math as the fold4 trunk, ``models/x3d_fold.py``); the port's step runs
its kernels' plain versions on the CPU.

Tolerances start from those of ``tests/test_training_dynamics.py``: the
loss of step 0 within 1e-3, all four steps within 5e-3.  The second is
loosened to 1.5e-2 for a measured reason: on these batches the JAX
package's own fold4 and plain layouts, the same math, end step 2 1.13e-2
apart (0.81825 against 0.80693), because a relu input within f32 rounding
of 0 takes the other branch in one of them and batch norm over 24 elements
at layer4 amplifies it.  The port, as this test runs it (two CPU threads;
another thread count sums in another order and moves step 2 by ~1e-3),
ends step 2 at 0.81674: 9.8e-3 from plain, 1.5e-3 from fold4
(``tests/_torch_port_layout_spread.py`` prints these).
After the steps both sides aggregate the split statistics and run the eval
step on the last batch; its loss is held to 1.5e-2 as well."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.train import TrainState as JTrainState
from coarse_fine_networks_tpu.train import make_eval_step as jmake_eval
from coarse_fine_networks_tpu.train import make_train_step as jmake_step
from coarse_fine_networks_tpu.train.steps import bn_aggregated as jbn_agg
from coarse_fine_networks_torch.train import (TrainState, bn_aggregated,
                                              make_eval_step,
                                              make_train_step)

from _torch_port_util import COARSE, coarse_batch, coarse_models, t

torch.set_num_threads(2)


def test_four_step_trajectory_matches_jax_plain_layout():
    jm, v, pm = coarse_models("plain", "lax")
    kw = dict(align_corners=False, fusion_lr_mult=COARSE["fusion_lr_mult"])
    jstep = jmake_step(jm, donate=False, **kw)
    step = make_train_step(pm, **kw)
    js, state = JTrainState.create(v), TrainState.create(pm)
    losses, jlosses = [], []
    for i in range(4):
        batch = coarse_batch(10 + i)
        js, jmet = jstep(js, jax.tree.map(jnp.asarray, batch),
                         jnp.float32(COARSE["lr"]), jax.random.PRNGKey(0))
        state, met = step(state, jax.tree.map(t, batch), COARSE["lr"])
        losses.append(met["loss"].item())
        jlosses.append(float(jmet["loss"]))
    print("port:", losses, "\njax: ", jlosses)
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], jlosses[0], atol=1e-3)
    np.testing.assert_allclose(losses, jlosses, atol=1.5e-2)

    ev = make_eval_step(pm, align_corners=False)(
        bn_aggregated(state), jax.tree.map(t, batch))
    jev = jmake_eval(jm, align_corners=False)(
        jbn_agg(js), jax.tree.map(jnp.asarray, batch))
    assert ev["probs"].shape == jev["probs"].shape
    np.testing.assert_allclose(ev["loss"].item(), float(jev["loss"]),
                               atol=1.5e-2)
