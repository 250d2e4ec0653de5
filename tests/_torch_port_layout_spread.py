"""How far apart the JAX package's own two trunk layouts land on a train
step, beside the port (CPU, f32): the measurement behind the tolerances of
``test_torch_port_train_step.py``, ``test_torch_port_train_trajectory.py``
(the coarse stream), ``test_torch_port_fine_step.py`` and
``test_torch_port_fine_long_cycle.py`` (the fine stream).

Same configurations and batches as those tests: the coarse stream at
X3D-M, 7 classes, B=2, T=8, 64², T_f=16, label length 32, lr 0.02, fusion
×10, dropout 0; the fine stream at X3D-M, 7 classes, B=4, T=8, 64², label
length 32, lr 0.01, ``align_corners=True``, dropout 0, two batch-norm
splits.  Prints, for each stream:

* one step: the losses, and how far apart the first SGD step's update
  direction (the momentum buffer ``g + wd·p``) lands, for JAX fold4 vs JAX
  plain, port vs JAX plain and port vs JAX fold4: the relative L2 distance
  per stage, and per tensor the largest difference over the tensor's
  largest magnitude (the tensors above 1e-3, worst first);
* the coarse stream's four steps, or the fine stream's short long cycle
  (two steps at two splits, the rebuild to one split, two steps, then the
  split statistics aggregated and the eval step): the losses of JAX plain,
  JAX fold4 and the port, and their absolute differences.

Run from the repository root (about 4 minutes per stream)::

    python tests/_torch_port_layout_spread.py [coarse|fine]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from coarse_fine_networks_tpu.models.surgery import \
    set_bn_splits as jset_splits  # noqa: E402
from coarse_fine_networks_tpu.train import TrainState as JTrainState  # noqa: E402
from coarse_fine_networks_tpu.train import make_eval_step as jmake_eval  # noqa: E402
from coarse_fine_networks_tpu.train import make_train_step as jmake_step  # noqa: E402
from coarse_fine_networks_tpu.train.steps import \
    bn_aggregated as jbn_agg  # noqa: E402
from coarse_fine_networks_torch.ckpt import state_dict_from_jax  # noqa: E402
from coarse_fine_networks_torch.models import set_bn_splits  # noqa: E402
from coarse_fine_networks_torch.train import (TrainState,  # noqa: E402
                                              bn_aggregated, make_eval_step,
                                              make_train_step)

from _torch_port_util import (COARSE, FINE, coarse_batch,  # noqa: E402
                              coarse_models, fine_batch, fine_models, t)

LAYOUTS = {"plain": ("plain", "lax"), "fold4": ("fold4", "interpret")}
KW = dict(align_corners=False, fusion_lr_mult=COARSE["fusion_lr_mult"])
FINE_KW = dict(align_corners=True)


def _stage(name):
    top = name.split(".")[0]
    if top.startswith(("rw", "mix")):
        return "fusion"
    if top.startswith(("layer", "pool_")):
        return top
    return "stem" if top in ("conv1_s", "conv1_t", "bn1") else "head"


def _jax_run(layout, batches):
    jm, v, pm = coarse_models(*LAYOUTS[layout])
    step = jmake_step(jm, donate=False, **KW)
    js, losses, first = JTrainState.create(v), [], None
    for b in batches:
        js, m = step(js, jax.tree.map(jnp.asarray, b),
                     jnp.float32(COARSE["lr"]), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        if first is None:
            first = state_dict_from_jax({"params": js.opt.momentum,
                                         "batch_stats": {}})
    return losses, first, pm


def _port_run(pm, batches):
    step = make_train_step(pm, **KW)
    state, losses, first = TrainState.create(pm), [], None
    names = {id(p): k for k, p in pm.named_parameters()}
    for b in batches:
        state, m = step(state, jax.tree.map(t, b), COARSE["lr"])
        losses.append(m["loss"].item())
        if first is None:
            first = {names[id(p)]: s["momentum_buffer"].clone()
                     for p, s in state.optimizer.state.items()}
    return losses, first


def _spread(a, b):
    acc = {}
    for k, ref in b.items():
        d = (a[k].reshape(ref.shape) - ref).double()
        e = acc.setdefault(_stage(k), [0.0, 0.0])
        e[0] += float(torch.sum(d * d))
        e[1] += float(torch.sum(ref.double() ** 2))
    return {g: round((x / n) ** 0.5, 6) for g, (x, n) in sorted(acc.items())}


def _per_tensor(a, b, floor=1e-3):
    err = {k: float((a[k].reshape(ref.shape) - ref).abs().max()
                    / ref.abs().max()) for k, ref in b.items()}
    return {k: round(e, 6) for k, e in sorted(err.items(),
                                              key=lambda kv: -kv[1])
            if e > floor}


def coarse():
    one = [coarse_batch(1)]
    four = [coarse_batch(10 + i) for i in range(4)]
    bufs, losses, first = {}, {}, {}
    for layout in LAYOUTS:
        first[layout], bufs[layout], _ = _jax_run(layout, one)
        losses[layout], _, _ = _jax_run(layout, four)
    first["port"], bufs["port"] = _port_run(
        coarse_models(*LAYOUTS["plain"])[2], one)
    losses["port"], _ = _port_run(coarse_models(*LAYOUTS["plain"])[2], four)
    print(f"one step, losses: {first}")
    print("one step, relative L2 of the update per stage:")
    for a, b in (("fold4", "plain"), ("port", "plain"), ("port", "fold4")):
        print(f"  {a} vs {b}: {_spread(bufs[a], bufs[b])}")
    print("one step, per tensor max|difference| / max|update| above 1e-3:")
    for a, b in (("fold4", "plain"), ("port", "plain"), ("port", "fold4")):
        print(f"  {a} vs {b}: {_per_tensor(bufs[a], bufs[b])}")
    print("four steps, losses:")
    for k, v in losses.items():
        print(f"  {k}: {v}")
    for a, b in (("fold4", "plain"), ("port", "plain"), ("port", "fold4")):
        d = np.abs(np.asarray(losses[a]) - np.asarray(losses[b]))
        print(f"  |{a} - {b}|: {d.tolist()}")


def _fine_jax_run(layout, batches, switch=None):
    """JAX fine steps from the fine fixtures' weights; with ``switch`` the
    splits are rebuilt to one after that many steps and the split
    statistics aggregated for the eval step at the end."""
    jm, v, _ = fine_models(*LAYOUTS[layout])
    step = jmake_step(jm, donate=False, **FINE_KW)
    js, losses, first = JTrainState.create(v), [], None
    for i, b in enumerate(batches):
        if i == switch:
            js = js.replace(batch_stats=jset_splits(js.batch_stats, 1))
            jm = jm.clone(bn_splits=1)
            step = jmake_step(jm, donate=False, **FINE_KW)
        js, m = step(js, jax.tree.map(jnp.asarray, b),
                     jnp.float32(FINE["lr"]), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        if first is None:
            first = state_dict_from_jax({"params": js.opt.momentum,
                                         "batch_stats": {}})
    if switch is not None:
        ev = jmake_eval(jm, **FINE_KW)(jbn_agg(js), jax.tree.map(
            jnp.asarray, batches[-1]))
        losses.append(float(ev["loss"]))
    return losses, first


def _fine_port_run(batches, switch=None):
    pm = fine_models(*LAYOUTS["plain"])[2]
    step = make_train_step(pm, **FINE_KW)
    state, losses, first = TrainState.create(pm), [], None
    names = {id(p): k for k, p in pm.named_parameters()}
    for i, b in enumerate(batches):
        if i == switch:
            set_bn_splits(pm, 1)
        state, m = step(state, jax.tree.map(t, b), FINE["lr"])
        losses.append(m["loss"].item())
        if first is None:
            first = {names[id(p)]: s["momentum_buffer"].clone()
                     for p, s in state.optimizer.state.items()}
    if switch is not None:
        ev = make_eval_step(pm, **FINE_KW)(bn_aggregated(state),
                                           jax.tree.map(t, batches[-1]))
        losses.append(ev["loss"].item())
    return losses, first


def fine():
    one = [fine_batch(1)]
    cycle = [fine_batch(10 + i) for i in range(4)]
    bufs, losses, first = {}, {}, {}
    for layout in LAYOUTS:
        first[layout], bufs[layout] = _fine_jax_run(layout, one)
        losses[layout], _ = _fine_jax_run(layout, cycle, switch=2)
    first["port"], bufs["port"] = _fine_port_run(one)
    losses["port"], _ = _fine_port_run(cycle, switch=2)
    print(f"fine, one step at {FINE['splits']} splits, losses: {first}")
    print("fine, one step, relative L2 of the update per stage:")
    for a, b in (("fold4", "plain"), ("port", "plain"), ("port", "fold4")):
        print(f"  {a} vs {b}: {_spread(bufs[a], bufs[b])}")
    print("fine, one step, per tensor max|difference| / max|update| above "
          "1e-3:")
    for a, b in (("fold4", "plain"), ("port", "plain"), ("port", "fold4")):
        print(f"  {a} vs {b}: {_per_tensor(bufs[a], bufs[b])}")
    print("fine, long cycle (2 steps at 2 splits, 2 at 1, eval), losses:")
    for k, v in losses.items():
        print(f"  {k}: {v}")
    for a, b in (("fold4", "plain"), ("port", "plain"), ("port", "fold4")):
        d = np.abs(np.asarray(losses[a]) - np.asarray(losses[b]))
        print(f"  |{a} - {b}|: {d.tolist()}")


def main():
    torch.set_num_threads(2)  # as the tests run
    which = sys.argv[1:] or ["coarse", "fine"]
    for stream in which:
        {"coarse": coarse, "fine": fine}[stream]()


if __name__ == "__main__":
    main()
