"""How far apart the JAX package's own two trunk layouts land on the coarse
train step, beside the port (CPU, f32): the measurement behind the
tolerances of ``test_torch_port_train_step.py`` and
``test_torch_port_train_trajectory.py``.

Same configuration and batches as those tests (X3D-M, 7 classes, B=2, T=8,
64², T_f=16, label length 32, lr 0.02, fusion ×10, dropout 0).  Prints:

* one step: the losses, and how far apart the first SGD step's update
  direction (the momentum buffer ``g + wd·p``) lands, for JAX fold4 vs JAX
  plain, port vs JAX plain and port vs JAX fold4: the relative L2 distance
  per stage, and per tensor the largest difference over the tensor's
  largest magnitude (the tensors above 1e-3, worst first);
* four steps: the losses of JAX plain, JAX fold4 and the port, and their
  absolute differences.

Run from the repository root (about 4 minutes)::

    python tests/_torch_port_layout_spread.py
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

from coarse_fine_networks_tpu.train import TrainState as JTrainState  # noqa: E402
from coarse_fine_networks_tpu.train import make_train_step as jmake_step  # noqa: E402
from coarse_fine_networks_torch.ckpt import state_dict_from_jax  # noqa: E402
from coarse_fine_networks_torch.train import (TrainState,  # noqa: E402
                                              make_train_step)

from _torch_port_util import COARSE, coarse_batch, coarse_models, t  # noqa: E402

LAYOUTS = {"plain": ("plain", "lax"), "fold4": ("fold4", "interpret")}
KW = dict(align_corners=False, fusion_lr_mult=COARSE["fusion_lr_mult"])


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


def main():
    torch.set_num_threads(2)  # as the tests run
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


if __name__ == "__main__":
    main()
