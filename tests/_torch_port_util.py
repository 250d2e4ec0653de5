"""Helpers for the port's parity tests: JAX variable trees filled from
numpy, and loading them into port modules through ``ckpt.from_jax``."""

import functools
import math

import numpy as np
import torch

import jax

from coarse_fine_networks_torch.ckpt import state_dict_from_jax


def _fill(path, shape, rng):
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = math.prod(shape[:-1])
        return rng.randn(*shape) / math.sqrt(fan_in)
    if leaf in ("bias", "mean", "split_mean"):
        return rng.randn(*shape) * 0.2
    if leaf in ("scale", "var", "split_var"):
        return 0.5 + rng.rand(*shape)
    raise KeyError(leaf)


def jax_variables(module, *args, seed=0, **static):
    """Variables of ``module.init(key, *args, **static)`` without running
    it: shapes from ``jax.eval_shape`` (``static`` keyword arguments are not
    traced), values from a numpy seed (positive ``var``, non-trivial
    ``mean``)."""
    shapes = jax.eval_shape(functools.partial(module.init, **static),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def rec(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: rec(v, path + (k,)) for k, v in tree.items()}
        return _fill(path, tree.shape, rng).astype(np.float32)

    return rec(shapes, ())


def nest(variables, prefix):
    """Put a module's variables under a flax path prefix."""
    out = {}
    for coll, tree in variables.items():
        for p in reversed(prefix):
            tree = {p: tree}
        out[coll] = tree
    return out


def load_port(port_module, variables, prefix=(), strip=""):
    """Load JAX ``variables`` (nested under ``prefix`` for the converter,
    whose resulting key prefix ``strip`` is removed) into ``port_module``
    with ``strict=True``; returns the module in eval mode."""
    sd = state_dict_from_jax(nest(variables, prefix))
    sd = {k[len(strip):]: v for k, v in sd.items() if k.startswith(strip)}
    port_module.load_state_dict(sd, strict=True)
    return port_module.eval()


def t(a):
    return torch.from_numpy(np.array(a))


# ---- the coarse train step at X3D-M width, cut to B=2, T=8, 64² -----------

COARSE = dict(b=2, t=8, hw=64, tf=16, tl=32, n_classes=7, lr=0.02,
              fusion_lr_mult=10.0)
BANKS = (("layer1", 24), ("layer2", 48), ("layer3", 96), ("layer4", 192),
         ("conv5", 432))


def coarse_batch(seed):
    """A numpy train batch in the JAX package's dict layout (the second
    sample has masked fine frames and label frames)."""
    c = COARSE
    rng = np.random.RandomState(seed)
    b, t_, tf, tl = c["b"], c["t"], c["tf"], c["tl"]
    feat_mask = np.ones((b, tf), np.float32)
    feat_mask[1, 12:] = 0
    masks = np.ones((b, tl), np.float32)
    masks[1, 28:] = 0
    return {
        "clips": rng.rand(b, t_, c["hw"], c["hw"], 3).astype(np.float32),
        "feats": {k: rng.rand(b, tf, 7, 7, ch).astype(np.float32)
                  for k, ch in BANKS},
        "feat_mask": feat_mask,
        "meta": np.array([[0, t_, tf, 1], [0, t_, 12, 1]], np.int32),
        "labels": (rng.rand(b, tl, c["n_classes"]) > 0.9).astype(np.float32),
        "masks": masks,
    }


def coarse_models(trunk_layout, dw_impl, seed=0):
    """The JAX ``CoarseNet`` (dropout 0) with variables filled from a numpy
    seed, and the port's ``CoarseNet`` loaded with the same weights."""
    from coarse_fine_networks_tpu.models.coarse import CoarseNet as JCoarse
    from coarse_fine_networks_torch.models import CoarseNet

    c = COARSE
    jm = JCoarse(version="M", n_classes=c["n_classes"], dropout_rate=0.0,
                 trunk_layout=trunk_layout, dw_impl=dw_impl)
    b = jax.tree.map(jax.numpy.asarray, coarse_batch(0))
    v = jax_variables(jm, b["clips"], b["feats"], b["feat_mask"], b["meta"],
                      seed=seed, train=False)
    pm = CoarseNet("M", c["n_classes"], dropout_rate=0.0)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm
