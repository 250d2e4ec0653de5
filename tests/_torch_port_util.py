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
