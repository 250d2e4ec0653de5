"""JAX-package variables → the port's ``state_dict``.

The JAX package keeps ``{"params": ..., "batch_stats": ...}`` as nested
dicts (flax names, channels-last kernels); the port uses the reference's
torch names and layouts.  Rules:

* Conv3d kernel ``(D, H, W, I, O)`` → ``(O, I, D, H, W)``; a depthwise kernel
  ``(3, 3, 3, 1, C)`` → ``(C, 1, 3, 3, 3)`` by the same transpose;
* Dense kernel ``(I, O)`` → ``(O, I)``, or ``(O, I, 1)`` for the kernel-1
  Conv1d heads of ``rw*``/``mix*``;
* SubBatchNorm ``scale``/``bias`` → ``weight``/``bias``; ``mean``/``var`` →
  ``bn.running_*``; ``split_mean``/``split_var`` → ``split_bn.running_*``;
* flax modules ``stem``/``head`` have no torch counterpart (their children sit
  at the tower's top level), ``layerN/blockM`` → ``layerN.M``, the block's
  ``se/fc*`` → ``fc*``, ``downsample_conv``/``downsample_bn`` →
  ``downsample.0``/``downsample.1``.

A joint pipeline tree (``fine``/``coarse`` subtrees) maps to the keys of
:class:`..models.pipeline.CoarseFinePipeline` (``fine.*``/``coarse.*``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN_LEAF = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "bn.running_mean",
    ("batch_stats", "var"): "bn.running_var",
    ("batch_stats", "split_mean"): "split_bn.running_mean",
    ("batch_stats", "split_var"): "split_bn.running_var",
}
_BLOCK_SUB = {
    ("se", "fc1"): ("fc1",),
    ("se", "fc2"): ("fc2",),
    ("downsample_conv",): ("downsample", "0"),
    ("downsample_bn",): ("downsample", "1"),
}
_TOWERS = ("fine", "coarse")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_path(mod: Tuple[str, ...]) -> Tuple[str, ...]:
    if mod and mod[0] in ("stem", "head"):
        mod = mod[1:]
    for i, m in enumerate(mod):
        if m.startswith("block") and m[5:].isdigit():
            rest = mod[i + 1:]
            for flax_sub, torch_sub in _BLOCK_SUB.items():
                if rest[:len(flax_sub)] == flax_sub:
                    rest = torch_sub + rest[len(flax_sub):]
                    break
            return mod[:i] + (m[5:],) + rest
    return mod


def _tensor(mod: Tuple[str, ...], leaf: str, val: np.ndarray) -> np.ndarray:
    if leaf == "bias" or val.ndim == 1:
        return val
    if val.ndim == 5:
        return np.transpose(val, (4, 3, 0, 1, 2))
    if val.ndim == 2:
        w = np.transpose(val, (1, 0))
        if mod and (mod[0].startswith("rw") or mod[0].startswith("mix")):
            w = w[:, :, None]
        return w
    raise ValueError(f"unexpected {val.ndim}-D leaf {'/'.join(mod)}/{leaf}")


def _tower(params: Mapping, batch_stats: Mapping) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for collection, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, val in _leaves(tree):
            mod, leaf = path[:-1], path[-1]
            is_bn = bool(mod) and (mod[-1].startswith("bn")
                                   or mod[-1] == "downsample_bn")
            name = ".".join(_module_path(mod))
            if is_bn:
                out[f"{name}.{_BN_LEAF[(collection, leaf)]}"] = val
            else:
                torch_leaf = {"kernel": "weight", "bias": "bias"}[leaf]
                out[f"{name}.{torch_leaf}"] = _tensor(mod, leaf, val)
    return out


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a JAX tower, module or joint
    pipeline → the port's ``state_dict`` (float32 tensors, owning their
    memory), ready for ``load_state_dict(..., strict=True)``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if set(params) <= set(_TOWERS) and params:
        flat = {}
        for tower in params:
            for k, v in _tower(params[tower], stats.get(tower, {})).items():
                flat[f"{tower}.{k}"] = v
    else:
        flat = _tower(params, stats)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            for k, v in flat.items()}
