"""Train-state checkpoints (counterpart of
``coarse_fine_networks_tpu/ckpt/checkpoint.py``, which serialises with
flax's msgpack): ``torch.save`` of a dict of tensors and plain values,
written to a temporary file and moved over the target with ``os.replace``,
so a reader never sees a half-written file.  One process writes.
``latest_checkpoint`` finds the highest ``<prefix>_NNNNNN.ckpt``."""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Save ``state`` (nested dicts and lists of tensors, numbers and
    strings) with its tensors on the CPU; returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint onto the CPU (tensors, containers and plain values
    only: ``weights_only``).  The JAX package's ``target`` (restore into a
    pytree's structure) has no counterpart: a module's
    ``load_state_dict`` does that."""
    return torch.load(path, map_location="cpu", weights_only=True)


_STEP_RE = re.compile(r"_(\d+)\.ckpt$")


def latest_checkpoint(directory: str, prefix: str) -> Optional[str]:
    """The highest-step ``<prefix>_NNNNNN.ckpt`` in ``directory``, or
    None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if not name.startswith(prefix):
            continue
        m = _STEP_RE.search(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best
