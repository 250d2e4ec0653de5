"""Tensor (model) parallelism for the X3D fine tower (counterpart of
``coarse_fine_networks_tpu/parallel/tensor.py``), for serving's extract.

The fine tower runs every window of a video through the whole trunk; this
module splits its wide channel dimensions over a list of devices,
Megatron-style, in one process:

* ``conv1`` (1×1×1 expand), the depthwise ``conv2``, bn1 and bn2 are
  column-parallel: each shard holds a slice of the mid channels and runs
  the eval bottleneck entry's kernel (K1 ``mm`` at stride 1, K4 ``mm`` at
  stride 2, :func:`..ops.dw_mm_act.dw_mm_bnrelu_conv3d`) on its slice;
* the SE block is a row→column pair: ``fc1`` contracts the sharded
  channels (the shards' partial sums are added, then its bias), ``fc2``
  emits each shard's slice of the gate;
* ``conv3`` (1×1×1 project) is row-parallel: the shards' partial sums
  (f32) are added on the first device and rounded once, and bn3, the
  downsample and the residual run there;
* the head repeats the pattern: ``conv5`` and bn5 column-parallel, the
  logits head's ``fc1`` row-parallel;
* the stem and everything between blocks run once, on the first device
  (the JAX mesh replicates them).

The JAX package forces its plain trunk here; the port's shards run its
hand-written kernels.  Those need each shard's width a multiple of 8
(16-byte rows of bf16 channels), so :func:`make_tp_tower` pads every mid
and head width to a multiple of ``8·N`` (``channel_pad``,
:class:`..models.x3d.X3DTrunk`) and zero-fills the padded parameters
(:func:`pad_tower_state_dict`, the JAX package's ``pad_tower_variables``):
zero conv1 columns give zero activations, bn1/bn2 with zero weight, bias
and mean and unit variance keep them zero, the depthwise conv and the
Swish preserve zeros, the SE gate scales a zero, and conv3's zero rows add
nothing.  The padded tower's outputs therefore equal the unpadded tower's
up to summation order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from ..models.fine import TOWER_HW, FineNet
from ..models.layers import SubBatchNorm, pointwise, swish
from ..models.x3d import X3DStage
from ..ops.dw_mm_act import dw_mm_bnrelu_conv3d, mm_f32
from ..ops.pools import adaptive_avg_pool_spatial

# the width each shard's mid and head channels are a multiple of (the
# kernels' 16-byte rows of bf16 channels)
SHARD_MULTIPLE = 8

# torch-layout parameter suffix → the dim it is sharded on (column-parallel:
# the output channels, dim 0; row-parallel: the input channels, dim 1)
_COLUMN = ("conv1.weight", "conv2.weight", "fc2.weight", "fc2.bias",
           "conv5.weight")
_ROW = ("conv3.weight", "fc1.weight")


def tower_param_specs(state_dict: Dict[str, torch.Tensor]
                      ) -> Dict[str, int | None]:
    """The dim each of the tower's tensors is sharded on (None: held
    whole), by ``state_dict`` name: ``conv1``, ``conv2``, the SE ``fc2``
    (weight and bias) and ``conv5`` on their output channels (0); ``conv3``,
    the SE ``fc1`` and the head's ``fc1`` on their input channels (1); the
    rest whole.  The logits head's ``fc2`` is a Linear and stays whole, as
    in the JAX package; the batch-norm vectors of the sharded channels are
    sliced with them (the JAX mesh replicates them and slices them
    locally)."""
    out = {}
    for k, v in state_dict.items():
        dim = None
        if v.dim() == 5 and k.endswith(_COLUMN):
            dim = 0
        elif v.dim() == 5 and k.endswith(_ROW):
            dim = 1
        elif k.endswith("fc2.bias") and "layer" in k:
            dim = 0
        out[k] = dim
    return out


def tp_param_bytes(state_dict: Dict[str, torch.Tensor],
                   n_shards: int) -> tuple[int, int]:
    """``(total bytes, bytes of one shard's slices and the whole
    tensors)`` of the tower's parameters under :func:`tower_param_specs`
    (the JAX package's ``tp_param_bytes``; buffers count whole)."""
    total = per = 0
    for k, dim in tower_param_specs(state_dict).items():
        v = state_dict[k]
        nbytes = v.numel() * v.element_size()
        total += nbytes
        per += nbytes // n_shards if dim is not None else nbytes
    return total, per


def _pad(name: str, v: torch.Tensor, shape) -> torch.Tensor:
    """``v`` zero-padded at the tail of each dim up to ``shape`` (a
    variance with ones)."""
    if tuple(v.shape) == tuple(shape):
        return v.clone()
    if v.dim() != len(shape):
        raise ValueError(f"{name}: {tuple(v.shape)} against {tuple(shape)}")
    out = torch.full(tuple(shape), 1.0 if name.endswith("running_var")
                     else 0.0, dtype=v.dtype)
    out[tuple(slice(0, s) for s in v.shape)] = v
    return out


def pad_tower_state_dict(state_dict: Dict[str, torch.Tensor],
                         padded: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """``state_dict`` of a tower mapped onto the shapes of ``padded`` (the
    ``channel_pad`` tower's ``state_dict``): kernels, affine vectors and
    means zero-padded, variances padded with ones, each split batch norm's
    ``split_bn`` statistics (``num_splits·C``, split-major) padded per
    split; the JAX package's ``pad_tower_variables`` in the port's
    names."""
    out = {}
    for k, v in state_dict.items():
        shape = padded[k].shape
        if ".split_bn." in k and tuple(v.shape) != tuple(shape):
            base = k.replace(".split_bn.", ".bn.")
            c, c_p = state_dict[base].shape[0], padded[base].shape[0]
            s = v.shape[0] // c
            out[k] = _pad(k, v.reshape(s, c), (s, c_p)).reshape(-1)
        else:
            out[k] = _pad(k, v, shape)
        if tuple(out[k].shape) != tuple(shape):
            raise ValueError(f"{k}: padded to {tuple(out[k].shape)}, not "
                             f"{tuple(shape)}")
    return out


def _bn_apply(bn: SubBatchNorm, x: torch.Tensor,
              sl: slice) -> torch.Tensor:
    """``bn``'s eval apply restricted to channels ``sl`` (the
    :class:`..models.layers.SubBatchNorm` eval formula), on x's device."""
    dev = x.device
    rm, rv = bn.bn.running_mean[sl].to(dev), bn.bn.running_var[sl].to(dev)
    xn = (x.float() - rm) * torch.rsqrt(rv + bn.eps)
    return (xn * bn.weight[sl].to(dev) + bn.bias[sl].to(dev)).to(x.dtype)


def _partial(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A row-parallel shard's partial product: the 1×1×1 conv ``weight``
    (its slice of the input channels) on ``x``, accumulated and returned
    in f32, so the shards' sum is rounded to the compute dtype once."""
    w = weight.reshape(weight.shape[0], weight.shape[1])
    return mm_f32(x.reshape(-1, x.shape[-1]), w.t().contiguous()).reshape(
        tuple(x.shape[:-1]) + (w.shape[0],))


def _sum_to(parts: List[torch.Tensor], device, dtype) -> torch.Tensor:
    """The shards' f32 partial sums added on ``device``, in ``dtype``."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total.to(dtype)


class TensorParallelTower:
    """A ``channel_pad`` :class:`..models.FineNet` in eval, its mid and
    head channels split over ``devices`` (module docstring).  Called with
    ``fine_clips (B, T_f, H, W, 3)`` it returns what the tower returns
    (for the global tower, five f32 ``(B, T_f, 7, 7, C)`` banks) on the
    first device, in f32, so it serves as a
    :class:`..serve.CachingVideoServer`'s ``extract_fn``.  Activations run
    in ``compute_dtype``.  The replicated parts run on the first device,
    which holds the whole module."""

    def __init__(self, model: FineNet, devices: Sequence,
                 compute_dtype: torch.dtype = torch.float32):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self.dtype = compute_dtype
        self.model = model.eval().to(self.devices[0])
        self.blocks = [b for m in model.modules() if isinstance(m, X3DStage)
                       for b in m]
        for blk in self.blocks:
            if blk.t_stride > 1:
                raise ValueError("the tensor-parallel tower has no "
                                 "t_downsample route")
        self._shards = [self._block_shards(b) for b in self.blocks]
        self._head = self._head_shards()

    def _slice(self, width: int) -> List[slice]:
        if width % (SHARD_MULTIPLE * self.n):
            raise ValueError(f"width {width} is not a multiple of "
                             f"{SHARD_MULTIPLE}·{self.n}: build the tower "
                             f"with make_tp_tower")
        w = width // self.n
        return [slice(i * w, (i + 1) * w) for i in range(self.n)]

    def _block_shards(self, blk) -> List[dict]:
        """Each shard's slices of one bottleneck, on its device: conv1 as
        the ``(C_in, m)`` matrix, conv2's taps ``(3, 3, 3, m)`` (in the
        compute dtype), bn1's f32 ``(sc, bi)``, and the SE convs'
        slices."""
        c_mid = blk.conv1.out_channels
        sc1, bi1 = blk.bn1.scale_bias()
        w1 = blk.conv1.weight.reshape(c_mid, -1).t()
        taps = blk.conv2.weight.reshape(c_mid, 27).t().reshape(3, 3, 3, c_mid)
        out = []
        for sl, dev in zip(self._slice(c_mid), self.devices):
            d = {"sl": sl, "w1": w1[:, sl], "taps": taps[..., sl],
                 "sc1": sc1[sl], "bi1": bi1[sl],
                 "w3": blk.conv3.weight[:, sl]}
            if blk.use_se:
                d.update(fc1=blk.fc1.weight[:, sl], fc2=blk.fc2.weight[sl],
                         fc2_b=blk.fc2.bias[sl])
            out.append({k: v if k == "sl" else
                        v.detach().to(dev, torch.float32
                                      if k in ("sc1", "bi1")
                                      else self.dtype).contiguous()
                        for k, v in d.items()})
        return out

    def _head_shards(self) -> List[dict]:
        m = self.model
        c5 = m.conv5.out_channels
        out = []
        for sl, dev in zip(self._slice(c5), self.devices):
            d = {"w5": m.conv5.weight[sl]}
            if hasattr(m, "fc1"):
                d["fc1"] = m.fc1.weight[:, sl]
            out.append({"sl": sl, **{k: v.detach().to(dev, self.dtype)
                                     .contiguous() for k, v in d.items()}})
        return out

    def _block(self, blk, shards, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for p, dev in zip(shards, self.devices):
            a = dw_mm_bnrelu_conv3d(x.to(dev), p["w1"], p["taps"], p["sc1"],
                                    p["bi1"], blk.stride)
            outs.append(_bn_apply(blk.bn2, a, p["sl"]))
        if blk.use_se:  # fc1 row-parallel, fc2 column-parallel
            h = _sum_to([_partial(torch.mean(a, dim=(1, 2, 3), keepdim=True),
                                  p["fc1"])
                         for a, p in zip(outs, shards)], x.device, x.dtype)
            h = torch.relu(h + blk.fc1.bias.to(x.dtype))
            outs = [a * torch.sigmoid(pointwise(h.to(a.device), p["fc2"],
                                                p["fc2_b"]))
                    for a, p in zip(outs, shards)]
        y = _sum_to([_partial(swish(a), p["w3"])
                     for a, p in zip(outs, shards)], x.device, x.dtype)
        y = blk.bn3(y)
        residual = x
        if blk.downsample is not None:
            s = blk.stride
            residual = blk.downsample[1](pointwise(
                x[:, :, ::s, ::s], blk.downsample[0].weight))
        return torch.relu(y + residual)

    def __call__(self, fine_clips: torch.Tensor):
        m = self.model
        with torch.inference_mode():
            x = m.stem(fine_clips.to(self.devices[0], self.dtype))
            feats = {}
            i = 0
            for li in range(4):
                stage = getattr(m, f"layer{li + 1}")
                for blk in stage:
                    x = self._block(blk, self._shards[i], x)
                    i += 1
                if m.global_tower:
                    feats[f"layer{li + 1}"] = adaptive_avg_pool_spatial(
                        x, TOWER_HW)
            heads = [torch.relu(_bn_apply(m.bn5, pointwise(x.to(dev),
                                                           p["w5"]),
                                          p["sl"]))
                     for p, dev in zip(self._head, self.devices)]
            if m.global_tower or m.extract_feat:
                y = torch.cat([h.to(self.devices[0]) for h in heads], -1)
                out = m.head_out(y, feats)
            else:  # the logits head: fc1 row-parallel
                axes = (1, 2, 3) if m.task == "class" else (2, 3)
                h = _sum_to([_partial(torch.mean(h, dim=axes, keepdim=True),
                                      p["fc1"])
                             for h, p in zip(heads, self._head)],
                            self.devices[0], x.dtype)
                h = torch.relu(h).reshape(h.shape[0], h.shape[1], -1)
                out = nn.functional.linear(h, m.fc2.weight.to(h.dtype),
                                           m.fc2.bias.to(h.dtype))
            if isinstance(out, dict):
                return {k: v.float() for k, v in out.items()}
            return out.float()


def make_tp_tower(model: FineNet, devices: Sequence,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> TensorParallelTower:
    """The tensor-parallel tower of ``model`` (a :class:`FineNet`, its
    weights loaded) over ``devices``: a clone with ``channel_pad = 8·N``
    whose ``state_dict`` is ``model``'s padded
    (:func:`pad_tower_state_dict`), split over the devices
    (:class:`TensorParallelTower`).  Its outputs equal ``model``'s in eval
    up to summation order."""
    n = len(devices)
    clone = FineNet(model.version, model.n_classes, task=model.task,
                    dropout_rate=model.dropout_rate,
                    extract_feat=model.extract_feat,
                    global_tower=model.global_tower,
                    channel_pad=SHARD_MULTIPLE * n)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    clone.load_state_dict(pad_tower_state_dict(sd, clone.state_dict()),
                          strict=True)
    return TensorParallelTower(clone, devices, compute_dtype)
