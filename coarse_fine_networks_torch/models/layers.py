"""Shared building blocks of the X3D trunks, channels-last
``(B, T, H, W, C)`` (counterpart of
``coarse_fine_networks_tpu/models/layers.py``).

Parameter and buffer names are the reference's torch names, so a
reference ``state_dict`` loads as it is.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn

from ..ops.dw_mm_bn_train import mm_bn_train
from ..parallel import mesh

BN_MOMENTUM = 0.1  # the running-statistics update rate of SubBatchNorm

# per thread: whether SubBatchNorm's statistics are frozen (frozen_stats)
_FROZEN = threading.local()


@contextlib.contextmanager
def frozen_stats():
    """Inside, on this thread, no :class:`SubBatchNorm` updates its running
    statistics (:meth:`forward`, :meth:`train_scale_bias` and
    :meth:`train_mm_entry` alike): a forward recomputed for the backward
    (``remat``, :func:`.x3d.remat_block`) must not move them a second
    time."""
    before = getattr(_FROZEN, "on", False)
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = before


def stats_frozen() -> bool:
    """Whether :func:`frozen_stats` holds on this thread."""
    return getattr(_FROZEN, "on", False)


def round_width(width: int, multiplier: float = 0.0625, min_width: int = 8,
                divisor: int = 8) -> int:
    """SE squeeze-width rule."""
    if not multiplier:
        return int(width)
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (flax's ``nn.Dropout``): each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask is
    drawn from ``generator``.  ``rate == 0`` is the identity.  Under data
    parallelism the mask is drawn for the global batch (every rank's
    generator in the same state) and the rank keeps its rows, so N ranks
    drop what one process drops."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    n, w = x.shape[0], mesh.world()
    draw = torch.rand((n * w,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device)
    keep = draw[mesh.rank() * n:(mesh.rank() + 1) * n] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def pointwise(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """A 1×1×1 conv (weight ``(O, I, 1, 1, 1)``) or a kernel-1 Conv1d
    (``(O, I, 1)``) on the channel axis of a channels-last tensor, in x's
    dtype."""
    w = weight.reshape(weight.shape[0], weight.shape[1]).to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return nn.functional.linear(x, w, b)


def conv3d(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """Run ``conv`` on a channels-last ``(B, T, H, W, C)`` tensor in x's
    dtype; the result is channels-last and contiguous."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight.to(x.dtype),
                             bias, conv.stride, conv.padding, conv.dilation,
                             conv.groups)
    return y.permute(0, 2, 3, 4, 1).contiguous()


class _RunningStats(nn.Module):
    """Holder of one set of running statistics (the reference's affine-free
    ``BatchNorm3d``), so the buffers carry the reference's names."""

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))


class SubBatchNorm(nn.Module):
    """SlowFast-style split batch norm.

    ``bn`` holds the eval statistics, ``split_bn`` the per-split running
    statistics that training keeps (``num_splits·C`` each);
    :func:`aggregate_sub_bn_stats` merges the latter into the former.  The
    affine ``weight``/``bias`` are shared by all splits.

    In training each of ``num_splits`` sub-batches (sample ``i`` belongs to
    split ``i % num_splits``) is normalised with its own statistics over all
    axes but batch and channel, in f32, with the one-pass variance
    ``E[x²] − E[x]²`` clamped at 0, and the momentum update goes to
    ``split_bn`` only (the JAX package's ``SubBatchNorm``); ``bn`` changes
    only through :func:`aggregate_sub_bn_stats`.

    Under data parallelism (:mod:`..parallel.mesh`) the statistics are the
    global batch's, as XLA reduces them over the JAX package's mesh: each
    rank's per-split Σx, Σx² and count are summed over the ranks (in f32,
    by an all-reduce with a backward, so the statistics' gradient is
    reduced too) before the mean and the clamped variance.  Global row
    ``i`` belongs to split ``i % num_splits``; a rank's local rows keep
    that only when the local batch divides by ``num_splits``, else
    training raises.  The running statistics come out equal on every
    rank."""

    def __init__(self, num_features: int, num_splits: int = 1,
                 eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.num_splits = num_splits
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.bn = _RunningStats(num_features)
        self.split_bn = _RunningStats(num_features * num_splits)

    def scale_bias(self) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 ``(sc, bi)`` with ``bn(x) == x·sc + bi``:
        ``sc = weight·rsqrt(var + eps)``, ``bi = bias − mean·sc``."""
        sc = self.weight.float() * torch.rsqrt(self.bn.running_var + self.eps)
        bi = self.bias.float() - self.bn.running_mean * sc
        return sc, bi

    def _batch_stats(self, xg: torch.Tensor):
        """Per-split f32 ``(mean, var)`` of ``xg (N/S, S, ..., C)`` over all
        axes but the split and the channel, and the running-stat update."""
        axes = (0,) + tuple(range(2, xg.dim() - 1))
        count = xg.numel() // (xg.shape[1] * xg.shape[-1])
        if mesh.world() == 1:
            mean = torch.mean(xg, dim=axes)
            mean2 = torch.mean(torch.square(xg), dim=axes)
        else:  # the global batch's: sums over the ranks' equal shards
            count *= mesh.world()
            tot = mesh.all_reduce_sum(torch.stack([
                torch.sum(xg, dim=axes),
                torch.sum(torch.square(xg), dim=axes)]))
            mean, mean2 = tot[0] / count, tot[1] / count
        # the one-pass form can cancel below 0 in f32 when |mean| >> std;
        # torch.maximum splits the gradient at a tie as JAX's maximum does
        var = torch.maximum(mean2 - torch.square(mean), mean.new_zeros(()))
        self._update_split_stats(mean, var, count)
        return mean, var

    def _update_split_stats(self, mean: torch.Tensor, var: torch.Tensor,
                            count: int) -> None:
        """The momentum update of ``split_bn`` from per-split batch
        statistics over ``count`` elements each, with the unbiased
        variance; none under :func:`frozen_stats`."""
        if stats_frozen():
            return
        with torch.no_grad():
            m = BN_MOMENTUM
            unbiased = var * (count / max(count - 1, 1))
            sp = self.split_bn
            sp.running_mean.copy_((1 - m) * sp.running_mean
                                  + m * mean.reshape(-1))
            sp.running_var.copy_((1 - m) * sp.running_var
                                 + m * unbiased.reshape(-1))

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        n, s = x.shape[0], self.num_splits
        if n % s:
            if mesh.world() > 1:
                raise ValueError(
                    f"local batch {n} of {mesh.world()} ranks not divisible "
                    f"by num_splits {s}: global row i belongs to split i % "
                    f"{s} only when (B/N) % num_splits == 0")
            raise ValueError(f"batch {n} not divisible by num_splits {s}")
        return x.float().reshape((n // s, s) + tuple(x.shape[1:]))

    def train_scale_bias(self, x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Training, ``num_splits == 1``: f32 ``(sc, bi)`` from the batch
        statistics of ``x``, with ``bn(x) == x·sc + bi``, inside autograd;
        updates the split statistics as :meth:`forward` does.  Consumed by
        the fused bottleneck entry instead of a normalised tensor."""
        if self.num_splits != 1:
            raise ValueError("train_scale_bias needs num_splits == 1")
        mean, var = self._batch_stats(self._split(x))
        sc = torch.rsqrt(var[0] + self.eps) * self.weight
        return sc, self.bias - mean[0] * sc

    def train_mm_entry(self, x: torch.Tensor, w1: torch.Tensor,
                       w_dw: torch.Tensor, stride: int) -> torch.Tensor:
        """Training, ``num_splits == 1``: the bottleneck entry
        ``dwconv3³(relu(bn(x @ w1)))`` with this norm's batch statistics of
        ``x @ w1`` and its affine, as one composite with a closed-form
        backward (:func:`..ops.dw_mm_bn_train.mm_bn_train`; the JAX
        package's ``FoldedSubBatchNorm`` in ``dw_fuse`` mode).  Returns the
        conv output and updates the split statistics from the composite's
        mean and variance over the ``B·T·H·W`` positions of every rank's
        equal shard."""
        if self.num_splits != 1:
            raise ValueError("train_mm_entry needs num_splits == 1")
        y, mean, var = mm_bn_train(x, w1, w_dw, self.weight, self.bias,
                                   stride, self.eps)
        self._update_split_stats(mean, var,
                                 x.numel() // x.shape[-1] * mesh.world())
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xg = self._split(x)
            mean, var = self._batch_stats(xg)
            shape = (1, self.num_splits) + (1,) * (x.dim() - 2) + (-1,)
            xn = (xg - mean.reshape(shape)) * torch.rsqrt(
                var.reshape(shape) + self.eps)
            xn = xn.reshape(x.shape)
        else:
            xn = (x.float() - self.bn.running_mean) * torch.rsqrt(
                self.bn.running_var + self.eps)
        return (xn * self.weight + self.bias).to(x.dtype)


def aggregate_sub_bn_stats(module: nn.Module) -> nn.Module:
    """Set every :class:`SubBatchNorm`'s eval statistics from its split
    statistics, in place: the mean over splits, and the mean split variance
    plus the between-split variance.  Serving applies this to a checkpoint
    whose training kept only the split statistics."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, SubBatchNorm):
                c = m.num_features
                sm = m.split_bn.running_mean.reshape(-1, c)
                sv = m.split_bn.running_var.reshape(-1, c)
                n = sm.shape[0]
                mean = torch.sum(sm, dim=0) / n
                var = (torch.sum(sv, dim=0) / n
                       + torch.sum((sm - mean[None, :]) ** 2, dim=0) / n)
                m.bn.running_mean.copy_(mean)
                m.bn.running_var.copy_(var)
    return module


def squeeze_excite(x: torch.Tensor, fc1: nn.Conv3d,
                   fc2: nn.Conv3d) -> torch.Tensor:
    """SE gate over ``(B, T, H, W, C)``: global mean → fc1 → relu → fc2 →
    sigmoid → scale."""
    s = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    s = torch.relu(pointwise(s, fc1.weight, fc1.bias))
    s = pointwise(s, fc2.weight, fc2.bias)
    return x * torch.sigmoid(s)


class SqueezeExcite(nn.Module):
    """SE block: ``fc1`` squeezes ``planes`` to ``round_width(planes)``,
    ``fc2`` expands back.  In the bottleneck the two convs sit on the block
    itself (the reference's names ``layerN.M.fc1``); this module is the
    stand-alone form."""

    def __init__(self, planes: int, width: int | None = None):
        super().__init__()
        width = round_width(planes) if width is None else width
        self.fc1 = nn.Conv3d(planes, width, 1, bias=True)
        self.fc2 = nn.Conv3d(width, planes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.fc1, self.fc2)


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight from ``generator``: Kaiming-normal (fan-out, ReLU
    gain, the reference's init) for 3-D convs, LeCun-normal for linear and
    kernel-1 Conv1d layers (flax's ``Dense`` default in the JAX package);
    biases zero; batch-norm affine and statistics at identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear, nn.Conv3d)):
                w = m.weight
                if isinstance(m, nn.Conv3d):
                    std = math.sqrt(2.0 / (w.shape[0] * math.prod(w.shape[2:])))
                else:
                    std = math.sqrt(1.0 / w.shape[1])
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=generator.device) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, SubBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                for stats in (m.bn, m.split_bn):
                    stats.running_mean.zero_()
                    stats.running_var.fill_(1.0)
    return module
