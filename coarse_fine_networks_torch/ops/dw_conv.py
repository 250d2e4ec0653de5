"""Plain depthwise 3³ conv of the split-batch-norm training route, with its
backward: ``y = dwconv3³_(1,s,s)(a)``.

In training with split batch norm (``bn1.num_splits > 1``) every
:class:`..models.x3d.Bottleneck` normalises conv1's output per split and
applies the ReLU in PyTorch, then enters the depthwise conv2 through
:class:`DwConv3d`: one forward kernel, and in the backward one dx kernel and
one weight-gradient kernel.  It is the counterpart of the JAX package's
``dw_fold4`` and ``dw_fold4_stride2``
(``coarse_fine_networks_tpu/ops/pallas/dw_fold.py``), whose forward is the
plain mode of the Pallas kernels K1/K4 and whose backward is K1 again on the
flipped taps (stride-1 dx), K8 (stride-2 dx) and the plain mode of K6/K10.

Kernels (CUDA C++ for ``sm_90a``, :mod:`._build`):

* ``dw_conv_s1``/``dw_conv_s2``: :func:`dw_conv3d`, in ``csrc/dw_mm_act.cu``
  (the plain mode of the bottleneck-entry kernel); ``dw_conv_s1`` on ``g``
  with the flipped taps is also the stride-1 dx;
* ``dw_conv_dx_s2``: :func:`dw_conv_dx_s2`, in ``csrc/dw_act_bwd.cu`` (the
  act-mode stride-2 dx without the mask, the scale and the sums);
* ``dw_conv_wgrad_s1``/``dw_conv_wgrad_s2``: :func:`dw_conv_wgrad`, in
  ``csrc/dw_act_bwd.cu``.

Each wrapper runs its ``*_plain`` version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises.  All tensors are channels-last
``(B, T, H, W, C)``; stride 2 means ``(1, 2, 2)``.
"""

from __future__ import annotations

import torch

from .dw_act import _check
from .dw_mm_act import BWD_LIBRARY, LIBRARIES, _launch, _out_hw, _partials
from .dw_mm_act import LIBRARY as FWD_LIBRARY
from .dw_mm_act import stencil_f32, wgrad_f32

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by a plain version).
LAUNCHES = {"dw_conv_s1": 0, "dw_conv_s2": 0, "dw_conv_dx_s2": 0,
            "dw_conv_wgrad_s1": 0, "dw_conv_wgrad_s2": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- forward: the plain mode of K1 (stride 1) and K4 (stride 2) -------------

def dw_conv3d_plain(x: torch.Tensor, w_dw: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """The 27-tap depthwise sum of x, zero-padded by one on T, H and W, in
    f32 at stride ``(1, s, s)``, written in x's dtype."""
    return stencil_f32(x, w_dw, stride).to(x.dtype)


def dw_conv3d(x: torch.Tensor, w_dw: torch.Tensor,
              stride: int) -> torch.Tensor:
    """Depthwise 3³ conv at stride ``(1, s, s)`` with SAME zero padding.

    Args:
      x: ``(B, T, H, W, C)`` float32 or bfloat16, contiguous.
      w_dw: ``(3, 3, 3, C)`` depthwise taps in x's dtype.
      stride: 1, or 2 for stride (1, 2, 2).

    Returns ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C)`` in x's dtype.  A CPU tensor takes
    :func:`dw_conv3d_plain`; a CUDA tensor launches ``dw_conv_s1`` or
    ``dw_conv_s2``, or raises."""
    _check(x, w_dw, None, None, stride)
    if x.device.type == "cpu":
        return dw_conv3d_plain(x, w_dw, stride)
    b, t, h, w, c = x.shape
    y = torch.empty((b, t) + _out_hw(h, w, stride) + (c,), dtype=x.dtype,
                    device=x.device)
    if y.numel():
        _launch(LAUNCHES, FWD_LIBRARY, f"dw_conv_s{stride}", x,
                x.data_ptr(), w_dw.data_ptr(), y.data_ptr(), b, t, h, w, c)
    return y


# ---- dx at stride 2: K8 ----------------------------------------------------------

def dw_conv_dx_s2_plain(g: torch.Tensor, w_dw: torch.Tensor,
                        hw: tuple[int, int]) -> torch.Tensor:
    """``dx[t, r, q] = Σ w[dt, dy, dx]·g[t−dt+1, (r−dy+1)/2, (q−dx+1)/2]``
    over the terms whose divisions are integral: the correlation of g placed
    at the even positions of a zero ``(B, T, H, W, C)`` tensor with the
    flipped taps, in f32, written in g's dtype."""
    b, t, _, _, c = g.shape
    up = torch.zeros((b, t) + tuple(hw) + (c,), dtype=torch.float32,
                     device=g.device)
    up[:, :, ::2, ::2] = g.float()
    return stencil_f32(up, torch.flip(w_dw, (0, 1, 2)), 1).to(g.dtype)


def dw_conv_dx_s2(g: torch.Tensor, w_dw: torch.Tensor,
                  hw: tuple[int, int]) -> torch.Tensor:
    """dx of :func:`dw_conv3d` at stride 2: ``g (B, T, ⌈H/2⌉, ⌈W/2⌉, C)``
    → ``(B, T, H, W, C)`` with ``hw = (H, W)`` (see
    :func:`dw_conv_dx_s2_plain`).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``dw_conv_dx_s2``, or raises."""
    _check(g, w_dw, None, None, 1)
    b, t, ho, wo, c = g.shape
    if (ho, wo) != _out_hw(hw[0], hw[1], 2):
        raise ValueError(f"g's H, W {(ho, wo)} are not those of stride 2 "
                         f"from {tuple(hw)}")
    shape = (b, t) + tuple(hw) + (c,)
    if g.device.type == "cpu":
        return dw_conv_dx_s2_plain(g, w_dw, hw)
    dx = torch.empty(shape, dtype=g.dtype, device=g.device)
    if dx.numel():
        _launch(LAUNCHES, BWD_LIBRARY, "dw_conv_dx_s2", g, g.data_ptr(),
                w_dw.data_ptr(), dx.data_ptr(), *shape)
    return dx


# ---- wgrad: the plain mode of K6 (stride 1) and K10 (stride 2) -------------------

def dw_conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """``dk[tap, c] = Σ_pos x_pad[s·pos + tap]·g[pos]`` in f32:
    ``(27, C)``."""
    return wgrad_f32(x, g, stride)


def dw_conv_wgrad(x: torch.Tensor, g: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """Weight gradient of :func:`dw_conv3d` (see :func:`dw_conv_wgrad_plain`),
    ``(27, C)`` f32.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``dw_conv_wgrad_s1`` or ``dw_conv_wgrad_s2`` (per-block partial
    sums, added with one ``torch.sum``), or raises."""
    _check(x, None, None, None, stride, g)
    if x.device.type == "cpu":
        return dw_conv_wgrad_plain(x, g, stride)
    if not g.numel():
        return torch.zeros((27, x.shape[-1]), device=x.device)
    name = f"dw_conv_wgrad_s{stride}"
    part = _partials(name, x, 27)
    _launch(LAUNCHES, BWD_LIBRARY, name, x, x.data_ptr(), g.data_ptr(),
            part.data_ptr(), *x.shape)
    return torch.sum(part, dim=0)


# ---- autograd ---------------------------------------------------------------------

class DwConv3d(torch.autograd.Function):
    """:func:`dw_conv3d` with the kernels' backward (the JAX package's
    ``_dw_fold4_bwd`` and ``_dw_s2_bwd``): at stride 1 dx is
    :func:`dw_conv3d` of g with the flipped taps, at stride 2
    :func:`dw_conv_dx_s2`; the taps' gradient is :func:`dw_conv_wgrad`,
    returned in the taps' dtype."""

    @staticmethod
    def forward(ctx, x, w_dw, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w_dw)
        return dw_conv3d(x, w_dw, stride)

    @staticmethod
    def backward(ctx, g):
        x, w_dw = ctx.saved_tensors
        g = g.contiguous()
        if ctx.stride == 1:
            dx = dw_conv3d(g, torch.flip(w_dw, (0, 1, 2)).contiguous(), 1)
        else:
            dx = dw_conv_dx_s2(g, w_dw, x.shape[2:4])
        dk = dw_conv_wgrad(x, g, ctx.stride)
        return dx, dk.reshape(3, 3, 3, -1).to(w_dw.dtype), None


# ``dw_conv3d_train(x, w_dw, stride)``: :func:`dw_conv3d` inside autograd
dw_conv3d_train = DwConv3d.apply
