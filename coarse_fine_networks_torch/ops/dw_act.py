"""Train-mode X3D bottleneck entry: ``dwconv3³(relu(x·sc + bi))`` and its
backward.

In training every :class:`..models.x3d.Bottleneck` runs conv1 as a product,
takes bn1's ``(sc, bi)`` from the batch statistics inside autograd, and
enters the depthwise conv2 through :class:`DwBnReluConv3d`: the bn1 apply,
the ReLU and the stencil in one forward kernel, and in the backward one dx
kernel (the relu mask, ``dx = dam·sc`` and the ``(dsc, dbi)`` sums fused in)
and one weight-gradient kernel.  Neither the activation nor its gradient
reaches device memory.  It is the counterpart of the JAX package's
``dw_fold4_act`` (``coarse_fine_networks_tpu/ops/pallas/dw_fold.py``), whose
forward is the ``act`` mode of the Pallas kernels K1/K4 and whose backward
is K3/K5 and the ``act`` mode of K6/K10.

Kernels (CUDA C++ for ``sm_90a``, :mod:`._build`):

* ``dw_act_s1``/``dw_act_s2``: :func:`dw_bnrelu_conv3d`, in
  ``csrc/dw_plain_s1.cu`` (K1 act: the act mode of K1 plain, each staged x
  pair activated in place a frame ahead, with :func:`..dw_conv.plan_s1`)
  and ``csrc/dw_plain_s2.cu`` (K4 act: the act mode of K4 plain likewise,
  with :func:`..dw_conv.plan_act_s2_fwd`);
* ``dw_act_dx_s1``/``dw_act_dx_s2``: :func:`dw_act_dx`, in
  ``csrc/dw_dx_s1.cu`` (K3: ``dw_plain_s1.cu``'s row strips on g with the
  flipped taps, x staged beside g) and ``csrc/dw_plain_s2.cu`` (K5: the act
  mode of K8's gather, x of each thread's quads staged beside g, with the
  work split of :func:`..dw_conv.plan_act_dx_s2`);
* ``dw_act_wgrad_s1``/``dw_act_wgrad_s2``: :func:`dw_act_wgrad`, in
  ``csrc/dw_plain_s1.cu`` (K6 act: the act mode of K6 plain, with
  :func:`..dw_conv.plan_s1`) and ``csrc/dw_plain_s2.cu`` (K10 act: the act
  mode of K10 plain, with :func:`..dw_conv.plan_s2`), x activated in place
  where it is staged, as in K1 act.

Each wrapper runs its ``*_plain`` version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises.  All tensors are channels-last
``(B, T, H, W, C)``; stride 2 means ``(1, 2, 2)``.
"""

from __future__ import annotations

import torch

from ..utils.hw import Work, kernel_work
from .dw_mm_act import DX_S1_LIBRARY, _launch, _out_hw
from .dw_mm_act import LIBRARIES, stencil_f32, wgrad_f32  # noqa: F401

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by a plain version).
LAUNCHES = {f"dw_act{part}_s{s}": 0 for part in ("", "_dx", "_wgrad")
            for s in (1, 2)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x, w_dw, sc, bi, stride, g=None):
    """Raise on what the kernels do not take: x ``(B, T, H, W, C)`` f32 or
    bf16, taps ``(3, 3, 3, C)`` and ``g`` (y's shape) in x's dtype, f32
    ``(C,)`` ``sc``/``bi``, all contiguous on x's device, a CPU or CUDA
    device.  ``w_dw``, ``sc``/``bi`` and ``g`` are checked where given."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2 (i.e. (1,2,2)), got {stride}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got {tuple(x.shape)}")
    b, t, h, w, c = x.shape
    tensors = [("x", x)]
    if w_dw is not None:
        if tuple(w_dw.shape) != (3, 3, 3, c):
            raise ValueError(
                f"w_dw must be (3, 3, 3, {c}), got {tuple(w_dw.shape)}")
        if w_dw.dtype != x.dtype:
            raise TypeError(f"w_dw must have x's dtype {x.dtype}, got "
                            f"{w_dw.dtype}")
        tensors.append(("w_dw", w_dw))
    if sc is not None:
        for name, v in (("sc", sc), ("bi", bi)):
            if tuple(v.shape) != (c,) or v.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 ({c},), got "
                                 f"{v.dtype} {tuple(v.shape)}")
            tensors.append((name, v))
    if g is not None:
        want = (b, t) + _out_hw(h, w, stride) + (c,)
        if tuple(g.shape) != want or g.dtype != x.dtype:
            raise ValueError(f"g must be {x.dtype} {want}, got {g.dtype} "
                             f"{tuple(g.shape)}")
        tensors.append(("g", g))
    for name, v in tensors:
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")


def _activate(x, sc, bi):
    """``relu(x·sc + bi)`` in f32, rounded to x's dtype (the forward's
    activation)."""
    return torch.relu(x.float() * sc + bi).to(x.dtype)


# ---- the work of each kernel's function (its roofline bound; the count of
# ``utils.hw.program_costs``): x, g and y read or written once, the taps and
# the f32 (sc, bi) read once; 27 taps an output element; the apply and the
# relu (and in the dx the mask, the scale and the two sums) an x element

def fwd_work(y, x, w_dw, sc, bi, stride) -> Work:
    """:func:`dw_bnrelu_conv3d`'s work, ``y`` its output."""
    return Work((x.numel() + y.numel() + w_dw.numel()) * x.element_size()
                + 2 * sc.numel() * 4, 2 * 27 * y.numel(), 3 * x.numel())


def dx_work(out, g, x, w_dw, sc, bi, stride) -> Work:
    """:func:`dw_act_dx`'s work, ``out`` its output: dx, and the f32
    ``(2, C)`` sums written beside (sc, bi) read."""
    return Work((2 * x.numel() + g.numel() + w_dw.numel()) * x.element_size()
                + 2 * 2 * sc.numel() * 4, 2 * 27 * g.numel(), 6 * x.numel())


def wgrad_work(dk, x, g, sc, bi, stride) -> Work:
    """:func:`dw_act_wgrad`'s work, ``dk`` its output."""
    return Work((x.numel() + g.numel()) * x.element_size()
                + 2 * sc.numel() * 4 + 27 * x.shape[-1] * 4,
                2 * 27 * g.numel(), 3 * x.numel())


# ---- forward: the act mode of K1 (stride 1) and K4 (stride 2) ---------------

def dw_bnrelu_conv3d_plain(x: torch.Tensor, w_dw: torch.Tensor,
                           sc: torch.Tensor, bi: torch.Tensor,
                           stride: int) -> torch.Tensor:
    """``a = relu(x·sc + bi)`` in f32, rounded to x's dtype, zero-padded
    by one on T, H and W (zero after the activation); the 27-tap depthwise
    sum in f32 at stride ``(1, s, s)``, written in x's dtype."""
    return stencil_f32(_activate(x, sc, bi), w_dw, stride).to(x.dtype)


@kernel_work(fwd_work)
def dw_bnrelu_conv3d(x: torch.Tensor, w_dw: torch.Tensor, sc: torch.Tensor,
                     bi: torch.Tensor, stride: int) -> torch.Tensor:
    """Fused ``dwconv3³(relu(x·sc + bi))`` at stride ``(1, s, s)``.

    Args:
      x: ``(B, T, H, W, C)`` float32 or bfloat16, contiguous: conv1's output.
      w_dw: ``(3, 3, 3, C)`` depthwise taps in x's dtype.
      sc, bi: ``(C,)`` float32 bn1 apply vectors.
      stride: 1, or 2 for stride (1, 2, 2).

    Returns ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C)`` in x's dtype.  A CPU tensor takes
    :func:`dw_bnrelu_conv3d_plain`; a CUDA tensor launches ``dw_act_s1``
    (with the work split of :func:`..dw_conv.plan_s1`, K1 plain's) or
    ``dw_act_s2`` (with :func:`..dw_conv.plan_act_s2_fwd`), or raises."""
    _check(x, w_dw, sc, bi, stride)
    if x.device.type == "cpu":
        return dw_bnrelu_conv3d_plain(x, w_dw, sc, bi, stride)
    b, t, h, w, c = x.shape
    y = torch.empty((b, t) + _out_hw(h, w, stride) + (c,), dtype=x.dtype,
                    device=x.device)
    if not y.numel():
        return y
    # .dw_conv builds on this module's libraries: imported here
    from . import dw_conv

    lib, plan = ((dw_conv.LIBRARY, dw_conv.plan_s1) if stride == 1 else
                 (dw_conv.LIBRARY_S2, dw_conv.plan_act_s2_fwd))
    p = plan(b, t, h, w, c)
    _launch(LAUNCHES, lib, f"dw_act_s{stride}", x, x.data_ptr(),
            w_dw.data_ptr(), sc.data_ptr(), bi.data_ptr(), y.data_ptr(), b, t,
            h, w, c, p.r, p.wb, p.pg, p.tt)
    return y


# ---- dx: K3 (stride 1) and K5 (stride 2) -------------------------------------

def dw_act_dx_plain(g: torch.Tensor, x: torch.Tensor, w_dw: torch.Tensor,
                    sc: torch.Tensor, bi: torch.Tensor, stride: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``da = ∂y/∂a·g`` (the correlation of g with the flipped taps; at
    stride 2 of g placed at the even positions of a zero full-resolution
    tensor), ``dam = da ⊙ 1[x·sc + bi > 0]`` with the mask compared in f32.
    Returns ``dx = dam·sc`` in x's dtype and the f32 ``(2, C)`` sums
    ``(Σ dam·x, Σ dam)``."""
    gf = g.float()
    if stride == 2:
        up = torch.zeros(x.shape, dtype=torch.float32, device=g.device)
        up[:, :, ::2, ::2] = gf
        gf = up
    da = stencil_f32(gf, torch.flip(w_dw, (0, 1, 2)), 1)
    xf = x.float()
    dam = torch.where(xf * sc + bi > 0, da, torch.zeros_like(da))
    red = torch.stack([torch.sum(dam * xf, dim=(0, 1, 2, 3)),
                       torch.sum(dam, dim=(0, 1, 2, 3))])
    return (dam * sc).to(x.dtype), red


@kernel_work(dx_work)
def dw_act_dx(g: torch.Tensor, x: torch.Tensor, w_dw: torch.Tensor,
              sc: torch.Tensor, bi: torch.Tensor, stride: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """dx of :func:`dw_bnrelu_conv3d` with the relu mask, the bn1 scale and
    the ``(dsc, dbi)`` sums fused in (see :func:`dw_act_dx_plain`).

    ``g`` is dL/dy (y's shape, x's dtype).  A CPU tensor takes the plain
    version; a CUDA tensor launches ``dw_act_dx_s1`` or ``dw_act_dx_s2``
    (with the work split of :func:`..dw_conv.plan_act_dx_s1` or
    :func:`..dw_conv.plan_act_dx_s2`; per-block partial sums, added with
    one ``torch.sum``), or raises."""
    _check(x, w_dw, sc, bi, stride, g)
    if x.device.type == "cpu":
        return dw_act_dx_plain(g, x, w_dw, sc, bi, stride)
    dx = torch.empty_like(x)
    if not x.numel():
        return dx, torch.zeros((2, x.shape[-1]), device=x.device)
    # .dw_conv builds on this module's libraries: imported here
    from . import dw_conv

    lib, plan = ((DX_S1_LIBRARY, dw_conv.plan_act_dx_s1) if stride == 1 else
                 (dw_conv.LIBRARY_S2, dw_conv.plan_act_dx_s2))
    p = plan(*x.shape)
    part = torch.empty((p.rows, 2, x.shape[-1]), dtype=torch.float32,
                       device=x.device)
    _launch(LAUNCHES, lib, f"dw_act_dx_s{stride}", x, g.data_ptr(),
            x.data_ptr(), w_dw.data_ptr(), sc.data_ptr(), bi.data_ptr(),
            dx.data_ptr(), part.data_ptr(), *x.shape, p.r, p.wb, p.pg, p.tt,
            p.rows)
    return dx, torch.sum(part, dim=0)


# ---- wgrad: the act mode of K6 (stride 1) and K10 (stride 2) -----------------

def dw_act_wgrad_plain(x: torch.Tensor, g: torch.Tensor, sc: torch.Tensor,
                       bi: torch.Tensor, stride: int) -> torch.Tensor:
    """``dk[tap, c] = Σ_pos a_pad[s·pos + tap]·g[pos]`` with the forward's
    rounded, zero-padded activation, in f32: ``(27, C)``."""
    return wgrad_f32(_activate(x, sc, bi), g, stride)


@kernel_work(wgrad_work)
def dw_act_wgrad(x: torch.Tensor, g: torch.Tensor, sc: torch.Tensor,
                 bi: torch.Tensor, stride: int) -> torch.Tensor:
    """Weight gradient of :func:`dw_bnrelu_conv3d` (see
    :func:`dw_act_wgrad_plain`), ``(27, C)`` f32.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``dw_act_wgrad_s1`` or
    ``dw_act_wgrad_s2`` (with the work split of :func:`..dw_conv.plan_s1`
    or :func:`..dw_conv.plan_s2`, K6 or K10 plain's; per-block partial
    sums, added with one ``torch.sum``), or raises."""
    _check(x, None, sc, bi, stride, g)
    if x.device.type == "cpu":
        return dw_act_wgrad_plain(x, g, sc, bi, stride)
    if not g.numel():
        return torch.zeros((27, x.shape[-1]), device=x.device)
    # .dw_conv builds on this module's libraries: imported here
    from . import dw_conv

    lib, plan = ((dw_conv.LIBRARY, dw_conv.plan_s1) if stride == 1 else
                 (dw_conv.LIBRARY_S2, dw_conv.plan_s2))
    p = plan(*x.shape)
    part = torch.empty((p.rows, 27, x.shape[-1]), dtype=torch.float32,
                       device=x.device)
    _launch(LAUNCHES, lib, f"dw_act_wgrad_s{stride}", x, x.data_ptr(),
            g.data_ptr(), sc.data_ptr(), bi.data_ptr(), part.data_ptr(),
            *x.shape, p.r, p.wb, p.pg, p.tt, p.ipb, p.rows)
    return torch.sum(part, dim=0)


# ---- autograd -----------------------------------------------------------------

class DwBnReluConv3d(torch.autograd.Function):
    """``dwconv3³(relu(x·sc + bi))`` with the kernels' backward:
    ``(dx, dw, dsc, dbi)`` from :func:`dw_act_dx` and :func:`dw_act_wgrad`
    (the JAX package's ``_dw_act_bwd``).  ``sc``/``bi`` come from bn1's
    batch statistics inside autograd, so the gradient through the mean and
    variance, and into bn1's weight and bias, is PyTorch's."""

    @staticmethod
    def forward(ctx, x, w_dw, sc, bi, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w_dw, sc, bi)
        return dw_bnrelu_conv3d(x, w_dw, sc, bi, stride)

    @staticmethod
    def backward(ctx, g):
        x, w_dw, sc, bi = ctx.saved_tensors
        g = g.contiguous()
        dx, red = dw_act_dx(g, x, w_dw, sc, bi, ctx.stride)
        dk = dw_act_wgrad(x, g, sc, bi, ctx.stride)
        dk = dk.reshape(3, 3, 3, -1).to(w_dw.dtype)
        return dx, dk, red[0], red[1], None


# ``dw_bnrelu_conv3d_train(x, w_dw, sc, bi, stride)``: :func:`dw_bnrelu_conv3d`
# inside autograd
dw_bnrelu_conv3d_train = DwBnReluConv3d.apply
