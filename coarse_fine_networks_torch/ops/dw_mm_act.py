"""Fused X3D bottleneck entry: ``dwconv3³(relu((x @ W1)·sc + bi))``.

Every eval-mode :class:`..models.x3d.Bottleneck` enters through
:func:`dw_mm_bnrelu_conv3d`: conv1 (a 1×1×1 conv, i.e. a product over
channels), the bn1 apply, the ReLU and the depthwise 3×3×3 conv2 in one
kernel, so the expanded ``C_mid`` tensor never reaches device memory.  It is
the counterpart of the JAX package's ``fold_dw_mm_bnrelu_conv3d``
(``coarse_fine_networks_tpu/ops/pallas/dw_fold.py``), whose ``mm`` modes ran
the same function as two Pallas kernels on the TPU.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/dw_mm_act.cu`` (built with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` and bound with ``ctypes``, :mod:`._build`); on a CPU tensor it
runs :func:`dw_mm_bnrelu_conv3d_plain`, which defines the semantics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import NVCC_FLAGS, CudaLibrary, I, P  # noqa: F401 (re-export)

# The source also holds the act-mode entries of :mod:`.dw_act` and the
# plain-mode entries of :mod:`.dw_conv`.
LIBRARY = CudaLibrary("dw_mm_act.cu", {
    "dw_mm_act_s1": [P] * 6 + [I] * 7 + [P],
    "dw_mm_act_s2": [P] * 6 + [I] * 7 + [P],
    "dw_act_s1": [P] * 5 + [I] * 6 + [P],
    "dw_act_s2": [P] * 5 + [I] * 6 + [P],
    "dw_conv_s1": [P] * 3 + [I] * 6 + [P],
    "dw_conv_s2": [P] * 3 + [I] * 6 + [P],
})
SOURCE = LIBRARY.source

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by the plain version).
LAUNCHES = {"dw_mm_act_s1": 0, "dw_mm_act_s2": 0}
_KERNEL = {1: "dw_mm_act_s1", 2: "dw_mm_act_s2"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _check(x, w1, w_dw, sc, bi, stride):
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2 (i.e. (1,2,2)), got {stride}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C_in), got {tuple(x.shape)}")
    c_in = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != c_in:
        raise ValueError(f"w1 must be ({c_in}, C_mid), got {tuple(w1.shape)}")
    c_mid = w1.shape[1]
    if tuple(w_dw.shape) != (3, 3, 3, c_mid):
        raise ValueError(
            f"w_dw must be (3, 3, 3, {c_mid}), got {tuple(w_dw.shape)}")
    for name, v in (("sc", sc), ("bi", bi)):
        if tuple(v.shape) != (c_mid,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({c_mid},), got "
                             f"{v.dtype} {tuple(v.shape)}")
    for name, v in (("w1", w1), ("w_dw", w_dw)):
        if v.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{v.dtype}")
    for name, v in (("x", x), ("w1", w1), ("w_dw", w_dw), ("sc", sc),
                    ("bi", bi)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dw_mm_bnrelu_conv3d_plain(x: torch.Tensor, w1: torch.Tensor,
                              w_dw: torch.Tensor, sc: torch.Tensor,
                              bi: torch.Tensor, stride: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch.

    ``a = relu((x @ w1)·sc + bi)`` from the f32 product, rounded to x's dtype,
    zero-padded by one on T, H and W (the padding is zero after the
    activation); then the 27-tap depthwise sum in f32 at stride
    ``(1, stride, stride)``, written in x's dtype.  Output
    ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C_mid)``."""
    z = torch.matmul(x.float(), w1.float())
    a = torch.relu(z * sc + bi).to(x.dtype)
    return stencil_f32(a, w_dw, stride).to(x.dtype)


def stencil_f32(a: torch.Tensor, w_dw: torch.Tensor,
                stride: int) -> torch.Tensor:
    """The 27-tap depthwise correlation of ``a (B, T, H, W, C)`` with taps
    ``w_dw (3, 3, 3, C)`` at stride ``(1, stride, stride)``, zero-padded by
    one on T, H and W, summed in f32: ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C)`` f32."""
    b, t, h, w, c = a.shape
    ho, wo = _out_hw(h, w, stride)
    a = F.pad(a.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w_dw.float()
    y = torch.zeros((b, t, ho, wo, c), dtype=torch.float32, device=a.device)
    for dt in range(3):
        for dy in range(3):
            for dx in range(3):
                y += (a[:, dt:dt + t,
                        dy:dy + stride * (ho - 1) + 1:stride,
                        dx:dx + stride * (wo - 1) + 1:stride]
                      * wf[dt, dy, dx])
    return y


def wgrad_f32(a: torch.Tensor, g: torch.Tensor, stride: int) -> torch.Tensor:
    """The weight gradient of :func:`stencil_f32`: ``dk[tap, c] =
    Σ_pos a_pad[s·pos + tap]·g[pos]`` over ``a (B, T, H, W, C)`` zero-padded
    by one on T, H and W and ``g`` of the output's shape, in f32:
    ``(27, C)``."""
    t = a.shape[1]
    ho, wo = g.shape[2], g.shape[3]
    a = F.pad(a.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.float()
    dk = []
    for dt in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = a[:, dt:dt + t, dy:dy + stride * (ho - 1) + 1:stride,
                        dx:dx + stride * (wo - 1) + 1:stride]
                dk.append(torch.sum(tap * gf, dim=(0, 1, 2, 3)))
    return torch.stack(dk)


def dw_mm_bnrelu_conv3d(x: torch.Tensor, w1: torch.Tensor,
                        w_dw: torch.Tensor, sc: torch.Tensor,
                        bi: torch.Tensor, stride: int) -> torch.Tensor:
    """Fused ``dwconv3³(relu((x @ w1)·sc + bi))`` at stride ``(1,s,s)``.

    Args:
      x: ``(B, T, H, W, C_in)`` float32 or bfloat16, contiguous.
      w1: ``(C_in, C_mid)`` conv1 weight in x's dtype.
      w_dw: ``(3, 3, 3, C_mid)`` depthwise conv2 taps in x's dtype.
      sc, bi: ``(C_mid,)`` float32 bn1 apply vectors.
      stride: 1, or 2 for stride (1, 2, 2).

    A CPU tensor takes :func:`dw_mm_bnrelu_conv3d_plain`; a CUDA tensor
    launches the kernel (``dw_mm_act_s1`` or ``dw_mm_act_s2``) or raises."""
    _check(x, w1, w_dw, sc, bi, stride)
    if x.device.type == "cpu":
        return dw_mm_bnrelu_conv3d_plain(x, w1, w_dw, sc, bi, stride)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, t, h, w, c_in = x.shape
    c_mid = w1.shape[1]
    if c_in % 8:
        raise ValueError(f"the kernel needs C_in % 8 == 0, got {c_in}")
    if x.data_ptr() % 16:
        raise ValueError("the kernel needs x 16-byte aligned")
    ho, wo = _out_hw(h, w, stride)
    y = torch.empty((b, t, ho, wo, c_mid), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    name = _KERNEL[stride]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        LIBRARY.call(name, x.data_ptr(), w1.data_ptr(), w_dw.data_ptr(),
                     sc.data_ptr(), bi.data_ptr(), y.data_ptr(), b, t, h, w,
                     c_in, c_mid, int(x.dtype == torch.bfloat16), stream)
    LAUNCHES[name] += 1
    return y
