"""Fused X3D bottleneck entry: ``dwconv3³(relu((x @ W1)·sc + bi))``, and
its backward.

Every eval-mode :class:`..models.x3d.Bottleneck` enters through
:class:`DwMmBnReluConv3d`: conv1 (a 1×1×1 conv, i.e. a product over
channels), the bn1 apply, the ReLU and the depthwise 3×3×3 conv2 in one
kernel (:func:`dw_mm_bnrelu_conv3d`), so the expanded ``C_mid`` tensor never
reaches device memory.  It is the counterpart of the JAX package's
``dw_fold4_mm_act`` (``coarse_fine_networks_tpu/ops/pallas/dw_fold.py``),
whose forward is the ``mm`` mode of the Pallas kernels K1/K4 and whose
backward (``_dw_mm_bwd``) is K1 plain on the flipped taps or K8, and the
``mm`` modes of K6/K10.

Kernels (CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use into
``_build/`` and bound with ``ctypes``, :mod:`._build`):

* ``dw_mm_act_s1``/``dw_mm_act_s2``: :func:`dw_mm_bnrelu_conv3d`; at
  stride 1 ``mm_fwd_s1_kernel`` in ``csrc/dw_mm_act.cu`` (K1 ``mm``: row
  strips with the work split of :func:`..dw_conv.plan_mm_s1`, conv1's
  product on the bf16 tensor cores), at stride 2 ``mm_s2_fwd_kernel`` in
  ``csrc/dw_plain_s2.cu`` (K4 ``mm``: the same product on K4 plain's row
  strips and stencil, with the work split of
  :func:`..dw_conv.plan_mm_s2_fwd`);
* ``dw_mm_wgrad_s1``/``dw_mm_wgrad_s2``: :func:`dw_mm_wgrad`, in
  ``csrc/dw_plain_s1.cu`` (K6 mm: K1 ``mm``'s product on K6 plain's
  persistent walk, with the work split of
  :func:`..dw_conv.plan_mm_wgrad_s1`) and ``csrc/dw_plain_s2.cu`` (K10
  mm: K4 ``mm``'s product on K10 plain's persistent walk, with the work
  split of :func:`..dw_conv.plan_mm_wgrad_s2`).

Each wrapper runs its ``*_plain`` version on a CPU tensor, which defines the
semantics, and launches its kernel on a CUDA tensor, or raises.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..utils.hw import Work, kernel_work
from ._build import NVCC_FLAGS, CudaLibrary, I, P  # noqa: F401 (re-export)

# The stride-1 forward's source (K1 mm; K4 mm, the stride-2 forward, is in
# :mod:`.dw_conv`'s ``LIBRARY_S2``, with the act entry's forwards).
LIBRARY = CudaLibrary("dw_mm_act.cu", {
    "dw_mm_act_s1": [P] * 6 + [I] * 11 + [P],
    "dw_mm_act_s1_occupancy": [I] * 6,
})
SOURCE = LIBRARY.source
# The stride-1 dx of both train entries (K3 of :mod:`.dw_act`, K2 of
# :mod:`.dw_mm_bn_train`), on the row-strip layout with the work splits of
# :func:`..dw_conv.plan_act_dx_s1` and :func:`..dw_conv.plan_mm_dx_s1`.
DX_S1_LIBRARY = CudaLibrary("dw_dx_s1.cu", {
    "dw_act_dx_s1": [P] * 7 + [I] * 11 + [P],
    "dw_mm_dx_mask_s1": [P] * 7 + [I] * 11 + [P],
    "dw_dx_s1_occupancy": [I] * 8,
})
# (this module's weight gradients, K6 and K10 mm, are in :mod:`.dw_conv`'s
# ``LIBRARY`` and ``LIBRARY_S2``, with their plain twins)
LIBRARIES = (LIBRARY, DX_S1_LIBRARY)

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by the plain version), under
# ``_COUNT_LOCK``: serving launches from one scheduler thread per model
# variant, so two threads can count at once.
_COUNT_LOCK = threading.Lock()
LAUNCHES = {"dw_mm_act_s1": 0, "dw_mm_act_s2": 0, "dw_mm_wgrad_s1": 0,
            "dw_mm_wgrad_s2": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(counts, lib, name, x, *args, key=None):
    """Launch ``name`` on x's device and current stream, in x's dtype, and
    count it in ``counts`` (the calling module's ``LAUNCHES``) under ``key``
    (default: ``name``)."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib.call(name, *args, int(x.dtype == torch.bfloat16), stream)
    _count(counts, key or name)


def _count(counts, key) -> None:
    """One launch of ``key`` in ``counts``, safe against other threads."""
    with _COUNT_LOCK:
        counts[key] += 1


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D tensors of one dtype, accumulated and returned
    in f32 (the JAX package's ``preferred_element_type=F32``): a bf16
    product on the card runs on the tensor cores with ``torch.mm``'s
    ``out_dtype`` (no f32 copy of its inputs); otherwise both are read as
    f32, which is the same function."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _check(x, w1, w_dw, sc, bi, stride, g=None):
    """Raise on what the mm entries do not take: x ``(B, T, H, W, C_in)``
    f32 or bf16, ``w1 (C_in, C_mid)``, taps ``(3, 3, 3, C_mid)`` (where
    given) and ``g`` (y's shape, where given) in x's dtype, f32 ``(C_mid,)``
    ``sc``/``bi``, all contiguous on x's device."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2 (i.e. (1,2,2)), got {stride}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C_in), got {tuple(x.shape)}")
    b, t, h, w, c_in = x.shape
    if w1.dim() != 2 or w1.shape[0] != c_in:
        raise ValueError(f"w1 must be ({c_in}, C_mid), got {tuple(w1.shape)}")
    c_mid = w1.shape[1]
    tensors = [("x", x), ("w1", w1), ("sc", sc), ("bi", bi)]
    if w_dw is not None:
        if tuple(w_dw.shape) != (3, 3, 3, c_mid):
            raise ValueError(
                f"w_dw must be (3, 3, 3, {c_mid}), got {tuple(w_dw.shape)}")
        tensors.append(("w_dw", w_dw))
    if g is not None:
        want = (b, t) + _out_hw(h, w, stride) + (c_mid,)
        if tuple(g.shape) != want:
            raise ValueError(f"g must be {want}, got {tuple(g.shape)}")
        tensors.append(("g", g))
    for name, v in (("sc", sc), ("bi", bi)):
        if tuple(v.shape) != (c_mid,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({c_mid},), got "
                             f"{v.dtype} {tuple(v.shape)}")
    for name, v in tensors:
        if name not in ("x", "sc", "bi") and v.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel_input(x):
    """Raise on a device with no kernel, and on what the prologue's 16-byte
    loads of x do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.shape[-1] % 8:
        raise ValueError(f"the kernel needs C_in % 8 == 0, got {x.shape[-1]}")
    if x.data_ptr() % 16:
        raise ValueError("the kernel needs x 16-byte aligned")


def dw_mm_bnrelu_conv3d_plain(x: torch.Tensor, w1: torch.Tensor,
                              w_dw: torch.Tensor, sc: torch.Tensor,
                              bi: torch.Tensor, stride: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch.

    ``a = relu((x @ w1)·sc + bi)`` from the f32 product, rounded to x's dtype,
    zero-padded by one on T, H and W (the padding is zero after the
    activation); then the 27-tap depthwise sum in f32 at stride
    ``(1, stride, stride)``, written in x's dtype.  Output
    ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C_mid)``."""
    return stencil_f32(_mm_activate(x, w1, sc, bi), w_dw, stride).to(x.dtype)


def _mm_product(x, w1):
    """conv1's product ``x @ w1`` in f32, ``(B, T, H, W, C_mid)``, as the
    plain versions compute it."""
    return torch.matmul(x.float(), w1.float())


def _mm_activate(x, w1, sc, bi):
    """``relu((x @ w1)·sc + bi)`` in f32, rounded to x's dtype (the
    forward's activation)."""
    return torch.relu(_mm_product(x, w1) * sc + bi).to(x.dtype)


def strides3(stride) -> tuple[int, int, int]:
    """A stride as ``(T, H, W)``: an int ``s`` is ``(1, s, s)``."""
    if isinstance(stride, int):
        return 1, stride, stride
    return tuple(int(s) for s in stride)


def stencil_f32(a: torch.Tensor, w_dw: torch.Tensor,
                stride) -> torch.Tensor:
    """The 27-tap depthwise correlation of ``a (B, T, H, W, C)`` with taps
    ``w_dw (3, 3, 3, C)`` at stride ``(1, stride, stride)`` (or the triple
    ``stride``, :func:`strides3`), zero-padded by one on T, H and W, summed
    in f32: ``(B, ⌈T/st⌉, ⌈H/s⌉, ⌈W/s⌉, C)`` f32."""
    st, sh, sw = strides3(stride)
    b, t, h, w, c = a.shape
    to, ho, wo = (t - 1) // st + 1, (h - 1) // sh + 1, (w - 1) // sw + 1
    a = F.pad(a.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w_dw.float()
    y = torch.zeros((b, to, ho, wo, c), dtype=torch.float32, device=a.device)
    for dt in range(3):
        for dy in range(3):
            for dx in range(3):
                y += (a[:, dt:dt + st * (to - 1) + 1:st,
                        dy:dy + sh * (ho - 1) + 1:sh,
                        dx:dx + sw * (wo - 1) + 1:sw]
                      * wf[dt, dy, dx])
    return y


def wgrad_f32(a: torch.Tensor, g: torch.Tensor, stride) -> torch.Tensor:
    """The weight gradient of :func:`stencil_f32`: ``dk[tap, c] =
    Σ_pos a_pad[s·pos + tap]·g[pos]`` over ``a (B, T, H, W, C)`` zero-padded
    by one on T, H and W and ``g`` of the output's shape, in f32:
    ``(27, C)``."""
    st, sh, sw = strides3(stride)
    to, ho, wo = g.shape[1:4]
    a = F.pad(a.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.float()
    dk = []
    for dt in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = a[:, dt:dt + st * (to - 1) + 1:st,
                        dy:dy + sh * (ho - 1) + 1:sh,
                        dx:dx + sw * (wo - 1) + 1:sw]
                dk.append(torch.sum(tap * gf, dim=(0, 1, 2, 3)))
    return torch.stack(dk)


# ---- the work of each kernel's function (its roofline bound; the count of
# ``utils.hw.program_costs``): x, g, y read or written once, w1, the taps and
# the f32 (sc, bi) once; conv1's product (2·C_in·C_mid an activation), 27
# taps an output element; the apply and the relu an activation

def fwd_work(y, x, w1, w_dw, sc, bi, stride) -> Work:
    """:func:`dw_mm_bnrelu_conv3d`'s work, ``y`` its output."""
    return Work((x.numel() + y.numel() + w1.numel() + w_dw.numel())
                * x.element_size() + 2 * w1.shape[1] * 4,
                2 * (x.numel() * w1.shape[1] + 27 * y.numel()))


def activations(x, w1) -> int:
    """Elements of conv1's output (x's positions × C_mid)."""
    return x.numel() // w1.shape[0] * w1.shape[1]


def wgrad_work(dk, x, w1, g, sc, bi, stride) -> Work:
    """:func:`dw_mm_wgrad`'s work, ``dk`` its output."""
    c, n_a = w1.shape[1], activations(x, w1)
    return Work((x.numel() + g.numel() + w1.numel()) * x.element_size()
                + 2 * c * 4 + 27 * c * 4,
                2 * w1.shape[0] * n_a + 2 * 27 * g.numel(), 3 * n_a)


@kernel_work(fwd_work)
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
    launches the kernel (``dw_mm_act_s1`` or ``dw_mm_act_s2``, with the work
    split of :func:`..dw_conv.plan_mm_s1` or :func:`..dw_conv.plan_mm_s2_fwd`)
    or raises."""
    _check(x, w1, w_dw, sc, bi, stride)
    if x.device.type == "cpu":
        return dw_mm_bnrelu_conv3d_plain(x, w1, w_dw, sc, bi, stride)
    _check_kernel_input(x)
    b, t, h, w, c_in = x.shape
    c_mid = w1.shape[1]
    ho, wo = _out_hw(h, w, stride)
    y = torch.empty((b, t, ho, wo, c_mid), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    # .dw_conv builds on this module's libraries: imported here
    from . import dw_conv

    lib, plan = ((LIBRARY, dw_conv.plan_mm_s1) if stride == 1 else
                 (dw_conv.LIBRARY_S2, dw_conv.plan_mm_s2_fwd))
    p = plan(b, t, h, w, c_in, c_mid, x.element_size())
    _launch(LAUNCHES, lib, f"dw_mm_act_s{stride}", x, x.data_ptr(),
            w1.data_ptr(), w_dw.data_ptr(), sc.data_ptr(), bi.data_ptr(),
            y.data_ptr(), b, t, h, w, c_in, c_mid, p.r, p.wb, p.pg, p.tt)
    return y


# ---- wgrad: the mm modes of K6 (stride 1) and K10 (stride 2) -----------------

def dw_mm_wgrad_plain(x: torch.Tensor, w1: torch.Tensor, g: torch.Tensor,
                      sc: torch.Tensor, bi: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """``dk[tap, c] = Σ_pos a_pad[s·pos + tap]·g[pos]`` with the forward's
    activation ``a = relu((x @ w1)·sc + bi)`` (f32, rounded to x's dtype,
    zero-padded after the activation), in f32: ``(27, C_mid)``."""
    return wgrad_f32(_mm_activate(x, w1, sc, bi), g, stride)


@kernel_work(wgrad_work)
def dw_mm_wgrad(x: torch.Tensor, w1: torch.Tensor, g: torch.Tensor,
                sc: torch.Tensor, bi: torch.Tensor,
                stride: int) -> torch.Tensor:
    """Weight gradient of :func:`dw_mm_bnrelu_conv3d`'s taps (see
    :func:`dw_mm_wgrad_plain`), ``(27, C_mid)`` f32; ``g`` is dL/dy (y's
    shape, x's dtype).  A CPU tensor takes the plain version; a CUDA tensor
    launches ``dw_mm_wgrad_s1`` or ``dw_mm_wgrad_s2`` (per-block partial
    sums, added with one ``torch.sum``; with the work split of
    :func:`..dw_conv.plan_mm_wgrad_s1` or
    :func:`..dw_conv.plan_mm_wgrad_s2`), or raises."""
    _check(x, w1, None, sc, bi, stride, g)
    if x.device.type == "cpu":
        return dw_mm_wgrad_plain(x, w1, g, sc, bi, stride)
    _check_kernel_input(x)
    if not g.numel():
        return torch.zeros((27, w1.shape[1]), device=x.device)
    b, t, h, w, c_in = x.shape
    c_mid = w1.shape[1]
    # .dw_conv builds on this module's libraries: imported here
    from . import dw_conv

    lib, plan = ((dw_conv.LIBRARY, dw_conv.plan_mm_wgrad_s1) if stride == 1
                 else (dw_conv.LIBRARY_S2, dw_conv.plan_mm_wgrad_s2))
    p = plan(b, t, h, w, c_in, c_mid, x.element_size())
    part = torch.empty((p.rows, 27, c_mid), dtype=torch.float32,
                       device=x.device)
    _launch(LAUNCHES, lib, f"dw_mm_wgrad_s{stride}", x, x.data_ptr(),
            w1.data_ptr(), g.data_ptr(), sc.data_ptr(), bi.data_ptr(),
            part.data_ptr(), b, t, h, w, c_in, c_mid, p.r, p.wb, p.pg, p.tt,
            p.ipb, p.rows)
    return torch.sum(part, dim=0)


# ---- autograd: the eval entry's backward -------------------------------------

class DwMmBnReluConv3d(torch.autograd.Function):
    """:func:`dw_mm_bnrelu_conv3d` with the JAX package's backward
    (``_dw_mm_bwd``): ``da`` from :func:`..dw_conv.dw_conv3d` on the flipped
    taps (stride 1) or :func:`..dw_conv.dw_conv_dx_s2` (K8, stride 2), the
    taps' gradient from :func:`dw_mm_wgrad`, and ``(dx, dw1, dsc, dbi)``
    from the relu mask of the recomputed product with the products in
    PyTorch; ``dsc`` by the contraction identity ``Σ_pos dam·(x@W1) =
    ⟨W1, xᵀ·dam⟩``, which never re-reads the product.  ``sc``/``bi`` are
    bn1's apply vectors from its running statistics, so the gradient reaches
    bn1's weight and bias (and its running statistics get none)."""

    @staticmethod
    def forward(ctx, x, w1, w_dw, sc, bi, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w1, w_dw, sc, bi)
        return dw_mm_bnrelu_conv3d(x, w1, w_dw, sc, bi, stride)

    @staticmethod
    def backward(ctx, g):
        # .dw_conv builds on this module's libraries: imported here
        from .dw_conv import dw_conv3d, dw_conv_dx_s2

        x, w1, w_dw, sc, bi = ctx.saved_tensors
        g = g.contiguous()
        if ctx.stride == 1:
            da = dw_conv3d(g, torch.flip(w_dw, (0, 1, 2)).contiguous(), 1)
        else:
            da = dw_conv_dx_s2(g, w_dw, x.shape[2:4])
        dk = dw_mm_wgrad(x, w1, g, sc, bi, ctx.stride)
        c_in, c_mid = w1.shape
        x2 = x.reshape(-1, c_in)
        z_pos = mm_f32(x2, w1) * sc + bi > 0
        dam = torch.where(z_pos, da.reshape(-1, c_mid), 0.0)
        w_sc = (w1.float() * sc).to(x.dtype)
        dx = mm_f32(dam, w_sc.t()).to(x.dtype).reshape(x.shape)
        gmat = mm_f32(x2.t(), dam)
        dw1 = (gmat * sc).to(w1.dtype)
        dsc = torch.sum(w1.float() * gmat, dim=0)
        dbi = torch.sum(dam, dim=0, dtype=torch.float32)
        return (dx, dw1, dk.reshape(3, 3, 3, -1).to(w_dw.dtype), dsc, dbi,
                None)


# ``dw_mm_bnrelu_conv3d_train(x, w1, w_dw, sc, bi, stride)``:
# :func:`dw_mm_bnrelu_conv3d` inside autograd
dw_mm_bnrelu_conv3d_train = DwMmBnReluConv3d.apply
