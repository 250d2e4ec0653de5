"""Train-mode matmul-fused X3D bottleneck entry:
``dwconv3³(relu(bn1_train(x @ W1)))`` as one composite with a closed-form
backward.

With ``CFN_MM_BN_TRAIN`` set (:func:`resolve_mm_train`), a training
:class:`..models.x3d.Bottleneck` whose bn1 has one split enters through
:class:`DwMmBnTrain` instead of materialising conv1's ``C_mid`` output: bn1's
batch statistics come from Σx and the Gram xᵀx (:func:`mm_bn_stats`), the
forward is the eval entry's kernel (:func:`.dw_mm_act.dw_mm_bnrelu_conv3d`,
the ``mm`` modes of K1/K4) with those statistics, and the backward is the
masked dx (:func:`dw_mm_dx_mask`), the ``mm`` weight gradient
(:func:`.dw_mm_act.dw_mm_wgrad`) and the batch-norm gradient in closed form,
whose only full-size work is three products in PyTorch.  It is the
counterpart of the JAX package's ``dw_fold4_mm_bn_train`` and
``resolve_mm_train_impl``
(``coarse_fine_networks_tpu/ops/pallas/dw_fold.py``), whose backward is the
Pallas kernels K2/K9 and the ``mm`` modes of K6/K10.

Kernels (CUDA C++ for ``sm_90a``, :mod:`._build`), :func:`dw_mm_dx_mask`:
``dw_mm_dx_mask_s1`` (K2) in ``csrc/dw_dx_s1.cu`` (``dw_plain_s1.cu``'s
row strips on g with the flipped taps) and ``dw_mm_dx_mask_s2`` (K9) in
``csrc/dw_plain_s2.cu`` (K8's gather on g's row strips), each with the
mask from conv1's product on the tensor cores by the mm forwards' code,
computed for a frame segment before its stencil.  The wrapper runs its ``*_plain`` version on a
CPU tensor and launches its kernel on a CUDA tensor, or raises.  All tensors
are channels-last ``(B, T, H, W, C)``; stride 2 means ``(1, 2, 2)``.
"""

from __future__ import annotations

import os

import torch

from ..parallel import mesh
from ..utils.hw import Work, kernel_work
from .dw_mm_act import (DX_S1_LIBRARY, _check, activations,
                        _check_kernel_input, _launch, _mm_product,
                        dw_mm_bnrelu_conv3d, dw_mm_wgrad, mm_f32, stencil_f32)

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by the plain version).
LAUNCHES = {"dw_mm_dx_mask_s1": 0, "dw_mm_dx_mask_s2": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_mm_train(stride: int) -> bool:
    """Whether a training bottleneck at ``stride`` takes the composite:
    ``CFN_MM_BN_TRAIN`` is ``0`` (the default: never), ``1`` (always) or
    ``s1`` (stride-1 blocks only), the JAX package's values.  The route
    depends on the variable and the stride alone, never on the device."""
    knob = os.environ.get("CFN_MM_BN_TRAIN", "0")
    if knob not in ("0", "1", "s1"):
        raise ValueError(f"CFN_MM_BN_TRAIN must be 0, 1 or s1, got {knob!r}")
    return knob == "1" or (knob == "s1" and stride == 1)


# ---- dx with the recomputed relu mask: K2 (stride 1) and K9 (stride 2) -------

def dw_mm_dx_mask_plain(g: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                        w_dw: torch.Tensor, sc: torch.Tensor,
                        bi: torch.Tensor, stride: int) -> torch.Tensor:
    """``dam = da ⊙ 1[(x @ w1)·sc + bi > 0]``: ``da`` the correlation of g
    (at stride 2 placed at the even positions of a zero full-resolution
    tensor) with the flipped taps in f32, the mask from the f32 product;
    ``(B, T, H, W, C_mid)`` in g's dtype."""
    gf = g.float()
    if stride == 2:
        up = torch.zeros(x.shape[:-1] + g.shape[-1:], dtype=torch.float32,
                         device=g.device)
        up[:, :, ::2, ::2] = gf
        gf = up
    da = stencil_f32(gf, torch.flip(w_dw, (0, 1, 2)), 1)
    keep = _mm_product(x, w1) * sc + bi > 0
    return torch.where(keep, da, 0.0).to(g.dtype)


def dx_mask_work(dam, g, x, w1, w_dw, sc, bi, stride) -> Work:
    """:func:`dw_mm_dx_mask`'s work, ``dam`` its output: g, x, dam, w1 and
    the taps moved once, the f32 (sc, bi) read once; conv1's product for
    the mask (2·C_in·C_mid an activation), 27 taps a g element; the apply
    and the mask an activation."""
    c, n_a = w1.shape[1], activations(x, w1)
    return Work((x.numel() + g.numel() + n_a + w1.numel() + w_dw.numel())
                * x.element_size() + 2 * c * 4,
                2 * w1.shape[0] * n_a + 2 * 27 * g.numel(), 3 * n_a)


@kernel_work(dx_mask_work)
def dw_mm_dx_mask(g: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                  w_dw: torch.Tensor, sc: torch.Tensor, bi: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """The masked dx of :func:`.dw_mm_act.dw_mm_bnrelu_conv3d` (see
    :func:`dw_mm_dx_mask_plain`): ``g`` is dL/dy (y's shape, x's dtype), x
    conv1's input.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``dw_mm_dx_mask_s1`` or ``dw_mm_dx_mask_s2`` (with the work
    split of :func:`..dw_conv.plan_mm_dx_s1` or
    :func:`..dw_conv.plan_mm_dx_s2`), whose masks take the forward kernels'
    relu branch, or raises."""
    _check(x, w1, w_dw, sc, bi, stride, g)
    if x.device.type == "cpu":
        return dw_mm_dx_mask_plain(g, x, w1, w_dw, sc, bi, stride)
    _check_kernel_input(x)
    b, t, h, w, c_in = x.shape
    c_mid = w1.shape[1]
    dam = torch.empty((b, t, h, w, c_mid), dtype=g.dtype, device=g.device)
    if not dam.numel():
        return dam
    # .dw_conv builds on this package's libraries: imported here
    from . import dw_conv

    lib, plan = ((DX_S1_LIBRARY, dw_conv.plan_mm_dx_s1) if stride == 1 else
                 (dw_conv.LIBRARY_S2, dw_conv.plan_mm_dx_s2))
    p = plan(b, t, h, w, c_in, c_mid, x.element_size())
    _launch(LAUNCHES, lib, f"dw_mm_dx_mask_s{stride}", x, g.data_ptr(),
            x.data_ptr(), w1.data_ptr(), w_dw.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), dam.data_ptr(), b, t, h, w, c_in, c_mid, p.r,
            p.wb, p.pg, p.tt)
    return dam


# ---- the composite -------------------------------------------------------------

def mm_bn_stats(x: torch.Tensor, w1: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor, eps: float):
    """Batch statistics of ``z = x @ w1`` without the product (the JAX
    package's ``_mm_bn_stats``).  Σx and the Gram xᵀx, of x in its own
    dtype accumulated in f32, give per channel ``mean = (Σx·W)/N`` and
    ``E[z²] = (Wᵀ·xᵀx·W)_oo / N``; the one-pass variance ``E[z²] − mean²``
    cancels below 0 in f32 when ``|mean| ≫ std`` and is clamped at 0 with
    ``torch.maximum`` (which splits a tie as JAX's ``maximum`` does).
    Under data parallelism (:mod:`..parallel.mesh`) xᵀx, Σx and N are
    summed over the ranks first, where JAX's partitioner reduced them, so
    the statistics are the global batch's.  Returns ``(mean, var, r, sc,
    bi, gram, s1, n)``: ``r = rsqrt(var + eps)``, bn1's f32 apply vectors
    ``sc = γ·r`` and ``bi = β − mean·sc``, this rank's own ``(xᵀx, Σx)``
    and the global N, which the closed-form backward reuses."""
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[0]
    wf = w1.float()
    gram = mm_f32(x2.t(), x2)
    s1 = torch.sum(x2, dim=0, dtype=torch.float32)
    gram_g, s1_g = gram, s1
    if mesh.world() > 1:
        c = gram.shape[0]
        tot = mesh.all_reduce_sum(torch.cat([
            gram.reshape(-1), s1, s1.new_full((1,), n)]))
        gram_g, s1_g, n = tot[:c * c].view(c, c), tot[c * c:-1], tot[-1]
    mean = (s1_g @ wf) / n
    szz = torch.sum((gram_g @ wf) * wf, dim=0)
    var = torch.maximum(szz / n - torch.square(mean), mean.new_zeros(()))
    r = torch.rsqrt(var + eps)
    sc = gamma * r
    return mean, var, r, sc, beta - mean * sc, gram, s1, n


class DwMmBnTrain(torch.autograd.Function):
    """``(y, mean, var)`` of ``dwconv3³(relu(bn_train(x @ w1)))`` with bn's
    batch statistics and affine ``gamma``/``beta`` (the JAX package's
    ``dw_fold4_mm_bn_train``).  ``mean``/``var`` are for the running-stat
    update and carry no gradient; the loss reaches the statistics only
    through the normalised activation, which the backward handles in closed
    form.  With per-channel ``S1 = Σdam``, ``S2 = r(Σ dam·z − μ·S1)``,
    ``A = γr(rμS2 − S1)/N`` and ``B = −γr²S2/N``:

        dx = dam·(W·γr)ᵀ + x·(W diag(B) Wᵀ) + W·A
        dW = γr·(xᵀdam) + Σx ⊗ A + (xᵀx·W) diag(B)
        dγ = S2,  dβ = S1

    with ``Σ dam·z = ⟨W, xᵀdam⟩`` (the product is never re-read) and JAX's
    casts to x's dtype in the same places.

    Under data parallelism the forward's statistics are global
    (:func:`mm_bn_stats`) and the backward sums ``S1`` and ``⟨W, xᵀdam⟩``
    over the ranks before ``A`` and ``B``; ``dx`` applies the global ``A``
    and ``B`` to this rank's rows, and ``dW``, ``dγ`` and ``dβ`` are this
    rank's share (its own ``xᵀdam``, Σx, Gram, ``S1`` and ``S2``), so
    their sum over the ranks, which the gradient reduction takes, is the
    global batch's."""

    @staticmethod
    def forward(ctx, x, w1, w_dw, gamma, beta, stride, eps):
        mean, var, r, sc, bi, gram, s1, n = mm_bn_stats(x, w1, gamma, beta,
                                                        eps)
        y = dw_mm_bnrelu_conv3d(x, w1, w_dw, sc, bi, stride)
        ctx.stride, ctx.n = stride, n
        ctx.save_for_backward(x, w1, w_dw, gamma, mean, r, sc, bi, gram, s1)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, w1, w_dw, gamma, mean, r, sc, bi, gram, s1 = ctx.saved_tensors
        stride, n = ctx.stride, ctx.n
        gy = gy.contiguous()
        dam = dw_mm_dx_mask(gy, x, w1, w_dw, sc, bi, stride)
        dk = dw_mm_wgrad(x, w1, gy, sc, bi, stride)
        c_in, c_mid = w1.shape
        x2, dam2 = x.reshape(-1, c_in), dam.reshape(-1, c_mid)
        wf = w1.float()
        s1d = torch.sum(dam2, dim=0, dtype=torch.float32)
        gmat = mm_f32(x2.t(), dam2)
        s2 = r * (torch.sum(wf * gmat, dim=0) - mean * s1d)
        s1d_g, s2_g = s1d, s2
        if mesh.world() > 1:  # the global S1 and ⟨W, xᵀdam⟩ for A and B
            tot = mesh.all_reduce_sum(torch.cat([
                s1d, torch.sum(wf * gmat, dim=0)]))
            s1d_g = tot[:c_mid]
            s2_g = r * (tot[c_mid:] - mean * s1d_g)
        sc_c = gamma * r
        a = sc_c * (r * mean * s2_g - s1d_g) / n
        b = -(sc_c * r * s2_g) / n
        w_sc = (wf * sc).to(x.dtype)
        m_corr = ((wf * b) @ wf.t()).to(x.dtype)
        dx = (mm_f32(dam2, w_sc.t()) + mm_f32(x2, m_corr)
              + wf @ a).to(x.dtype)
        dw1 = (gmat * sc + s1[:, None] * a + (gram @ wf) * b).to(w1.dtype)
        return (dx.reshape(x.shape), dw1,
                dk.reshape(3, 3, 3, -1).to(w_dw.dtype), s2.to(gamma.dtype),
                s1d.to(gamma.dtype), None, None)


# ``mm_bn_train(x, w1, w_dw, gamma, beta, stride, eps)`` -> (y, mean, var)
mm_bn_train = DwMmBnTrain.apply
