"""The port's fused bottleneck entry ``dw_mm_bnrelu_conv3d``.

Its plain version is held against the JAX Pallas kernel itself (the ``mm``
modes of ``_dw_fold4_pcall`` and ``_fwd_s2_direct_pcall``), run in interpret
mode on the CPU exactly as ``tests/test_dw_fold.py`` runs it, and against a
direct XLA reference at odd sizes the Pallas kernel does not take.  The CUDA
kernel itself only runs on the card: ``chip_smoke.py`` holds it against the
plain version there.  All f32; tolerance 1e-4 absolute and relative (f32
sums of up to 27·C_in terms in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from coarse_fine_networks_tpu.models.x3d import Bottleneck as JBottleneck
from coarse_fine_networks_tpu.ops.fold import (fold_pad, fold_pointwise_kernel,
                                               from_fold4, pad_vec, to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import \
    fold_dw_mm_bnrelu_conv3d
from coarse_fine_networks_torch.models.x3d import Bottleneck
from coarse_fine_networks_torch.ops import dw_conv, dw_mm_act
from coarse_fine_networks_torch.ops.dw_mm_act import (
    dw_mm_bnrelu_conv3d, dw_mm_bnrelu_conv3d_plain)

from _torch_port_util import jax_variables, load_port, t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(shape, c_mid, seed):
    rng = np.random.RandomState(seed)
    c_in = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    w1 = (rng.randn(c_in, c_mid) / np.sqrt(c_in)).astype(np.float32)
    k = rng.randn(3, 3, 3, c_mid).astype(np.float32)
    sc = (rng.rand(c_mid) + 0.5).astype(np.float32)
    bi = rng.randn(c_mid).astype(np.float32)
    bi[: c_mid // 2] = -np.abs(bi[: c_mid // 2]) - 0.5  # negative: zero frame
    return x, w1, k, sc, bi


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape,c_mid", [((1, 4, 16, 16, 24), 54),
                                         ((2, 3, 8, 16, 48), 108)])
def test_plain_matches_pallas_kernel(shape, c_mid, stride):
    x, w1, k, sc, bi = _inputs(shape, c_mid, seed=stride)
    c_in = shape[-1]
    p = fold_pad(c_mid)
    y = fold_dw_mm_bnrelu_conv3d(
        to_fold4(jnp.asarray(x)),
        fold_pointwise_kernel(jnp.asarray(w1).reshape(1, 1, 1, c_in, c_mid),
                              c_in, c_mid),
        jnp.asarray(k).reshape(3, 3, 3, 1, c_mid),
        pad_vec(jnp.asarray(sc), c_mid, p), pad_vec(jnp.asarray(bi), c_mid, p),
        c_mid, stride, impl="interpret")
    ref = np.asarray(from_fold4(y, c_mid))
    got = dw_mm_bnrelu_conv3d_plain(t(x), t(w1), t(k), t(sc), t(bi), stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _xla_reference(x, w1, k, sc, bi, stride):
    a = jnp.maximum(jnp.einsum("bthwi,io->bthwo", x, w1,
                               precision=lax.Precision.HIGHEST) * sc + bi, 0)
    return lax.conv_general_dilated(
        a, jnp.asarray(k).reshape(3, 3, 3, 1, -1), (1, stride, stride),
        [(1, 1)] * 3, dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        feature_group_count=a.shape[-1], precision=lax.Precision.HIGHEST)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_plain_odd_sizes(hw, stride):
    x, w1, k, sc, bi = _inputs((1, 3) + hw + (16,), 20, seed=7)
    ref = _xla_reference(*(jnp.asarray(a) for a in (x, w1, k, sc, bi)),
                         stride)
    got = dw_mm_bnrelu_conv3d_plain(t(x), t(w1), t(k), t(sc), t(bi), stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_odd_size_stride2_bottleneck_matches_jax():
    """7×7 at stride (1,2,2) (layer4 block0's output size is odd): the
    port's kernel-entry bottleneck against the JAX plain Bottleneck."""
    x = np.random.RandomState(3).randn(1, 3, 7, 7, 24).astype(np.float32)
    jm = JBottleneck(54, 48, stride=2, use_se=True, has_downsample=True)
    v = jax_variables(jm, jnp.asarray(x), train=False)
    ref = jm.apply(v, jnp.asarray(x), False)
    pm = load_port(Bottleneck(24, 54, 48, 2, True, True), v,
                   ("layer1", "block0"), "layer1.0.")
    got = pm(t(x))
    assert got.shape == ref.shape == (1, 3, 4, 4, 48)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_wrapper_cpu_takes_plain_and_counts_nothing():
    x, w1, k, sc, bi = _inputs((1, 2, 6, 6, 8), 12, seed=1)
    dw_mm_act.reset_launches()
    for s in (1, 2):
        got = dw_mm_bnrelu_conv3d(t(x), t(w1), t(k), t(sc), t(bi), s)
        ref = dw_mm_bnrelu_conv3d_plain(t(x), t(w1), t(k), t(sc), t(bi), s)
        assert torch.equal(got, ref)
    assert dw_mm_act.LAUNCHES == {"dw_mm_act_s1": 0, "dw_mm_act_s2": 0,
                                  "dw_mm_wgrad_s1": 0, "dw_mm_wgrad_s2": 0}


def test_wrapper_bf16_rounds_activation():
    """bf16: the activation is rounded to bf16 before the f32 stencil and
    the output is bf16, like the TPU tile stored in x.dtype."""
    x, w1, k, sc, bi = _inputs((1, 2, 4, 4, 8), 8, seed=2)
    xb, wb, kb = (t(a).to(torch.bfloat16) for a in (x, w1, k))
    got = dw_mm_bnrelu_conv3d(xb, wb, kb, t(sc), t(bi), 1)
    assert got.dtype == torch.bfloat16
    a = torch.relu(xb.float() @ wb.float() * t(sc) + t(bi)).bfloat16()
    ref = dw_mm_bnrelu_conv3d_plain(a, torch.eye(8, dtype=torch.bfloat16), kb,
                                    torch.ones(8), torch.zeros(8), 1)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("bad", ["dtype", "w1", "w_dw", "sc", "stride",
                                 "noncontig", "device"])
def test_wrapper_rejects(bad):
    x, w1, k, sc, bi = (t(a) for a in _inputs((1, 2, 4, 4, 8), 8, seed=4))
    stride = 1
    if bad == "dtype":
        x = x.double()
    elif bad == "w1":
        w1 = w1[:4]
    elif bad == "w_dw":
        k = k.reshape(27, 8)
    elif bad == "sc":
        sc = sc.double()
    elif bad == "stride":
        stride = 3
    elif bad == "noncontig":
        x = x.transpose(2, 3)
    else:  # no kernel and no plain version off the CPU and the card
        x, w1, k, sc, bi = (a.to("meta") for a in (x, w1, k, sc, bi))
    with pytest.raises((ValueError, TypeError)):
        dw_mm_bnrelu_conv3d(x, w1, k, sc, bi, stride)


def test_kernel_source_ships_both_entries():
    src = dw_mm_act.SOURCE.read_text()
    # the weight gradients are the mm modes of K6 and K10 plain, in their
    # sources; the stride-2 forward (K4 mm) is K4 plain's source's mm mode
    s1 = dw_conv.LIBRARY.source.read_text()
    s2 = dw_conv.LIBRARY_S2.source.read_text()
    for name in dw_mm_act.LAUNCHES:
        home = (s1 if name == "dw_mm_wgrad_s1" else
                s2 if name in ("dw_mm_act_s2", "dw_mm_wgrad_s2") else src)
        assert f'extern "C" int {name}(' in home
    # the tile kernel of K4 mm is gone from the forward's source
    for gone in ("dw_mm_act_kernel", "Geom", "dispatch<",
                 'extern "C" int dw_mm_act_s2('):
        assert gone not in src
    assert "sm_90a" in " ".join(dw_mm_act.NVCC_FLAGS)


def test_kernels_only_raise_their_shared_memory_limit():
    """A kernel's shared-memory limit is set in one place, ``set_smem`` of
    ``csrc/common.cuh``, which raises it only, under a lock, per card: a
    loader's worker threads launch ``crop_resize_kernel`` at once with
    different needs, and a limit lowered by one thread between another's
    set and launch refuses that launch (``cudaErrorInvalidValue``).
    ``chip_smoke.py``'s ``decode`` phase launches it from threads on the
    card."""
    csrc = dw_conv.LIBRARY.source.parent
    common = (csrc / "common.cuh").read_text()
    body = common[common.index("int set_smem("):]
    body = body[:body.index("\n}\n")]
    for piece in ("std::lock_guard<std::mutex>", "cudaGetDevice(",
                  "if (bytes <= cur) return 0;", "cur = bytes;"):
        assert piece in body
    for src in sorted(csrc.glob("*.cu*")):
        text = src.read_text()
        n = text.count("cudaFuncSetAttribute(")
        assert n == (1 if src.name == "common.cuh" else 0), src.name
    assert "cfn::set_smem(crop_resize_kernel" in (
        csrc / "frame_decode.cu").read_text()
