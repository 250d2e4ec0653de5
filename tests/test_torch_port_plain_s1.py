"""The stride-1 kernels of the split-batch-norm route (``dw_conv_s1``, also
the stride-1 dx, and ``dw_conv_wgrad_s1``, in ``csrc/dw_plain_s1.cu``):
the work split their wrapper computes, the wrappers' CPU route, the
bindings and the sources.  The kernels themselves run only on the card,
where ``chip_smoke.py`` holds them against their plain versions and the
forward against K11 bit for bit.

* ``plan_s1`` covers every (sample, frame, row, column, channel) of x
  exactly once, forward and weight gradient, at the fine tower's stride-1
  entry shapes of long-cycle phases A-C and at ragged ones (7×6, 5×9,
  C = 12, odd C, a width split into column tiles), within the kernels'
  limits, and gives the partial buffer's row count.
* The wrappers take the plain versions on the CPU and count no launch; the
  plain versions at ragged shapes (odd C included) are held against XLA's
  grouped conv and ``jax.grad`` at 1e-4, as
  ``tests/test_torch_port_fine_kernels.py`` holds them at odd sizes.
* Every bound name's ``ctypes`` argument types match its C declaration.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from coarse_fine_networks_torch.ops import dw_conv, dw_mm_act, dw_stencil
from coarse_fine_networks_torch.ops.dw_conv import (
    FWD_BLOCKS, NT_MAX, RMAX, RMIN, TT_MIN, WG_BLOCKS, dw_conv3d, dw_conv3d_plain,
    dw_conv3d_train, dw_conv_wgrad, dw_conv_wgrad_plain, plan_s1)

from _torch_port_util import t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, T, H, C) of the fine tower's stride-1 entries at long-cycle phases
# A (B64 T16 112²), B (B32 T32 144²) and C (B16 T32 224²)
PATH = [(64, 16, 28, 54), (64, 16, 14, 108), (64, 16, 7, 216),
        (64, 16, 4, 432), (32, 32, 36, 54), (32, 32, 18, 108),
        (32, 32, 9, 216), (32, 32, 5, 432), (16, 32, 56, 54),
        (16, 32, 28, 108), (16, 32, 14, 216), (16, 32, 7, 432)]
RAGGED = [(1, 3, 7, 6, 12), (2, 5, 5, 9, 13), (2, 17, 7, 7, 54),
          (1, 3, 4, 300, 6), (3, 1, 1, 1, 1), (2, 9, 9, 9, 7)]
SHAPES = [(b, tt, h, h, c) for b, tt, h, c in PATH] + RAGGED


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_plan_covers_every_position_once(shape):
    """Every tile of every item and channel group, clipped to x, adds one
    to each position it owns: all of x is owned exactly once.  The forward
    launches one block per (item, group); the weight gradient's ``rows``
    blocks per group walk ``ipb`` consecutive items each, and every block
    has at least one."""
    b, tt, h, w, c = shape
    p = plan_s1(*shape)
    p2 = -(-c // 2)
    assert RMIN <= p.r <= RMAX and p.wb * p.pg <= NT_MAX and p.threads <= NT_MAX
    assert p.pg <= p2 and p.wb <= w and (p.wb >= 2 or w == 1)
    assert p.items == b * p.n_tseg * p.n_strip * p.n_wt
    # the weight gradient's partial buffer: one row per block of a group
    assert p.rows * p.ipb >= p.items > (p.rows - 1) * p.ipb
    if p.items * p.n_pg >= WG_BLOCKS:
        assert p.rows * p.n_pg <= WG_BLOCKS
    # the forward's frames: the whole clip unless that gives under two
    # waves, and never split below TT_MIN
    assert p.tt == tt or (p.tt >= min(TT_MIN, tt) and
                          p._replace(tt=2 * p.tt).items * p.n_pg
                          < FWD_BLOCKS)
    count = np.zeros((b, tt, h, w, 2 * p.n_pg * p.pg), np.uint8)
    for row in range(p.rows):
        for item in range(row * p.ipb, min((row + 1) * p.ipb, p.items)):
            for g in range(p.n_pg):
                bi, (t0, t1), (h0, h1), (w0, w1), (c0, c1) = p.tile(item, g)
                assert t0 < t1 and h0 < h1 and w0 < w1
                count[bi, t0:t1, h0:h1, w0:w1, c0:c1] += 1
    assert (count[..., :c] == 1).all()
    assert not count[..., c:].any()


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, k, g


@pytest.mark.parametrize("shape", [(1, 3, 7, 6, 12), (2, 3, 5, 9, 13),
                                   (1, 4, 4, 9, 7)])
def test_plain_against_xla_and_jax_grad(shape):
    """The stride-1 Function's forward, dx and taps' gradient at ragged
    shapes, odd C included, against XLA's grouped conv and ``jax.grad``."""
    x, k, g = _inputs(shape, seed=sum(shape))

    def loss(a, w):
        y = lax.conv_general_dilated(
            a, w.reshape(3, 3, 3, 1, -1), (1, 1, 1), [(1, 1)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            feature_group_count=a.shape[-1], precision=lax.Precision.HIGHEST)
        return jnp.sum(y * g), y
    (_, y), (gx, gk) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(k))
    xt, kt = t(x).requires_grad_(), t(k).requires_grad_()
    yt = dw_conv3d_train(xt, kt, 1)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    yt.backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_cpu_take_plain_and_count_nothing(dtype):
    dw_conv.reset_launches()
    for shape in [(1, 3, 7, 6, 12), (2, 3, 5, 9, 13)]:
        x, k, g = (t(a).to(dtype) for a in _inputs(shape, seed=3))
        assert torch.equal(dw_conv3d(x, k, 1), dw_conv3d_plain(x, k, 1))
        assert torch.equal(dw_conv_wgrad(x, g, 1),
                           dw_conv_wgrad_plain(x, g, 1))
    assert not any(dw_conv.LAUNCHES.values())


LIBRARIES = dw_conv.LIBRARIES + (dw_stencil.LIBRARY,)


@pytest.mark.parametrize("lib", LIBRARIES, ids=[lib.source.name
                                                 for lib in LIBRARIES])
def test_bindings_match_the_c_declarations(lib):
    """A pointer for each ``void*``, an int for each ``int``, in order: a
    wrong count makes ctypes pass the stream as a 32-bit int."""
    src = lib.source.read_text()
    for name, argtypes in lib.functions.items():
        m = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params]
        assert argtypes == want, name


def test_stride1_entries_left_the_entry_sources():
    """The plain mode at stride 1, the act forward and weight gradient at
    stride 1 (K1 act, K6 act) and the mm weight gradient at stride 1 (K6
    mm) live in ``dw_plain_s1.cu`` only, the three stride-2 plain entries
    (K4 plain, K8, K10 plain), the act forward, dx and weight gradient at
    stride 2 (K4 act, K5, K10 act) and the mm forward, masked dx and
    weight gradient at stride 2 (K4 mm, K9, K10 mm) in ``dw_plain_s2.cu``
    only, and the stride-1 dx of the train entries (K3, K2) in
    ``dw_dx_s1.cu`` only: none is left in the bottleneck entry's source,
    and neither is its ``PLAIN`` mode or the tile kernel of K4 mm; the
    entry backward's tile source is gone; the act modes are instantiations
    of the plain bodies."""
    fwd = dw_mm_act.LIBRARY.source.read_text()
    new = dw_conv.LIBRARY.source.read_text()
    s2 = dw_conv.LIBRARY_S2.source.read_text()
    dx1 = dw_mm_act.DX_S1_LIBRARY.source.read_text()
    for lib, src, names in (
            (dw_conv.LIBRARY, new, ("dw_conv_s1", "dw_act_s1",
                                    "dw_conv_wgrad_s1", "dw_act_wgrad_s1",
                                    "dw_mm_wgrad_s1")),
            (dw_conv.LIBRARY_S2, s2, ("dw_conv_s2", "dw_act_s2",
                                      "dw_conv_dx_s2", "dw_act_dx_s2",
                                      "dw_conv_wgrad_s2", "dw_act_wgrad_s2",
                                      "dw_mm_act_s2", "dw_mm_dx_mask_s2",
                                      "dw_mm_wgrad_s2")),
            (dw_mm_act.DX_S1_LIBRARY, dx1, ("dw_act_dx_s1",
                                            "dw_mm_dx_mask_s1"))):
        others = "".join(other for other in (fwd, new, s2, dx1)
                         if other is not src)
        for name in names:
            assert f'extern "C" int {name}(' in src
            assert f'extern "C" int {name}(' not in others
            assert name in lib.functions
            for other in (dw_mm_act.LIBRARY, dw_conv.LIBRARY,
                          dw_conv.LIBRARY_S2, dw_mm_act.DX_S1_LIBRARY):
                if other is not lib:
                    assert name not in other.functions
    assert "PLAIN" not in fwd
    assert not (dw_conv.LIBRARY.source.parent / "dw_act_bwd.cu").exists()
    assert "dw_mm_act_kernel" not in fwd
    assert "ACT" not in fwd and "activate(x" not in fwd
    assert "fwd_body<T, R, true>" in new and "fwd_body<T, R, false>" in new
    assert ("s2_fwd_body<T, R, true>" in s2
            and "s2_fwd_body<T, R, false>" in s2)
    assert ("s2_wgrad_body<T, R, true>" in s2
            and "s2_wgrad_body<T, R, false>" in s2)
    for lib in (dw_conv.LIBRARY, dw_conv.LIBRARY_S2, dw_mm_act.DX_S1_LIBRARY):
        assert lib in dw_conv.LIBRARIES
