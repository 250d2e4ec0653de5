"""The stride-1 mm forward (K1 ``mm``, ``dw_mm_act_s1``, in
``csrc/dw_mm_act.cu``: row strips with conv1's product on the tensor
cores): the work split its wrapper computes, the wrapper's CPU route, the
binding and the source.  The kernel itself runs only on the card, where
``chip_smoke.py`` holds it against its plain version and holds its relu
branch against the masked dx's (K2) element for element.

* ``plan_mm_s1`` covers every (sample, frame, row, column, channel) of the
  output exactly once at the serve run's and the fine eval step's eight
  stride-1 entry shapes (12 in all) and at ragged ones (odd H and W,
  C_mid = 12, odd C_mid, a width split into column tiles), within the
  kernel's limits and its shared memory; its frame segments are those of
  the least rounds × frames.
* The plain version at ragged shapes is held against the JAX Pallas kernel
  in interpret mode (``dw_fold4_mm_act``, through its fold4 entry) at 1e-4.
* The plain versions of the forward and of the masked dx take one relu
  branch: with only the centre tap set the forward's ``y > 0`` is the mask.
* The wrapper takes the plain version on the CPU and counts no launch.
* The new bindings' ``ctypes`` argument types match the C declarations.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import (fold_pad, fold_pointwise_kernel,
                                               from_fold4, pad_vec, to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import \
    fold_dw_mm_bnrelu_conv3d
from coarse_fine_networks_torch.ops import dw_mm_act
from coarse_fine_networks_torch.ops.dw_conv import (
    MM_SETUP_FRAMES, NT_MAX, RMAX, RMIN, SMEM_MAX, SMS, plan_mm_s1,
    plan_s1, smem_mm_s1)
from coarse_fine_networks_torch.ops.dw_mm_act import (
    dw_mm_bnrelu_conv3d, dw_mm_bnrelu_conv3d_plain)
from coarse_fine_networks_torch.ops.dw_mm_bn_train import dw_mm_dx_mask_plain

from _torch_port_util import t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, T, H, C_in, C_mid) of the stride-1 entries: the serve run's fine
# tower (B3 T128) and coarse tower (B3, T64 in layer1, T17 after Grid Pool),
# and the fine eval step (B8 T64)
PATH = [(3, 128, 56, 24, 54), (3, 128, 28, 48, 108), (3, 128, 14, 96, 216),
        (3, 128, 7, 192, 432), (3, 64, 56, 24, 54), (3, 17, 28, 48, 108),
        (3, 17, 14, 96, 216), (3, 17, 7, 192, 432), (8, 64, 56, 24, 54),
        (8, 64, 28, 48, 108), (8, 64, 14, 96, 216), (8, 64, 7, 192, 432)]
# (B, T, H, W, C_in, C_mid); the last two: the fine tower's layer3 and
# layer4 at a 64² crop (chip_smoke.py's small request), where f32 needs more
# channel groups for its shared memory
RAGGED = [(1, 3, 7, 6, 16, 12), (2, 5, 5, 9, 8, 13), (2, 17, 7, 7, 24, 54),
          (1, 3, 4, 300, 8, 6), (3, 1, 1, 1, 8, 1), (2, 9, 9, 9, 16, 7),
          (1, 32, 4, 4, 96, 216), (1, 32, 2, 2, 192, 432)]
SHAPES = [(b, tt, h, h, ci, cm) for b, tt, h, ci, cm in PATH] + RAGGED


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_plan_covers_every_output_once(shape, esz):
    """One block per (item, channel group) adds one to each output position
    it owns: all of y is owned exactly once.  Rows and columns are
    ``plan_s1``'s, and its channel pairs unless the shared memory needs more
    groups (then the fewest that fit); the frame segments minimise the
    modelled rounds × frames."""
    b, tt, h, w, c_in, c = shape
    p = plan_mm_s1(b, tt, h, w, c_in, c, esz)
    base = plan_s1(b, tt, h, w, c)
    assert (p.r, p.wb) == (base.r, base.wb) and p.pg <= base.pg
    assert smem_mm_s1(p, c_in, esz) <= SMEM_MAX
    if p.pg < base.pg:  # one group fewer would not fit
        wider = p._replace(pg=-(-(-(-c // 2)) // (p.n_pg - 1)))
        assert smem_mm_s1(wider, c_in, esz) > SMEM_MAX
    assert RMIN <= p.r <= RMAX and p.wb * p.pg <= NT_MAX
    assert p.threads <= NT_MAX and 1 <= p.tt <= tt

    def cost(seg):
        blocks = p._replace(tt=seg).items * p.n_pg
        return -(-blocks // (2 * SMS)) * (seg + 2 + MM_SETUP_FRAMES)
    assert cost(p.tt) == min(cost(-(-tt // n)) for n in range(1, tt + 1))
    count = np.zeros((b, tt, h, w, 2 * p.n_pg * p.pg), np.uint8)
    for item in range(p.items):
        for g in range(p.n_pg):
            bi, (t0, t1), (h0, h1), (w0, w1), (c0, c1) = p.tile(item, g)
            assert t0 < t1 and h0 < h1 and w0 < w1
            count[bi, t0:t1, h0:h1, w0:w1, c0:c1] += 1
    assert (count[..., :c] == 1).all()
    assert not count[..., c:].any()


def test_width_split_into_column_tiles():
    p = plan_mm_s1(1, 3, 4, 300, 8, 6, 2)
    assert p.n_wt == 2 and p.wb == 150


def test_f32_at_narrow_frames_takes_more_channel_groups():
    """At layer4 of a 64² crop (2×2, C_in 192) one group of 216 pairs would
    stage W1's columns in 166 KB of f32 alone: the f32 plan splits them,
    the bf16 plan keeps ``plan_s1``'s."""
    base = plan_s1(1, 32, 2, 2, 432)
    assert plan_mm_s1(1, 32, 2, 2, 192, 432, 2).pg == base.pg
    assert plan_mm_s1(1, 32, 2, 2, 192, 432, 4).pg < base.pg


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


@pytest.mark.parametrize("shape,c_mid", [((1, 3, 8, 7, 16), 12),
                                         ((1, 3, 8, 9, 8), 7),
                                         ((2, 3, 4, 5, 24), 54)])
def test_plain_matches_pallas_interpret(shape, c_mid):
    """K1 ``mm``'s plain version against the Pallas kernel in interpret
    mode at odd W, C_mid = 12 and odd C_mid."""
    x, w1, k, sc, bi = _inputs(shape, c_mid, seed=sum(shape) + c_mid)
    c_in = shape[-1]
    p = fold_pad(c_mid)
    y = fold_dw_mm_bnrelu_conv3d(
        to_fold4(jnp.asarray(x)),
        fold_pointwise_kernel(jnp.asarray(w1).reshape(1, 1, 1, c_in, c_mid),
                              c_in, c_mid),
        jnp.asarray(k).reshape(3, 3, 3, 1, c_mid),
        pad_vec(jnp.asarray(sc), c_mid, p), pad_vec(jnp.asarray(bi), c_mid, p),
        c_mid, 1, impl="interpret")
    ref = np.asarray(from_fold4(y, c_mid))
    got = dw_mm_bnrelu_conv3d_plain(t(x), t(w1), t(k), t(sc), t(bi), 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_and_mask_take_one_relu_branch(stride, dtype):
    """With only the centre tap set to 1 the forward's y is the activation
    itself, so ``y > 0`` is its relu branch; the masked dx of ``g = 1`` is
    the mask where g reaches (every position at stride 1, the even ones at
    stride 2): the plain versions agree element for element, as
    ``chip_smoke.py`` holds the kernels."""
    x, w1, _, sc, bi = _inputs((2, 4, 9, 7, 16), 20, seed=11 + stride)
    x, w1 = t(x).to(dtype), t(w1).to(dtype)
    taps = torch.zeros((3, 3, 3, 20), dtype=dtype)
    taps[1, 1, 1] = 1
    y = dw_mm_bnrelu_conv3d_plain(x, w1, taps, t(sc), t(bi), stride)
    dam = dw_mm_dx_mask_plain(torch.ones_like(y), x, w1, taps, t(sc), t(bi),
                              stride)
    keep = dam[:, :, ::stride, ::stride] != 0
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(keep, y > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_cpu_takes_plain_and_counts_nothing(dtype):
    dw_mm_act.reset_launches()
    x, w1, k, sc, bi = _inputs((1, 3, 7, 6, 16), 12, seed=4)
    args = (t(x).to(dtype), t(w1).to(dtype), t(k).to(dtype), t(sc), t(bi), 1)
    assert torch.equal(dw_mm_bnrelu_conv3d(*args),
                       dw_mm_bnrelu_conv3d_plain(*args))
    assert not any(dw_mm_act.LAUNCHES.values())


@pytest.mark.parametrize("name", ["dw_mm_act_s1", "dw_mm_act_s1_occupancy"])
def test_binding_matches_the_c_declaration(name):
    """A pointer for each ``void*``, an int for each ``int``, in order: a
    wrong count makes ctypes pass the stream as a 32-bit int."""
    src = dw_mm_act.LIBRARY.source.read_text()
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src)
    assert m, name
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in (q.strip() for q in m.group(1).split(","))]
    assert dw_mm_act.LIBRARY.functions[name] == want


def test_the_product_on_the_tensor_cores_settles_its_relu_branch():
    """The stride-1 forward's bf16 product runs on mma and sends the relu
    inputs within ``mm_band`` of 0 to the sum in order, ``mm_z_fmaf``,
    whose branch every mm kernel takes: the
    pieces are in the shared header, the product that uses them in
    ``mm_strip.cuh``, and the forward, the stride-1 masked dx and the
    stride-1 mm weight gradient all call that product (the forward and the
    weight gradient through ``mm_activate``, which stores its relu, the
    masked dx through ``mm_masks``, which stores its branch)."""
    csrc = dw_mm_act.LIBRARY.source.parent
    common = (csrc / "common.cuh").read_text()
    product = (csrc / "mm_strip.cuh").read_text()
    src = dw_mm_act.LIBRARY.source.read_text()
    dx = dw_mm_act.DX_S1_LIBRARY.source.read_text()
    wg = (csrc / "dw_plain_s1.cu").read_text()
    for name in ("mm_ksteps_bf16", "mm_band", "mm_z_fmaf", "mma.sync"):
        assert name in common
    for name in ("mm_ksteps_bf16(", "mm_z_fmaf(", "mm_strip_product("):
        assert name in product
    act = product[product.index("void mm_activate("):]
    assert "mm_strip_product<T>(" in act
    masks = product[product.index("void mm_masks("):]
    assert "mm_strip_product<T>(" in masks and "mm_band(" in masks
    for name in ("mm_activate<T>(", "mm_band(", "mm_fwd_s1_kernel"):
        assert name in src
    for name in ("mm_masks<T>(", "mm_dx_s1_kernel"):
        assert name in dx
    for name in ("mm_activate<T>(", "mm_band(", "mm_wgrad_s1_kernel"):
        assert name in wg
