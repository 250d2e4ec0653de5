"""The stride-2 plain weight gradient of the split-batch-norm route
(``dw_conv_wgrad_s2``, K10 plain, in ``csrc/dw_plain_s2.cu``): the work
split its wrapper computes, the wrapper's CPU route, the binding and the
source.  The kernel itself runs only on the card, where ``chip_smoke.py``
holds it against its plain version and against itself run again (bit for
bit).

* ``plan_s2`` covers every (sample, frame, output row, output column,
  channel) of g exactly once at the fine tower's four stride-2 entries of
  long-cycle phases A-C and at ragged ones (odd H and W, 7×7 → 4×4, C = 12,
  odd C, an output width split into column tiles, a one-column frame of 512
  channels whose f32 shared memory needs more channel groups), within the
  kernel's limits and its shared memory, and gives the partial buffer's row
  count.
* The plain version at ragged shapes is held against the JAX Pallas kernel
  in interpret mode (``_wgrad_s2_raw``, which takes H a multiple of 8 and
  an even W: C = 12 and odd C) and, at odd H and W, against ``jax.grad`` of
  XLA's grouped conv, at 1e-4 (f32 sums of up to 2·3·5·5 positions in
  another order).
* The wrapper takes the plain version on the CPU and counts no launch.
* The binding's ``ctypes`` argument types match the C declarations.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from coarse_fine_networks_tpu.ops.fold import FOLD, fold_pad, to_fold4
from coarse_fine_networks_tpu.ops.pallas.dw_fold import _wgrad_s2_raw
from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_conv import (
    NT_MAX, RMAX, RMIN, SMEM_MAX, TT_MIN, WG_BLOCKS, dw_conv_wgrad,
    dw_conv_wgrad_plain, plan_s2, smem_s2)

from _torch_port_util import t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, T, H, C) of x at the fine tower's stride-2 entries (layer1.0 ..
# layer4.0) at long-cycle phases A (B64 T16 112²), B (B32 T32 144²) and C
# (B16 T32 224²)
PATH = [(64, 16, 56, 54), (64, 16, 28, 108), (64, 16, 14, 216),
        (64, 16, 7, 432), (32, 32, 72, 54), (32, 32, 36, 108),
        (32, 32, 18, 216), (32, 32, 9, 432), (16, 32, 112, 54),
        (16, 32, 56, 108), (16, 32, 28, 216), (16, 32, 14, 432)]
RAGGED = [(2, 5, 9, 13, 12), (1, 3, 7, 7, 54), (2, 9, 9, 9, 7),
          (1, 3, 5, 600, 6), (3, 1, 1, 1, 1), (1, 17, 8, 7, 13),
          (1, 2, 8, 1, 512)]
SHAPES = [(b, tt, h, h, c) for b, tt, h, c in PATH] + RAGGED


def _out(h):
    return (h - 1) // 2 + 1


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_plan_covers_every_output_once(shape):
    """Every item of every block row and channel group, clipped to g, adds
    one to each output position it owns: all of g is owned exactly once.
    ``rows`` blocks per group walk ``ipb`` consecutive items each, and every
    block has at least one."""
    b, tt, h, w, c = shape
    p = plan_s2(*shape)
    ho, wo = _out(h), _out(w)
    assert (p.h, p.w) == (ho, wo)  # the split is over the output
    p2 = -(-c // 2)
    assert RMIN <= p.r <= RMAX and p.wb * p.pg <= NT_MAX
    assert p.threads <= NT_MAX and p.pg <= p2
    # plan_s1's rule for the pairs, unless the f32 shared memory of either
    # weight gradient (the act mode's ring is the larger) would not fit:
    # then the fewest groups that do
    rule = -(-p2 // -(-p2 // max(1, NT_MAX // p.wb)))
    assert p.pg <= rule
    if p.pg < rule:
        assert smem_s2(p._replace(pg=-(-p2 // (p.n_pg - 1))), 4,
                       True) > SMEM_MAX
    assert p.wb <= wo and (p.wb >= 2 or wo == 1)
    assert p.items == b * p.n_tseg * p.n_strip * p.n_wt
    assert p.rows * p.ipb >= p.items > (p.rows - 1) * p.ipb
    if p.items * p.n_pg >= WG_BLOCKS:
        assert p.rows * p.n_pg <= WG_BLOCKS
    # frames: the whole clip unless that gives under two blocks per SM,
    # never split below TT_MIN
    assert p.tt == tt or (p.tt >= min(TT_MIN, tt) and
                          p._replace(tt=2 * p.tt).items * p.n_pg
                          < WG_BLOCKS)
    for esz in (2, 4):
        assert smem_s2(p, esz) <= smem_s2(p, esz, True) <= SMEM_MAX
    count = np.zeros((b, tt, ho, wo, 2 * p.n_pg * p.pg), np.uint8)
    for row in range(p.rows):
        for item in range(row * p.ipb, min((row + 1) * p.ipb, p.items)):
            for g in range(p.n_pg):
                bi, (t0, t1), (h0, h1), (w0, w1), (c0, c1) = p.tile(item, g)
                assert t0 < t1 and h0 < h1 and w0 < w1
                count[bi, t0:t1, h0:h1, w0:w1, c0:c1] += 1
    assert (count[..., :c] == 1).all()
    assert not count[..., c:].any()


def test_width_split_into_column_tiles():
    """An output wider than 256 columns is split into equal column tiles."""
    p = plan_s2(1, 3, 5, 600, 6)
    assert p.n_wt == 2 and p.wb == 150


def test_wide_channels_split_for_shared_memory():
    """One group of 256 pairs at one column and four rows would stage 245
    KB of f32: the plan takes two groups."""
    p = plan_s2(1, 2, 8, 1, 512)
    assert (p.r, p.wb, p.n_pg) == (4, 1, 2)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    b, tt, h, w, c = shape
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    g = rng.randn(b, tt, _out(h), _out(w), c).astype(np.float32)
    return x, g


@pytest.mark.parametrize("shape", [(1, 3, 8, 8, 12), (2, 3, 8, 6, 7),
                                   (1, 2, 8, 10, 54)])
def test_plain_matches_pallas_interpret(shape):
    """K10 plain's plain version against the Pallas kernel itself, run in
    interpret mode (its per-lane sums folded back to channels), at C = 12
    and odd C."""
    x, g = _inputs(shape, seed=sum(shape))
    c = shape[-1]
    dk = np.asarray(_wgrad_s2_raw(to_fold4(jnp.asarray(x)),
                                  to_fold4(jnp.asarray(g), fold_pad(c)),
                                  True))
    ref = dk.reshape(27, FOLD, -1).sum(1)[:, :c]
    got = dw_conv_wgrad_plain(t(x), t(g), 2)
    assert got.shape == (27, c)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("shape", [(1, 3, 7, 7, 54), (2, 3, 9, 5, 13)])
def test_plain_matches_jax_grad_at_odd_sizes(shape):
    """At odd H and W (7×7 → 4×4, 9×5 → 5×3, which the fold4 kernel does
    not take) against ``jax.grad`` of XLA's grouped conv at stride
    (1, 2, 2)."""
    x, g = _inputs(shape, seed=sum(shape) + 1)

    def loss(k):
        y = lax.conv_general_dilated(
            jnp.asarray(x), k.reshape(3, 3, 3, 1, -1), (1, 2, 2),
            [(1, 1)] * 3, dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            feature_group_count=x.shape[-1], precision=lax.Precision.HIGHEST)
        return jnp.sum(y * g)
    ref = jax.grad(loss)(jnp.zeros((3, 3, 3, x.shape[-1]), jnp.float32))
    got = dw_conv_wgrad_plain(t(x), t(g), 2)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).reshape(27, -1), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_cpu_takes_plain_and_counts_nothing(dtype):
    dw_conv.reset_launches()
    for shape in [(1, 3, 7, 6, 12), (2, 3, 5, 9, 13)]:
        x, g = (t(a).to(dtype) for a in _inputs(shape, seed=3))
        assert torch.equal(dw_conv_wgrad(x, g, 2),
                           dw_conv_wgrad_plain(x, g, 2))
    assert not any(dw_conv.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(dw_conv.LIBRARY_S2.functions))
def test_binding_matches_the_c_declaration(name):
    """A pointer for each ``void*``, an int for each ``int``, in order."""
    src = dw_conv.LIBRARY_S2.source.read_text()
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src)
    assert m, name
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in (q.strip() for q in m.group(1).split(","))]
    assert dw_conv.LIBRARY_S2.functions[name] == want
