"""The depthwise 3³ conv at stride (2, 2, 2) (``FineNet``'s
``t_downsample``) in the port against the JAX package's ``_lax_conv`` and
its VJP on the CPU, f32, within 1e-5 of the largest magnitude (sums in
another order): the three plain versions (``dw_conv3d_plain`` at ``T2``,
``dw_conv_dx_t2_plain``, ``dw_conv_wgrad_plain`` at ``T2``) and
``DwConv3d`` at even and odd T, H and W, and with a NaN of x on the first
frame, the last frame, the last row, the last column and inside (fault
3.4's positions): the taps' gradient has NaN exactly where JAX's has.
Also a model of the three kernels' temporal walks (``csrc/dw_plain_s2.cu``
with ``ST = 2``: the forward's two-frame register ring, the dx's two dx
frames a g frame, the weight gradient's pairs under ``wgrad_slots_t2``)
against the definition at every clip length and segment, their work
splits covering every output once, and the wrappers' strides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.pallas.dw_conv import _lax_conv
from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_conv import T2

torch.set_num_threads(2)
TOL = 1e-5
C = 6
SHAPES = [(8, 8, 8), (7, 9, 5), (4, 6, 7), (5, 3, 2), (1, 1, 1)]
NANS = {"first_frame": lambda t, h, w: (0, h // 2, w // 2),
        "last_frame": lambda t, h, w: (t - 1, h // 2, w // 2),
        "last_row": lambda t, h, w: (t // 2, h - 1, w // 2),
        "last_column": lambda t, h, w: (t // 2, h // 2, w - 1),
        "inside": lambda t, h, w: (t // 2, h // 2, w // 2)}


def _inputs(shape, seed, nan=None):
    t, h, w = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(2, t, h, w, C).astype(np.float32)
    if nan is not None:
        x[(1,) + NANS[nan](t, h, w) + (2,)] = np.nan
    k = (rng.randn(3, 3, 3, C) / 5).astype(np.float32)
    to, ho, wo = ((n - 1) // 2 + 1 for n in shape)
    g = rng.randn(2, to, ho, wo, C).astype(np.float32)
    return x, k, g


def _jax(x, k, g):
    """y, dx and the taps' gradient of JAX's ``_lax_conv`` at (2, 2, 2)."""
    y, vjp = jax.vjp(lambda a, b: _lax_conv(a, b[..., None, :], (2, 2, 2)),
                     jnp.asarray(x), jnp.asarray(k))
    dx, dk = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dk)


def _close(got, ref, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan), name
    err = np.abs(got[~nan] - ref[~nan]).max(initial=0.0)
    assert err <= TOL * max(1.0, np.abs(ref[~nan]).max(initial=0.0)), (name,
                                                                       err)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_lax_conv(shape):
    x, k, g = _inputs(shape, sum(shape))
    y, dx, dk = _jax(x, k, g)
    xt, kt, gt = map(torch.from_numpy, (x, k, g))
    _close(dw_conv.dw_conv3d_plain(xt, kt, T2), y, "y")
    _close(dw_conv.dw_conv3d(xt, kt, (2, 2, 2)), y, "y (wrapper)")
    _close(dw_conv.dw_conv_dx_t2_plain(gt, kt, shape), dx, "dx")
    _close(dw_conv.dw_conv_dx_t2(gt, kt, shape), dx, "dx (wrapper)")
    _close(dw_conv.dw_conv_wgrad_plain(xt, gt, T2).reshape(k.shape), dk,
           "dk")
    _close(dw_conv.dw_conv_wgrad(xt, gt, T2).reshape(k.shape), dk,
           "dk (wrapper)")


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_function_matches_lax_conv_vjp(shape):
    x, k, g = _inputs(shape, 2 * sum(shape))
    y, dx, dk = _jax(x, k, g)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    yt = dw_conv.dw_conv3d_train(xt, kt, T2)
    yt.backward(torch.from_numpy(g))
    _close(yt, y, "y")
    _close(xt.grad, dx, "dx")
    _close(kt.grad, dk, "dk")


@pytest.mark.parametrize("nan", sorted(NANS))
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_nan_of_x_reaches_the_taps_it_reaches_in_jax(shape, nan):
    """Fault 3.4's positions: a NaN of x reaches exactly the taps XLA's
    weight gradient gives NaN, and y where JAX's y is NaN."""
    x, k, g = _inputs(shape, 3 * sum(shape), nan)
    y, _, dk = _jax(x, k, g)
    assert np.isnan(dk).any()
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    _close(dw_conv.dw_conv3d_plain(xt, torch.from_numpy(k), T2), y, "y")
    _close(dw_conv.dw_conv_wgrad_plain(xt, gt, T2).reshape(k.shape), dk,
           "dk")


# ---- the kernels' temporal walks (csrc/dw_plain_s2.cu, ST = 2) -----------------

def _fwd_walk(t0, t1, tn):
    """s2_fwd_body<ST = 2>: output frame -> its (dt, input frame) terms in
    the order the register ring adds them."""
    out, acc = {}, [[], []]
    f0, nf = 2 * t0 - 1, 2 * (t1 - t0 - 1) + 3
    for i in range(nf):
        ti, odd = f0 + i, i & 1
        if 0 <= ti < tn:
            for j in range(3):  # s2_frame's taps dt = 2 - j
                if (j == 1) == bool(odd):
                    acc[j >> 1].append((2 - j, ti))
        if not odd:
            to = t0 + i // 2 - 1
            if to >= t0:
                out[to] = acc[0]
            acc = [acc[1], []]
    return out


def _dx_walk(t0, t1, tn, tg):
    """dx_s2_body<ST = 2>: dx frame -> its (dt, g frame) terms in order."""
    out = {}
    for o in range(t0, t1):
        for e in range(2):
            if 2 * o + e >= tn:
                break
            out[2 * o + e] = [(1 if e == 0 else 2 - 2 * f, o + f)
                              for f in range(2)
                              if not (e == 0 and f == 1)
                              and not (f == 1 and o + 1 >= tg)]
    return out


def _wgrad_walk(t0, t1, tn):
    """s2_wgrad_body<ST = 2>: the (x frame, dt, g frame) products, in order,
    with the ring's g frames and ``wgrad_slots_t2``'s admission."""
    pairs, gr = [], [None, None]
    f0, nf = 2 * t0 - 1, 2 * (t1 - t0) + 1
    for i in range(nf):
        ti, odd = f0 + i, i & 1
        if not odd:
            tg = t0 + i // 2
            gr = [gr[1], tg if tg < t1 else None]
        if 0 <= ti < tn:
            slots = 2 if odd else ((i >= 2) | (4 if i < nf - 1 else 0))
            for j in range(3):
                if (slots >> j) & 1:
                    pairs.append((ti, 2 - j, gr[0 if j == 0 else 1]))
    return pairs


@pytest.mark.parametrize("tn", range(1, 20))
def test_kernel_walks_match_the_definition(tn):
    to = (tn - 1) // 2 + 1
    for tt in range(1, to + 1):
        segs = [(s, min(s + tt, to)) for s in range(0, to, tt)]
        fwd, dx, pairs = {}, {}, []
        for s in segs:
            fwd.update(_fwd_walk(*s, tn))
            dx.update(_dx_walk(*s, tn, to))
            pairs += _wgrad_walk(*s, tn)
        # every output frame once, its taps in order dt = 0, 1, 2
        assert fwd == {o: [(dt, 2 * o + dt - 1) for dt in range(3)
                           if 0 <= 2 * o + dt - 1 < tn] for o in range(to)}
        # every dx frame once, its g frames ascending (K8's order)
        assert dx == {f: sorted([(dt, o) for o in range(to) for dt in range(3)
                                 if 2 * o + dt - 1 == f], key=lambda p: p[1])
                      for f in range(tn)}
        # every (x frame, tap, g frame) product once and no other: a NaN of
        # x reaches the taps it reaches in the plain version
        assert sorted(pairs) == sorted(
            (2 * o + dt - 1, dt, o) for o in range(to) for dt in range(3)
            if 0 <= 2 * o + dt - 1 < tn)


def test_the_source_has_the_walks():
    src = (dw_conv.LIBRARY_S2.source).read_text()
    for name in ("plain_t2_fwd_kernel", "plain_t2_dx_kernel",
                 "plain_t2_wgrad_kernel", 'extern "C" int dw_conv_t2(',
                 'extern "C" int dw_conv_dx_t2(',
                 'extern "C" int dw_conv_wgrad_t2('):
        assert name in src, name
    assert ("if (i & 1) return 2u;\n"
            "  return (i >= 2 ? 1u : 0u) | (i < nf - 1 ? 4u : 0u);") in src
    assert "constexpr int GSTAGE_T2 = 4;" in src
    assert dw_conv.GSTAGE_T2 == 4


# ---- the work splits and the wrappers -------------------------------------------

# the four t_downsample entries of FineNet at B32 T16 224² and B64 T16 112²,
# and ragged ones
PLAN_SHAPES = [(32, 16, 112, 112, 54), (32, 8, 56, 56, 108),
               (32, 4, 28, 28, 216), (32, 2, 14, 14, 432),
               (64, 16, 56, 56, 54), (64, 8, 28, 28, 108),
               (64, 4, 14, 14, 216), (64, 2, 7, 7, 432),
               (3, 9, 13, 11, 30), (2, 5, 9, 7, 7), (1, 1, 3, 3, 2)]


def _covers(p, t, h, w, c):
    """Every (sample, frame, row, column, channel) of ``(B, t, h, w, c)``
    in exactly one tile of plan ``p``."""
    seen = np.zeros((p.b, t, h, w, c), np.int32)
    for item in range(p.items):
        for pg in range(p.n_pg):
            b, (t0, t1), (h0, h1), (w0, w1), (c0, c1) = p.tile(item, pg)
            seen[b, t0:t1, h0:h1, w0:w1, c0:c1] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plans_cover_the_output(shape):
    b, t, h, w, c = shape
    to, ho, wo = (t - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    for plan in (dw_conv.plan_t2_fwd, dw_conv.plan_t2_dx, dw_conv.plan_t2):
        p = plan(*shape)
        assert (p.t, p.h, p.w, p.c) == (to, ho, wo, c)
        assert p.wb * p.pg <= dw_conv.NT_MAX
        assert _covers(p, to, ho, wo, c), plan.__name__
    assert dw_conv.smem_s2_fwd(dw_conv.plan_t2_fwd(*shape),
                               4) <= dw_conv.SMEM_MAX
    assert dw_conv.smem_t2_dx(dw_conv.plan_t2_dx(*shape), 4) <= dw_conv.SMEM_MAX
    p = dw_conv.plan_t2(*shape)
    assert dw_conv.smem_s2(p, 4) <= dw_conv.SMEM_MAX
    # the persistent grid: every block has an item, the blocks cover all
    assert p.rows * p.ipb >= p.items > (p.rows - 1) * p.ipb
    # K10 plain's items for g at the even frames of a zero tensor of t
    # frames, where its segments are even or span the clip
    q = dw_conv.plan_s2(*shape)
    if q.tt % 2 == 0 or q.tt >= t:
        assert (p.items, p.ipb, p.rows) == (q.items, q.ipb, q.rows)


def test_wrappers_take_t2_and_refuse_other_strides():
    x = torch.zeros(1, 4, 5, 5, 6)
    k = torch.zeros(3, 3, 3, 6)
    assert dw_conv.dw_conv3d(x, k, T2).shape == (1, 2, 3, 3, 6)
    assert dw_conv.dw_conv3d(x, k, (1, 2, 2)).shape == (1, 4, 3, 3, 6)
    for stride in ((2, 1, 1), (2, 2, 1), 3, (1, 3, 3)):
        with pytest.raises(ValueError):
            dw_conv.dw_conv3d(x, k, stride)
    with pytest.raises(ValueError):  # g of another stride
        dw_conv.dw_conv_dx_t2(torch.zeros(1, 4, 3, 3, 6), k, (4, 5, 5))
    with pytest.raises(ValueError):
        dw_conv.dw_conv_wgrad(x, torch.zeros(1, 4, 3, 3, 6), T2)
    assert set(dw_conv.LAUNCHES) >= {"dw_conv_t2", "dw_conv_dx_t2",
                                     "dw_conv_wgrad_t2"}
