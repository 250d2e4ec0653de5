"""The port's plain-layout depthwise conv (``ops/dw_stencil.py``): the plain
versions of K11 (``dw_stencil_s1``), K7 (``dw_stencil_s2``) and the taps'
gradient (``dw_stencil_wgrad``), the autograd Function and dispatcher built
on them, and the stem that runs ``conv1_t`` through them.

The plain versions are held against the JAX Pallas kernels themselves, run
on the CPU in interpret mode as ``tests/test_dw_conv.py`` and
``tests/test_dw_fold.py`` run them: K11 (``_dw_pallas``, untiled and tiled),
its custom VJP, and K7 (``_dw_fold4_s2_raw`` through ``to_fold4``); the
dispatcher at stride (1, 2, 2) and the stem against XLA's conv
(``impl="lax"``) and ``jax.grad``.  The CUDA kernels only run on the card:
``chip_smoke.py`` holds them against these plain versions there.

All f32.  Tolerances: the JAX tests' own for K11 and its VJP (1e-4 relative
and 1e-5 absolute on y and dx, 1e-3 on the taps' gradient, a sum over up to
2·6·8·12 positions); K7 1e-5 of the largest value (27 taps summed in
another order); the dispatcher and the stem 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import coarse_fine_networks_tpu.ops.pallas.dw_conv as dwc
from coarse_fine_networks_tpu.models import x3d as jx3d
from coarse_fine_networks_tpu.ops.fold import fold_pad, from_fold4, to_fold4
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (_dw_fold4_s2_raw,
                                                          _prep_lane_weights)
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.models import X3DStem
from coarse_fine_networks_torch.ops import dw_conv, dw_stencil
from coarse_fine_networks_torch.ops.dw_conv import dw_conv3d_plain
from coarse_fine_networks_torch.ops.dw_stencil import (
    DwStencil3d, depthwise_conv3d, dw_stencil3d, dw_stencil3d_plain,
    dw_stencil_wgrad, dw_stencil_wgrad_plain)

from _torch_port_util import apply_train, jax_variables, load_port, nest, t

torch.set_num_threads(2)

K11 = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _taps(w):
    """JAX taps ``(KT, KH, KW, 1, C)`` → the port's ``(KT, KH, KW, C)``."""
    return t(np.asarray(w)[..., 0, :])


@pytest.mark.parametrize("ks", [(5, 1, 1), (3, 3, 3), (3, 1, 1)])
def test_k11_plain_matches_pallas(ks):
    """K11's plain version against ``_dw_pallas`` in interpret mode."""
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.rand(2, 8, 8, 12, 6), jnp.float32)
    w = jnp.asarray(rng.rand(*ks, 1, 6), jnp.float32)
    ref = dwc._dw_pallas(x, w, True)
    got = dw_stencil3d_plain(t(x), _taps(w))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **K11)


@pytest.mark.parametrize("ks", [(5, 1, 1), (3, 3, 3)])
def test_k11_plain_matches_pallas_tiled(ks, monkeypatch):
    """The same against the Pallas kernel over 4×4 (T, H) tiles with
    materialised halos, as ``test_pallas_tiled_matches_lax`` runs it."""
    monkeypatch.setattr(dwc, "_pick_tiles", lambda *a: (4, 4))
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.rand(2, 12, 8, 12, 6), jnp.float32)
    w = jnp.asarray(rng.rand(*ks, 1, 6), jnp.float32)
    ref = dwc._dw_pallas(x, w, True)
    np.testing.assert_allclose(dw_stencil3d_plain(t(x), _taps(w)).numpy(),
                               np.asarray(ref), **K11)


@pytest.mark.parametrize("ks", [(5, 1, 1), (3, 3, 3), (1, 3, 3)])
def test_function_matches_pallas_vjp(ks):
    """``DwStencil3d``'s dx (K11 on the flipped taps) and taps' gradient
    against ``jax.grad`` of ``_dw_pallas`` (its custom VJP ``_dw_bwd``)."""
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.rand(2, 6, 8, 12, 6), jnp.float32)
    w = jnp.asarray(rng.rand(*ks, 1, 6), jnp.float32)
    g = jnp.asarray(rng.rand(2, 6, 8, 12, 6), jnp.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(dwc._dw_pallas(a, b, True) * g),
                      argnums=(0, 1))(x, w)
    xt, wt = t(x).requires_grad_(), _taps(w).requires_grad_()
    y = DwStencil3d.apply(xt, wt, (1, 1, 1))
    y.backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **K11)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw)[..., 0, :],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 24), (2, 3, 8, 16, 54)])
def test_k7_plain_matches_pallas(shape):
    """K7's plain version against ``_dw_fold4_s2_raw`` (the stride-1
    stencil over row pairs with the 2×2 subsample fused into the write) in
    interpret mode, through the fold4 layout: 1e-5 of the largest value;
    the wrapper's CPU route, K4 plain's plain version (K7 launches K4
    plain's kernel), likewise, and equal to ``dw_conv3d_plain`` bit for
    bit."""
    rng = np.random.RandomState(4)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, 3, 1, c) / np.sqrt(27)).astype(np.float32)
    lane_w = _prep_lane_weights(jnp.asarray(w), c, fold_pad(c))
    ref = np.asarray(from_fold4(_dw_fold4_s2_raw(to_fold4(jnp.asarray(x)),
                                                 lane_w, True), c))
    got = dw_stencil3d_plain(t(x), t(w[..., 0, :]), (1, 2, 2)).numpy()
    assert got.shape == ref.shape == shape[:2] + (shape[2] // 2,
                                                  shape[3] // 2, c)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # the wrapper's route on the CPU: K4 plain's plain version, bit for bit
    route = dw_stencil3d(t(x), t(w[..., 0, :]), (1, 2, 2))
    assert torch.equal(route, dw_conv3d_plain(t(x), t(w[..., 0, :]), 2))
    np.testing.assert_allclose(route.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (5, 9)])
def test_dispatcher_stride2_matches_lax(hw):
    """Stride (1, 2, 2) through K7 forward and the K8 / K10-plain backward:
    y and both gradients against ``depthwise_conv3d(impl="lax")`` and
    ``jax.grad``, including odd sizes."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, *hw, 20).astype(np.float32)
    w = (rng.randn(3, 3, 3, 1, 20) / 5).astype(np.float32)
    ho, wo = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1
    g = rng.randn(2, 3, ho, wo, 20).astype(np.float32)

    def loss(a, b):
        y = dwc.depthwise_conv3d(a, b, (1, 2, 2), impl="lax")
        return jnp.sum(y * g), y
    (_, y), (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = t(x).requires_grad_(), t(w[..., 0, :]).requires_grad_()
    yt = depthwise_conv3d(xt, wt, (1, 2, 2))
    assert yt.shape == y.shape
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    yt.backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw)[..., 0, :],
                               **TOL)


@pytest.mark.parametrize("strides,ks", [
    ((2, 2, 2), (3, 3, 3)), ((1, 2, 2), (5, 1, 1)), ((1, 1, 1), (4, 1, 1)),
    ((1, 1, 1), (3, 1, 3)), ((1, 1, 1), (9, 1, 1)), ((1, 1, 1), (1, 5, 5))])
def test_dispatcher_raises_off_its_routes(strides, ks):
    """No route for (2, 2, 2) (the JAX package's ``impl="pallas"`` returns
    a stride-1 result there; the port raises), nor for even, unequal or
    larger taps than the kernels take."""
    x = t(_rand((1, 4, 4, 4, 3), 6))
    w = t(_rand(ks + (3,), 7))
    with pytest.raises(ValueError):
        depthwise_conv3d(x, w, strides)
    with pytest.raises(ValueError):
        dw_stencil3d(x, w, strides)


def test_stem_matches_jax_train_forward_and_grads():
    """The port's ``X3DStem`` in training (conv1_t through
    ``depthwise_conv3d``) against JAX ``X3DStem(s2d=False, dw_impl="lax")``
    from the same weights: y, the new split statistics, and the gradients
    of every parameter and of the input, 1e-4."""
    rng = np.random.RandomState(8)
    x = rng.rand(2, 6, 16, 16, 3).astype(np.float32)
    jm = jx3d.X3DStem(24, s2d=False, dw_impl="lax")
    v = jax_variables(jm, jnp.asarray(x), train=False)
    y, stats, vjp = apply_train(jm, v, x)
    g = rng.randn(*y.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(g))
    pm = load_port(X3DStem(24), v, ("stem",)).train()
    xt = t(x).requires_grad_()
    yt = pm(xt)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    yt.backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    ref = state_dict_from_jax(nest({"params": gp}, ("stem",)))
    params = dict(pm.named_parameters())
    assert set(ref) == set(params)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), **TOL,
                                   err_msg=k)
    new = state_dict_from_jax(nest({"params": v["params"],
                                    "batch_stats": stats}, ("stem",)))
    for k in ("bn1.split_bn.running_mean", "bn1.split_bn.running_var"):
        np.testing.assert_allclose(pm.state_dict()[k].numpy(),
                                   new[k].numpy(), **TOL, err_msg=k)


def test_stem_grads_reach_conv1_s_and_conv1_t(monkeypatch):
    """The stem has a backward on the card: with the kernel wrapper
    replaced by one that returns a tensor outside autograd, as a launch on
    the card does, the gradients still reach ``conv1_s`` and ``conv1_t``
    (through ``DwStencil3d``) and equal those of autograd through the
    plain version."""
    torch.manual_seed(0)
    stem = X3DStem(24).train()
    x = torch.randn(2, 6, 16, 16, 3)
    g = torch.randn(2, 6, 8, 8, 24)
    tracked = ("conv1_s.weight", "conv1_t.weight", "bn1.weight", "bn1.bias")

    def grads():
        stem.zero_grad(set_to_none=True)
        stem(x).backward(g)
        params = dict(stem.named_parameters())
        return {k: params[k].grad for k in tracked}

    monkeypatch.setattr("coarse_fine_networks_torch.models.x3d."
                        "depthwise_conv3d",
                        lambda a, w: dw_stencil3d_plain(a, w))  # autograd
    ref = grads()
    monkeypatch.undo()
    # what the wrapper returns on a CPU tensor, now outside autograd
    monkeypatch.setattr("coarse_fine_networks_torch.ops.dw_stencil."
                        "dw_stencil3d_plain",
                        lambda *a: dw_stencil3d_plain(*a).detach())
    got = grads()
    for k in tracked:
        assert got[k] is not None and float(got[k].abs().max()) > 0, k
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **TOL,
                                   err_msg=k)


def test_composite_route_step_reaches_conv1_s(monkeypatch):
    """One coarse train step with every bottleneck through the matmul-fused
    composite (``CFN_MM_BN_TRAIN=1``), the stencil wrapper returning tensors
    outside autograd as a launch on the card does: the stem's ``conv1_t``
    runs its forward and its dx through the stencil (two calls) and its
    taps' gradient once, and ``conv1_s.weight`` gets a nonzero gradient."""
    from coarse_fine_networks_torch.models import CoarseNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState, make_train_step
    from _torch_port_util import COARSE, coarse_batch

    calls = {"fwd": 0, "wgrad": 0}
    plain, wgrad_plain = dw_stencil3d_plain, dw_stencil_wgrad_plain

    def fwd(*a):
        calls["fwd"] += 1
        return plain(*a).detach()

    def wgrad(*a):
        calls["wgrad"] += 1
        return wgrad_plain(*a)

    monkeypatch.setenv("CFN_MM_BN_TRAIN", "1")
    monkeypatch.setattr(dw_stencil, "dw_stencil3d_plain", fwd)
    monkeypatch.setattr(dw_stencil, "dw_stencil_wgrad_plain", wgrad)
    c = COARSE
    model = init_parameters(CoarseNet("M", c["n_classes"], dropout_rate=0.0),
                            torch.Generator().manual_seed(0))
    step = make_train_step(model, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    _, m = step(TrainState.create(model), jax.tree.map(t, coarse_batch(0)),
                c["lr"])
    assert np.isfinite(m["loss"].item())
    assert calls == {"fwd": 2, "wgrad": 1}
    grad = model.conv1_s.weight.grad
    assert grad is not None and float(grad.abs().max()) > 0


@pytest.mark.parametrize("ks", [(5, 1, 1), (3, 3, 3), (7, 3, 3)])
def test_wgrad_plain_against_autograd(ks):
    """``dw_stencil_wgrad_plain`` against autograd through the plain
    forward in float64, up to the kernels' largest tap count (63)."""
    x = _rand((2, 5, 6, 7, 10), 9)
    g = _rand((2, 5, 6, 7, 10), 10)
    w = torch.tensor(_rand(ks + (10,), 11), dtype=torch.float64,
                     requires_grad=True)
    y = dw_stencil3d_plain(torch.tensor(x, dtype=torch.float64), w)
    y.backward(torch.tensor(g, dtype=torch.float64))
    got = dw_stencil_wgrad_plain(t(x), t(g), ks)
    assert got.shape == (int(np.prod(ks)), 10)
    np.testing.assert_allclose(got.numpy(), w.grad.reshape(-1, 10).numpy(),
                               **TOL)


def test_wrappers_cpu_take_plain_and_count_nothing():
    x, g = t(_rand((1, 5, 4, 6, 8), 12)), t(_rand((1, 5, 4, 6, 8), 13))
    w1, w3 = t(_rand((5, 1, 1, 8), 14)), t(_rand((3, 3, 3, 8), 15))
    dw_stencil.reset_launches()
    assert torch.equal(dw_stencil3d(x, w1), dw_stencil3d_plain(x, w1))
    assert torch.equal(dw_stencil3d(x, w3, (1, 2, 2)),
                       dw_conv3d_plain(x, w3, 2))  # K7's: K4 plain's
    assert torch.equal(dw_stencil_wgrad(x, g, (5, 1, 1)),
                       dw_stencil_wgrad_plain(x, g, (5, 1, 1)))
    assert set(dw_stencil.LAUNCHES) == {"dw_stencil_s1", "dw_stencil_s2",
                                        "dw_stencil_wgrad"}
    assert not any(dw_stencil.LAUNCHES.values())


def test_bf16_keeps_dtypes():
    """bf16: y and dx in bf16, the taps' gradient f32 from the wrapper and
    in the taps' dtype from the Function."""
    x = t(_rand((1, 4, 5, 5, 8), 16)).bfloat16()
    w = t(_rand((5, 1, 1, 8), 17)).bfloat16()
    assert dw_stencil3d(x, w).dtype == torch.bfloat16
    assert dw_stencil_wgrad(x, x, (5, 1, 1)).dtype == torch.float32
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    depthwise_conv3d(xr, wr).backward(torch.ones_like(x))
    assert xr.grad.dtype == wr.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["dtype", "w_dtype", "w_channels", "g",
                                 "noncontig", "device"])
def test_wrappers_reject(bad):
    x, g = t(_rand((1, 3, 4, 4, 8), 18)), t(_rand((1, 3, 4, 4, 8), 19))
    w = t(_rand((5, 1, 1, 8), 20))
    if bad == "dtype":
        x, g, w = x.double(), g.double(), w.double()
    elif bad == "w_dtype":
        w = w.bfloat16()
    elif bad == "w_channels":
        w = w[..., :4].contiguous()
    elif bad == "g":
        g = g[:, :, :2].contiguous()
    elif bad == "noncontig":
        x, g = x.transpose(2, 3), g.transpose(2, 3)
    else:  # no kernel and no plain version off the CPU and the card
        x, g, w = (a.to("meta") for a in (x, g, w))
    with pytest.raises((ValueError, TypeError)):
        if bad == "g":
            dw_stencil_wgrad(x, g, (5, 1, 1))
        else:
            dw_stencil3d(x, w)
    if bad not in ("w_dtype", "w_channels"):
        with pytest.raises((ValueError, TypeError)):
            dw_stencil_wgrad(x, g, (5, 1, 1))


def test_kernel_source_ships_every_entry():
    """Each counted entry's C function is in its library's source and
    bound: K7 (``dw_stencil_s2``) launches K4 plain's ``dw_conv_s2``."""
    src = dw_stencil.LIBRARY.source.read_text()
    entries = {name: (dw_stencil.LIBRARY, name) for name in
               list(dw_stencil.LAUNCHES) + ["dw_stencil_partial_rows",
                                            "dw_stencil_s1_occupancy"]}
    entries["dw_stencil_s2"] = (dw_stencil.K7_LIBRARY, dw_stencil.K7_ENTRY)
    assert entries["dw_stencil_s2"] == (dw_conv.LIBRARY_S2, "dw_conv_s2")
    for lib, name in entries.values():
        assert f'extern "C" int {name}(' in lib.source.read_text()
        assert name in lib.functions
    assert 'extern "C" int dw_stencil_s2(' not in src


# ---- the taps' gradient's work split (``wg_plan``, csrc/dw_stencil.cu) ------

def dk_partition_model(x, g, ksize):
    """dk as ``stencil_dk_kernel`` sums it, in f32, with its partition
    (``plan_stencil_wgrad``): each block row walks its items (sample, frame
    segment, pixel range) in order; a thread's sums take its pixel and
    channel vector over the segment's g frames, each against the x frame
    each tap pairs it with (zero-padded); each row adds its ``pp`` pixels
    in order (the block's fixed-order sum); then the rows are added.
    Checks on the way that every (sample, frame, pixel, channel) of g is
    owned by exactly one (item, channel vector) thread."""
    b, t_, h, w, c = x.shape
    kt, ks = ksize[0], ksize[1]
    p = dw_stencil.plan_stencil_wgrad(b, t_, h, w, c, kt, ks)
    owner = torch.zeros((c,), dtype=torch.int64)  # channel vectors
    for cg in range(p.n_cg):
        for jl in range(p.nvb):
            c0 = (cg * p.nvb + jl) * p.v
            owner[c0:min(c0 + p.v, c)] += 1
    assert (owner == 1).all()
    pt, ps = kt // 2, ks // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, ps, ps, ps, ps, pt, pt))
    gf = g.float().reshape(b, t_, h * w, c)
    taps = [(dt, dy, dx) for dt in range(kt) for dy in range(ks)
            for dx in range(ks)]
    owned = torch.zeros((b, t_, h * w), dtype=torch.int64)
    rows = torch.zeros((p.rows, len(taps), c))
    for row in range(p.rows):
        acc = torch.zeros((len(taps), p.pp, c))
        for item in range(row * p.ipb, min((row + 1) * p.ipb, p.items)):
            pr, ts = item % p.npr, item // p.npr % p.n_tseg
            bb = item // p.npr // p.n_tseg
            t0, t1 = ts * p.tt, min(ts * p.tt + p.tt, t_)
            pos = torch.arange(pr * p.pp, min(pr * p.pp + p.pp, h * w))
            hh, ww = pos // w, pos % w
            owned[bb, t0:t1, pos] += 1
            gs = gf[bb, t0:t1, pos]
            for k, (dt, dy, dx) in enumerate(taps):
                xs = xp[bb, t0 + dt:t1 + dt, hh + dy, ww + dx]
                acc[k, :len(pos)] += torch.sum(xs * gs, dim=0)
        for q in range(p.pp):  # the block's fixed-order sum
            rows[row] += acc[:, q]
    assert (owned == 1).all()
    return torch.sum(rows, dim=0), p


# (x shape, taps): the stem's 5×1×1 at C = 24 with split segments and two
# items a block row, a ragged pixel range and a short last segment, C not a
# multiple of the vector; 7×1×1 (vectors of 4); 3×3×3 (vectors of 2) and
# 7×3×3 (vectors of 1, channel-wide blocks of 8 pixels)
DK_CASES = [((8, 16, 40, 40, 24), (5, 1, 1)), ((2, 17, 7, 9, 24), (5, 1, 1)),
            ((2, 9, 6, 6, 13), (5, 1, 1)), ((2, 9, 6, 6, 24), (7, 1, 1)),
            ((2, 5, 6, 7, 10), (3, 3, 3)), ((1, 9, 5, 5, 24), (7, 3, 3))]


@pytest.mark.parametrize("shape,ks", DK_CASES,
                         ids=["x".join(map(str, s)) + "-" + "x".join(
                             map(str, k)) for s, k in DK_CASES])
def test_dk_partition_model_matches_plain(shape, ks):
    """The kernel's partition, summed as it sums, is the plain version's
    taps' gradient within 1e-5 of its largest value (f32 sums in another
    order)."""
    x, g = t(_rand(shape, 21) - 0.5), t(_rand(shape, 22) - 0.5)
    got, p = dk_partition_model(x, g, ks)
    ref = dw_stencil_wgrad_plain(x, g, ks)
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, p)
    if shape == (8, 16, 40, 40, 24):  # segments split, two items a row
        assert p.n_tseg == 2 and p.ipb == 2 and p.rows == 200


def test_dk_plan_keeps_every_lane_busy_at_the_stem():
    """At the stem's C = 24 a thread owns 8 channels (16 bytes of bf16) and
    a block 64 whole pixels, 3 threads each: 192 threads, six full warps;
    the persistent grid has at most ``WG_BLOCKS`` block rows (about two
    blocks per SM) at every path's stem shape, the whole clip a segment."""
    for b, t_, hw in ((8, 64, 112), (64, 16, 56), (32, 32, 72),
                      (16, 32, 112)):
        p = dw_stencil.plan_stencil_wgrad(b, t_, hw, hw, 24, 5, 1)
        assert (p.v, p.nvb, p.n_cg, p.pp, p.threads) == (8, 3, 1, 64, 192)
        assert p.tt == t_ and dw_stencil.WG_BLOCKS // 2 < p.rows
        assert p.rows <= dw_stencil.WG_BLOCKS
        assert p.rows * p.ipb >= p.items > (p.rows - 1) * p.ipb


def test_dk_plan_mirror_matches_the_source():
    """``plan_stencil_wgrad`` mirrors ``wg_plan`` (and ``wg_vec``), which
    sizes ``dw_stencil_partial_rows``' rows and the kernel's launch: the
    same constants, vector rule and steps."""
    import re

    src = dw_stencil.LIBRARY.source.read_text()
    for name in ("WG_THREADS", "WG_BLOCKS", "WG_TT_MIN"):
        m = re.search(r"constexpr int %s = (\d+);" % name, src)
        assert m and int(m.group(1)) == getattr(dw_stencil, name), name
    vec = src[src.index("constexpr int wg_vec("):]
    assert ("return KS == 1 ? (KT <= 5 ? 8 : 4) : (KT <= 3 ? 2 : 1);"
            in vec[:vec.index("\n}\n")])
    for kt in (1, 3, 5, 7):
        for ks in (1, 3):
            want = (8 if kt <= 5 else 4) if ks == 1 else (
                2 if kt <= 3 else 1)
            assert dw_stencil.plan_stencil_wgrad(1, 1, 1, 1, 8, kt,
                                                 ks).v == want
    plan = src[src.index("inline WgPlan wg_plan("):]
    plan = plan[:plan.index("\n}\n")]
    for step in ("const int nv = cdiv(C, wg_vec(KT, KS));",
                 "p.NVB = nv < WG_THREADS ? nv : WG_THREADS;",
                 "p.n_cg = cdiv(nv, p.NVB);",
                 "p.PP = 32 * p.NVB <= WG_THREADS ? WG_THREADS / (32 * p.NVB)"
                 " * 32",
                 ": WG_THREADS / p.NVB;", "p.npr = cdiv(H * W, p.PP);",
                 "p.TT = Tn;",
                 "while (p.TT > WG_TT_MIN && B * cdiv(Tn, p.TT) * p.npr < "
                 "WG_BLOCKS)",
                 "p.TT = cdiv(p.TT, 2) > WG_TT_MIN ? cdiv(p.TT, 2) : "
                 "WG_TT_MIN;",
                 "p.n_tseg = cdiv(Tn, p.TT);",
                 "p.items = B * p.n_tseg * p.npr;",
                 "const int per_cg = WG_BLOCKS / p.n_cg > 1 ? WG_BLOCKS / "
                 "p.n_cg : 1;",
                 "p.ipb = cdiv(p.items, p.items < per_cg ? p.items : per_cg);",
                 "p.rows = cdiv(p.items, p.ipb);"):
        assert step in " ".join(plan.split()), step
    rows = src[src.index('extern "C" int dw_stencil_partial_rows('):]
    assert "return wg_plan(B, T, H, W, C, KT, KS).rows;" in rows[
        :rows.index("\n}\n")]
    kern = src[src.index("stencil_dk_kernel(const T*"):]
    kern = kern[:kern.index("\n}\n")]
    for name in ("copy_vec<T, V>(", "cp_wait<D - 1>();",
                 "if (tg < t0 || tg >= t1) continue;",
                 "row * pl.ipb", "part[((size_t)row * K + k) * C + ch]"):
        assert name in kern, name
    assert "atomic" not in kern
