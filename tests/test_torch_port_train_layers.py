"""Training of the port's layers against the JAX package, on the CPU in
f32, with the same variables (filled from a numpy seed, carried by
``ckpt.from_jax``): ``SubBatchNorm`` in training mode (outputs, the
gradients of the input and the parameters, the new split statistics), the
gradients of the fusion ops, Grid Pool, the losses, SGD with the fusion
group, the schedules, the train step's clip, accumulation and fusion
learning-rate override, and dropout.  The training bottleneck is in
``test_torch_port_train_bottleneck.py``.  Tolerances are stated per
test."""

import types

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import flax.linen as fnn

from coarse_fine_networks_tpu.models import coarse as jcoarse
from coarse_fine_networks_tpu.models import layers as jlayers
from coarse_fine_networks_tpu.models import x3d_fold as jxf
from coarse_fine_networks_tpu.ops import gaussian as jgauss
from coarse_fine_networks_tpu.ops import grid_pool as jgp
from coarse_fine_networks_tpu.ops import resample as jres
from coarse_fine_networks_tpu.ops import reweight as jrw
from coarse_fine_networks_tpu.ops.fold import from_fold4, to_fold4
from coarse_fine_networks_tpu.train import TrainState as JTrainState
from coarse_fine_networks_tpu.train import make_train_step as jmake_step
from coarse_fine_networks_tpu.train import losses as jlosses
from coarse_fine_networks_tpu.train import optim as joptim
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.models import (CoarseNet, GridPool,
                                               SubBatchNorm)
from coarse_fine_networks_torch.models.coarse import grid_unpool_logits
from coarse_fine_networks_torch.models.layers import dropout
from coarse_fine_networks_torch.ops import (cdf_knots, gaussian_alignment,
                                            inverse_cdf, linear_resize,
                                            reweight_aggregate,
                                            temporal_resample)
from coarse_fine_networks_torch.train import (CosineSchedule,
                                              MultiStepSchedule, TrainState,
                                              bce_loss, build_schedule,
                                              detection_loss,
                                              fusion_lr_scale,
                                              make_optimizer,
                                              make_train_step)

from _torch_port_util import jax_variables, load_port, nest, t

torch.set_num_threads(2)


def _close(got, ref, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref), (name, got.shape, np.shape(ref))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol,
                               err_msg=name)


def _apply_train(jm, v, *args):
    """JAX train-mode apply: output, new batch_stats, and a VJP over
    (params, *args)."""
    def f(params, *a):
        return jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        *a, True, mutable=["batch_stats"])
    y, vjp, upd = jax.vjp(f, v["params"], *(jnp.asarray(a) for a in args),
                          has_aux=True)
    return y, upd["batch_stats"], vjp


def _grads_by_name(jgrads, prefix):
    """JAX parameter gradients → port parameter names (under ``prefix``)."""
    sd = state_dict_from_jax(nest({"params": jgrads}, prefix))
    return sd


# ---- SubBatchNorm --------------------------------------------------------------

def _split_moments(x, splits):
    """numpy f32 one-pass moments per split, as the JAX module groups them
    (sample ``i`` in split ``i % splits``)."""
    c = x.shape[-1]
    xg = x.reshape((x.shape[0] // splits, splits, -1, c))
    xg = np.moveaxis(xg, 1, 0).reshape(splits, -1, c)
    n = np.float32(xg.shape[1])
    return xg.sum(1) / n, (xg * xg).sum(1) / n


def _bn_case(splits, clamp, seed):
    rng = np.random.RandomState(seed)
    c = 6
    if clamp:
        # two elements per channel and split, so each f32 sum is a single
        # rounding in either framework; channels 0-2 hold pairs whose
        # one-pass variance E[x²]−E[x]² rounds below 0 (|mean| >> std)
        x = rng.randn(2, 1, 1, splits, c).astype(np.float32)
        pairs = [(1000.5, 1000.5625), (1000.75, 1000.875),
                 (1001.0, 1001.03125)]
        for ch, (a, b) in enumerate(pairs):
            if splits == 1:   # the split's two elements: the two samples
                x[0, ..., ch], x[1, ..., ch] = a, b
            else:             # each sample is a split of two columns
                x[:, 0, 0, 0, ch], x[:, 0, 0, 1, ch] = a, b
    else:
        x = (rng.randn(4, 3, 5, 5, c) * 2 + 1).astype(np.float32)
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": (rng.rand(c) + 0.5).astype(np.float32),
             "split_mean": rng.randn(splits * c).astype(np.float32),
             "split_var": (rng.rand(splits * c) + 0.5).astype(np.float32)}
    params = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32)}
    return x, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("splits,clamp", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_sub_batchnorm_train(splits, clamp):
    """Output, new split statistics and the gradients of x, weight and bias
    against the JAX ``SubBatchNorm``.  Tolerance 1e-5 relative, 1e-4
    absolute (f32 moments in another order; the clamp cases have exact
    sums, and their clamped channels normalise by rsqrt(eps))."""
    x, v = _bn_case(splits, clamp, seed=splits + 2 * clamp)
    c = x.shape[-1]
    if clamp:  # the unclamped one-pass variance is negative there
        m, m2 = _split_moments(x, splits)
        assert (m2 - m * m)[:, :3].max() < 0
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    jm = jlayers.SubBatchNorm(c, splits)
    y, stats, vjp = _apply_train(jm, v, x)
    gp, gx = vjp(jnp.asarray(g))

    pm = load_port(SubBatchNorm(c, splits), v, ("bn1",), "bn1.").train()
    xt = t(x).requires_grad_()
    yt = pm(xt)
    yt.backward(t(g))
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(pm.split_bn.running_mean.numpy(),
                               np.asarray(stats["split_mean"]), **tol)
    np.testing.assert_allclose(pm.split_bn.running_var.numpy(),
                               np.asarray(stats["split_var"]), **tol)
    # bn (the eval statistics) changes only through aggregate_sub_bn_stats
    np.testing.assert_array_equal(pm.bn.running_mean.numpy(),
                                  v["batch_stats"]["mean"])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(pm.weight.grad.numpy(),
                               np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(pm.bias.grad.numpy(), np.asarray(gp["bias"]),
                               **tol)


def test_train_scale_bias_matches_folded_bn():
    """``train_scale_bias`` against the fold-layout bn1's ``scale_bias``
    route (the JAX package's ``FoldedSubBatchNorm``): (sc, bi), their
    gradients through the batch statistics, and the split statistics; with
    ``num_splits > 1`` it raises, as in JAX."""
    x, v = _bn_case(1, False, seed=5)
    x = x[:, :, :4, :4]
    c = x.shape[-1]
    g_sc, g_bi = np.random.RandomState(6).randn(2, c).astype(np.float32)
    jm = jxf.FoldedSubBatchNorm(c)

    def f(params, xf):
        (sc, bi), upd = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xf, True,
            scale_bias=True, mutable=["batch_stats"])
        return (sc[:c], bi[:c]), upd

    (sc, bi), vjp, upd = jax.vjp(f, v["params"], to_fold4(jnp.asarray(x)),
                                 has_aux=True)
    gp, gx = vjp((jnp.asarray(g_sc), jnp.asarray(g_bi)))
    pm = load_port(SubBatchNorm(c), v, ("bn1",), "bn1.").train()
    xt = t(x).requires_grad_()
    sct, bit = pm.train_scale_bias(xt)
    (torch.sum(sct * t(g_sc)) + torch.sum(bit * t(g_bi))).backward()
    tol = 1e-5
    _close(sct, sc, tol, "sc")
    _close(bit, bi, tol, "bi")
    _close(pm.split_bn.running_var, upd["batch_stats"]["split_var"], tol)
    _close(xt.grad, from_fold4(gx, c), tol, "dx")
    _close(pm.weight.grad, gp["scale"], tol, "dweight")
    _close(pm.bias.grad, gp["bias"], tol, "dbias")
    with pytest.raises(ValueError):
        SubBatchNorm(c, 2).train().train_scale_bias(xt)


# ---- the fusion ops' gradients ------------------------------------------------

def _vjp_pair(jfn, tfn, args, cot_seed=0, diff=None):
    """Gradients of ``Σ out · g`` through the JAX and the port function."""
    diff = range(len(args)) if diff is None else diff
    jout = jfn(*[jnp.asarray(a) for a in args])
    g = np.random.RandomState(cot_seed).randn(*jout.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * g), argnums=tuple(diff))(
        *[jnp.asarray(a) for a in args])
    targs = [t(a).requires_grad_() if i in diff else t(a)
             for i, a in enumerate(args)]
    out = tfn(*targs)
    _close(out, jout, 1e-5, "value")
    torch.sum(out * t(g)).backward()
    return [targs[i].grad for i in diff], jg


def test_temporal_resample_grad_at_integer_positions():
    """Positions on the hat's kinks (integers, and ±1 from a frame) take
    JAX's one-sided slope of |r| and the half-split gradient of max(d, 0)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 3, 4).astype(np.float32)
    pos = np.array([[0.0, 1.0, 2.5, 5.0], [0.25, 3.0, 4.0, 4.75]], np.float32)
    got, ref = _vjp_pair(jres.temporal_resample, temporal_resample, [x, pos])
    for a, b in zip(got, ref):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_linear_resize_grad(align_corners):
    x = np.random.RandomState(1).randn(2, 9, 5).astype(np.float32)
    got, ref = _vjp_pair(
        lambda a: jres.linear_resize(a, 32, align_corners=align_corners),
        lambda a: linear_resize(a, 32, align_corners=align_corners), [x])
    _close(got[0], ref[0], 1e-5)


def test_grid_pool_knots_and_inverse_cdf_grads():
    """scores → cdf_knots → inverse_cdf, and Grid Unpool of logits at those
    knots (the learned sampler's whole differentiable path)."""
    rng = np.random.RandomState(2)
    scores = rng.randn(2, 4).astype(np.float32) * 2
    logits = rng.randn(2, 5, 7).astype(np.float32)
    got, ref = _vjp_pair(jgp.cdf_knots, cdf_knots, [scores])
    _close(got[0], ref[0], 1e-5)
    got, ref = _vjp_pair(lambda s: jres.inverse_cdf(jgp.cdf_knots(s)),
                         lambda s: inverse_cdf(cdf_knots(s)), [scores])
    _close(got[0], ref[0], 1e-4)
    got, ref = _vjp_pair(
        lambda lg, s: jcoarse.grid_unpool_logits(lg, jgp.cdf_knots(s)),
        lambda lg, s: grid_unpool_logits(lg, cdf_knots(s)), [logits, scores])
    for a, b in zip(got, ref):
        _close(a, b, 1e-4)


def test_gaussian_alignment_and_reweight_grads():
    rng = np.random.RandomState(3)
    b, tf, tc = 2, 12, 5
    meta = np.array([[0, 16, 12, 1], [2, 16, 9, 1]], np.float32)
    mask = np.ones((b, tf), np.float32)
    mask[1, 9:] = 0
    scores = rng.randn(b, tc - 1).astype(np.float32)
    got, ref = _vjp_pair(
        lambda s: jgauss.gaussian_alignment(jnp.asarray(meta),
                                            jnp.asarray(mask),
                                            jgp.cdf_knots(s), 16),
        lambda s: gaussian_alignment(t(meta), t(mask), cdf_knots(s), 16),
        [scores])
    _close(got[0], ref[0], 1e-4)
    feat = rng.randn(b, tf, 7, 7, 6).astype(np.float32)
    gate = rng.rand(b, tf, 7, 7).astype(np.float32)
    align = rng.rand(b, tf, tc).astype(np.float32)
    got, ref = _vjp_pair(
        lambda f, g_, a: jrw.reweight_aggregate(f, g_, a, jnp.asarray(mask)),
        lambda f, g_, a: reweight_aggregate(f, g_, a, t(mask)),
        [feat, gate, align])
    for a, b_ in zip(got, ref):
        _close(a, b_, 1e-4)


def test_grid_pool_train():
    """Grid Pool in training (its score head's batch norms on batch
    statistics): pooled features, knots, the input and parameter gradients
    and the new split statistics.  Tolerance 1e-4."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 8, 24).astype(np.float32)
    jm = jcoarse.GridPool(24)
    v = jax_variables(jm, jnp.asarray(x), train=False)
    (pooled, knots), stats, vjp = _apply_train(jm, v, x)
    gp_ = rng.randn(*pooled.shape).astype(np.float32)
    gk = rng.randn(*knots.shape).astype(np.float32)
    gpar, gx = vjp((jnp.asarray(gp_), jnp.asarray(gk)))
    pm = load_port(GridPool(24), v, ("pool_1",), "pool_1.").train()
    xt = t(x).requires_grad_()
    pt, kt = pm(xt)
    (torch.sum(pt * t(gp_)) + torch.sum(kt * t(gk))).backward()
    _close(pt, pooled, 1e-4)
    _close(kt, knots, 1e-5)
    _close(xt.grad, gx, 1e-4, "dx")
    names = dict(pm.named_parameters())
    for k, ref in _grads_by_name(gpar, ("pool_1",)).items():
        _close(names[k[len("pool_1."):]].grad, ref.numpy(), 1e-4, k)
    new = state_dict_from_jax(nest({"params": v["params"],
                                    "batch_stats": stats}, ("pool_1",)))
    for k, ref in new.items():
        if "split_bn" in k:
            _close(pm.state_dict()[k[len("pool_1."):]], ref.numpy(), 1e-5, k)


# ---- losses, SGD, schedules --------------------------------------------------

def test_bce_and_detection_loss_values_and_grads():
    """Values and gradients against the JAX losses, including exactly
    saturated probabilities (the -100 clamp's gradient is 0, NaN-free) and
    masked frames.  Tolerance 1e-5."""
    p = np.array([0.0, 1.0, 0.5, 1e-45, 0.3, 0.999], np.float32)
    y = np.array([1.0, 0.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    got, ref = _vjp_pair(jlosses.bce_loss, bce_loss, [p, y], diff=[0])
    assert np.isfinite(got[0].numpy()).all()
    _close(got[0], ref[0], 1e-5)
    rng = np.random.RandomState(5)
    probs = rng.rand(2, 10, 7).astype(np.float32)
    masks = np.ones((2, 10), np.float32)
    masks[1, 7:] = 0
    probs *= masks[:, :, None]
    labels = (rng.rand(2, 10, 7) > 0.7).astype(np.float32)
    jl = jlosses.detection_loss(jnp.asarray(probs), jnp.asarray(labels),
                                jnp.asarray(masks))
    pt = t(probs).requires_grad_()
    tl = detection_loss(pt, t(labels), t(masks))
    for a, b in zip(tl, jl):
        _close(a, b, 1e-5)
    tl[0].backward()
    jg = jax.grad(lambda q: jlosses.detection_loss(
        q, jnp.asarray(labels), jnp.asarray(masks))[0])(jnp.asarray(probs))
    _close(pt.grad, jg, 1e-5)


class _TinyFusion(nn.Module):
    """Parameters named like a fusion layer (``rw``) and like the trunk."""

    def __init__(self):
        super().__init__()
        self.rw_proj = nn.Linear(3, 8)
        self.bn = SubBatchNorm(8)
        self.cls = nn.Linear(8, 5)

    def forward(self, x, feats, feat_mask, meta, generator=None):
        return self.cls(self.bn(self.rw_proj(x)))


class _JTinyFusion(fnn.Module):
    @fnn.compact
    def __call__(self, x, feats, feat_mask, meta, train=True):
        x = fnn.Dense(8, name="rw_proj")(x)
        x = jlayers.SubBatchNorm(8, name="bn")(x, train)
        return fnn.Dense(5, name="cls")(x)


def test_sgd_fusion_group_matches_jax_sgd():
    """Three updates of ``torch.optim.SGD`` (dampening 0) over the two
    groups against ``sgd_update`` with ``fusion_lr_scale``.  1e-6."""
    torch.manual_seed(0)
    m = _TinyFusion()
    opt = make_optimizer(m)
    assert [g["fusion"] for g in opt.param_groups] == [False, True]
    # copies: JAX on the CPU may alias a numpy buffer, which the in-place
    # torch update would then change
    params = {k: jnp.asarray(v.detach().numpy().copy())
              for k, v in m.named_parameters()}
    state = joptim.sgd_init(params)
    scales = {k: joptim.fusion_lr_scale(k) for k in params}
    rng = np.random.RandomState(7)
    for _ in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        for k, p in m.named_parameters():
            p.grad = t(grads[k])
        for g in opt.param_groups:
            g["lr"] = 0.05 * (10.0 if g["fusion"] else 1.0)
        opt.step()
        params, state = joptim.sgd_update(
            params, {k: jnp.asarray(v) for k, v in grads.items()}, state,
            jnp.float32(0.05), lr_scales=scales)
    for k, p in m.named_parameters():
        _close(p, params[k], 1e-6, k)
    assert fusion_lr_scale("rw2.at1.weight") == 10.0
    assert fusion_lr_scale("mix3.conv_at.bias") == 10.0
    assert fusion_lr_scale("layer1.0.conv1.weight") == 1.0


def test_schedules_match_jax():
    def both(**cfg):
        ns = types.SimpleNamespace(**cfg)
        return build_schedule(ns, 7), joptim.build_schedule(ns, 7)

    cfgs = [dict(lr_schedule="multistep", init_lr=0.1, lr_milestones=[2, 4],
                 warmup_steps=10, total_steps=None, max_steps=None,
                 max_epochs=5, cosine_final_lr=0.0),
            dict(lr_schedule="cosine", init_lr=0.1, lr_milestones=[],
                 warmup_steps=5, total_steps=None, max_steps=None,
                 max_epochs=5, cosine_final_lr=0.001),
            dict(lr_schedule="cosine", init_lr=0.1, lr_milestones=[],
                 warmup_steps=0, total_steps=20, max_steps=30,
                 max_epochs=5, cosine_final_lr=0.0)]
    for cfg in cfgs:
        ours, ref = both(**cfg)
        assert type(ours).__name__ == type(ref).__name__
        for epoch in range(6):
            for step in range(0, 40, 3):
                assert ours.lr(step) == pytest.approx(ref.lr(step), rel=1e-12)
                assert ours.in_warmup(step) == ref.in_warmup(step)
            ours.epoch_step()
            ref.epoch_step()
        assert ours.state_dict() == ref.state_dict()
    assert isinstance(MultiStepSchedule(0.1, [1]), MultiStepSchedule)
    assert CosineSchedule(0.1, 10).lr(10) == pytest.approx(0.0)
    with pytest.raises(ValueError):
        build_schedule(types.SimpleNamespace(lr_schedule="step"))


def _tiny_batch(seed, b=4):
    r = np.random.RandomState(seed)
    return {"clips": r.randn(b, 6, 3).astype(np.float32),
            "feats": {"layer1": np.zeros((b, 1), np.float32)},
            "feat_mask": np.ones((b, 1), np.float32),
            "meta": np.zeros((b, 4), np.float32),
            "labels": (r.rand(b, 6, 5) > 0.7).astype(np.float32),
            "masks": np.ones((b, 6), np.float32)}


def _tiny_pair():
    torch.manual_seed(1)
    pm = _TinyFusion()
    def cp(p):  # a copy: the torch step updates p in place
        return p.detach().numpy().copy()

    params = {"rw_proj": {"kernel": cp(pm.rw_proj.weight).T,
                          "bias": cp(pm.rw_proj.bias)},
              "bn": {"scale": np.ones(8, np.float32),
                     "bias": np.zeros(8, np.float32)},
              "cls": {"kernel": cp(pm.cls.weight).T,
                      "bias": cp(pm.cls.bias)}}
    zeros, ones = np.zeros(8, np.float32), np.ones(8, np.float32)
    stats = {"bn": {"mean": zeros, "var": ones, "split_mean": zeros,
                    "split_var": ones}}
    return pm, JTrainState.create({"params": params, "batch_stats": stats})


def _jax_tree(b):
    return jax.tree.map(jnp.asarray, b)


@pytest.mark.parametrize("opts", [
    dict(fusion_lr_mult=10.0), dict(fusion_lr_mult=10.0, lr_fusion=0.3),
    dict(grad_clip=1e-3), dict(grad_clip=1e9), dict(accum_steps=2)],
    ids=["mult", "lr_fusion", "clip_tiny", "clip_huge", "accum"])
def test_train_step_options_match_jax(opts):
    """The port's train step against the JAX ``make_train_step`` on the
    same tiny model (a ``rw``-named layer, a split batch norm, a head):
    the fusion multiplier and its ``lr_fusion`` override, the global-norm
    clip (tiny: active; huge: a no-op) and two accumulated micro-batches
    with the statistics chained.  Parameters and split statistics after two
    steps, losses of both steps; 1e-5."""
    opts = dict(opts)
    lr_fusion = opts.pop("lr_fusion", None)
    accum = opts.get("accum_steps", 1)
    pm, jstate = _tiny_pair()
    step = make_train_step(pm, align_corners=False, **opts)
    jstep = jmake_step(_JTinyFusion(), align_corners=False, donate=False,
                       **opts)
    state = TrainState.create(pm)
    key = jax.random.PRNGKey(0)
    for i in range(2):
        if accum == 1:
            b = _tiny_batch(10 + i)
        else:
            parts = [_tiny_batch(20 + 2 * i + j, b=2) for j in range(accum)]
            b = jax.tree.map(lambda *a: np.stack(a), *parts)
        tb = jax.tree.map(t, b)
        state, m = step(state, tb, 0.05, lr_fusion=lr_fusion)
        extra = () if lr_fusion is None else (jnp.float32(lr_fusion),)
        jstate, jm = jstep(jstate, _jax_tree(b), jnp.float32(0.05), key,
                           *extra)
        _close(m["loss"], jm["loss"], 1e-5, "loss")
        assert m["probs"].shape == jm["probs"].shape
    assert state.step == int(jstate.step) == 2
    sd = state_dict_from_jax({"params": jstate.params,
                              "batch_stats": jstate.batch_stats})
    ours = pm.state_dict()
    for k in ("rw_proj.weight", "rw_proj.bias", "cls.weight", "cls.bias",
              "bn.weight", "bn.bias", "bn.split_bn.running_mean",
              "bn.split_bn.running_var"):
        _close(ours[k], sd[k].numpy().reshape(ours[k].shape), 1e-5, k)


# ---- dropout -------------------------------------------------------------------

def test_dropout_rate_scale_and_seed():
    x = torch.ones(200_000)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.3) < 5e-3
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dropout(x, 0.3,
                                      torch.Generator().manual_seed(1)))
    assert dropout(x, 0.0, None) is x
    assert not dropout(x, 1.0, torch.Generator()).any()
    with pytest.raises(ValueError):
        dropout(x, 0.5, None)


def test_coarse_dropout_active_in_train_only():
    """CoarseNet: dropout at the head's fc1 and rw6's hidden layers in
    training (repeatable under a seeded generator), none in eval."""
    from coarse_fine_networks_torch.models.layers import init_parameters

    m = init_parameters(CoarseNet("M", 5, dropout_rate=0.5),
                        torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(1)
    b, tt, tf = 2, 4, 8
    args = (torch.rand(b, tt, 32, 32, 3, generator=rng),
            {k: torch.rand(b, tf, 7, 7, c, generator=rng)
             for k, c in (("layer1", 24), ("layer2", 48), ("layer3", 96),
                          ("layer4", 192), ("conv5", 432))},
            torch.ones(b, tf), torch.tensor([[0, tt, tf, 1]] * b))
    m.train()
    with torch.no_grad():
        a = m(*args, generator=torch.Generator().manual_seed(3))
        b_ = m(*args, generator=torch.Generator().manual_seed(3))
        with pytest.raises(ValueError):
            m(*args)
        m.dropout_rate = m.rw6.dropout_rate = 0.0
        c = m(*args)
        m.eval()
        e1, e2 = m(*args), m(*args)
    # training normalises with batch statistics, so the running statistics
    # that moved between the calls do not change the logits
    assert torch.equal(a, b_)
    assert not torch.allclose(a, c)
    assert torch.equal(e1, e2)


# ---- eval helpers ----------------------------------------------------------------

@pytest.mark.parametrize("crops", [1, 3])
def test_crop_reduced_loss_and_t_chunks_match_jax(crops):
    """The eval tail (resize to the label length, max over each sample's
    crops, mask, loss) and the chunked-inference windows.  1e-5."""
    from coarse_fine_networks_tpu.train import steps as jsteps
    from coarse_fine_networks_torch.train import crop_reduced_loss, t_chunks

    rng = np.random.RandomState(crops)
    logits = rng.randn(2 * crops, 9, 7).astype(np.float32)
    batch = {"labels": (rng.rand(2, 36, 7) > 0.8).astype(np.float32),
             "masks": np.ones((2, 36), np.float32)}
    batch["masks"][1, 30:] = 0
    ref = jsteps.crop_reduced_loss(jnp.asarray(logits),
                                   jax.tree.map(jnp.asarray, batch), crops,
                                   False)
    got = crop_reduced_loss(t(logits), jax.tree.map(t, batch), crops, False)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-5, k)
    clips = rng.rand(1, 23, 2, 2, 3).astype(np.float32)
    for t_lim in (8, 23, 30):
        ours = t_chunks(t(clips), t_lim)
        theirs = jsteps.t_chunks(jnp.asarray(clips), t_lim)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _close(a, b, 0.0)
