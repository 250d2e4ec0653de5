"""Helpers for the port's parity tests: JAX variable trees filled from
numpy, and loading them into port modules through ``ckpt.from_jax``."""

import fcntl
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

import jax

from coarse_fine_networks_torch.ckpt import state_dict_from_jax


def _fill(path, shape, rng):
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = math.prod(shape[:-1])
        return rng.randn(*shape) / math.sqrt(fan_in)
    if leaf in ("bias", "mean", "split_mean"):
        return rng.randn(*shape) * 0.2
    if leaf in ("scale", "var", "split_var"):
        return 0.5 + rng.rand(*shape)
    raise KeyError(leaf)


def jax_variables(module, *args, seed=0, **static):
    """Variables of ``module.init(key, *args, **static)`` without running
    it: shapes from ``jax.eval_shape`` (``static`` keyword arguments are not
    traced), values from a numpy seed (positive ``var``, non-trivial
    ``mean``)."""
    shapes = jax.eval_shape(functools.partial(module.init, **static),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def rec(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: rec(v, path + (k,)) for k, v in tree.items()}
        return _fill(path, tree.shape, rng).astype(np.float32)

    return rec(shapes, ())


def nest(variables, prefix):
    """Put a module's variables under a flax path prefix."""
    out = {}
    for coll, tree in variables.items():
        for p in reversed(prefix):
            tree = {p: tree}
        out[coll] = tree
    return out


def load_port(port_module, variables, prefix=(), strip=""):
    """Load JAX ``variables`` (nested under ``prefix`` for the converter,
    whose resulting key prefix ``strip`` is removed) into ``port_module``
    with ``strict=True``; returns the module in eval mode."""
    sd = state_dict_from_jax(nest(variables, prefix))
    sd = {k[len(strip):]: v for k, v in sd.items() if k.startswith(strip)}
    port_module.load_state_dict(sd, strict=True)
    return port_module.eval()


def t(a):
    return torch.from_numpy(np.array(a))


def jax_native_library():
    """Load the JAX package's native library (``native/libcfn_data.so``)
    into its loader, building it first where needed; None, or why it
    cannot be built (the compiler's message).

    The JAX loader (``data/native.py``'s ``_load``) runs ``make`` in
    ``native/`` when the library is missing and loads whatever file is
    there, so a process that looks while another is linking gets "file too
    short" and caches the failure: under the tier-1 command's six workers,
    which all import the test files at once on a tree without the library,
    the library's tests then skip.  Here one process at a time (an
    exclusive ``fcntl`` lock) builds it with ``native/Makefile`` in a
    temporary directory and moves it into a cache named by the sources'
    hash, and into ``native/``, by ``os.replace``, so no process sees a
    partial file; the loader is then probed again on the cached copy."""
    from coarse_fine_networks_tpu.data import native as jn

    if jn._LIB is not None:
        return None
    src = jn._NATIVE_DIR
    digest = hashlib.sha256()
    for name in ("Makefile", "cfn_data.cpp"):
        with open(os.path.join(src, name), "rb") as f:
            digest.update(f.read())
    cache = os.path.join(tempfile.gettempdir(),
                         f"cfn_native_{digest.hexdigest()[:16]}")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "libcfn_data.so")
    with open(os.path.join(cache, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            work = tempfile.mkdtemp(dir=cache)
            try:
                for name in ("Makefile", "cfn_data.cpp"):
                    shutil.copy(os.path.join(src, name), work)
                proc = subprocess.run(["make", "-C", work, "-s"],
                                      capture_output=True, text=True,
                                      timeout=300)
                if proc.returncode:
                    return (f"the JAX package's native library does not "
                            f"build: {proc.stderr[-2000:]}")
                os.replace(os.path.join(work, "libcfn_data.so"), so)
            finally:
                shutil.rmtree(work, ignore_errors=True)
        tmp = f"{jn._SO}.{os.getpid()}.tmp"
        shutil.copy(so, tmp)
        os.replace(tmp, jn._SO)
        old = jn._SO
        jn._SO, jn._LIB, jn._TRIED = so, None, False
        try:
            ok = jn.available()
        finally:
            jn._SO = old
    return None if ok else f"the native library at {so} does not load"


def close(got, ref, tol, name=""):
    """``got`` (a tensor or array) equals ``ref`` in shape, and within
    ``tol`` absolute and relative."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref), (name, got.shape, np.shape(ref))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol,
                               err_msg=name)


def apply_train(jm, v, *args):
    """JAX train-mode apply of module ``jm`` with variables ``v``: output,
    new batch_stats, and a VJP over (params, *args)."""
    def f(params, *a):
        return jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        *a, True, mutable=["batch_stats"])
    y, vjp, upd = jax.vjp(f, v["params"], *(jax.numpy.asarray(a)
                                            for a in args), has_aux=True)
    return y, upd["batch_stats"], vjp


# ---- the coarse train step at X3D-M width, cut to B=2, T=8, 64² -----------

COARSE = dict(b=2, t=8, hw=64, tf=16, tl=32, n_classes=7, lr=0.02,
              fusion_lr_mult=10.0)
BANKS = (("layer1", 24), ("layer2", 48), ("layer3", 96), ("layer4", 192),
         ("conv5", 432))


def coarse_batch(seed):
    """A numpy train batch in the JAX package's dict layout (the second
    sample has masked fine frames and label frames)."""
    c = COARSE
    rng = np.random.RandomState(seed)
    b, t_, tf, tl = c["b"], c["t"], c["tf"], c["tl"]
    feat_mask = np.ones((b, tf), np.float32)
    feat_mask[1, 12:] = 0
    masks = np.ones((b, tl), np.float32)
    masks[1, 28:] = 0
    return {
        "clips": rng.rand(b, t_, c["hw"], c["hw"], 3).astype(np.float32),
        "feats": {k: rng.rand(b, tf, 7, 7, ch).astype(np.float32)
                  for k, ch in BANKS},
        "feat_mask": feat_mask,
        "meta": np.array([[0, t_, tf, 1], [0, t_, 12, 1]], np.int32),
        "labels": (rng.rand(b, tl, c["n_classes"]) > 0.9).astype(np.float32),
        "masks": masks,
    }


def coarse_models(trunk_layout, dw_impl, seed=0):
    """The JAX ``CoarseNet`` (dropout 0) with variables filled from a numpy
    seed, and the port's ``CoarseNet`` loaded with the same weights."""
    from coarse_fine_networks_tpu.models.coarse import CoarseNet as JCoarse
    from coarse_fine_networks_torch.models import CoarseNet

    c = COARSE
    jm = JCoarse(version="M", n_classes=c["n_classes"], dropout_rate=0.0,
                 trunk_layout=trunk_layout, dw_impl=dw_impl)
    b = jax.tree.map(jax.numpy.asarray, coarse_batch(0))
    v = jax_variables(jm, b["clips"], b["feats"], b["feat_mask"], b["meta"],
                      seed=seed, train=False)
    pm = CoarseNet("M", c["n_classes"], dropout_rate=0.0)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm


def coarse_step_spread(jm, v, pm, batch):
    """One coarse train step of the JAX model ``jm`` (variables ``v``) and of
    the port's ``pm`` from the same weights on the numpy ``batch``: the two
    losses, each new split statistic's largest difference over the JAX
    tensor's largest magnitude, each parameter update's (``p1 − p0``) the
    same, and the updates' relative L2 distance per stage.  Checks that the
    eval statistics did not move."""
    from coarse_fine_networks_tpu.train import TrainState as JTrainState
    from coarse_fine_networks_tpu.train import make_train_step as jmake_step
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    jnp = jax.numpy
    c = COARSE
    p0 = {k: x.clone() for k, x in pm.state_dict().items()}
    jstep = jmake_step(jm, align_corners=False,
                       fusion_lr_mult=c["fusion_lr_mult"], donate=False)
    js, jmet = jstep(JTrainState.create(v), jax.tree.map(jnp.asarray, batch),
                     jnp.float32(c["lr"]), jax.random.PRNGKey(0))
    step = make_train_step(pm, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    state, met = step(TrainState.create(pm), jax.tree.map(t, batch),
                      c["lr"])
    assert state.step == 1
    ref = state_dict_from_jax({"params": js.params,
                               "batch_stats": js.batch_stats})
    got = pm.state_dict()
    params = dict(pm.named_parameters())
    assert set(ref) == set(got)
    stats_err, update_err, stage = {}, {}, {}
    for k, r in ref.items():
        if k in params:
            d = (got[k] - p0[k]).double(), (r - p0[k]).double()
            update_err[k] = float((d[0] - d[1]).abs().max()
                                  / d[1].abs().max())
            acc = stage.setdefault(coarse_stage(k), [0.0, 0.0])
            acc[0] += float(torch.sum((d[0] - d[1]) ** 2))
            acc[1] += float(torch.sum(d[1] ** 2))
        elif "split_bn" in k:
            stats_err[k] = ((got[k] - r).abs().max() / r.abs().max()).item()
        else:  # bn.running_* change only through aggregation
            assert torch.equal(got[k], p0[k]), k
    rel = {g: (e / n) ** 0.5 for g, (e, n) in stage.items()}
    return met["loss"].item(), float(jmet["loss"]), stats_err, update_err, rel


def coarse_stage(name):
    """The stage of a coarse parameter: stem, layer1-4, pool_1, fusion or
    head."""
    top = name.split(".")[0]
    if top.startswith(("rw", "mix")):
        return "fusion"
    if top.startswith(("layer", "pool_")):
        return top
    return "stem" if top in ("conv1_s", "conv1_t", "bn1") else "head"


# ---- one training bottleneck against the JAX package's two layouts ---------

def bottleneck_train_parity(c_in, stride, use_se, down, fold, splits=1,
                            batch=2, tol=1e-4, grad_rel=None):
    """A port ``Bottleneck(c_in, 54, 24, ...)`` in training mode, with
    ``splits`` batch-norm splits, against the JAX plain ``Bottleneck`` or
    (``fold``) ``FoldedBottleneck`` with the Pallas kernels under the
    interpreter, from the same variables: the output, the gradient of the
    input and of every parameter, and the new split statistics, within
    ``tol`` absolute and relative; with ``grad_rel`` each parameter's
    gradient within ``grad_rel`` of its largest magnitude instead."""
    from coarse_fine_networks_tpu.models import x3d as jx3d
    from coarse_fine_networks_tpu.models import x3d_fold as jxf
    from coarse_fine_networks_tpu.ops.fold import from_fold4, to_fold4
    from coarse_fine_networks_torch.models import Bottleneck, set_bn_splits

    jnp = jax.numpy
    rng = np.random.RandomState(c_in + stride)
    x = rng.randn(batch, 3, 16, 16, c_in).astype(np.float32)
    ho = 16 // stride
    g = rng.randn(batch, 3, ho, ho, 24).astype(np.float32)
    plain = jx3d.Bottleneck(54, 24, stride=stride, use_se=use_se,
                            has_downsample=down, bn_splits=splits)
    v = jax_variables(plain, jnp.asarray(x), train=False)
    if fold:
        jm = jxf.FoldedBottleneck(c_in, 54, 24, stride=stride, use_se=use_se,
                                  has_downsample=down, bn_splits=splits,
                                  dw_impl="interpret")
        y, stats, vjp = apply_train(jm, v, to_fold4(jnp.asarray(x)))
        y = from_fold4(y, 24)
        gp, gx = vjp(to_fold4(jnp.asarray(g)))
        gx = from_fold4(gx, c_in)
    else:
        y, stats, vjp = apply_train(plain, v, x)
        gp, gx = vjp(jnp.asarray(g))

    prefix, strip = ("layer1", "block0"), "layer1.0."
    pm = set_bn_splits(Bottleneck(c_in, 54, 24, stride, use_se, down), splits)
    pm = load_port(pm, v, prefix, strip).train()
    xt = t(x).requires_grad_()
    yt = pm(xt)
    yt.backward(t(g))
    close(yt, y, tol, "y")
    close(xt.grad, gx, tol, "dx")
    jg = state_dict_from_jax(nest({"params": gp}, prefix))
    names = dict(pm.named_parameters())
    assert {k[len(strip):] for k in jg} == set(names)
    for k, ref in jg.items():
        got = names[k[len(strip):]].grad
        if grad_rel is None:
            close(got, ref.numpy(), tol, k)
        else:
            assert got.shape == ref.shape, k
            err = float((got - ref).abs().max() / ref.abs().max())
            assert err <= grad_rel, (k, err)
    new = state_dict_from_jax(nest({"params": v["params"],
                                    "batch_stats": stats}, prefix))
    split = [k for k in new if "split_bn" in k]
    assert split
    for k in split:
        assert new[k].shape[0] == splits * pm.state_dict()[
            k[len(strip):].replace("split_bn", "bn")].shape[0]
        close(pm.state_dict()[k[len(strip):]], new[k].numpy(), tol, k)
    return pm


# ---- the fine train step at X3D-M width, cut to B=4, T=8, 64² --------------

FINE = dict(b=4, t=8, hw=64, tl=32, n_classes=7, lr=0.01, splits=2)


def fine_batch(seed):
    """A numpy train batch of the fine stream in the JAX package's dict
    layout (the last sample has masked label frames)."""
    c = FINE
    rng = np.random.RandomState(seed)
    b, tl = c["b"], c["tl"]
    masks = np.ones((b, tl), np.float32)
    masks[-1, 26:] = 0
    return {
        "clips": rng.rand(b, c["t"], c["hw"], c["hw"], 3).astype(np.float32),
        "labels": (rng.rand(b, tl, c["n_classes"]) > 0.9).astype(np.float32),
        "masks": masks,
    }


def fine_models(trunk_layout, dw_impl, bn_splits=FINE["splits"], seed=0):
    """The JAX ``FineNet`` (``task='loc'``, dropout 0, ``bn_splits``) with
    variables filled from a numpy seed, and the port's ``FineNet`` at
    ``bn_splits`` loaded with the same weights."""
    from coarse_fine_networks_tpu.models.fine import FineNet as JFine
    from coarse_fine_networks_torch.models import FineNet, set_bn_splits

    c = FINE
    jm = JFine(version="M", n_classes=c["n_classes"], dropout_rate=0.0,
               bn_splits=bn_splits, trunk_layout=trunk_layout,
               dw_impl=dw_impl)
    v = jax_variables(jm, jax.numpy.asarray(fine_batch(0)["clips"]),
                      seed=seed, train=False)
    pm = set_bn_splits(FineNet("M", c["n_classes"], dropout_rate=0.0,
                               global_tower=False), bn_splits)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm
