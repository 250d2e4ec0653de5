"""The models' remaining options in the port against the JAX package on the
CPU: every ``CoarseNet`` option that is not the serving configuration
(``t_pool`` avg, max, stride and None, ``learned_mixing=False``,
``is_mixing=False``, ``task='class'``) and ``FineNet(t_downsample=True)``
in its ``loc``, ``class`` and ``global_tower`` modes.  Each variant's JAX
variables (filled from a numpy seed) load strictly into the port's variant
through ``state_dict_from_jax``; then the eval output and every parameter's
gradient through it (against one cotangent), the train-mode output and the
new split statistics agree within 1e-4, f32 (the packages sum in another
order).  The train-mode gradients agree within the JAX package's own
spread between its two trunk layouts, the same math in another order
(``tests/_torch_port_layout_spread.py``: up to 4.85e-2 relative L2 per
stage, 0.44 of a tensor's largest magnitude), as ``chip_smoke.py`` holds
the card against the CPU: batch norm over a few elements carries a rounding
into every gradient upstream (the serving configuration itself, ``t_pool=
'grid'``, differs by ~1 % of a tensor there).  X3D-M's widths with one
bottleneck a stage (``get_blocks`` patched in both packages, so each
variant compiles in seconds), B2: the coarse stream at T8 32² with banks at
T_f = 16, the fine stream at T16 64² (the stages at T8 … T1)."""

import numpy as np
import pytest
import torch

import jax

from coarse_fine_networks_torch.ckpt import load_strict, state_dict_from_jax

from _torch_port_util import close, jax_variables, t

B, T, TF, H, N_CLASSES = 2, 8, 16, 32, 7
# the fine stream at 64²: layer4 then normalises 2×2 positions a sample
T_FINE, H_FINE = 16, 64
TOL = 1e-4
# train-mode gradients: the JAX package's layout spread (chip_smoke.py's
# GRAD_STAGE_TOL, GRAD_TENSOR_TOL); a gradient that is zero up to rounding
# (a bias taken out again by a training-mode batch norm) is held at
# ZERO_GRAD of the largest gradient instead
GRAD_STAGE_TOL, GRAD_TENSOR_TOL, ZERO_GRAD = 5e-2, 0.5, 1e-6
# the global tower's banks in training (no path trains the tower: it
# extracts in eval mode), as a fraction of each bank's largest value: the
# deep banks normalise a few positions a channel, and the tower without
# t_downsample differs from JAX's there by 4.2e-5 of its largest value (2.6
# times TOL element by element), with t_downsample by 1.5e-4
TRAIN_BANK_TOL = 1e-3
BANKS = (("layer1", 24), ("layer2", 48), ("layer3", 96), ("layer4", 192),
         ("conv5", 432))

torch.set_num_threads(2)

# the options and the logits' frames they give at T = 8
COARSE_VARIANTS = {
    "avg": (dict(t_pool="avg"), T // 4),
    "max": (dict(t_pool="max"), T // 4),
    "stride": (dict(t_pool="stride"), T // 4),
    "no_pool": (dict(t_pool=None), T),
    "unlearned_mixing": (dict(learned_mixing=False), T),
    "no_mixing": (dict(is_mixing=False), T),
    "class": (dict(task="class"), T),
}


@pytest.fixture(autouse=True)
def one_block_a_stage(monkeypatch):
    """One bottleneck a stage (block 0: strided, SE, the downsample) in both
    packages' trunks."""
    from coarse_fine_networks_tpu.models import coarse as jcoarse
    from coarse_fine_networks_tpu.models import fine as jfine
    from coarse_fine_networks_torch.models import x3d

    for mod in (jcoarse, jfine, x3d):
        monkeypatch.setattr(mod, "get_blocks", lambda version: [1, 1, 1, 1])


def _coarse_inputs(seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, TF), np.float32)
    mask[1, 12:] = 0
    return (rng.rand(B, T, H, H, 3).astype(np.float32),
            {k: rng.rand(B, TF, 7, 7, c).astype(np.float32)
             for k, c in BANKS},
            mask, np.array([[0, T, TF, 1], [0, T, 12, 1]], np.int32))


def _flat(out):
    """A model's output as a list of arrays (a bank dict by key)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [out]


def _run(jm, v, pm, args, seed, train):
    """One apply of ``jm`` and of ``pm`` (eval or ``train`` mode) and the
    gradients of ``Σ out·g`` for a cotangent ``g`` drawn from ``seed``: the
    port's outputs and parameters (``.grad`` set), and the JAX outputs, new
    batch statistics and parameter gradients (as the port's state dict)."""
    jnp = jax.numpy
    jargs = jax.tree.map(jnp.asarray, args)

    def f(params):
        return jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        *jargs, train, mutable=["batch_stats"])

    @jax.jit
    def step(params, cot):
        y, vjp, upd = jax.vjp(f, params, has_aux=True)
        return y, upd, vjp(cot)[0]

    shapes = jax.eval_shape(f, v["params"])[0]
    rng = np.random.RandomState(seed)
    cot = [rng.randn(*s.shape).astype(np.float32) for s in _flat(shapes)]
    tree = jax.tree.structure(shapes)
    y, upd, gp = step(v["params"],
                      jax.tree.unflatten(tree, [jnp.asarray(c) for c in cot]))
    pm.train(train)
    pm.zero_grad(set_to_none=True)
    out = _flat(pm(*jax.tree.map(t, args)))
    torch.autograd.backward(out, [t(c) for c in cot])
    assert len(out) == len(_flat(y))
    return (out, dict(pm.named_parameters()), _flat(y),
            state_dict_from_jax({"params": v["params"],
                                 "batch_stats": upd["batch_stats"]}),
            state_dict_from_jax({"params": gp}))


def _stage(name):
    top = name.split(".")[0]
    return top if top.startswith(("layer", "rw", "mix", "pool_")) else top[:3]


def _hold(jm, v, pm, args, seed, banks=False):
    """``pm`` (loaded from ``v``) against ``jm``: in eval mode the outputs
    and every parameter's gradient within ``TOL``; in training the outputs
    (``banks``: within ``TRAIN_BANK_TOL`` of their largest value) and the
    new split statistics within ``TOL``, and the gradients within the
    layout spread.  Returns the eval outputs."""
    got, names, ref, _, jg = _run(jm, v, pm, args, seed, False)
    for i, (g_, r) in enumerate(zip(got, ref)):
        close(g_.detach(), r, TOL, f"eval output {i}")
    assert set(jg) == set(names)
    for k, r in jg.items():
        close(names[k].grad, r.numpy(), TOL, f"eval gradient {k}")

    out, names, y, new, jg = _run(jm, v, pm, args, seed + 1, True)
    for i, (g_, r) in enumerate(zip(out, y)):
        if banks:
            r = np.asarray(r)
            err = np.abs(g_.detach().numpy() - r).max()
            assert err <= TRAIN_BANK_TOL * np.abs(r).max(), (i, err)
        else:
            close(g_.detach(), r, TOL, f"train output {i}")
    sd = pm.state_dict()
    split = [k for k in new if "split_bn" in k]
    assert split
    for k in split:
        close(sd[k], new[k].numpy(), TOL, k)
    stage = {}
    top = max(float(r.abs().max()) for r in jg.values())
    for k, r in jg.items():
        d = (names[k].grad - r).double()
        scale = max(float(r.abs().max()), ZERO_GRAD * top)
        assert d.abs().max() <= GRAD_TENSOR_TOL * scale, k
        acc = stage.setdefault(_stage(k), [0.0, 0.0])
        acc[0] += float(torch.sum(d ** 2))
        acc[1] += float(torch.sum(r.double() ** 2))
    rel = {s: (e / max(n, 1e-30)) ** 0.5 for s, (e, n) in stage.items()}
    assert max(rel.values()) <= GRAD_STAGE_TOL, rel
    return [g_.detach() for g_ in got]


@pytest.mark.parametrize("name", list(COARSE_VARIANTS))
def test_coarse_variant_matches_jax(name):
    from coarse_fine_networks_tpu.models import CoarseNet as JCoarse
    from coarse_fine_networks_torch.models import CoarseNet

    kw, frames = COARSE_VARIANTS[name]
    jm = JCoarse(version="M", n_classes=N_CLASSES, dropout_rate=0.0,
                 trunk_layout="plain", **kw)
    args = _coarse_inputs(1)
    v = jax_variables(jm, *jax.tree.map(jax.numpy.asarray, args), seed=3,
                      train=False)
    pm = load_strict(CoarseNet("M", N_CLASSES, dropout_rate=0.0, **kw),
                     state_dict_from_jax(v))
    # only the modules the configuration uses, as in the JAX package
    top = {k.split(".")[0] for k in pm.state_dict()}
    assert ("pool_1" in top) == (kw.get("t_pool", "grid") == "grid")
    assert ("mix2" in top) == (kw.get("learned_mixing", True)
                               and kw.get("is_mixing", True))
    (logits,) = _hold(jm, v, pm, args, seed=4)
    assert logits.shape == (B, frames, N_CLASSES)


@pytest.mark.parametrize("mode", ["loc", "class", "global_tower"])
def test_fine_t_downsample_matches_jax(mode):
    from coarse_fine_networks_tpu.models import FineNet as JFine
    from coarse_fine_networks_torch.models import FineNet

    tower = mode == "global_tower"
    task = "class" if mode == "class" else "loc"
    jm = JFine(version="M", n_classes=N_CLASSES, dropout_rate=0.0, task=task,
               t_downsample=True, global_tower=tower, trunk_layout="plain")
    x = np.random.RandomState(5).rand(B, T_FINE, H_FINE, H_FINE,
                                      3).astype(np.float32)
    v = jax_variables(jm, jax.numpy.asarray(x), seed=6, train=False)
    pm = load_strict(FineNet("M", N_CLASSES, task=task, dropout_rate=0.0,
                             global_tower=tower, t_downsample=True),
                     state_dict_from_jax(v))
    got = _hold(jm, v, pm, (x,), seed=7, banks=tower)
    if tower:  # the banks at T/2 … T/16, 7×7
        assert [tuple(g.shape) for g in got] == [
            (B, T_FINE // 16, 7, 7, 432), (B, T_FINE // 2, 7, 7, 24),
            (B, T_FINE // 4, 7, 7, 48), (B, T_FINE // 8, 7, 7, 96),
            (B, T_FINE // 16, 7, 7, 192)]
    else:
        assert got[0].shape == (B, 1, N_CLASSES)
