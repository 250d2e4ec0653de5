"""The port's numeric ops against the JAX package's, on the CPU, in f32.

Inputs are drawn with numpy from a seed and fed to both.  Tolerance: 1e-5
absolute and relative unless a case states otherwise (the two compute the
same formulas; only summation order differs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coarse_fine_networks_tpu import ops as jops
from coarse_fine_networks_torch import ops as tops

from _torch_port_util import t as _t

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               **(tol or TOL))


@pytest.mark.parametrize("h_in,h_out", [(56, 7), (8, 7), (4, 7), (14, 14)])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pools(kind, h_in, h_out):
    x = np.random.RandomState(h_in).randn(2, 3, h_in, h_in, 5).astype(
        np.float32)
    jf = getattr(jops, f"adaptive_{kind}_pool_spatial")
    tf = getattr(tops, f"adaptive_{kind}_pool_spatial")
    _close(tf(_t(x), h_out), jf(jnp.asarray(x), h_out))


@pytest.mark.parametrize("h_in,out", [(7, 56), (7, 8), (7, 14)])
def test_spatial_replicate(h_in, out):
    x = np.random.RandomState(out).randn(2, 3, h_in, h_in, 4).astype(
        np.float32)
    _close(tops.spatial_replicate(_t(x), out),
           jops.spatial_replicate(jnp.asarray(x), out))


def test_hat_matrix_and_temporal_resample():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 3, 3, 4).astype(np.float32)
    pos = (rng.rand(2, 5) * 10 - 0.5).astype(np.float32)  # some out of range
    _close(tops.hat_matrix(_t(pos), 9), jops.hat_matrix(jnp.asarray(pos), 9))
    _close(tops.temporal_resample(_t(x), _t(pos)),
           jops.temporal_resample(jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("out_len", [1, 7, 32])
def test_linear_resize(align_corners, out_len):
    x = np.random.RandomState(out_len).randn(2, 12, 5).astype(np.float32)
    _close(tops.linear_resize(_t(x), out_len, align_corners),
           jops.linear_resize(jnp.asarray(x), out_len, align_corners))


@pytest.mark.parametrize("seed", [0, 1])
def test_cdf_knots_and_inverse_cdf(seed):
    rng = np.random.RandomState(seed)
    scores = (rng.randn(3, 16) * 3).astype(np.float32)
    knots_t = tops.cdf_knots(_t(scores))
    knots_j = jops.cdf_knots(jnp.asarray(scores))
    _close(knots_t, knots_j)
    kn = np.asarray(knots_j)
    for num_out in (None, 9):
        _close(tops.inverse_cdf(_t(kn), num_out),
               jops.inverse_cdf(jnp.asarray(kn), num_out))


def test_inverse_cdf_ties_and_exact_knots():
    """searchsorted(side='left') then -1: queries equal to a knot and
    repeated knots take the left segment, as in the JAX function."""
    kn = np.asarray([[0.0, 0.25, 0.25, 0.5, 1.0],
                     [0.0, 0.0, 0.5, 1.0, 1.0]], np.float32)
    _close(tops.inverse_cdf(_t(kn)), jops.inverse_cdf(jnp.asarray(kn)))


def test_interp1d():
    rng = np.random.RandomState(3)
    x = np.sort(rng.rand(2, 10).astype(np.float32), axis=1)
    y = rng.randn(2, 10).astype(np.float32)
    xnew = (rng.rand(2, 7) * 1.4 - 0.2).astype(np.float32)  # extrapolates
    _close(tops.interp1d(_t(x), _t(y), _t(xnew)),
           jops.interp1d(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xnew)),
           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("crops", [1, 2])
@pytest.mark.parametrize("uniform", [False, True])
def test_gaussian_alignment(crops, uniform):
    rng = np.random.RandomState(crops)
    b, tf, k = 2, 12, 5
    meta = np.asarray([[0, 16, 12, 1], [3, 20, 9, 2]], np.int32)
    mask = np.zeros((b, tf), np.float32)
    mask[0, :12], mask[1, :9] = 1, 1
    knots = None if uniform else np.sort(
        rng.rand(b * crops, k).astype(np.float32), axis=1)
    kw = dict(coarse_len=k) if uniform else {}
    got = tops.gaussian_alignment(_t(meta), _t(mask),
                                  None if uniform else _t(knots), 16,
                                  crops=crops, **kw)
    ref = jops.gaussian_alignment(jnp.asarray(meta), jnp.asarray(mask),
                                  None if uniform else jnp.asarray(knots), 16,
                                  crops=crops, **kw)
    _close(got, ref)


def test_reweight_aggregate():
    rng = np.random.RandomState(5)
    b, tf, tc, c = 2, 10, 4, 6
    feat = rng.randn(b, tf, 7, 7, c).astype(np.float32)
    gate = rng.rand(b, tf, 7, 7).astype(np.float32)
    align = rng.rand(b, tf, tc).astype(np.float32)
    mask = (rng.rand(b, tf) > 0.3).astype(np.float32)
    _close(tops.reweight_aggregate(_t(feat), _t(gate), _t(align), _t(mask)),
           jops.reweight_aggregate(jnp.asarray(feat), jnp.asarray(gate),
                                   jnp.asarray(align), jnp.asarray(mask)),
           rtol=1e-4, atol=1e-5)


def test_port_imports_nothing_of_jax():
    """The port (its data plane, metrics, checkpoints and drivers
    included) and chip_smoke.py import neither JAX, flax nor the JAX
    package: not at import time, and not in any import statement."""
    import pathlib
    import re
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    code = ("import sys, coarse_fine_networks_torch.models, "
            "coarse_fine_networks_torch.serve, coarse_fine_networks_torch.ckpt,"
            " coarse_fine_networks_torch.train, coarse_fine_networks_torch.data,"
            " coarse_fine_networks_torch.metrics,"
            " coarse_fine_networks_torch.ckpt.checkpoint,"
            " coarse_fine_networks_torch.data.synthetic,"
            " coarse_fine_networks_torch.data.loader,"
            " coarse_fine_networks_torch.data.device_prefetch,"
            " coarse_fine_networks_torch.train.config,"
            " coarse_fine_networks_torch.train.fine_driver,"
            " coarse_fine_networks_torch.train.extract_driver,"
            " coarse_fine_networks_torch.train.coarse_driver;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'coarse_fine_networks_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|coarse_fine_networks_tpu)\b",
                     re.M)
    files = sorted((root / "coarse_fine_networks_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    for f in files:
        assert not pat.search(f.read_text()), f
