"""X3D-S and X3D-XL in the port against the JAX package on the CPU: the
width and depth tables, and the XL fine tower (its logits and its five
feature banks) and the XL joint pipeline at B1 T4 32², full depth, from
the same variables (filled from a numpy seed) carried across by
``state_dict_from_jax`` and loaded strictly; f32, within 1e-4 (the
packages sum in another order), and the XL converter's round trip."""

import numpy as np
import pytest
import torch

import jax

from coarse_fine_networks_torch.ckpt import load_strict, state_dict_from_jax

from _torch_port_util import close, jax_variables, t

B, T, TF, H, N_CLASSES = 1, 4, 4, 32, 7
TOL = 1e-4

torch.set_num_threads(2)


@pytest.mark.parametrize("version", ["S", "M", "XL"])
def test_tables_equal_jax(version):
    from coarse_fine_networks_tpu.models import x3d as jx3d
    from coarse_fine_networks_torch.models import x3d

    assert x3d.get_inplanes(version) == [tuple(p) for p in
                                         jx3d.get_inplanes(version)]
    assert x3d.get_blocks(version) == list(jx3d.get_blocks(version))


def test_s_is_m():
    """S has M's tables in both packages: the same module shapes."""
    from coarse_fine_networks_torch.models import CoarseFinePipeline

    s = CoarseFinePipeline(N_CLASSES, "S", device="cpu").state_dict()
    m = CoarseFinePipeline(N_CLASSES, "M", device="cpu").state_dict()
    assert {k: v.shape for k, v in s.items()} == {k: v.shape
                                                  for k, v in m.items()}


def _clips(seed, tf=TF):
    rng = np.random.RandomState(seed)
    return rng.rand(B, tf, H, H, 3).astype(np.float32)


@pytest.fixture(scope="module")
def xl_fine():
    from coarse_fine_networks_tpu.models import FineNet as JFine

    jm = JFine(version="XL", n_classes=N_CLASSES, dropout_rate=0.0)
    v = jax_variables(jm, jax.numpy.asarray(_clips(0)), seed=11,
                      train=False)
    return jm, v


def test_xl_fine_stream_matches_jax(xl_fine):
    """FineNet("XL") with its logits head, and as the global tower (the
    head dropped), against the JAX model's logits and feature banks."""
    from coarse_fine_networks_torch.models import FineNet

    jm, v = xl_fine
    x = _clips(1)
    sd = state_dict_from_jax(v)
    assert sd["layer4.14.conv3.weight"].shape == (280, 630, 1, 1, 1)
    pm = load_strict(FineNet("XL", N_CLASSES, global_tower=False), sd).eval()
    with torch.no_grad():
        got = pm(t(x))
    ref = jax.jit(lambda v, x: jm.apply(v, x, False))(v, x)
    close(got, ref, TOL, "logits")

    from coarse_fine_networks_tpu.models import FineNet as JFine

    jg = JFine(version="XL", n_classes=N_CLASSES, global_tower=True)
    tower = load_strict(FineNet("XL"), sd, drop=("fc1.", "fc2.")).eval()
    with torch.no_grad():
        feats = tower(t(x))
    ref = jax.jit(lambda v, x: jg.apply(v, x, False))(
        {"params": {k: p for k, p in v["params"].items()
                    if k not in ("fc1", "fc2")},
         "batch_stats": v["batch_stats"]}, x)
    assert set(feats) == set(ref)
    for k, r in ref.items():
        assert feats[k].shape[-1] == {"layer1": 32, "layer2": 72,
                                      "layer3": 136, "layer4": 280,
                                      "conv5": 630}[k]
        close(feats[k], r, TOL, k)


def test_xl_pipeline_matches_jax():
    """The XL joint pipeline (extract + fuse) with a masked fine frame."""
    from coarse_fine_networks_tpu.models import CoarseFinePipeline as JPipe
    from coarse_fine_networks_torch.models import CoarseFinePipeline

    jnp = jax.numpy
    jm = JPipe(n_classes=N_CLASSES, version="XL")
    clips, fine = _clips(2), _clips(3)
    meta = np.asarray([[0, T, TF - 1, 1]], np.int32)
    mask = np.ones((B, TF), np.float32)
    mask[:, -1] = 0
    v = jax_variables(jm, jnp.asarray(clips), jnp.asarray(fine),
                      jnp.asarray(meta), seed=12)
    pm = load_strict(CoarseFinePipeline(N_CLASSES, "XL", device="cpu"),
                     state_dict_from_jax(v))
    with torch.inference_mode():
        got = pm(t(clips), t(fine), t(meta), 4 * T, fine_mask=t(mask))
    ref = jax.jit(lambda v, c, f, m, k: jm.apply(v, c, f, m, 4 * T,
                                                 fine_mask=k))(
        v, clips, fine, meta, mask)
    assert np.ptp(np.asarray(ref)) > 1e-3
    close(got, ref, TOL, "probs")


def test_xl_convert_round_trip(xl_fine, tmp_path):
    """``convert_checkpoint`` finds XL's widths in a reference-format
    ``.pt`` and its ``--to-torch`` output equals JAX
    ``export_torch_state_dict`` exactly."""
    from coarse_fine_networks_tpu.ckpt import export_torch_state_dict
    from coarse_fine_networks_torch.cli import convert_checkpoint

    _, v = xl_fine
    src, mid, out = (str(tmp_path / n) for n in ("x.pt", "x.ckpt", "y.pt"))
    torch.save({"model_state_dict": state_dict_from_jax(v)}, src)
    convert_checkpoint.main(["--input", src, "--output", mid])
    convert_checkpoint.main(["--input", mid, "--output", out, "--to-torch"])
    got = torch.load(out, weights_only=True)["model_state_dict"]
    ref = export_torch_state_dict(v["params"], v["batch_stats"])
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
