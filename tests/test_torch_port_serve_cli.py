"""The port's serving command line (``cli/serve.py``) and checkpoint
converter (``cli/convert_checkpoint.py``) against the JAX package's on the
CPU.

* End to end: JAX variables (X3D-M, 7 classes, filled from a numpy seed)
  saved as the JAX per-stream checkpoints and, carried across by
  ``state_dict_from_jax``, as the port's; each package's
  ``assemble_pipeline_variables`` → ``build_server`` → HTTP scores the same
  request (T=6, T_f=7, 32²) and its cache hit: the probabilities agree to
  1e-4 absolute in f32 (the two packages sum in another order).
* A fine checkpoint at 4 batch-norm splits with its logits head: the port
  aggregates the split statistics as the JAX package does (1e-6 relative:
  the same f32 sums).
* Strict loading: a missing key, an unknown key or a shape that differs
  raises; the flags are the JAX ones plus ``--device``.
* ``--mesh-devices 2``: two CPU replicas serve a batch as JAX's 2-device
  mesh server and the one-replica server do.
* ``convert_checkpoint`` round-trips, and its ``--to-torch`` output equals
  JAX ``export_torch_state_dict`` on the same weights key for key and value
  for value (XL's in ``tests/test_torch_port_xl.py``)."""

import argparse
import concurrent.futures
import io
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax

from coarse_fine_networks_torch.ckpt import (load_checkpoint,
                                             save_checkpoint,
                                             state_dict_from_jax)
from coarse_fine_networks_torch.cli import convert_checkpoint
from coarse_fine_networks_torch.cli import serve as pserve

from _torch_port_util import jax_variables

H, T, TF, N_CLASSES = 32, 8, 8, 7

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_pipeline_variables():
    from coarse_fine_networks_tpu.models import CoarseFinePipeline as JPipe

    jnp = jax.numpy
    m = JPipe(n_classes=N_CLASSES)
    return jax_variables(m, jnp.zeros((1, T, H, H, 3)),
                         jnp.zeros((1, TF, H, H, 3)),
                         jnp.asarray([[0, T, TF, 1]], jnp.int32), seed=3)


def _tower(v, name):
    return {"params": v["params"][name], "batch_stats": v["batch_stats"][name]}


def _port_stream_ckpts(v, tmp_path):
    """The two per-stream driver payloads of the port (``variables``)."""
    sd = state_dict_from_jax(v)
    paths = {}
    for tower in ("fine", "coarse"):
        paths[tower] = str(tmp_path / f"port_{tower}.ckpt")
        save_checkpoint(paths[tower], {
            "variables": {k[len(tower) + 1:]: x for k, x in sd.items()
                          if k.startswith(tower + ".")},
            "step": 1, "scheduler": {"epoch": 0}})
    return paths


def _post(port, path, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=600) as resp:
        assert resp.status == 200
        with np.load(io.BytesIO(resp.read())) as z:
            return z["probs"]


def _stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_cli_end_to_end_matches_jax(jax_pipeline_variables, tmp_path):
    from coarse_fine_networks_tpu.ckpt import save_checkpoint as jsave
    from coarse_fine_networks_tpu.cli import serve as jserve

    v = jax_pipeline_variables
    for tower in ("fine", "coarse"):
        jsave(str(tmp_path / f"jax_{tower}.ckpt"),
              {"variables": _tower(v, tower)})
    port_ckpts = _port_stream_ckpts(v, tmp_path)
    kw = dict(port=0, cache_bytes=1 << 28, max_batch=2, max_wait_ms=20,
              max_queue=16, request_timeout_s=600)
    jsrv = jserve.build_server(jserve.assemble_pipeline_variables(
        None, str(tmp_path / "jax_fine.ckpt"),
        str(tmp_path / "jax_coarse.ckpt")), "M", N_CLASSES, **kw).start()
    psrv = pserve.build_server(pserve.assemble_pipeline_variables(
        None, port_ckpts["fine"], port_ckpts["coarse"], "M", N_CLASSES),
        "M", N_CLASSES, device="cpu", **kw).start()
    try:
        rng = np.random.RandomState(3)
        clips = rng.rand(6, H, H, 3).astype(np.float32)
        fine = rng.rand(7, H, H, 3).astype(np.float32)
        body = {"clips": clips, "fine_clips": fine}
        got = _post(psrv.port, "/v1/score?video_id=vid1", body)
        ref = _post(jsrv.port, "/v1/score?video_id=vid1", body)
        assert got.shape == ref.shape == (24, N_CLASSES)
        assert np.ptp(ref) > 1e-3  # not a constant output
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        # the repeat without fine pixels hits the cache in both
        hit = _post(psrv.port, "/v1/score?video_id=vid1", {"clips": clips})
        jhit = _post(jsrv.port, "/v1/score?video_id=vid1", {"clips": clips})
        np.testing.assert_allclose(hit, got, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(hit, jhit, rtol=0, atol=1e-4)
        assert _stats(psrv.port) == _stats(jsrv.port)
        assert _stats(psrv.port)["coarse_fine"]["cache_hits"] == 1
    finally:
        psrv.stop()
        jsrv.stop()


def test_split_statistics_aggregate_as_in_jax(jax_pipeline_variables,
                                              tmp_path):
    """A fine checkpoint saved at 4 splits, with the fine stream's logits
    head (which serving drops), assembled: the eval statistics equal the
    JAX package's aggregation, the split statistics are kept."""
    from coarse_fine_networks_tpu.models.layers import \
        aggregate_sub_bn_stats as jaggregate

    rng = np.random.RandomState(5)

    def four_splits(node):
        if isinstance(node, dict) and "split_mean" in node:
            c = node["mean"].shape[0]
            return dict(node,
                        split_mean=rng.randn(4 * c).astype(np.float32) * 0.3,
                        split_var=(0.5 + rng.rand(4 * c)).astype(np.float32))
        if isinstance(node, dict):
            return {k: four_splits(x) for k, x in node.items()}
        return node

    v = dict(jax_pipeline_variables)
    v["batch_stats"] = dict(v["batch_stats"],
                            fine=four_splits(v["batch_stats"]["fine"]))
    paths = _port_stream_ckpts(v, tmp_path)
    fine = load_checkpoint(paths["fine"])
    fine["variables"].update({"fc1.weight": torch.randn(2048, 432, 1, 1, 1),
                              "fc2.weight": torch.randn(N_CLASSES, 2048),
                              "fc2.bias": torch.randn(N_CLASSES)})
    save_checkpoint(paths["fine"], fine)
    got = pserve.assemble_pipeline_variables(None, paths["fine"],
                                             paths["coarse"], "M", N_CLASSES)
    ref = state_dict_from_jax(dict(v, batch_stats=jaggregate(
        jax.tree.map(jax.numpy.asarray, v["batch_stats"]))))
    assert set(got) == set(ref)
    assert got["fine.layer2.0.bn1.split_bn.running_mean"].shape == (4 * 108,)
    for k, r in ref.items():
        err = (got[k] - r).abs().max() / r.abs().max().clamp_min(1e-12)
        assert err <= 1e-6, (k, float(err))
    moved = [k for k in ref if k.startswith("fine.") and
             k.endswith("bn.running_mean") and "split" not in k]
    assert moved and all(not torch.equal(
        got[k], state_dict_from_jax(v)[k]) for k in moved)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_serving_loads_strictly(jax_pipeline_variables, tmp_path, fault):
    paths = _port_stream_ckpts(jax_pipeline_variables, tmp_path)
    payload = load_checkpoint(paths["coarse"])
    sd = payload["variables"]
    if fault == "missing":
        del sd["rw3.fc1.weight"]
    elif fault == "unexpected":
        sd["rw3.extra.weight"] = torch.zeros(3)
    else:
        sd["fc2.weight"] = torch.zeros(N_CLASSES + 1, sd["fc2.weight"]
                                       .shape[1])
    save_checkpoint(paths["coarse"], payload)
    with pytest.raises(ValueError, match=fault if fault != "shape"
                       else "another shape"):
        pserve.assemble_pipeline_variables(None, paths["fine"],
                                           paths["coarse"], "M", N_CLASSES)
    with pytest.raises(ValueError, match="joint"):
        pserve.assemble_pipeline_variables(paths["coarse"], None, None)
    with pytest.raises(ValueError, match="need --ckpt"):
        pserve.assemble_pipeline_variables(None, paths["fine"], None)


def test_mesh_devices_raises(jax_pipeline_variables, tmp_path):
    """``--mesh-devices 2`` raised until data-parallel serving was ported;
    now it serves.  ``build_server(..., mesh_devices=2)`` on two CPU
    replicas scores a batch of three requests (padded to four rows, two a
    replica) over HTTP as JAX's ``build_server`` over its 2-device mesh
    does (1e-4 absolute, as above) and as the one-replica server does
    (1e-6: the same kernels' plain versions on the same rows); ``main``
    gets past the flag to the checkpoints it needs."""
    from coarse_fine_networks_tpu.ckpt import save_checkpoint as jsave
    from coarse_fine_networks_tpu.cli import serve as jserve

    v = jax_pipeline_variables
    for tower in ("fine", "coarse"):
        jsave(str(tmp_path / f"jax_{tower}.ckpt"),
              {"variables": _tower(v, tower)})
    with pytest.raises(ValueError, match="need --ckpt"):
        pserve.main(["--mesh-devices", "2", "--device", "cpu"])
    port_ckpts = _port_stream_ckpts(v, tmp_path)
    sd = pserve.assemble_pipeline_variables(
        None, port_ckpts["fine"], port_ckpts["coarse"], "M", N_CLASSES)
    kw = dict(port=0, cache_bytes=1 << 28, max_batch=3, max_wait_ms=500,
              max_queue=16, request_timeout_s=600)
    assert pserve.serving_devices("cpu", 2) == [torch.device("cpu")] * 2
    servers = {
        "mesh": pserve.build_server(sd, "M", N_CLASSES, mesh_devices=2,
                                    device="cpu", **kw),
        "one": pserve.build_server(sd, "M", N_CLASSES, device="cpu", **kw),
        "jax": jserve.build_server(jserve.assemble_pipeline_variables(
            None, str(tmp_path / "jax_fine.ckpt"),
            str(tmp_path / "jax_coarse.ckpt")), "M", N_CLASSES,
            mesh_devices=2, **kw)}
    rng = np.random.RandomState(4)
    bodies = [{"clips": rng.rand(6, H, H, 3).astype(np.float32),
               "fine_clips": rng.rand(7, H, H, 3).astype(np.float32)}
              for _ in range(3)]
    out = {}
    for name, srv in servers.items():
        srv.start()
        try:
            with concurrent.futures.ThreadPoolExecutor(3) as pool:
                out[name] = list(pool.map(
                    lambda ib: _post(srv.port, f"/v1/score?video_id=v{ib[0]}",
                                     ib[1]), enumerate(bodies)))
            if name == "mesh":
                assert _stats(srv.port)["coarse_fine"]["batches_run"] == 1
        finally:
            srv.stop()
    for a, b, c in zip(out["mesh"], out["one"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-4)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.required, a.nargs, type(a).__name__)
            for a in parser._actions}


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch, argv):
    """The parser ``main(argv)`` builds, captured at ``parse_args``."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("name", ["serve", "convert_checkpoint"])
def test_flags_match_jax(monkeypatch, name):
    """Every flag with its default, type, choices and action; ``serve``
    adds ``--device`` (default ``cuda``), the converter nothing."""
    import importlib

    port = importlib.import_module(f"coarse_fine_networks_torch.cli.{name}")
    jax_ = importlib.import_module(f"coarse_fine_networks_tpu.cli.{name}")
    got = _flags(_parser_of(port.main, monkeypatch, []))
    ref = _flags(_parser_of(jax_.main, monkeypatch, []))
    if name == "serve":
        assert got.pop("device")[:2] == (("--device",), "cuda")
    assert got == ref


# ---- convert_checkpoint --------------------------------------------------

@pytest.mark.parametrize("kind,version", [("fine", "M"), ("coarse", "M")])
def test_convert_round_trip_matches_jax_export(tmp_path, kind, version):
    """A reference-format ``.pt`` (the port's names, the reference's
    ``num_batches_tracked`` counters beside them) → ``.ckpt`` → ``.pt``:
    the ``.ckpt`` holds the driver payload, and the exported
    ``model_state_dict`` equals JAX ``export_torch_state_dict`` of the same
    variables, key for key, exactly."""
    from coarse_fine_networks_tpu.ckpt import export_torch_state_dict
    from coarse_fine_networks_tpu.models import CoarseNet as JCoarse
    from coarse_fine_networks_tpu.models import FineNet as JFine

    jnp = jax.numpy
    clips = jnp.zeros((1, 4, H, H, 3))
    if kind == "fine":
        v = jax_variables(JFine(version=version, n_classes=N_CLASSES,
                                dropout_rate=0.0), clips, seed=1,
                          train=False)
    else:
        from _torch_port_util import BANKS

        feats = {k: jnp.zeros((1, 8, 7, 7, c)) for k, c in BANKS}
        v = jax_variables(JCoarse(version=version, n_classes=N_CLASSES,
                                  dropout_rate=0.0), clips, feats,
                          jnp.ones((1, 8)),
                          jnp.asarray([[0, 4, 8, 1]], jnp.int32), seed=1,
                          train=False)
    sd = state_dict_from_jax(v)
    ref = export_torch_state_dict(v["params"], v["batch_stats"])
    ref_pt = dict(sd)
    ref_pt.update({k.replace("running_mean", "num_batches_tracked"):
                   torch.tensor(7) for k in sd if k.endswith("running_mean")})
    src, mid, out = (str(tmp_path / n) for n in ("ref.pt", "mid.ckpt",
                                                 "out.pt"))
    torch.save({"model_state_dict": ref_pt}, src)
    convert_checkpoint.main(["--input", src, "--output", mid, "--model",
                             kind])
    payload = load_checkpoint(mid)
    assert payload["step"] == 0 and payload["scheduler"] == {"epoch": 0}
    assert set(payload["variables"]) == set(sd)
    convert_checkpoint.main(["--input", mid, "--output", out, "--model",
                             kind, "--to-torch"])
    got = torch.load(out, weights_only=True)["model_state_dict"]
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)


def test_convert_refuses_a_mismatch(tmp_path):
    """A state dict that misses a tensor of the model it names raises."""
    from coarse_fine_networks_torch.models import CoarseNet

    sd = CoarseNet("M", N_CLASSES).state_dict()
    del sd["layer3.4.conv2.weight"]
    src = str(tmp_path / "bad.pt")
    torch.save({"model_state_dict": sd}, src)
    with pytest.raises(ValueError, match="missing"):
        convert_checkpoint.main(["--input", src, "--output",
                                 str(tmp_path / "o.ckpt"), "--model",
                                 "coarse"])
    with pytest.raises(ValueError):
        convert_checkpoint.main(["--input", src, "--output",
                                 str(tmp_path / "o.ckpt"), "--model",
                                 "fine"])
