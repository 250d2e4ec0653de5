"""The port's command lines against the JAX package's: each ``main(argv)``
with both packages' driver entry monkeypatched to capture what it is
given, so that the port's ``DriverConfig`` equals the JAX one field for
field (but ``device``); the parsers' flags and defaults (but ``--device``);
``--device cpu`` reaching the driver; ``--help`` of ``python -m``; and no
module of the port importing JAX or the JAX package."""

import dataclasses
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import coarse_fine_networks_torch
from coarse_fine_networks_tpu.cli import common as jcommon

ROOT = Path(__file__).resolve().parents[1]
# each command line and the driver entry its main calls
CLIS = {"pretrain_kinetics": ("kinetics_driver", "run"),
        "train_fine": ("fine_driver", "run"),
        "extract_fineFEAT": ("extract_driver", "run"),
        "train_coarse_fineFEAT": ("coarse_driver", "run")}
ARGV = {"pretrain_kinetics": [],
        "train_fine": ["--kinetics-ckpt", "k.ckpt"],
        "extract_fineFEAT": ["--save-feat-dir", "feats", "--fine-ckpt",
                             "fine_charades_000100.ckpt"],
        "train_coarse_fineFEAT": ["--fine-feat-dir", "feats",
                                  "--localize-csv", "out.csv"]}
# flags every command line is given in some case: the user's overrides of
# the CLIs' own defaults, and of the shared ones
OVERRIDES = ["--batch-size", "3", "--lr", "0.5", "--frames", "24",
             "--max-epochs", "7", "--warmup-steps", "5", "--version", "S",
             "--dtype", "float32", "--no-resume", "--debug-nans",
             "--max-steps", "11", "--accum-steps", "2", "--num-workers",
             "1", "--save-dir", "out", "--anno", "a.json"]


def _mains(name):
    port = importlib.import_module(f"coarse_fine_networks_torch.cli.{name}")
    jax_ = importlib.import_module(f"coarse_fine_networks_tpu.cli.{name}")
    return port, jax_


def _captured(monkeypatch, module, name):
    """Run ``module.main`` with its driver's entry replaced: returns the
    arguments the entry was called with, and the parser ``main`` built."""
    driver_mod, attr = CLIS[name]
    seen, parsers = [], []
    monkeypatch.setattr(getattr(module, driver_mod), attr,
                        lambda *a, **k: seen.append((a, k)) or "results")
    real = module.base_parser
    monkeypatch.setattr(module, "base_parser",
                        lambda d: parsers.append(real(d)) or parsers[-1])
    return seen, parsers


def _run(monkeypatch, module, name, argv):
    seen, parsers = _captured(monkeypatch, module, name)
    assert module.main(argv) == "results"
    (args, kwargs), = seen
    return args, kwargs, parsers[0]


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("extra", [[], OVERRIDES], ids=["defaults",
                                                        "overrides"])
@pytest.mark.parametrize("name", sorted(CLIS))
def test_config_matches_jax(monkeypatch, name, extra):
    """The driver gets the JAX CLI's configuration, field for field (the
    port's ``device`` aside, ``cuda`` by default), and the same other
    arguments."""
    port, jax_ = _mains(name)
    argv = ["--root", "frames"] + ARGV[name] + extra
    (cfg, *rest), kw, _ = _run(monkeypatch, port, name, argv)
    (jcfg, *jrest), jkw, _ = _run(monkeypatch, jax_, name, argv)
    got, ref = _fields(cfg), _fields(jcfg)
    assert got.pop("device") == "cuda"
    assert got == ref
    assert (rest, kw) == (jrest, jkw)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.required, a.nargs, type(a).__name__)
            for a in parser._actions}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_parser_flags_match_jax(monkeypatch, name):
    """Every flag with its default, type, choices and action; the port adds
    ``--device`` (default ``cuda``) and nothing else."""
    port, jax_ = _mains(name)
    argv = ["--root", "frames"] + ARGV[name]
    *_, parser = _run(monkeypatch, port, name, argv)
    *_, jparser = _run(monkeypatch, jax_, name, argv)
    got, ref = _flags(parser), _flags(jparser)
    device = got.pop("device")
    assert device[:2] == (("--device",), "cuda")
    assert got == ref
    assert _flags(jcommon.base_parser("x")).keys() <= ref.keys()


@pytest.mark.parametrize("name", sorted(CLIS))
def test_device_flag_reaches_the_driver(monkeypatch, name):
    port, _ = _mains(name)
    argv = ["--root", "frames", "--device", "cpu"] + ARGV[name]
    (cfg, *_), _, _ = _run(monkeypatch, port, name, argv)
    assert cfg.device == "cpu"


# flags each command line's --help must name
HELP_FLAGS = {**{name: ("--device", "--root") for name in CLIS},
              "serve": ("--device", "--fine-ckpt", "--prewarm-dir"),
              "convert_checkpoint": ("--input", "--to-torch")}


def test_help_runs_as_a_module():
    """``python -m coarse_fine_networks_torch.cli.<name> --help`` for each
    command line, in processes started together."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"coarse_fine_networks_torch.cli.{name}",
         "--help"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in HELP_FLAGS}
    for name, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, (name, err)
        assert all(f in out for f in HELP_FLAGS[name]), (name, out)


def test_no_module_of_the_port_imports_jax():
    """Every module of the package, imported in a fresh interpreter, leaves
    no ``jax``, ``flax`` or ``coarse_fine_networks_tpu`` module loaded."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        coarse_fine_networks_torch.__path__, "coarse_fine_networks_torch."))
    assert {"coarse_fine_networks_torch.cli.train_fine",
            "coarse_fine_networks_torch.train.kinetics_driver",
            "coarse_fine_networks_torch.data.kinetics",
            "coarse_fine_networks_torch.utils.logging",
            "coarse_fine_networks_torch.serve.router",
            "coarse_fine_networks_torch.serve.http",
            "coarse_fine_networks_torch.ckpt.strict",
            "coarse_fine_networks_torch.cli.serve",
            "coarse_fine_networks_torch.cli.convert_checkpoint"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'coarse_fine_networks_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_logger_prints_the_drivers_lines(capsys):
    """``get_logger``: the drivers' ``cfn_torch`` lines reach stdout at
    INFO, with one handler however often it is asked for."""
    from coarse_fine_networks_torch.utils import get_logger

    log = get_logger()
    assert get_logger() is log and len(log.handlers) == 1
    handler = log.handlers[0]
    stream = handler.stream
    handler.setStream(sys.stdout)  # capsys's stdout
    try:
        import logging

        logging.getLogger("cfn_torch").info("step %d", 3)
    finally:
        handler.setStream(stream)
    assert "cfn_torch INFO step 3" in capsys.readouterr().out
