"""The port's checkpoints: atomic saves and the latest one found, a
reference-named ``.pt`` with a 400-class head loaded as the JAX package
loads it (the fresh 157-class head kept), save → ``maybe_resume`` restoring
the parameters, momentum, step, schedule and input position, and the
preemption guard saving when an exception escapes."""

import os
import signal
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax

from coarse_fine_networks_tpu.models.coarse import CoarseNet as JCoarse
from coarse_fine_networks_tpu.train.common import (
    load_pretrained as jload_pretrained)
from coarse_fine_networks_torch.ckpt import (latest_checkpoint,
                                             load_checkpoint,
                                             save_checkpoint,
                                             state_dict_from_jax)
from coarse_fine_networks_torch.data.loader import PrefetchLoader
from coarse_fine_networks_torch.models import CoarseNet, init_parameters
from coarse_fine_networks_torch.train import (DriverConfig,
                                              MultiStepSchedule, TrainState,
                                              load_pretrained, maybe_resume,
                                              preemption_guard,
                                              save_train_state)

from _torch_port_util import BANKS, jax_variables


def test_save_is_atomic_and_latest_is_found(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    assert latest_checkpoint(d, "run") is None
    for step in (3, 12, 7):
        save_checkpoint(os.path.join(d, f"run_{step:06d}.ckpt"),
                        {"step": step, "w": torch.full((3,), float(step))})
    save_checkpoint(os.path.join(d, "other_000099.ckpt"), {"step": 99})
    open(os.path.join(d, "run_notes.txt"), "w").close()
    best = latest_checkpoint(d, "run")
    assert best.endswith("run_000012.ckpt")
    assert load_checkpoint(best)["step"] == 12
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]

    def broken(obj, f, *a, **k):  # dies half way through the write
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        save_checkpoint(best, {"step": 13})
    monkeypatch.undo()
    raw = load_checkpoint(best)  # the old file is whole
    assert raw["step"] == 12 and torch.equal(raw["w"], torch.full((3,), 12.))


def test_load_pretrained_keeps_the_fresh_head_as_jax_does(tmp_path):
    """A reference-named ``.pt`` of a 400-class coarse model into the
    157-class one: every tensor of matching shape is the file's, the
    class-sized ones (the head ``fc2``, ``rw6``'s ``fc2``/``fc4``) keep
    their fresh init, on the port as in the JAX package's
    ``load_pretrained``."""
    src = init_parameters(CoarseNet("M", 400, dropout_rate=0.0),
                          torch.Generator().manual_seed(1))
    with torch.no_grad():  # non-trivial statistics, so they are checked
        for k, v in src.state_dict().items():
            if "running" in k:
                v.add_(torch.rand(v.shape, generator=torch.Generator()
                                  .manual_seed(len(k))))
    pt = str(tmp_path / "x3d_kinetics.pt")
    torch.save({"model_state_dict": src.state_dict()}, pt)
    ref_sd = src.state_dict()

    model = init_parameters(CoarseNet("M", 157, dropout_rate=0.0),
                            torch.Generator().manual_seed(2))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained(model, pt)
    got = model.state_dict()
    heads = {k for k in got if got[k].shape != ref_sd[k].shape}
    assert heads == {"fc2.weight", "fc2.bias", "rw6.fc2.weight",
                     "rw6.fc2.bias", "rw6.fc4.weight", "rw6.fc4.bias"}
    for k, v in got.items():
        want = fresh[k] if k in heads else ref_sd[k]
        assert torch.equal(v, want), k

    b = dict(clips=np.zeros((1, 8, 32, 32, 3), np.float32),
             feats={k: np.zeros((1, 4, 7, 7, c), np.float32)
                    for k, c in BANKS},
             feat_mask=np.ones((1, 4), np.float32),
             meta=np.array([[0, 8, 4, 1]], np.int32))
    jm = JCoarse(version="M", n_classes=157, dropout_rate=0.0)
    v = jax_variables(jm, b["clips"], b["feats"], b["feat_mask"], b["meta"],
                      train=False)
    jsd = state_dict_from_jax(jax.tree.map(np.asarray, jload_pretrained(
        v, pt, "coarse")))
    jfresh = state_dict_from_jax(v)
    assert set(jsd) == set(got)
    for k in jsd:
        want = jfresh[k] if k in heads else ref_sd[k]
        assert torch.equal(jsd[k], want.float()), k


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Linear(4, 3)
        self.rw = nn.Linear(3, 2)  # the fusion group

    def forward(self, x):
        return self.rw(torch.relu(self.body(x)))


def _state(seed):
    torch.manual_seed(seed)
    return TrainState.create(_Tiny())


def _cfg(tmp_path, **kw):
    return DriverConfig(anno="", root="", save_dir=str(tmp_path / "ck"),
                        device="cpu", **kw)


class _Items:
    rng = None

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return i


def test_save_then_resume_restores_everything(tmp_path):
    state = _state(0)
    for _ in range(2):  # momentum buffers with values
        state.optimizer.zero_grad()
        state.model(torch.randn(5, 4)).square().sum().backward()
        for g in state.optimizer.param_groups:
            g["lr"] = 0.1
        state.optimizer.step()
    state.step = 7
    sched = MultiStepSchedule(0.01, (2, 5))
    for _ in range(3):
        sched.epoch_step()
    loader = PrefetchLoader(_Items(), 3, list, shuffle=True, seed=4,
                            num_workers=1)
    list(loader)
    it = iter(loader)
    first = next(it)
    it.close()
    cfg = _cfg(tmp_path)
    path = save_train_state(cfg, "coarse_x", state, sched, loader=loader)
    assert path.endswith("coarse_x_000007.ckpt")

    new, new_sched = _state(1), MultiStepSchedule(0.01, (2, 5))
    new_loader = PrefetchLoader(_Items(), 3, list, shuffle=True, seed=4,
                                num_workers=1)
    assert maybe_resume(_cfg(tmp_path, resume=False), "coarse_x", new,
                        new_sched) is new and new.step == 0
    out = maybe_resume(cfg, "coarse_x", new, new_sched, loader=new_loader)
    assert out is new and new.step == 7 and new_sched.epoch == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(new.model.state_dict()[k], v), k
    old_m = [state.optimizer.state[p]["momentum_buffer"]
             for p in state.model.parameters()]
    new_m = [new.optimizer.state[p]["momentum_buffer"]
             for p in new.model.parameters()]
    assert all(torch.equal(a, b) and a.abs().sum() > 0
               for a, b in zip(old_m, new_m))
    assert [g["fusion"] for g in new.optimizer.param_groups] == \
        [g["fusion"] for g in state.optimizer.param_groups]
    assert new_loader.state_dict()["epoch"] == 1
    assert new_loader.state_dict()["pos"] == 1
    rest = list(new_loader)  # the rest of epoch 1, after `first`
    uninterrupted = PrefetchLoader(_Items(), 3, list, shuffle=True, seed=4,
                                   num_workers=1)
    list(uninterrupted)
    assert [first] + rest == list(uninterrupted)


def _guarded_failure(cfg, box):
    with preemption_guard(cfg, "coarse_g", box):
        raise RuntimeError("boom")


def test_preemption_guard_saves_when_an_exception_escapes(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(0)
    state.step = 5
    box = {"state": state, "sched": MultiStepSchedule(0.01, ())}
    with pytest.raises(RuntimeError, match="boom"):
        _guarded_failure(cfg, box)
    saved = latest_checkpoint(cfg.save_dir, "coarse_g")
    assert saved.endswith("coarse_g_000005.ckpt")
    assert load_checkpoint(saved)["step"] == 5

    # off the main thread no handler is installed; the save still happens
    state.step = 6
    errors = []

    def run():
        try:
            _guarded_failure(cfg, box)
        except RuntimeError as e:
            errors.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(errors) == 1
    assert latest_checkpoint(cfg.save_dir, "coarse_g").endswith("006.ckpt")

    # nothing to save yet: the error propagates, nothing is written
    with pytest.raises(RuntimeError):
        _guarded_failure(_cfg(tmp_path / "empty"), {"state": None,
                                                    "sched": None})
    assert latest_checkpoint(str(tmp_path / "empty" / "ck"), "coarse_g") \
        is None


def test_preemption_guard_turns_sigterm_into_a_checkpoint(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed on the main thread only")
    cfg = _cfg(tmp_path)
    state = _state(0)
    state.step = 9
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as e:
        with preemption_guard(cfg, "coarse_s", {
                "state": state, "sched": MultiStepSchedule(0.01, ())}):
            handler = signal.getsignal(signal.SIGTERM)
            assert handler is not before
            handler(signal.SIGTERM, None)  # as the signal would
    assert e.value.code == 128 + signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before
    assert latest_checkpoint(cfg.save_dir, "coarse_s").endswith("009.ckpt")
