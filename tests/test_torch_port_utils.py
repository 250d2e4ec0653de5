"""The port's ``utils/hw.py`` and ``utils/profiling.py`` on the CPU: the
card's peaks by name, ``utilization`` against the JAX package's, ``sync``,
``StepTimer``, ``trace``, and ``program_costs``: exact on a product and on
a small ``FineNet`` forward, the same whether the depthwise convs run
through the port's wrappers or a grouped ``F.conv3d``, with the backward
of a coarse train step, and beside XLA's count of the same forward
(``compiled_costs``).  The card's side (``chip_peaks`` of the card, the
count on the card against the CPU's, ``StepTimer`` against CUDA events,
the trace's kernel records against the launch counters) is
``chip_smoke.py``'s ``utils`` phase.
"""

import glob
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.utils import hw as jhw
from coarse_fine_networks_torch.models import (CoarseNet, FineNet,
                                               init_parameters)
from coarse_fine_networks_torch.models import x3d
from coarse_fine_networks_torch.train import TrainState, make_train_step
from coarse_fine_networks_torch.utils import hw, profiling

from _torch_port_util import COARSE, coarse_batch

torch.set_num_threads(2)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def card_named(monkeypatch):
    """``torch.cuda.get_device_name`` answering ``name`` (set by the
    test): the CPU has no card to ask."""
    box = {"name": H100}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: box["name"])
    return box


@pytest.fixture
def one_block_a_stage(monkeypatch):
    """One bottleneck a stage (block 0: strided, SE, the downsample) in
    both packages' trunks."""
    from coarse_fine_networks_tpu.models import fine as jfine

    for mod in (jfine, x3d):
        monkeypatch.setattr(mod, "get_blocks", lambda version: [1, 1, 1, 1])


# ---- peaks, utilization, sync, StepTimer, trace ----------------------------

def test_chip_peaks_by_name(card_named):
    known = hw.peaks_for_name(H100)
    assert known == hw.H100_SXM and known.known
    assert (known.flops_bf16, known.hbm_bw, known.flops_f32) == (
        989e12, 3.35e12, 67e12)
    other = hw.peaks_for_name("NVIDIA A100-SXM4-80GB")
    assert not other.known and "NVIDIA A100-SXM4-80GB" in other.name
    assert other[1:3] == known[1:3] and other.flops_f32 == known.flops_f32
    assert hw.chip_peaks() == known
    assert hw.chip_peaks("cuda:0") == known
    card_named["name"] = "NVIDIA H100 PCIe"  # another part, other peaks
    assert not hw.chip_peaks().known
    with pytest.raises(ValueError):
        hw.chip_peaks("cpu")


def test_utilization_implies_the_jax_rates(card_named):
    """The same FLOPs, bytes and time: each package divides by its own
    chip's peaks (JAX's CPU device is unknown to it: v5e assumed), so the
    FLOP/s and bytes/s they imply are equal."""
    flops, nbytes, secs = 1.25e12, 3.5e10, 0.271
    got = hw.utilization(flops, nbytes, secs)
    ref = jhw.utilization(flops, nbytes, secs)
    assert set(got) == set(ref) == {"mfu", "hbm_bw_util", "chip"}
    assert got["chip"] == "H100 SXM"
    jpk = jhw.chip_peaks()
    assert got["mfu"] * hw.H100_SXM.flops_bf16 == pytest.approx(
        ref["mfu"] * jpk.flops_bf16, rel=1e-12)
    assert got["hbm_bw_util"] * hw.H100_SXM.hbm_bw == pytest.approx(
        ref["hbm_bw_util"] * jpk.hbm_bw, rel=1e-12)
    assert got["mfu"] == pytest.approx(flops / secs / 989e12, rel=1e-12)
    zero = hw.utilization(flops, nbytes, 0.0)
    assert zero == {"mfu": 0.0, "hbm_bw_util": 0.0, "chip": "H100 SXM"}
    assert zero.keys() == jhw.utilization(flops, nbytes, 0.0).keys()


def test_sync_and_step_timer():
    a, b = torch.ones(3), torch.zeros(0)
    tree = {"x": [a, b], "y": (torch.arange(4), 7)}
    assert hw.sync(tree) is tree
    assert hw.sync([]) == []
    timer = profiling.StepTimer()
    assert timer.mean == 0.0 and timer.best == 0.0
    out = []
    with timer.measure(out):
        out.append(torch.mm(torch.ones(64, 64), torch.ones(64, 64)))
    with timer.measure():
        pass
    assert len(timer.times) == 2 and all(t >= 0 for t in timer.times)
    assert timer.best == min(timer.times)
    assert timer.mean == pytest.approx(sum(timer.times) / 2)


def test_trace_writes_a_file_naming_the_ops(tmp_path):
    x = torch.randn(32, 16)
    with profiling.trace(str(tmp_path)):
        torch.mm(x, x.t())
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_build_directory():
    from coarse_fine_networks_torch.ops import _build

    default = _build.BUILD_DIR
    try:
        assert hw.enable_compilation_cache() == str(default)
        moved = "/tmp/cfn_build"
        assert hw.enable_compilation_cache(moved) == moved
        assert _build.BUILD_DIR.as_posix() == moved
    finally:
        _build.BUILD_DIR = default


# ---- program_costs -----------------------------------------------------------

def test_program_costs_of_a_product():
    m, k, n = 24, 40, 56
    a, b = torch.randn(m, k), torch.randn(k, n)
    got = hw.program_costs(torch.mm, a, b)
    assert got["flops"] == 2 * m * n * k
    assert got["bytes"] == (m * k + k * n + m * n) * 4
    assert got["kernels"] == {}
    # views move nothing, a copy its input and output
    assert hw.program_costs(lambda: a.t().reshape(-1))["bytes"] == (
        2 * m * k * 4)


def _clips(seed, b=1, t=4, hw_=32):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        b, t, hw_, hw_, 3).astype(np.float32))


def _finenet(seed=0):
    return init_parameters(FineNet("M"), torch.Generator().manual_seed(seed)
                           ).eval()


def _finenet_flops(model, x) -> int:
    """A global tower's forward FLOPs from its layers' shapes: conv1_s
    (3 → C, 1×3×3), conv1_t (5 taps a channel), each bottleneck's conv1,
    27 depthwise taps, SE's two products on the pooled vector, conv3 and
    the downsample, and conv5; 2 FLOPs a multiply-add."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, i, o: seen.append(
        (mod, tuple(i[0].shape), tuple(o.shape))))
        for m in model.modules() if isinstance(m, x3d.Bottleneck)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    b, t, hh, ww, _ = x.shape
    c0 = model.conv1_s.out_channels
    stem = b * t * ((hh - 1) // 2 + 1) * ((ww - 1) // 2 + 1) * c0
    flops = 2 * stem * 27 + 2 * stem * 5
    for blk, (_, _, h, w, c_in), (_, _, ho, wo, c_out) in seen:
        c_mid = blk.conv1.out_channels
        pos, pos_out = b * t * h * w, b * t * ho * wo
        flops += 2 * pos * c_in * c_mid + 2 * 27 * pos_out * c_mid
        if blk.use_se:
            flops += 2 * 2 * b * c_mid * blk.fc1.out_channels
        flops += 2 * pos_out * c_mid * c_out
        if blk.downsample is not None:
            flops += 2 * pos_out * c_in * c_out
    c5 = model.conv5
    return flops + 2 * pos_out * c5.in_channels * c5.out_channels


def _grouped_conv_route(monkeypatch):
    """The bottleneck entry as conv1's product, the apply and relu in
    PyTorch and a grouped ``F.conv3d``, and the stem's ``conv1_t`` as a
    grouped ``F.conv3d``: the same weights, no hand-written kernel."""
    def entry(x, w1, w_dw, sc, bi, stride):
        a = torch.relu(torch.matmul(x, w1) * sc + bi)
        y = F.conv3d(a.permute(0, 4, 1, 2, 3),
                     w_dw.permute(3, 0, 1, 2).unsqueeze(1),
                     stride=(1, stride, stride), padding=1,
                     groups=w_dw.shape[-1])
        return y.permute(0, 2, 3, 4, 1)

    def stem(x, taps, strides=(1, 1, 1)):
        k = taps.shape[:3]
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     taps.permute(3, 0, 1, 2).unsqueeze(1), stride=strides,
                     padding=[s // 2 for s in k], groups=taps.shape[-1])
        return y.permute(0, 2, 3, 4, 1)

    monkeypatch.setattr(x3d, "dw_mm_bnrelu_conv3d_train", entry)
    monkeypatch.setattr(x3d, "depthwise_conv3d", stem)


def test_program_costs_of_a_small_finenet(one_block_a_stage, monkeypatch):
    """Exactly the count from the layer shapes through the port's
    wrappers (each kernel's formula); the same FLOPs through PyTorch's
    products and grouped convolutions, and the same outputs."""
    model, x = _finenet(), _clips(0)
    want = _finenet_flops(model, x)
    with torch.no_grad():
        ref = model(x)
        got = hw.program_costs(model, x)
    assert got["flops"] == want
    assert got["kernels"]["dw_mm_bnrelu_conv3d"][0] == 4
    assert got["kernels"]["dw_stencil3d"][0] == 1
    _grouped_conv_route(monkeypatch)
    with torch.no_grad():
        lib = hw.program_costs(model, x)
        out = model(x)
    assert lib["kernels"] == {}
    assert lib["flops"] == want
    # the fused entry moves less than its unfused sequence
    assert got["bytes"] < lib["bytes"]
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# XLA's count of the same forward over the port's.  XLA counts every
# elementwise operation (batch norm, relu, swish, SE's sigmoid and scale,
# the residual adds, the poolings), which products-only counting leaves
# out, and the JAX stem's space-to-depth conv (a 2×2 conv over 12 channels
# for the 3×3 stride-2 one: 48 multiply-adds an output for 27).  Measured
# at this configuration: 0.8835 (port 13.74 MFLOP, XLA 15.55; without
# the hand-written kernels' FLOPs the port's count would be 0.35 of XLA's)
JAX_RATIO = (0.80, 0.95)


def test_program_costs_beside_xla(one_block_a_stage):
    from coarse_fine_networks_tpu.models.fine import FineNet as JFine

    from _torch_port_util import jax_variables, load_port

    x = _clips(0)
    jm = JFine(version="M", global_tower=True)
    v = jax_variables(jm, jnp.asarray(x.numpy()), train=False)
    pm = load_port(FineNet("M"), v)
    compiled = jax.jit(lambda xx: jm.apply(v, xx, False)).lower(
        jnp.asarray(x.numpy())).compile()
    xla = jhw.compiled_costs(compiled)
    with torch.no_grad():
        got = hw.program_costs(pm, x)
    ratio = got["flops"] / xla["flops"]
    print(f"port {got['flops']:.6g} FLOPs, XLA {xla['flops']:.6g}: "
          f"ratio {ratio:.4f}; bytes {got['bytes']:.6g} and "
          f"{xla['bytes']:.6g}")
    assert JAX_RATIO[0] <= ratio <= JAX_RATIO[1], ratio


def test_program_costs_count_the_backward():
    """A coarse train step (the act route) counts the forward, the loss and
    the backward: each act-route entry's dx and weight gradient once a
    forward call, the stem's dx and taps' gradient, and the library
    products' backward."""
    c = COARSE
    model = init_parameters(CoarseNet("M", c["n_classes"], dropout_rate=0.0),
                            torch.Generator().manual_seed(0))
    batch = jax.tree.map(torch.from_numpy, coarse_batch(0))
    step = make_train_step(model, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    state = TrainState.create(model)
    costs = hw.program_costs(step, state, batch, c["lr"])
    kern = {k: v[0] for k, v in costs["kernels"].items()}
    assert kern == {"dw_stencil3d": 2, "dw_stencil_wgrad": 1,
                    "dw_bnrelu_conv3d": 26, "dw_act_dx": 26,
                    "dw_act_wgrad": 26}
    with torch.no_grad():
        fwd = hw.program_costs(model, batch["clips"], batch["feats"],
                               batch["feat_mask"], batch["meta"])
    ratio = costs["flops"] / fwd["flops"]
    # the backward: two products for each forward one (the input's and the
    # weight's gradient), less the input gradients nothing needs (of the
    # stem's conv1_s on the clip, of the fusion's first products on the
    # fine banks): 2.43 measured; without the library ops' backward ~1
    assert 2.0 < ratio < 3.0, ratio
    assert costs["bytes"] > 2 * fwd["bytes"]
    assert math.isfinite(costs["flops"])
