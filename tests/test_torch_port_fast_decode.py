"""The port's DCT-scaled fast decode (``ops/scaled_decode.py`` over
``csrc/jpeg_entropy.cpp``, the plain version of ``idct_rgb_kernel``, and
``crop_resize_plain``) against the JAX library's
fast mode (``native/cfn_data.cpp``'s ``decode_crop_scaled`` over
libjpeg-turbo), on the CPU.

Tolerance 0: uint8 frames equal.  4:2:0, 4:4:4 and 4:2:2 RGB and grey
frames, at a size that is no MCU multiple (61×45) and at 256×192 with
outputs at which the scale reaches 8, 4, 2 and 1; centre and random crops,
from files and from a pack; restart markers.  Frames the port refuses raise
naming the frame; the default mode follows
``CFN_EXACT_DECODE``; Pillow's ``draft`` decode, cropped by the same
rules, agrees for 4:2:0 and 4:4:4 (it keeps fancy upsampling, which 4:2:2
needs).  The kernel itself is held against its plain version by
``chip_smoke.py``'s ``fast_decode`` phase.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from coarse_fine_networks_tpu.data import native as jnative
from coarse_fine_networks_torch.data import native as pnative
from coarse_fine_networks_torch.ops import frame_decode
from coarse_fine_networks_torch.ops import scaled_decode as sd
from coarse_fine_networks_torch.utils import hw

from _torch_port_util import jax_native_library

torch.set_num_threads(2)

_NATIVE_MISSING = jax_native_library()
pytestmark = pytest.mark.skipif(_NATIVE_MISSING is not None,
                                reason=str(_NATIVE_MISSING))

# Pillow's subsampling argument of each layout (None: a grey frame)
LAYOUTS = {"420": 2, "444": 0, "422": 1, "grey": None}
SIZES = [(256, 192), (61, 45)]
# outputs of a 256×192 frame's centre crop (192²) at each scale num/8
OUT_BY_NUM = {8: 150, 4: 60, 2: 30, 1: 12}
# (out, scale, tl_x, tl_y) of the random crops
CROPS = [(40, 0.7, 0.3, 0.6), (20, 0.875, 0.9, 0.05), (9, 1.0, 0.5, 0.5)]


@pytest.fixture(autouse=True)
def fast_on_both_sides():
    """Both packages in their fast mode, each restored after."""
    prev = jnative.set_fast_decode(True), pnative.set_fast_decode(True)
    yield
    jnative.set_fast_decode(prev[0])
    pnative.set_fast_decode(prev[1])


def _image(rng, w, h, layout, kind):
    if kind == "noise":
        shape = (h, w) if layout == "grey" else (h, w, 3)
        return rng.randint(0, 256, shape).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.sin(xx / 7.0) * 60 + np.cos(yy / 5.0) * 60 + 128
    a = base if layout == "grey" else np.stack(
        [base, base[::-1], base[:, ::-1]], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def _save(a, path, layout, **kw):
    img = Image.fromarray(a, "L" if layout == "grey" else "RGB")
    if layout != "grey":
        kw["subsampling"] = LAYOUTS[layout]
    img.save(path, "JPEG", **kw)
    return path


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Per (layout, size): three frames, two noise (quality 90 and 20, the
    latter's IDCT outputs reaching libjpeg's range-limit wrap) and one
    smooth."""
    root = tmp_path_factory.mktemp("fast")
    rng = np.random.RandomState(0)
    out = {}
    for layout in LAYOUTS:
        for w, h in SIZES:
            paths = []
            for i, (kind, q) in enumerate([("noise", 90), ("noise", 20),
                                           ("smooth", 90)]):
                paths.append(_save(_image(rng, w, h, layout, kind),
                                   str(root / f"{layout}_{w}_{i}.jpg"),
                                   layout, quality=q))
            out[layout, (w, h)] = paths
    return out


def _eq(got, ref):
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_mode_switch():
    """``set_fast_decode`` returns the previous mode, and both decode
    functions follow it."""
    assert pnative.fast_decode() is True
    assert pnative.set_fast_decode(False) is True
    assert pnative.fast_decode() is frame_decode.fast_decode() is False
    assert pnative.set_fast_decode(True) is False


def test_env_default():
    """Fast unless ``CFN_EXACT_DECODE`` is set (to anything), read on first
    use, in both packages: a fresh process for each setting, the three at
    once (the JAX library is the one the module's fixture installed)."""
    code = ("from coarse_fine_networks_torch.data import native as p;"
            "from coarse_fine_networks_tpu.data import native as q;"
            "print(p.fast_decode(), q.fast_decode())")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {}
    for env, fast in ((None, True), ("1", False), ("", False)):
        e = {k: v for k, v in os.environ.items() if k != "CFN_EXACT_DECODE"}
        if env is not None:
            e["CFN_EXACT_DECODE"] = env
        procs[env, fast] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=root, env=e, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    for (env, fast), proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        assert out.split()[-2:] == [str(fast)] * 2, (env, out)


def test_geometry():
    """The C++'s scale and scaled box, and libjpeg's component sizes."""
    assert {n: sd.scale_num(192, o) for n, o in OUT_BY_NUM.items()} == {
        8: 8, 4: 4, 2: 2, 1: 1}
    assert sd.scale_num(480, 224) == 4 and sd.scale_num(480, 112) == 2
    assert sd.scale_num(480, 56) == 1 and sd.scale_num(1, 1) == 8
    s420, s422 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))
    assert [sd.component_sizes(s420, n) for n in (4, 2, 1)] == [
        [4, 8, 8], [2, 4, 4], [1, 2, 2]]
    assert sd.component_sizes(s422, 4) == [4, 4, 4]
    assert sd.component_sizes(((1, 1),) * 3, 2) == [2, 2, 2]
    # 640×480 centre crop to 224: the Charades fine path
    g = sd.geometry(640, 480, s420, (80, 0, 480, 480), 224)
    assert (g.num, g.win, g.height, g.width, g.box) == (
        4, (5, 35, 0, 30), 240, 240, (0, 0, 240, 240))
    assert [(c.s, c.hexp, c.vexp) for c in g.comps] == [
        (4, 1, 1), (8, 1, 1), (8, 1, 1)]
    g = sd.geometry(640, 480, s422, (80, 0, 480, 480), 224)
    assert [(c.s, c.hexp, c.vexp) for c in g.comps] == [
        (4, 1, 1), (4, 2, 1), (4, 2, 1)]
    # the box's clamps, in the C++'s order
    assert sd.scaled_box(61, 44, 1, 1, 8, 6) == (7, 5, 1, 1)
    assert sd.scaled_box(3, 2, 45, 4, 31, 23) == (1, 1, 23, 22)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fast_decode_matches_jax(frames, layout, size):
    """Centre and random crops from files: every output at which the
    256×192 frames' scale reaches 8, 4, 2 and 1, the random crops' sizes."""
    paths = frames[layout, size]
    for out in OUT_BY_NUM.values():
        _eq(pnative.decode_batch(paths, out, device="cpu"),
            jnative.decode_batch(paths, out))
    for crop in CROPS:
        _eq(pnative.decode_batch_random_crop(paths, *crop, device="cpu"),
            jnative.decode_batch_random_crop(paths, *crop))


def test_packed_fast_decode_matches_jax(frames, tmp_path):
    """From a pack of mixed layouts and sizes (grouped by layout), at
    selected indices, centre and random crops."""
    paths = [p for k in (("420", (256, 192)), ("grey", (61, 45)),
                         ("422", (256, 192))) for p in frames[k]]
    pack = str(tmp_path / "mixed.cfnpack")
    pnative.pack_video(paths, pack)
    idx = [0, 4, 7, 2, 5, 8, 3]
    for out in (60, 12):
        _eq(pnative.decode_packed(pack, idx, out, device="cpu"),
            jnative.decode_packed(pack, idx, out))
    for crop in CROPS[:2]:
        _eq(pnative.decode_packed_random_crop(pack, idx, *crop,
                                              device="cpu"),
            jnative.decode_packed_random_crop(pack, idx, *crop))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("layout", ["420", "grey"])
def test_restart_markers(tmp_path, layout, restart):
    """Frames with restart intervals (the DC predictions reset at each
    RSTn)."""
    rng = np.random.RandomState(3)
    paths = [_save(_image(rng, 256, 192, layout, "noise"),
                   str(tmp_path / f"r{i}.jpg"), layout, quality=85,
                   **restart) for i in range(2)]
    with open(paths[0], "rb") as f:
        assert b"\xff\xdd" in f.read()  # a DRI segment
    for out in (60, 30):
        _eq(pnative.decode_batch(paths, out, device="cpu"),
            jnative.decode_batch(paths, out))
    _eq(pnative.decode_batch_random_crop(paths, *CROPS[0], device="cpu"),
        jnative.decode_batch_random_crop(paths, *CROPS[0]))


def test_refused_frames_raise(frames, tmp_path):
    """The frames the port's decoder once refused now decode as the JAX
    library's do in its fast mode, below 8/8 and at it: a progressive frame
    and a frame cut short (libjpeg's grey fill).  What still raises
    :class:`IOError` naming the frame: a frame the JAX library fails on too
    (not a JPEG, a 12-bit frame), without the exact mode's hint; and below
    8/8 an RGB-transform frame (which the JAX library decodes and the port
    leaves to the exact mode), naming ``CFN_EXACT_DECODE=1``."""
    a = _image(np.random.RandomState(4), 256, 192, "420", "noise")
    prog = _save(a, str(tmp_path / "prog.jpg"), "420", quality=90,
                 progressive=True)
    cut = str(tmp_path / "cut.jpg")
    with open(frames["420", (256, 192)][0], "rb") as f:
        blob = f.read()
    with open(cut, "wb") as f:
        f.write(blob[:len(blob) // 2])
    for out in (OUT_BY_NUM[4], OUT_BY_NUM[8]):
        _eq(pnative.decode_batch([prog, cut], out, device="cpu"),
            jnative.decode_batch([prog, cut], out))
    broken = str(tmp_path / "broken.jpg")
    with open(broken, "wb") as f:
        f.write(b"not a jpeg")
    deep = bytearray(blob)
    sof = deep.index(b"\xff\xc0")
    deep[sof + 4] = 12
    deep_path = str(tmp_path / "deep.jpg")
    with open(deep_path, "wb") as f:
        f.write(bytes(deep))
    rgb = os.path.join(os.path.dirname(__file__), "torch_port_jpegs",
                       "rgb_transform_444.jpg")
    good = frames["420", (256, 192)][:1]
    for bad, why, hint in ((broken, "not a JPEG", False),
                           (deep_path, "not 8 bits", False),
                           (rgb, "RGB colour transform", True)):
        with pytest.raises(IOError, match=why) as err:
            pnative.decode_batch(good + [bad], 60, device="cpu")
        assert os.path.basename(bad) in str(err.value)
        assert ("CFN_EXACT_DECODE=1" in str(err.value)) == hint
    jnative.decode_batch([rgb], 60)  # libjpeg reads it
    _eq(pnative.decode_batch([rgb], OUT_BY_NUM[8], device="cpu"),
        jnative.decode_batch([rgb], OUT_BY_NUM[8]))


@pytest.mark.parametrize("layout", ["420", "444"])
def test_pillow_draft_cross_check(frames, layout):
    """Pillow's ``draft`` decode at num/8 (libjpeg-turbo too, fancy
    upsampling on), cropped at the C++'s scaled box and resized by
    ``crop_resize_plain``: the port's fast path, where chroma needs no
    upsampling (4:2:0 chroma comes out 1:1, 4:4:4 has none)."""
    for path in frames[layout, (256, 192)]:
        for out in (60, 30, 12):
            num = sd.scale_num(192, out)
            sw, sh = sd.scaled_size(256, num), sd.scaled_size(192, num)
            with Image.open(path) as img:
                img.draft("RGB", (sw, sh))
                full = np.asarray(img.convert("RGB"))
            assert full.shape == (sh, sw, 3)
            box = sd.scaled_box(32, 0, 192, num, sw, sh)
            ref = frame_decode.crop_resize_plain(
                torch.from_numpy(full.copy())[None], [box], out).numpy()
            _eq(pnative.decode_batch([path], out, device="cpu"), ref)


def test_window_decode_is_the_full_decode(frames):
    """The entropy decoder's window (MCU columns emitted, rows below never
    decoded) holds the full frame's coefficients at the same blocks; and
    its threads give the same result."""
    paths = frames["420", (256, 192)] + frames["420", (256, 192)]
    blobs = [open(p, "rb").read() for p in paths]
    p = sd.probe(blobs[0])
    assert p.status == 0 and p.samp == ((2, 2), (1, 1), (1, 1))
    full = sd.geometry(256, 192, p.samp, (0, 0, 192, 192), 60)
    full = full._replace(win=(0, 16, 0, 12))  # the frame's 16 × 12 MCUs
    part = sd.geometry(256, 192, p.samp, (32, 0, 192, 192), 60)
    part = part._replace(win=(3, 9, 2, 5), frame_blocks=72 + 2 * 18)
    cf, qf = sd.entropy_decode(blobs, paths, p, _blocks(full, p))
    cp, qp = sd.entropy_decode(blobs, paths, p, part, num_threads=3)
    assert torch.equal(qf, qp)
    # luma: window rows 4..9, columns 6..17 of the frame's 24 × 32 blocks
    lf = cf[:, :24 * 32].view(-1, 24, 32, 64)[:, 4:10, 6:18]
    assert torch.equal(lf.reshape(-1, 72, 64), cp[:, :72])
    cbf = cf[:, 24 * 32:24 * 32 + 12 * 16].view(-1, 12, 16, 64)[:, 2:5, 3:9]
    assert torch.equal(cbf.reshape(-1, 18, 64), cp[:, 72:90])
    # four Python threads at once, each with threads of its own
    res = [None] * 4

    def run(i):
        res[i] = sd.entropy_decode(blobs, paths, p, part, num_threads=2)[0]
    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(torch.equal(r, cp) for r in res)


def _blocks(g, p):
    """``g`` with the frame's whole MCU grid as its window's blocks."""
    wc, wr = g.win[1] - g.win[0], g.win[3] - g.win[2]
    return g._replace(frame_blocks=sum(wc * h * wr * v for h, v in p.samp))


def test_wrappers_on_the_cpu_and_their_work(frames):
    """On CPU tensors the wrapper runs the plain version (no launch
    counted); ``program_costs`` counts the wrapper's Work and nothing
    inside it, the same formula ``chip_smoke.py`` bounds the kernel by."""
    blobs = [open(p, "rb").read() for p in frames["422", (256, 192)]]
    p = sd.probe(blobs[0])
    g = sd.geometry(256, 192, p.samp, (32, 0, 192, 192), 60)
    coefs, qt = sd.entropy_decode(blobs, ["f"] * 3, p, g)
    sd.reset_launches()
    rgb = sd.idct_rgb(coefs, qt, g)
    assert torch.equal(rgb, sd.idct_rgb_plain(coefs, qt, g))
    assert torch.equal(rgb, sd.ycc_rgb_plain(sd.scaled_idct_plain(
        coefs, qt, g), g))
    assert rgb.shape == (3, g.height, g.width, 3)
    assert sd.LAUNCHES == {"idct_rgb_kernel": 0}
    costs = hw.program_costs(lambda: sd.idct_rgb(coefs, qt, g))
    wk = sd.idct_rgb_work(rgb, coefs, qt, g)
    assert costs["kernels"] == {"idct_rgb": [1, 0, wk.bytes]}
    assert costs["bytes"] == wk.bytes and costs["flops"] == 0
    assert wk.bytes == 3 * (g.frame_blocks * 128 + 3 * 256
                            + 3 * g.height * g.width)


def test_idct_sizes_against_the_dct():
    """The plain 8×8 IDCT is libjpeg's islow: a block of one cosine
    decodes within 1 of the inverse DCT at the pixel centres, at every
    frequency; each reduced size gives a DC block's flat value."""
    xs = np.arange(8)
    for u in range(8):
        for v in range(8):
            coef = torch.zeros(1, 8, 8, dtype=torch.int32)
            coef[0, u, v] = 200
            got = sd.idct_blocks_plain(coef, 8)[0].to(torch.float64)
            cu = np.cos((2 * xs + 1) * u * np.pi / 16) * (
                np.sqrt(0.5) if u == 0 else 1)
            cv = np.cos((2 * xs + 1) * v * np.pi / 16) * (
                np.sqrt(0.5) if v == 0 else 1)
            ref = 128 + 200 / 4 * np.outer(cu, cv)
            assert np.abs(got.numpy() - ref).max() <= 1.0 + 1e-9, (u, v)
    dc = torch.zeros(1, 8, 8, dtype=torch.int32)
    dc[0, 0, 0] = 200
    for s in (4, 2, 1):
        assert (sd.idct_blocks_plain(dc, s) == 153).all(), s


def test_kernel_source_pins():
    """The kernels' source and the plain versions share their constants:
    the colour tables' FIX values, the geometry array's layout, the
    plane alignment."""
    src = open(os.path.join(os.path.dirname(sd.__file__), os.pardir, "csrc",
                            "scaled_idct.cu")).read()
    assert (f"FIX_R = {sd.FIX_R}, FIX_B = {sd.FIX_B}, FIX_GR = {sd.FIX_GR}, "
            f"FIX_GB = {sd.FIX_GB}") in src
    assert (f"GEOM_HEAD = {sd.GEOM_HEAD}, GEOM_COMP = {sd.GEOM_COMP}"
            in src)
    assert len(sd.Comp._fields) == sd.GEOM_COMP
    for c in ("4433", "15137", "6270", "9633", "2446", "16819", "25172",
              "12299", "7373", "20995", "16069", "3196", "1730", "11893",
              "17799", "8697", "4176", "4926", "5906", "6967", "10426",
              "29692"):
        assert c in src, c
    assert sd.LIBRARY._lib is None and sd.ENTROPY.source.suffix == ".cpp"
