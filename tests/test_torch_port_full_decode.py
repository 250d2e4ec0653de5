"""The port's full-scale decode (``ops/scaled_decode.py`` at 8/8: the host
entropy decoder, ``idct_rgb_plain``'s IDCT, libjpeg's fancy upsampling
and colour conversion, then ``crop_resize_plain``) against the JAX
library, on the CPU.

Tolerance 0: uint8 frames equal.  The JAX library decodes these frames with
libjpeg-turbo: its exact mode's full decode (``set_fast_decode(False)``),
its fast mode at 8/8 and its raw frames (``out_size`` 0, one frame a
call: the C++ copies each raw frame to the buffer's start).  Layouts
4:2:0, 4:2:2, 4:4:4 and grey from Pillow, 4:4:0 from a small C helper over
the system's libjpeg (``_torch_port_jpeg_helper.py``, built by g++); sizes
256×192, 61×45 (no MCU multiple) and frames whose chroma is two samples
wide, where libjpeg repeats it; crops on each edge, restart markers, noise
at quality 20 (the IDCT's range-limit wrap).  None of these frames but
the routing test's RGB-transform frame goes to Pillow: the port's own path
decodes each (``DECODES``).  The kernel
itself is held against ``idct_rgb_plain`` by ``chip_smoke.py``'s
``fast_decode`` phase.
"""

import ctypes
import io

import numpy as np
import pytest
import torch
from PIL import Image

from coarse_fine_networks_tpu.data import native as jnative
from coarse_fine_networks_torch.data import native as pnative
from coarse_fine_networks_torch.ops import frame_decode
from coarse_fine_networks_torch.ops import scaled_decode as sd

import _torch_port_jpeg_helper as jh
from _torch_port_util import jax_native_library
from test_torch_port_fast_decode import LAYOUTS, _image, _save

torch.set_num_threads(2)

_NATIVE_MISSING = jax_native_library()
pytestmark = pytest.mark.skipif(_NATIVE_MISSING is not None,
                                reason=str(_NATIVE_MISSING))

FULL_LAYOUTS = [*LAYOUTS, "440"]
SIZES = [(256, 192), (61, 45)]
# (out, scale, tl_x, tl_y): random crops on each edge and inside; at both
# sizes each needs 8/8 in the fast mode (at 4/8 the crop would not cover
# out)
CROPS = [(100, 0.7, 0.0, 0.0), (100, 0.7, 1.0, 1.0), (100, 0.55, 1.0, 0.0),
         (100, 0.55, 0.0, 1.0), (100, 0.9, 0.4, 0.7)]

@pytest.fixture(scope="module")
def helper(tmp_path_factory):
    """libjpeg's compressor with the luma's sampling factors set: 4:4:0 is
    h 1, v 2, which Pillow cannot write."""
    return jh.build(tmp_path_factory.mktemp("helper"))


def _write(helper, a, path, layout, quality=90, restart=0):
    """Frame ``a`` as a JPEG of ``layout``: Pillow's, or 4:4:0 by the
    helper (``restart``: its restart interval in MCUs)."""
    if layout != "440":
        kw = {"restart_marker_blocks": restart} if restart else {}
        return _save(a, path, layout, quality=quality, **kw)
    return jh.write(helper, a, path, quality, samp=(1, 2), restart=restart)


@pytest.fixture(scope="module")
def frames(tmp_path_factory, helper):
    """Per (layout, size): noise at quality 90 and 20, and a smooth
    frame."""
    root = tmp_path_factory.mktemp("full")
    rng = np.random.RandomState(11)
    out = {}
    for layout in FULL_LAYOUTS:
        for w, h in SIZES:
            kind = "grey" if layout == "grey" else "rgb"
            out[layout, (w, h)] = [
                _write(helper, _image(rng, w, h, kind, k),
                       str(root / f"{layout}_{w}_{i}.jpg"), layout, q)
                for i, (k, q) in enumerate([("noise", 90), ("noise", 20),
                                            ("smooth", 90)])]
    return out


@pytest.fixture(autouse=True)
def restore_modes():
    prev = jnative.fast_decode(), pnative.fast_decode()
    yield
    jnative.set_fast_decode(prev[0])
    pnative.set_fast_decode(prev[1])


def _modes(fast: bool):
    jnative.set_fast_decode(fast)
    pnative.set_fast_decode(fast)


def _eq(got, ref):
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _jax_raw(paths=None, pack=None, indices=()):
    """The JAX library's raw frames (``out_size`` 0), one a call."""
    lib = jnative._load()
    got = []
    for key in (paths if pack is None else indices):
        if pack is None:
            with Image.open(key) as img:
                w, h = img.size
        else:
            blob = pnative.read_pack_frames(pack, [key])[0]
            p = sd.probe(blob)
            w, h = p.w, p.h
        buf = np.zeros((h, w, 3), np.uint8)
        status = np.zeros(1, np.int32)
        u8 = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        st = status.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        if pack is None:
            fails = lib.cfn_decode_batch((ctypes.c_char_p * 1)(key.encode()),
                                         1, 0, u8, st, 1)
        else:
            idx = np.asarray([key], np.int32)
            fails = lib.cfn_decode_packed(
                pack.encode(), idx.ctypes.data_as(ctypes.POINTER(
                    ctypes.c_int)), 1, 0, u8, st, 1)
        assert fails == 0 and status[0] == 0, key
        got.append(buf)
    return np.stack(got)


def _counted(fn):
    """``fn()`` and the frames of each of the port's decode routes."""
    frame_decode.reset_launches()
    out = fn()
    return out, dict(frame_decode.DECODES)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", FULL_LAYOUTS)
def test_full_decode_matches_jax(frames, layout, size):
    """The exact mode's centre and random crops (outs at 4/8 and 8/8 of
    the fast mode's scale), the fast mode's crops at 8/8 and the raw
    frames, from files: every frame on the port's own path."""
    paths = frames[layout, size]
    n = len(paths)
    routes = {"port": 0, "nvjpeg": 0, "pillow": 0, "nvjpeg_calls": 0}
    for fast in (False, True):
        _modes(fast)
        outs = (150,) if fast else (60, 150)
        for out in outs:
            got, dec = _counted(lambda: pnative.decode_batch(
                paths, out, device="cpu"))
            _eq(got, jnative.decode_batch(paths, out))
            assert dec == {**routes, "port": n}
        for crop in CROPS:
            got, dec = _counted(lambda: pnative.decode_batch_random_crop(
                paths, *crop, device="cpu"))
            _eq(got, jnative.decode_batch_random_crop(paths, *crop))
            assert dec == {**routes, "port": n}
        got, dec = _counted(lambda: pnative.decode_batch(paths, 0,
                                                         device="cpu"))
        _eq(got, _jax_raw(paths))
        assert dec == {**routes, "port": n}


def test_packed_full_decode_matches_jax(frames, tmp_path):
    """From a pack of mixed layouts and sizes, at selected indices: the
    exact mode's and the fast mode's 8/8 crops, and raw frames of one
    size."""
    paths = [p for k in (("420", (256, 192)), ("440", (61, 45)),
                         ("grey", (256, 192)), ("422", (256, 192)))
             for p in frames[k]]
    pack = str(tmp_path / "mixed.cfnpack")
    pnative.pack_video(paths, pack)
    idx = [0, 4, 7, 2, 9, 5, 11, 3]
    for fast in (False, True):
        _modes(fast)
        _eq(pnative.decode_packed(pack, idx, 150, device="cpu"),
            jnative.decode_packed(pack, idx, 150))
        for crop in CROPS[:3]:
            _eq(pnative.decode_packed_random_crop(pack, idx, *crop,
                                                  device="cpu"),
                jnative.decode_packed_random_crop(pack, idx, *crop))
        if not fast:
            _eq(pnative.decode_packed(pack, idx, 60, device="cpu"),
                jnative.decode_packed(pack, idx, 60))
    one_size = [0, 7, 2, 9, 11]
    _eq(pnative.decode_packed(pack, one_size, 0, device="cpu"),
        _jax_raw(pack=pack, indices=one_size))
    with pytest.raises(ValueError, match="more than one size"):
        pnative.decode_packed(pack, [0, 4], 0, device="cpu")


@pytest.mark.parametrize("layout", FULL_LAYOUTS)
def test_full_decode_is_pillows(frames, layout):
    """The raw frames against Pillow's full decode (libjpeg-turbo as well,
    fancy upsampling on): the fancy filters and the colour conversion over
    whole frames, edges included."""
    for size in SIZES:
        paths = frames[layout, size]
        with_pillow = np.stack([np.asarray(Image.open(p).convert("RGB"))
                                for p in paths])
        _eq(pnative.decode_batch(paths, 0, device="cpu"), with_pillow)


def test_narrow_chroma_is_repeated(helper, tmp_path):
    """Frames whose subsampled chroma is at most two samples wide:
    ``jinit_upsampler`` takes ``h2v1_upsample`` and ``h2v2_upsample``
    (repetition) there, while 4:4:0's ``h1v2_fancy_upsample`` has no such
    condition; exact and fast modes, crops and raw frames."""
    rng = np.random.RandomState(5)
    for layout, (w, h) in (("420", (4, 21)), ("420", (3, 9)),
                           ("422", (4, 11)), ("440", (4, 13))):
        paths = [_write(helper, _image(rng, w, h, "rgb", "noise"),
                        str(tmp_path / f"{layout}_{w}x{h}_{q}.jpg"), layout,
                        q) for q in (90, 20)]
        p = sd.probe(open(paths[0], "rb").read())
        assert sd.fancy_upsampled(p.samp, w) == [False] + [
            layout == "440"] * 2
        for fast in (False, True):
            _modes(fast)
            _eq(pnative.decode_batch(paths, 5, device="cpu"),
                jnative.decode_batch(paths, 5))
            _eq(pnative.decode_batch_random_crop(paths, 2, 0.8, 1.0, 0.5,
                                                 device="cpu"),
                jnative.decode_batch_random_crop(paths, 2, 0.8, 1.0, 0.5))
        _eq(pnative.decode_batch(paths, 0, device="cpu"), _jax_raw(paths))


@pytest.mark.parametrize("layout", ["420", "440", "grey"])
def test_restart_markers_at_full_scale(helper, tmp_path, layout):
    """Frames with restart intervals at 8/8 in both modes, and raw."""
    rng = np.random.RandomState(6)
    kind = "grey" if layout == "grey" else "rgb"
    paths = [_write(helper, _image(rng, 256, 192, kind, "noise"),
                    str(tmp_path / f"r{i}.jpg"), layout, 85, restart=3)
             for i in range(2)]
    with open(paths[0], "rb") as f:
        assert b"\xff\xdd" in f.read()  # a DRI segment
    for fast in (False, True):
        _modes(fast)
        _eq(pnative.decode_batch(paths, 150, device="cpu"),
            jnative.decode_batch(paths, 150))
        _eq(pnative.decode_batch_random_crop(paths, *CROPS[1], device="cpu"),
            jnative.decode_batch_random_crop(paths, *CROPS[1]))
    _eq(pnative.decode_batch(paths, 0, device="cpu"), _jax_raw(paths))


def _jdsample(plane, kind, dw, dh):
    """``jdsample.c``'s fancy filters as libjpeg-turbo 2.1 writes them, row
    by row in plain Python over a whole component of ``dw × dh`` real
    samples: the context rows above the first and below the last are those
    rows themselves (``jdmainct.c``), the first and last columns special
    cases."""
    def row(r):
        return [int(v) for v in plane[min(max(r, 0), dh - 1)][:dw]]

    out = []
    for r in range(dh):
        if kind == "h2v1":
            s = row(r)
            o = [s[0], (s[0] * 3 + s[1] + 2) >> 2]
            for i in range(1, dw - 1):
                o += [(s[i] * 3 + s[i - 1] + 1) >> 2,
                      (s[i] * 3 + s[i + 1] + 2) >> 2]
            o += [(s[-1] * 3 + s[-2] + 1) >> 2, s[-1]]
            out.append(o)
        elif kind == "h1v2":
            for far, bias in ((r - 1, 1), (r + 1, 2)):
                out.append([(3 * a + b + bias) >> 2
                            for a, b in zip(row(r), row(far))])
        else:
            for far in (r - 1, r + 1):
                cs = [3 * a + b for a, b in zip(row(r), row(far))]
                o = [(cs[0] * 4 + 8) >> 4, (cs[0] * 3 + cs[1] + 7) >> 4]
                for i in range(1, dw - 1):
                    o += [(cs[i] * 3 + cs[i - 1] + 8) >> 4,
                          (cs[i] * 3 + cs[i + 1] + 7) >> 4]
                o += [(cs[-1] * 3 + cs[-2] + 8) >> 4, (cs[-1] * 4 + 7) >> 4]
                out.append(o)
    return np.asarray(out)


@pytest.mark.parametrize("kind", ["h2v1", "h1v2", "h2v2"])
def test_fancy_upsample_plain_is_jdsample(kind):
    """:func:`fancy_upsample_plain` on a whole frame's component equals
    ``jdsample.c``'s loops, where the real samples stop short of the
    blocks (the padding never read)."""
    hexp, vexp = {"h2v1": (2, 1), "h1v2": (1, 2), "h2v2": (2, 2)}[kind]
    rng = np.random.RandomState(7)
    dw, dh = 13, 11
    plane = rng.randint(0, 256, (16, 16)).astype(np.uint8)
    g = sd.Geometry(8, (0, 2, 0, 2), 16 * vexp, 16 * hexp, (0, 0, 1, 1),
                    (), 0, 0)
    c = sd.Comp(0, 2, 2, 8, 0, 16, hexp, vexp, 1, dw - 1, dh - 1)
    got = sd.fancy_upsample_plain(torch.from_numpy(plane)[None], c, g)[0]
    ref = _jdsample(plane, kind, dw, dh)
    np.testing.assert_array_equal(got[:ref.shape[0], :ref.shape[1]].numpy(),
                                  ref)


def test_window_is_the_full_decode_inside_the_box(frames):
    """The window of a box at 8/8 (its MCUs and one more on each side)
    decodes, inside the box, to the whole frame's decode: the fancy
    filters' neighbours across the window's edges are never inside it."""
    rng = np.random.RandomState(8)
    for layout in ("420", "422", "440"):
        blobs = [open(p, "rb").read() for p in frames[layout, (256, 192)]]
        p = sd.probe(blobs[0])
        whole = sd.geometry(p.w, p.h, p.samp, (0, 0, p.w, p.h), 0, 8)
        assert whole.win == {"420": (0, 16, 0, 12), "422": (0, 16, 0, 24),
                             "440": (0, 32, 0, 12)}[layout]
        full = sd.idct_rgb_plain(*sd.entropy_decode(blobs, ["f"] * 3, p,
                                                    whole), whole)
        for _ in range(6):
            cw, ch = rng.randint(1, 120, 2)
            x1, y1 = rng.randint(0, p.w - cw), rng.randint(0, p.h - ch)
            g = sd.geometry(p.w, p.h, p.samp, (x1, y1, cw, ch), 0, 8)
            win = sd.idct_rgb_plain(*sd.entropy_decode(blobs, ["f"] * 3, p,
                                                       g), g)
            bx, by, bw, bh = g.box
            assert (bw, bh) == (cw, ch)
            assert torch.equal(win[:, by:by + bh, bx:bx + bw],
                               full[:, y1:y1 + ch, x1:x1 + cw])


def test_geometry_at_full_scale():
    """At 8/8 the window covers the box's MCUs and one more on each side,
    clipped to the frame's MCU grid; each component's last real sample;
    which components libjpeg upsamples by its fancy filters."""
    s420, s422 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))
    s440, s444 = ((1, 2), (1, 1), (1, 1)), ((1, 1),) * 3
    assert sd.fancy_upsampled(s420, 640) == [False, True, True]
    assert sd.fancy_upsampled(s422, 5) == [False, True, True]
    assert sd.fancy_upsampled(s422, 4) == [False, False, False]
    assert sd.fancy_upsampled(s440, 1) == [False, True, True]
    assert sd.fancy_upsampled(s444, 640) == [False] * 3
    # a 420-pixel train crop of a 480² frame: MCU columns 0-26 and rows
    # 2-28 widened to 0-27 and 1-29 (the frame's last row)
    g = sd.geometry(480, 480, s420, (12, 40, 420, 420), 224, 8)
    assert (g.num, g.win, g.box) == (8, (0, 28, 1, 30), (12, 24, 420, 420))
    assert [(c.xmax, c.ymax) for c in g.comps] == [(447, 463), (223, 231),
                                                   (223, 231)]
    assert [(c.s, c.hexp, c.vexp, c.fancy) for c in g.comps] == [
        (8, 1, 1, 0), (8, 2, 2, 1), (8, 2, 2, 1)]
    # the window reaches the frame's right and bottom edges: 61×45 4:2:0
    # has 31 × 23 real chroma samples in 4 × 3 MCUs
    g = sd.geometry(61, 45, s420, (20, 10, 41, 35), 0, 8)
    assert g.win == (0, 4, 0, 3)
    assert [(c.xmax, c.ymax) for c in g.comps[1:]] == [(30, 22)] * 2
    # inside the frame the window's own last sample; 4:4:4 not widened
    g = sd.geometry(640, 480, s420, (200, 200, 40, 40), 0, 8)
    assert g.win == (11, 16, 11, 16)
    assert [(c.xmax, c.ymax) for c in g.comps] == [(79, 79), (39, 39),
                                                   (39, 39)]
    g = sd.geometry(640, 480, s444, (200, 200, 40, 40), 0, 8)
    assert g.win == (25, 30, 25, 30)
    # the whole frame (raw) and the fast mode's scale below 8/8 unchanged
    assert sd.geometry(61, 45, s420, (0, 0, 61, 45), 0, 8).win == (0, 4, 0, 3)
    g = sd.geometry(640, 480, s420, (80, 0, 480, 480), 224)
    assert (g.num, g.win) == (4, (5, 35, 0, 30))
    assert not any(c.fancy for c in g.comps)


def test_truncated_frames_raise_in_both_modes(frames, tmp_path):
    """A frame whose entropy-coded data ends early decodes as the JAX
    library's libjpeg fills it (it warns, decodes the MCU where the bits
    run out on zero bits and leaves the rest grey), in both modes and raw.
    What still raises naming the frame, in both modes and raw: a
    progressive frame cut before its last scan, whose blocks libjpeg
    smooths (its frame comes back)."""
    with open(frames["420", (256, 192)][0], "rb") as f:
        blob = f.read()
    cut = str(tmp_path / "cut.jpg")
    with open(cut, "wb") as f:
        f.write(blob[:len(blob) // 2])
    good = frames["420", (256, 192)][1:2]
    a = _image(np.random.RandomState(9), 256, 192, "rgb", "noise")
    prog = _save(a, str(tmp_path / "prog.jpg"), "420", quality=90,
                 progressive=True)
    with open(prog, "rb") as f:
        pblob = f.read()
    cut_prog = str(tmp_path / "cut_prog.jpg")
    with open(cut_prog, "wb") as f:
        f.write(pblob[:len(pblob) // 2])
    for fast in (False, True):
        _modes(fast)
        jax = jnative.decode_batch(good + [cut], 150)
        _eq(pnative.decode_batch(good + [cut], 150, device="cpu"), jax)
        assert (jax[1, -20:] == 128).all()  # libjpeg's grey fill
        for out in (150, 0):
            with pytest.raises(IOError, match="smooths") as err:
                pnative.decode_batch(good + [cut_prog], out, device="cpu")
            assert "cut_prog.jpg" in str(err.value)
        assert jnative.decode_batch([cut_prog], 150).shape == (1, 150, 150,
                                                               3)
    _eq(pnative.decode_batch([cut], 0, device="cpu"), _jax_raw([cut]))


def test_routes_are_chosen_from_the_header(frames, tmp_path, monkeypatch):
    """A progressive frame takes the port's own path with the baseline
    ones, in the exact mode, at 8/8 and raw.  An RGB-transform frame (which
    the JAX library decodes and the port's decoder refuses by its header)
    takes the exact path's decoder (Pillow on the CPU) and never reaches
    the entropy decoder; a frame the JAX library fails on (a lossless one)
    raises in both modes before any decoder.  ``DECODES`` counts each
    route's frames."""
    a = _image(np.random.RandomState(9), 256, 192, "rgb", "noise")
    prog = _save(a, str(tmp_path / "prog.jpg"), "420", quality=90,
                 progressive=True)
    rgb = _write_rgb(a, str(tmp_path / "rgb.jpg"))
    paths = frames["420", (256, 192)] + [prog, rgb]
    seen = []
    decode = sd.entropy_decode

    def spy(blobs, names, *args, **kwargs):
        seen.extend(names)
        return decode(blobs, names, *args, **kwargs)
    monkeypatch.setattr(sd, "entropy_decode", spy)
    for fast, out in ((False, 60), (True, 150), (False, 0)):
        _modes(fast)
        got, dec = _counted(lambda: pnative.decode_batch(paths, out,
                                                         device="cpu"))
        if out:
            _eq(got, jnative.decode_batch(paths, out))
        else:
            _eq(got, _jax_raw(paths))
        assert dec == {"port": 4, "nvjpeg": 0, "pillow": 1,
                       "nvjpeg_calls": 0}
    assert rgb not in seen and prog in seen and len(seen) == 12
    _modes(True)
    with pytest.raises(IOError, match="RGB colour transform") as err:
        pnative.decode_batch(paths, 60, device="cpu")
    assert "rgb.jpg" in str(err.value) and "CFN_EXACT_DECODE=1" in str(
        err.value)
    with open(prog, "rb") as f:
        blob = bytearray(f.read())
    blob[blob.index(b"\xff\xc2") + 1] = 0xC3  # lossless: libjpeg refuses
    lossless = str(tmp_path / "lossless.jpg")
    with open(lossless, "wb") as f:
        f.write(bytes(blob))
    for fast in (False, True):
        _modes(fast)
        with pytest.raises(Exception):
            jnative.decode_batch([lossless], 60)
        frame_decode.reset_launches()
        with pytest.raises(IOError, match="lossless") as err:
            pnative.decode_batch(paths[:1] + [lossless], 60, device="cpu")
        assert "lossless.jpg" in str(err.value)
        assert "CFN_EXACT_DECODE" not in str(err.value)
        assert frame_decode.DECODES["pillow"] == 0


def _write_rgb(a, path):
    """Frame ``a`` as a JPEG without a colour transform: Pillow's 4:4:4
    frame with its JFIF segment dropped and its components named R, G and
    B, which libjpeg then reads as RGB (as the port does)."""
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", quality=90, subsampling=0)
    blob = bytearray(buf.getvalue())
    app0 = blob.index(b"\xff\xe0")
    del blob[app0:app0 + 2 + (blob[app0 + 2] << 8 | blob[app0 + 3])]
    sof = blob.index(b"\xff\xc0")
    sos = blob.index(b"\xff\xda")
    for k, name in enumerate(b"RGB"):
        blob[sof + 10 + 3 * k] = name
        blob[sos + 5 + 2 * k] = name
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return path
