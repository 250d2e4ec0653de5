"""The port's decoder on the frames beyond one baseline scan, against the
JAX library on the CPU: progressive (Huffman and arithmetic), sequential
frames of several scans, arithmetic-coded frames, restart intervals in
progressive scans, frames cut short, corrupt data and restart markers out
of order, and the kinds the JAX library itself refuses.

Tolerance 0: uint8 frames equal, in the JAX library's fast mode (crops at
4/8 and 8/8) and exact mode, raw frames (``out_size`` 0) and from a pack.
Progressive frames come from Pillow (4:2:0, 4:2:2, 4:4:4, grey) and, with
what Pillow cannot write (4:4:0, arithmetic coding, scan scripts, restart
intervals), from a small C helper over the system's libjpeg
(``_torch_port_jpeg_helper.py``), which also reads libjpeg's own
coefficients of a frame (``jpeg_read_coefficients``) for the entropy
decoder's checks on broken data.  None of these frames goes to Pillow or
nvJPEG: ``DECODES`` counts the port's path for each.
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from coarse_fine_networks_tpu.data import native as jnative
from coarse_fine_networks_torch.data import native as pnative
from coarse_fine_networks_torch.ops import frame_decode
from coarse_fine_networks_torch.ops import scaled_decode as sd

import _torch_port_jpeg_helper as jh
from _torch_port_util import jax_native_library
from test_torch_port_fast_decode import _image
from test_torch_port_full_decode import _jax_raw

torch.set_num_threads(2)

_NATIVE_MISSING = jax_native_library()
pytestmark = pytest.mark.skipif(_NATIVE_MISSING is not None,
                                reason=str(_NATIVE_MISSING))

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_port_jpegs"
W, H = 256, 192
# (out, scale, tl_x, tl_y) of random crops: at 8/8 in the fast mode (the
# first two, on the bottom-right and top-left edges) and at 4/8
CROPS = [(100, 0.7, 1.0, 1.0), (100, 0.55, 0.0, 0.0), (40, 0.5, 0.3, 0.6)]
PORT_ONLY = {"nvjpeg": 0, "pillow": 0, "nvjpeg_calls": 0}


@pytest.fixture(scope="module")
def helper(tmp_path_factory):
    return jh.build(tmp_path_factory.mktemp("jpeg_helper"))


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


def _pillow(a, path, layout, **kw):
    """Frame ``a`` saved by Pillow: layout "420", "422", "444" or "grey"."""
    img = Image.fromarray(a, "L" if layout == "grey" else "RGB")
    if layout != "grey":
        kw["subsampling"] = {"420": 2, "422": 1, "444": 0}[layout]
    prev = ImageFile.MAXBLOCK
    ImageFile.MAXBLOCK = 1 << 22  # progressive noise outgrows Pillow's buffer
    try:
        img.save(path, "JPEG", **kw)
    finally:
        ImageFile.MAXBLOCK = prev
    return str(path)


def _frames(rng, kind="rgb"):
    """A noise frame at quality 90 and one at 20 (the IDCT's range-limit
    wrap), and a smooth one."""
    return [(_image(rng, W, H, kind, "noise"), 90),
            (_image(rng, W, H, kind, "noise"), 20),
            (_image(rng, W, H, kind, "smooth"), 90)]


def _matches(paths, raw=True, outs=(150, 60)):
    """Every route of the JAX library's: both modes, centre crops (150 at
    8/8 and 60 at 4/8 in the fast mode; 30 and 12 at 2/8 and 1/8; all at
    8/8 in the exact one), the random crops, and the raw frames; each frame
    on the port's path."""
    n = len(paths)
    for fast in (True, False):
        _modes(fast)
        for out in outs:
            frame_decode.reset_launches()
            _eq(pnative.decode_batch(paths, out, device="cpu"),
                jnative.decode_batch(paths, out))
            assert frame_decode.DECODES == {**PORT_ONLY, "port": n}
        for crop in CROPS:
            _eq(pnative.decode_batch_random_crop(paths, *crop, device="cpu"),
                jnative.decode_batch_random_crop(paths, *crop))
    if raw:
        _eq(pnative.decode_batch(paths, 0, device="cpu"), _jax_raw(paths))


def _write(path, blob):
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("layout", ["420", "422", "444", "grey"])
def test_pillow_progressive_frames(tmp_path, layout):
    """Pillow's progressive frames (libjpeg's ten-scan script, six for
    grey): probed as the port's own, then equal to the JAX library's."""
    rng = np.random.RandomState(1)
    kind = "grey" if layout == "grey" else "rgb"
    paths = [_pillow(a, tmp_path / f"p{i}.jpg", layout, quality=q,
                     progressive=True)
             for i, (a, q) in enumerate(_frames(rng, kind))]
    blob = _read(paths[0])
    assert 0xC2 in [m for m, _, _ in jh.segments(blob)]
    assert len(jh.scans(blob)) == (6 if layout == "grey" else 10)
    assert sd.probe(blob).status == 0
    _matches(paths)


def test_progressive_440_and_odd_sizes(helper, tmp_path):
    """4:4:0 progressive frames (the helper's), and progressive frames of
    a size that is no MCU multiple (61×45) in 4:2:0 and grey."""
    rng = np.random.RandomState(2)
    paths = [jh.write(helper, a, tmp_path / f"a{i}.jpg", q, samp=(1, 2),
                      progressive=True)
             for i, (a, q) in enumerate(_frames(rng))]
    _matches(paths)
    odd = [_pillow(_image(rng, 61, 45, "rgb", "noise"), tmp_path / "o1.jpg",
                   "420", quality=90, progressive=True),
           _pillow(_image(rng, 61, 45, "grey", "smooth"), tmp_path / "o2.jpg",
                   "grey", quality=75, progressive=True)]
    for path in odd:
        _matches([path])


@pytest.mark.parametrize("scans", [1, 2], ids=["per_component", "y_then_c"])
def test_sequential_frames_of_several_scans(helper, tmp_path, scans):
    """Sequential (SOF0) frames whose components come in scans of their
    own (non-interleaved, each over its own block raster), or the luma
    alone and then both chroma interleaved."""
    rng = np.random.RandomState(3)
    paths = [jh.write(helper, a, tmp_path / f"s{i}.jpg", q, scans=scans,
                      samp=(2, 2) if i else (2, 1))
             for i, (a, q) in enumerate(_frames(rng))]
    assert len(jh.scans(_read(paths[0]))) == (3 if scans == 1 else 2)
    _matches(paths)


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
def test_arithmetic_frames(helper, tmp_path, progressive):
    """Arithmetic-coded frames (SOF9, SOF10): 4:2:0, 4:2:2, grey, with and
    without restart intervals (the statistics reset at each)."""
    rng = np.random.RandomState(4)
    frames = _frames(rng)
    paths = [jh.write(helper, a, tmp_path / f"r{i}.jpg", q, arith=True,
                      progressive=progressive, samp=samp, restart=rst)
             for i, ((a, q), samp, rst) in enumerate(zip(
                 frames, [(2, 2), (2, 1), (2, 2)], [0, 3, 1]))]
    grey = jh.write(helper, _image(rng, W, H, "grey", "noise"),
                    tmp_path / "g.jpg", 85, arith=True,
                    progressive=progressive)
    assert (0xCA if progressive else 0xC9) in [
        m for m, _, _ in jh.segments(_read(paths[0]))]
    _matches(paths + [grey])


def test_progressive_restart_intervals(helper, tmp_path):
    """Progressive frames with restart intervals, which reset the DC
    predictions and the end-of-band runs: Pillow's (in MCU rows) and the
    helper's (every 2 MCUs, in non-interleaved scans every 2 blocks)."""
    rng = np.random.RandomState(5)
    frames = _frames(rng)
    paths = [_pillow(frames[0][0], tmp_path / "p.jpg", "420", quality=90,
                     progressive=True, restart_marker_rows=1),
             jh.write(helper, frames[1][0], tmp_path / "h1.jpg",
                      frames[1][1], restart=2, progressive=True),
             jh.write(helper, frames[2][0], tmp_path / "h2.jpg",
                      frames[2][1], restart=7, progressive=True,
                      samp=(1, 2))]
    for path in paths:
        assert len(jh.restarts(_read(path))) > 10
    _matches(paths)


def test_new_kinds_from_a_pack(helper, tmp_path):
    """A pack of progressive, arithmetic, multi-scan and baseline frames of
    mixed layouts: crops in both modes and raw frames by index."""
    rng = np.random.RandomState(6)
    a = _image(rng, W, H, "rgb", "noise")
    paths = [_pillow(a, tmp_path / "p.jpg", "420", quality=90,
                     progressive=True),
             jh.write(helper, a, tmp_path / "ar.jpg", arith=True,
                      progressive=True),
             jh.write(helper, a, tmp_path / "ms.jpg", scans=1),
             _pillow(a, tmp_path / "b.jpg", "422", quality=90),
             _pillow(_image(rng, W, H, "grey", "smooth"), tmp_path / "g.jpg",
                     "grey", quality=90, progressive=True)]
    pack = str(tmp_path / "mixed.cfnpack")
    pnative.pack_video(paths, pack)
    idx = [4, 0, 2, 1, 3, 0]
    for fast in (True, False):
        _modes(fast)
        frame_decode.reset_launches()
        _eq(pnative.decode_packed(pack, idx, 60, device="cpu"),
            jnative.decode_packed(pack, idx, 60))
        assert frame_decode.DECODES == {**PORT_ONLY, "port": len(idx)}
        _eq(pnative.decode_packed_random_crop(pack, idx, *CROPS[0],
                                              device="cpu"),
            jnative.decode_packed_random_crop(pack, idx, *CROPS[0]))
    _eq(pnative.decode_packed(pack, idx, 0, device="cpu"),
        _jax_raw(pack=pack, indices=idx))


def test_cut_baseline_and_multiscan_frames(helper, tmp_path):
    """Frames whose data ends early, as libjpeg fills them (jpeg_mem_src's
    EOI: the MCU where the bits run out decoded on zero bits, the rest
    grey; scans that never arrive leave their coefficients zero): a
    baseline frame cut inside the fast mode's top-left window and below
    it, one with restart markers cut between two intervals, sequential and
    arithmetic frames of several scans cut inside a later scan."""
    rng = np.random.RandomState(7)
    a = _image(rng, W, H, "rgb", "noise")
    base = _read(_pillow(a, tmp_path / "b.jpg", "420", quality=90))
    rst = _read(jh.write(helper, a, tmp_path / "r.jpg", restart=4))
    multi = _read(jh.write(helper, a, tmp_path / "m.jpg", scans=1))
    arith = _read(jh.write(helper, a, tmp_path / "a.jpg", arith=True,
                           scans=2))
    r = jh.restarts(rst)[20]
    cuts = {"inside": base[:len(base) // 3], "below": base[:-len(base) // 5],
            "rst": rst[:r], "multi": multi[:jh.scans(multi)[1][0] + 900],
            "arith": arith[:jh.scans(arith)[1][0] + 700]}
    paths = [_write(tmp_path / f"cut_{k}.jpg", v) for k, v in cuts.items()]
    _matches(paths)
    _modes(False)
    got = pnative.decode_batch(paths[:1], 0, device="cpu")
    assert (got[0, -16:] == 128).all()  # libjpeg's grey fill
    # the fast mode's top-left crop ends above the cut below it: those
    # pixels are the whole frame's
    _modes(True)
    whole = pnative.decode_batch_random_crop([str(tmp_path / "b.jpg")],
                                             *CROPS[1], device="cpu")
    _eq(pnative.decode_batch_random_crop(paths[1:2], *CROPS[1],
                                         device="cpu"), whole)


def test_cut_progressive_frames(tmp_path):
    """A progressive frame cut inside its last scan is complete in every
    coefficient's top bits, so libjpeg does not smooth it: equal.  Cut
    inside an earlier scan or between two scans, libjpeg-turbo smooths its
    blocks at output (``jdcoefct.c``'s block smoothing, where a
    coefficient's bits are incomplete): the port raises, naming the frame
    and the smoothing, in both modes and raw; the JAX library returns a
    frame."""
    rng = np.random.RandomState(8)
    blob = _read(_pillow(_image(rng, W, H, "rgb", "noise"), tmp_path / "p.jpg",
                         "420", quality=90, progressive=True))
    sc = jh.scans(blob)
    last = _write(tmp_path / "last.jpg",
                  blob[:(sc[-1][0] + sc[-1][1]) // 2])
    _matches([last])
    smoothed = [_write(tmp_path / "in3.jpg",
                       blob[:(sc[3][0] + sc[3][1]) // 2]),
                _write(tmp_path / "after6.jpg", blob[:sc[6][1]]),
                _write(tmp_path / "in0.jpg", blob[:sc[0][0] + 40])]
    for path in smoothed:
        for fast in (True, False):
            _modes(fast)
            for out in (150, 0):
                with pytest.raises(IOError, match="smooths") as err:
                    pnative.decode_batch([last, path], out, device="cpu")
                assert path in str(err.value)
                assert "CFN_EXACT_DECODE" not in str(err.value)
            assert jnative.decode_batch([path], 150).shape == (1, 150, 150, 3)


def _port_coefficients(blob):
    """The port's entropy decode of the whole frame, whatever its status:
    each component's blocks ``(rows, cols, 64)`` and the status."""
    p = sd.probe(blob)
    g = sd.geometry(p.w, p.h, p.samp, (0, 0, p.w, p.h), 0, 8)
    coefs = np.zeros((1, g.frame_blocks, 64), np.int16)
    qt = np.zeros((1, len(p.samp), 64), np.int32)
    status = np.zeros(1, np.int32)
    nc = len(p.samp)
    layout = (ctypes.c_int32 * 9)(p.w, p.h, nc, *[
        x for hv in p.samp for x in hv], *([0] * (6 - 2 * nc)))
    sd.ENTROPY.build().cfn_entropy_decode(
        (ctypes.c_char_p * 1)(blob), (ctypes.c_size_t * 1)(len(blob)), 1,
        layout, (ctypes.c_int32 * 4)(*g.win), g.frame_blocks,
        coefs.ctypes.data, qt.ctypes.data, status.ctypes.data, 1, 0)
    return [coefs[0, c.block_off:c.block_off + c.rows * c.cols].reshape(
        c.rows, c.cols, 64) for c in g.comps], int(status[0])


def _same_coefficients(helper, blob):
    """The port's coefficients of every real block equal libjpeg's; the
    port's status."""
    port, status = _port_coefficients(blob)
    for lib, mine in zip(jh.coefficients(helper, blob), port):
        np.testing.assert_array_equal(mine[:lib.shape[0], :lib.shape[1]],
                                      lib)
    return status


def _damage(blob, first, n, seed):
    """``n`` bytes of the entropy-coded data from ``first`` on set to
    seeded values (no 0xFF written, none next to one)."""
    r = np.random.RandomState(seed)
    b = bytearray(blob)
    for i in r.randint(first, len(b) - 2, n):
        if 0xFF not in (b[i - 1], b[i], b[i + 1]):
            b[i] = r.randint(0, 255)
    return bytes(b)


def test_corrupt_data_as_libjpeg_reads_it(helper, tmp_path):
    """Damaged entropy-coded data (bad Huffman codes among the bytes): the
    port's coefficients are libjpeg's, block for block (a bad code takes 17
    bits and gives 0, jpeg_huff_decode), and its frames the JAX library's
    at every scale, where the garbage passes what 8-bit blocks give and
    libjpeg-turbo's SIMD IDCT wraps and saturates it in 16-bit lanes
    (``scaled_decode.idct_blocks_plain``)."""
    rng = np.random.RandomState(9)
    a = _image(rng, W, H, "rgb", "noise")
    base = _read(_pillow(a, tmp_path / "b.jpg", "420", quality=90))
    prog = _read(_pillow(a, tmp_path / "p.jpg", "420", quality=90,
                         progressive=True))
    cases = {}
    for off in (4000, 8000):
        # 48 one-bits (stuffed), where no code ends: a bad Huffman code
        at = jh.scans(base)[0][0] + off
        while 0xFF in base[at - 1:at + 13]:
            at += 1
        cases[f"planted{off}"] = base[:at] + b"\xff\x00" * 6 + base[at + 12:]
    for seed in range(2):
        cases[f"damaged{seed}"] = _damage(base, jh.scans(base)[0][0] + 200,
                                          3, seed)
    for k in (0, 4, 9):
        cases[f"prog{k}"] = _damage(prog, jh.scans(prog)[k][0] + 20, 2, k)
    paths = []
    for name, blob in cases.items():
        assert _same_coefficients(helper, blob) == 0, name
        paths.append(_write(tmp_path / f"{name}.jpg", blob))
    # the garbage leaves the 8-bit range: beyond |coef · q| = 1024 somewhere
    p = sd.probe(cases["damaged0"])
    g = sd.geometry(p.w, p.h, p.samp, (0, 0, p.w, p.h), 0, 8)
    coefs, qt = sd.entropy_decode([cases["damaged0"]], ["d"], p, g)
    assert max(int((coefs[0, c.block_off:c.block_off + c.rows * c.cols]
                    .to(torch.int64) * qt[0, i]).abs().max())
               for i, c in enumerate(g.comps)) > 1024
    _matches(paths, outs=(150, 60, 30, 12))


def test_cut_frames_at_low_quality(tmp_path):
    """Frames cut short at quality 5 and 20: the MCU where the bits run out
    is decoded on zero bits, whose coefficients at large quantisers take
    the IDCT past ±512 and its first pass past 16 bits, where
    libjpeg-turbo's SIMD code saturates; equal to the JAX library's in
    both modes at every scale and raw."""
    rng = np.random.RandomState(14)
    paths = []
    for q in (5, 20):
        for layout, kind in (("grey", "grey"), ("420", "rgb")):
            blob = _read(_pillow(_image(rng, W, H, kind, "noise"),
                                 tmp_path / f"f{q}{layout}.jpg", layout,
                                 quality=q))
            first, end = jh.scans(blob)[0]
            for frac in (0.3, 0.6, 0.9):
                paths.append(_write(tmp_path / f"c{q}{layout}{frac}.jpg",
                                    blob[:first + int((end - first) * frac)]))
    for layout in ("grey", "420"):
        _matches([p for p in paths if layout in p],
                 outs=(150, 60, 30, 12))


def _jax_frame(path, out, fast):
    """The JAX library's frame of ``path`` (``out`` 0: raw, its size from
    the port's probe), or None where it fails."""
    jnative.set_fast_decode(fast)
    try:
        if out:
            return jnative.decode_batch([path], out)
        p = sd.probe(_read(path))
        lib = jnative._load()
        buf = np.zeros((max(p.h, 1), max(p.w, 1), 3), np.uint8)
        status = np.zeros(1, np.int32)
        fails = lib.cfn_decode_batch(
            (ctypes.c_char_p * 1)(path.encode()), 1, 0,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1)
        return None if fails or p.w < 1 else buf[None]
    except Exception:  # noqa: BLE001 — the JAX library refused the frame
        return None


def test_damaged_frames_match_or_fail_alike(helper, tmp_path):
    """A corpus of seeded damage (bytes overwritten, cut, removed or
    inserted) to small baseline, progressive, arithmetic and multi-scan
    frames, at every scale and raw, in both modes: where the JAX library
    returns a frame the port's equals it, or the port raises because
    libjpeg smooths the frame; where the JAX library fails the port
    raises."""
    rng = np.random.RandomState(15)
    a = _image(rng, 48, 40, "rgb", "noise")
    a[:20] = _image(rng, 48, 20, "rgb", "smooth")
    seeds = [_read(jh.write(helper, a, tmp_path / f"s{i}.jpg", 60, **kw))
             for i, kw in enumerate([
                 {}, {"progressive": True}, {"arith": True},
                 {"arith": True, "progressive": True, "restart": 2},
                 {"scans": 2}, {"progressive": True, "restart": 1}])]
    outcomes = {"equal": 0, "both fail": 0, "smoothed": 0}
    for i, seed in enumerate(seeds):
        for k in range(16):
            b = bytearray(seed)
            mode = (i + k) % 4
            at = rng.randint(2, len(b))
            if mode == 0:
                for x in rng.randint(2, len(b), 3):
                    b[x] = rng.randint(256)
            elif mode == 1:
                b = b[:at]
            elif mode == 2:
                b = b[:at] + b[rng.randint(at, len(b) + 1):]
            else:
                b = b[:at] + bytes(rng.randint(0, 256, 9).astype(np.uint8)) \
                    + b[at:]
            path = _write(tmp_path / f"d{i}_{k}.jpg", bytes(b))
            for fast, out in ((False, 0), (True, 24), (True, 12), (True, 6),
                              (True, 3)):
                ref = _jax_frame(path, out, fast)
                pnative.set_fast_decode(fast)
                try:
                    got = pnative.decode_batch([path], out, device="cpu")
                except IOError as e:
                    assert ref is None or "smooths" in str(e), (path, out, e)
                    outcomes["both fail" if ref is None else "smoothed"] += 1
                    continue
                assert ref is not None, (path, out)
                _eq(got, ref)
                outcomes["equal"] += 1
    assert all(outcomes.values()), outcomes


def test_restart_markers_out_of_order(helper, tmp_path):
    """Restart markers swapped, dropped, duplicated, renumbered far ahead or
    behind: jpeg_resync_to_restart's choices (take the marker, scan on, or
    leave it and decode an empty segment), in baseline, progressive and
    arithmetic frames: coefficients libjpeg's, frames the JAX
    library's."""
    rng = np.random.RandomState(10)
    a = _image(rng, W, H, "rgb", "noise")
    base = _read(jh.write(helper, a, tmp_path / "b.jpg", restart=2))
    rst = jh.restarts(base)

    def renumber(i, by):
        b = bytearray(base)
        b[rst[i] + 1] = 0xD0 + ((b[rst[i] + 1] - 0xD0 + by) & 7)
        return bytes(b)

    swapped = bytearray(base)
    swapped[rst[5] + 1], swapped[rst[6] + 1] = (swapped[rst[6] + 1],
                                                swapped[rst[5] + 1])
    cases = {"swapped": bytes(swapped),
             "dropped": base[:rst[7]] + base[rst[7] + 2:],
             "duplicated": base[:rst[4]] + base[rst[4]:rst[4] + 2]
             + base[rst[4]:],
             "far": renumber(9, 4), "behind": renumber(9, -1)}
    prog = _read(jh.write(helper, a, tmp_path / "p.jpg", restart=3,
                          progressive=True))
    r = jh.restarts(prog)[30]
    cases["progressive"] = prog[:r] + prog[r + 2:]
    arith = _read(jh.write(helper, a, tmp_path / "a.jpg", restart=3,
                           arith=True))
    r = jh.restarts(arith)[10]
    cases["arithmetic"] = arith[:r] + arith[r + 2:]
    paths = []
    for name, blob in cases.items():
        assert _same_coefficients(helper, blob) == 0, name
        paths.append(_write(tmp_path / f"{name}.jpg", blob))
    _matches(paths)


def test_missing_huffman_tables_are_the_standard_ones(tmp_path):
    """A frame without DHT segments (Motion-JPEG's habit): libjpeg-turbo's
    std_huff_tables supplies T.81's tables 0 and 1, and so does the port;
    Pillow's unoptimised frames carry those same tables."""
    rng = np.random.RandomState(11)
    paths = []
    for i, (layout, kind) in enumerate((("420", "rgb"), ("grey", "grey"))):
        blob = _read(_pillow(_image(rng, W, H, kind, "noise"),
                             tmp_path / f"s{i}.jpg", layout, quality=85,
                             optimize=False))
        sos = [s for s in jh.segments(blob) if s[0] == 0xDA][0]
        head = b"".join(blob[s:e] for m, s, e in jh.segments(blob)
                        if m != 0xC4 and e <= sos[1])
        stripped = blob[:2] + head + blob[sos[1]:]
        assert b"\xff\xc4" not in stripped[:sos[1]]
        paths.append(_write(tmp_path / f"n{i}.jpg", stripped))
    _matches(paths)


def _patched(blob, at, value):
    b = bytearray(blob)
    b[at] = value
    return bytes(b)


def test_frames_the_jax_library_refuses_raise(tmp_path):
    """Kinds the JAX library's libjpeg fails on: chosen from the header (a
    12-bit frame, a lossless one, four components), or found in a later
    scan (a scan of a component the frame lacks).  The port raises
    :class:`IOError` naming each in both modes, never with the exact
    mode's hint and never by another decoder."""
    rng = np.random.RandomState(12)
    a = _image(rng, 64, 48, "rgb", "smooth")
    base = _read(_pillow(a, tmp_path / "b.jpg", "420", quality=90))
    prog = _read(_pillow(a, tmp_path / "p.jpg", "420", quality=90,
                         progressive=True))
    sof = [s for s in jh.segments(base) if s[0] == 0xC0][0][1]
    later = [s for s in jh.segments(prog) if s[0] == 0xDA][3][1]
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(np.dstack([a, a[..., :1]]), "CMYK").save(cmyk, "JPEG")
    cases = {"12bit": (_patched(base, sof + 4, 12), "not 8 bits"),
             "lossless": (_patched(base, sof + 1, 0xC3), "lossless"),
             "cmyk": (_read(cmyk), "component count"),
             "bad_scan": (_patched(prog, later + 5, 0x7F), "scan's header")}
    good = str(tmp_path / "b.jpg")
    for name, (blob, why) in cases.items():
        path = _write(tmp_path / f"{name}.jpg", blob)
        for fast in (True, False):
            _modes(fast)
            with pytest.raises(Exception):
                jnative.decode_batch([path], 60)
            for out in (60, 150, 0):
                frame_decode.reset_launches()
                with pytest.raises(IOError, match=why) as err:
                    pnative.decode_batch([good, path], out, device="cpu")
                assert path in str(err.value)
                assert "CFN_EXACT_DECODE" not in str(err.value)
                assert frame_decode.DECODES["pillow"] == 0


def test_fixtures_against_the_jax_library():
    """The committed frames Pillow cannot write (``torch_port_jpegs/``,
    made by its ``make_fixtures.py``): the arithmetic and multi-scan ones
    on the port's path; the RGB-transform and 4:1:1 ones (which the JAX
    library decodes and the port leaves to the exact mode's decoder) raise
    naming the exact mode in the fast mode below 8/8, and equal the JAX
    library's through Pillow at 8/8, in the exact mode and raw."""
    own = [str(FIXTURES / n) for n in ("arith_sequential_420.jpg",
                                       "arith_progressive_420.jpg",
                                       "multiscan_sequential_422.jpg")]
    other = [str(FIXTURES / n) for n in ("rgb_transform_444.jpg",
                                         "sampling_411.jpg")]
    assert sum(p.stat().st_size for p in FIXTURES.glob("*.jpg")) < (
        256 << 10)
    assert [sd.probe(_read(p)).status for p in own + other] == [
        0, 0, 0, sd.RGB_TRANSFORM, sd.SAMPLING]
    _matches(own)
    for fast in (True, False):
        _modes(fast)
        frame_decode.reset_launches()
        _eq(pnative.decode_batch(other, 150, device="cpu"),
            jnative.decode_batch(other, 150))
        assert frame_decode.DECODES == {"port": 0, "nvjpeg": 0, "pillow": 2,
                                        "nvjpeg_calls": 0}
    _eq(pnative.decode_batch(other, 0, device="cpu"), _jax_raw(other))
    _modes(True)
    for path in other:
        with pytest.raises(IOError, match="CFN_EXACT_DECODE=1") as err:
            pnative.decode_batch([path], 60, device="cpu")
        assert path in str(err.value)


def test_large_411_fixtures_against_the_jax_library():
    """The two 640×480 4:1:1 fixtures (the path's size, where the card
    holds nvJPEG's decode of them against Pillow's): refused by the port's
    decoder by their header, named with the exact mode below 8/8 in the
    fast mode, and equal to the JAX library's through Pillow at 8/8, in
    the exact mode and raw."""
    paths = [str(FIXTURES / n) for n in ("sampling_411_smooth_640x480.jpg",
                                         "sampling_411_noise_640x480.jpg")]
    heads = [sd.probe(_read(p)) for p in paths]
    assert [(x.status, x.w, x.h) for x in heads] == [
        (sd.SAMPLING, 640, 480)] * 2
    for fast, out in ((True, 300), (False, 300), (False, 224)):
        _modes(fast)
        frame_decode.reset_launches()
        _eq(pnative.decode_batch(paths, out, device="cpu"),
            jnative.decode_batch(paths, out))
        assert frame_decode.DECODES == {"port": 0, "nvjpeg": 0, "pillow": 2,
                                        "nvjpeg_calls": 0}
    _eq(pnative.decode_batch(paths, 0, device="cpu"), _jax_raw(paths))
    _modes(True)
    with pytest.raises(IOError, match="CFN_EXACT_DECODE=1") as err:
        pnative.decode_batch(paths, 224, device="cpu")
    assert paths[0] in str(err.value)


def test_baseline_fast_path_is_the_buffered_path(helper, tmp_path):
    """A baseline frame's one interleaved scan (the fast path, decoded
    straight into the window) and the same picture's frame in one scan a
    component (the coefficient buffer's path): libjpeg quantises the same
    coefficients either way, and the port reads them alike, with restart
    intervals too, and as libjpeg does.  A scan whose components leave the
    frame header's order is refused, as libjpeg's get_sos refuses it."""
    rng = np.random.RandomState(13)
    a = _image(rng, W, H, "rgb", "noise")
    for restart in (0, 3):
        one = _read(jh.write(helper, a, tmp_path / "one.jpg", 20,
                             restart=restart))
        many = _read(jh.write(helper, a, tmp_path / "many.jpg", 20,
                              restart=restart, scans=1))
        assert len(jh.scans(one)) == 1 and len(jh.scans(many)) == 3
        fast, status = _port_coefficients(one)
        buffered, status2 = _port_coefficients(many)
        assert status == status2 == 0
        for x, y in zip(fast, buffered):
            np.testing.assert_array_equal(x, y)
        _same_coefficients(helper, one)
    sof = [s for s in jh.segments(one) if s[0] == 0xC0][0][1] + 10
    swapped = one[:sof + 3] + one[sof + 6:sof + 9] + one[sof + 3:sof + 6] + (
        one[sof + 9:])
    path = _write(tmp_path / "swapped.jpg", swapped)
    with pytest.raises(Exception):
        jnative.decode_batch([path], 60)
    with pytest.raises(IOError, match="scan's header") as err:
        pnative.decode_batch([path], 60, device="cpu")
    assert path in str(err.value)
