"""The port's native data plane (``data/native.py``, ``ops/frame_decode.py``,
``cli/pack_dataset.py``) against the JAX package's (``data/native.py`` over
``native/cfn_data.cpp``) in its exact mode, on the CPU: Pillow's decode and
``crop_resize_plain`` against libjpeg and the C++ ``crop_resize`` (both
packages' modes set to exact; the fast mode is
``test_torch_port_fast_decode.py``'s).

Exact: uint8 frames equal, packs equal byte for byte, the datasets' samples
and random draws equal.  Small sizes: frames of 40-64 pixels a side, a few
frames a video.  The card's path (nvJPEG and ``crop_resize_kernel``) is
held against ``crop_resize_plain`` and Pillow by ``chip_smoke.py``'s
``decode`` and ``packed`` phases.
"""

import filecmp
import glob
import io
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from coarse_fine_networks_tpu.cli import pack_dataset as jcli
from coarse_fine_networks_tpu.data import dataset as jds
from coarse_fine_networks_tpu.data import native as jnative
from coarse_fine_networks_tpu.data import transforms as jtr
from coarse_fine_networks_torch.cli import pack_dataset as pcli
from coarse_fine_networks_torch.data import dataset as pds
from coarse_fine_networks_torch.data import native as pnative
from coarse_fine_networks_torch.data import transforms as ptr
from coarse_fine_networks_torch.data.synthetic import generate_mini_charades
from coarse_fine_networks_torch.ops import frame_decode, scaled_decode

from _torch_port_util import jax_native_library

# built once under a lock, never loaded half-written (see the helper)
_NATIVE_MISSING = jax_native_library()
pytestmark = pytest.mark.skipif(_NATIVE_MISSING is not None,
                                reason=str(_NATIVE_MISSING))

# (out size, scale, tl_x, tl_y) of the random crops
CROPS = [(32, 0.7, 0.3, 0.6), (48, 0.875, 0.9, 0.05), (20, 1.0, 0.5, 0.5)]


@pytest.fixture(autouse=True)
def exact_decode():
    """Both packages in their exact mode (full decode, then the crop), each
    restored after: the fast mode is ``test_torch_port_fast_decode.py``'s."""
    prev = jnative.set_fast_decode(False), pnative.set_fast_decode(False)
    yield
    jnative.set_fast_decode(prev[0])
    pnative.set_fast_decode(prev[1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A mini-Charades tree (6 videos of 12 frames at 48², SYN000-002
    training; SYN002 cut at frame 9 by a gap), plus a folder of odd
    frames: non-square RGB (64×40 and 40×64), grey, and a broken file."""
    root = str(tmp_path_factory.mktemp("native"))
    anno = generate_mini_charades(root, num_videos=6, num_frames=12, hw=48,
                                  num_classes=5)
    frames = os.path.join(root, "frames")
    os.remove(os.path.join(frames, "SYN002", "SYN002-000010.jpg"))
    odd = os.path.join(root, "odd")
    os.makedirs(odd)
    rng = np.random.RandomState(1)
    paths = []
    for i, (w, h, mode) in enumerate([(64, 40, "RGB"), (40, 64, "RGB"),
                                      (56, 56, "L"), (64, 40, "RGB")]):
        shape = (h, w, 3) if mode == "RGB" else (h, w)
        img = Image.fromarray(rng.randint(0, 255, shape).astype(np.uint8),
                              mode)
        paths.append(os.path.join(odd, f"f{i}.jpg"))
        img.save(paths[-1], quality=90)
    bad = os.path.join(odd, "broken.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg")
    return {"root": root, "anno": anno, "frames": frames, "odd": paths,
            "bad": bad}


def _paths(tree, vid="SYN000"):
    return sorted(glob.glob(os.path.join(tree["frames"], vid, "*.jpg")))


def test_module_facts():
    """Available wherever the port runs; both of the JAX library's modes,
    switched as there (``set_fast_decode`` returns the previous mode);
    nothing built when the modules are imported."""
    assert pnative.available() is True
    assert pnative.fast_decode() is False
    assert pnative.set_fast_decode(True) is False
    assert pnative.fast_decode() is frame_decode.fast_decode() is True
    assert pnative.set_fast_decode(False) is True
    assert frame_decode.LIBRARY._lib is None
    assert scaled_decode.LIBRARY._lib is None
    assert "-lnvjpeg" in frame_decode.LIBRARY.flags


@pytest.mark.parametrize("kind", ["tree", "odd"])
def test_center_crop_decode_matches_jax(tree, kind):
    """CenterCropScaled from JPEG files: square frames, frames wider and
    taller than square (the box at ``(w − m + 1) // 2``) and grey ones
    (three equal channels)."""
    paths = _paths(tree) if kind == "tree" else tree["odd"]
    for out in (32, 48, 20):
        got = pnative.decode_batch(paths, out, device="cpu")
        ref = jnative.decode_batch(paths, out)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        assert got.shape == (len(paths), out, out, 3)
        np.testing.assert_array_equal(got, ref)
    if kind == "odd":
        grey = got[2]
        assert (grey[..., 0] == grey[..., 1]).all()
        assert (grey[..., 0] == grey[..., 2]).all()


@pytest.mark.parametrize("crop", CROPS)
@pytest.mark.parametrize("kind", ["tree", "odd"])
def test_random_crop_decode_matches_jax(tree, kind, crop):
    paths = _paths(tree) if kind == "tree" else tree["odd"]
    got = pnative.decode_batch_random_crop(paths, *crop, device="cpu")
    ref = jnative.decode_batch_random_crop(paths, *crop)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("crop", [None] + CROPS)
def test_packed_decode_matches_jax(tree, tmp_path, crop):
    """From a pack, the port's and the JAX package's, at selected
    indices: the same frames as from the files."""
    paths = _paths(tree, "SYN001")
    pack = str(tmp_path / "SYN001.cfnpack")
    pnative.pack_video(paths, pack)
    idx = [0, 3, 4, 11, 2]
    if crop is None:
        got = pnative.decode_packed(pack, idx, 40, device="cpu")
        ref = jnative.decode_packed(pack, idx, 40)
        files = pnative.decode_batch([paths[i] for i in idx], 40,
                                     device="cpu")
    else:
        got = pnative.decode_packed_random_crop(pack, idx, *crop,
                                                device="cpu")
        ref = jnative.decode_packed_random_crop(pack, idx, *crop)
        files = pnative.decode_batch_random_crop([paths[i] for i in idx],
                                                 *crop, device="cpu")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, files)


def test_jax_fast_path_is_another_function(tree, tmp_path):
    """The JAX library's fast mode (a DCT-scaled partial decode, then the
    resize) is another function than its exact mode, and the port's fast
    mode is that function: the train crop at 48² → 16 (scale 1/4 of the
    DCT covers it), the two fast paths equal, both unequal to the exact
    one."""
    paths = _paths(tree)
    exact = pnative.decode_batch_random_crop(paths, 16, 0.875, 0.3, 0.6,
                                             device="cpu")
    jnative.set_fast_decode(True)
    pnative.set_fast_decode(True)
    fast = jnative.decode_batch_random_crop(paths, 16, 0.875, 0.3, 0.6)
    mine = pnative.decode_batch_random_crop(paths, 16, 0.875, 0.3, 0.6,
                                            device="cpu")
    d = np.abs(fast.astype(np.int32) - exact)
    print("JAX fast path against the exact one: max", d.max(), "mean",
          d.mean())
    assert d.max() > 0
    np.testing.assert_array_equal(mine, fast)


def test_packs_cross_between_packages(tree, tmp_path):
    """The port writes the C++'s bytes, and each package reads the other's
    packs: frame counts and decoded frames."""
    paths = _paths(tree, "SYN003")
    mine, theirs = str(tmp_path / "port.cfnpack"), str(tmp_path / "jax.cfnpack")
    pnative.pack_video(paths, mine)
    jnative.pack_video(paths, theirs)
    assert filecmp.cmp(mine, theirs, shallow=False)
    assert pnative.pack_num_frames(theirs) == jnative.pack_num_frames(
        mine) == len(paths)
    for a, b in ((mine, theirs), (theirs, mine)):
        np.testing.assert_array_equal(
            pnative.decode_packed(a, [1, 5], 24, device="cpu"),
            jnative.decode_packed(b, [1, 5], 24))
    blobs = pnative.read_pack_frames(theirs, [0, len(paths) - 1])
    for blob, p in zip(blobs, (paths[0], paths[-1])):
        with open(p, "rb") as f:
            assert blob == f.read()


def test_pack_directory_matches_jax(tree, tmp_path):
    """Every video packed, the cut one up to its gap; the same files; a
    second call skips them, ``skip_existing=False`` rewrites them."""
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert pnative.pack_directory(tree["frames"], mine) == 6
    assert jnative.pack_directory(tree["frames"], theirs) == 6
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs)) == [
        f"SYN{v:03d}.cfnpack" for v in range(6)]
    for n in names:
        assert filecmp.cmp(os.path.join(mine, n), os.path.join(theirs, n),
                           shallow=False)
    assert pnative.pack_num_frames(os.path.join(mine, names[2])) == 9
    assert pnative.pack_directory(tree["frames"], mine) == 0
    assert pnative.pack_directory(tree["frames"], mine, vids=["SYN003"],
                                  skip_existing=False) == 1


def test_cli_matches_jax(tree, tmp_path, capsys):
    """``cli/pack_dataset.py`` against the JAX command line, flag for
    flag: the same files and the same report."""
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--root", tree["frames"], "--vids", "SYN000", "SYN004"]
    assert pcli.main(argv + ["--out", mine]) == 2
    out_p = capsys.readouterr().out
    jcli.main(argv + ["--out", theirs])
    out_j = capsys.readouterr().out
    assert out_p.replace(mine, "X") == out_j.replace(theirs, "X")
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for n in os.listdir(mine):
        assert filecmp.cmp(os.path.join(mine, n), os.path.join(theirs, n),
                           shallow=False)
    assert pcli.main(argv + ["--out", mine]) == 0
    assert pcli.main(argv + ["--out", mine, "--no-skip-existing"]) == 2


def test_failures_raise_naming_the_frame(tree, tmp_path):
    """A broken or missing frame raises :class:`IOError` naming it, as the
    JAX library raises; so does a bad pack or an index outside it."""
    paths = _paths(tree)[:2] + [tree["bad"]]
    for fn in (pnative.decode_batch, jnative.decode_batch):
        kw = {"device": "cpu"} if fn is pnative.decode_batch else {}
        with pytest.raises(IOError, match="broken.jpg"):
            fn(paths, 16, **kw)
    missing = os.path.join(tree["frames"], "SYN000", "none.jpg")
    with pytest.raises(IOError, match="none.jpg"):
        pnative.decode_batch([missing], 16, device="cpu")
    pack = str(tmp_path / "p.cfnpack")
    pnative.pack_video(_paths(tree)[:3], pack)
    with pytest.raises(IOError):
        pnative.decode_packed(pack, [3], 16, device="cpu")
    with pytest.raises(IOError):
        jnative.decode_packed(pack, [3], 16)
    with open(tree["bad"], "rb") as f, open(str(tmp_path / "x.cfnpack"),
                                            "wb") as g:
        g.write(f.read())
    with pytest.raises(IOError):
        pnative.pack_num_frames(str(tmp_path / "x.cfnpack"))


def test_cuda_decode_raises_without_a_card(tree):
    """On a machine without a card the CUDA path raises; it does not decode
    with Pillow instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        pnative.decode_batch(_paths(tree)[:2], 16, device="cuda")


def test_crop_resize_takes_pitched_frames():
    """``crop_resize`` on the CPU is its plain version; rows a pitch apart
    (nvJPEG's layout) give the contiguous frames' result, and per-frame
    boxes each their own; boxes outside a frame and other layouts raise."""
    rng = np.random.RandomState(2)
    n, h, w, pitch = 3, 30, 26, 128
    buf = torch.from_numpy(rng.randint(0, 255, (n, h, pitch), np.uint8))
    view = buf[:, :, :w * 3].view(n, h, w, 3)
    dense = view.contiguous()
    boxes = [(0, 0, 26, 26), (3, 4, 20, 20), (0, 2, 17, 25)]
    got = frame_decode.crop_resize(view, boxes, 16)
    np.testing.assert_array_equal(
        got, frame_decode.crop_resize_plain(dense, boxes, 16))
    for i, b in enumerate(boxes):
        np.testing.assert_array_equal(
            got[i], frame_decode.crop_resize_plain(dense[i:i + 1], [b],
                                                   16)[0])
    with pytest.raises(ValueError, match="outside"):
        frame_decode.crop_resize(dense, [(10, 0, 20, 20)] * n, 16)
    with pytest.raises(ValueError, match="strides"):
        frame_decode.crop_resize(dense.transpose(1, 2), boxes, 16)


def test_crop_resize_plain_is_the_cpp_arithmetic():
    """``crop_resize_plain`` against a per-pixel transcription of the C++
    loop in numpy float32 scalars (each operation rounded on its own),
    grey frames included."""
    rng = np.random.RandomState(3)
    f32 = np.float32
    for c in (3, 1):
        frame = rng.randint(0, 255, (21, 17, c)).astype(np.uint8)
        x1, y1, cw, ch, out = 2, 1, 13, 19, 9
        got = frame_decode.crop_resize_plain(torch.from_numpy(frame[None]),
                                             [(x1, y1, cw, ch)], out)[0]
        sx, sy = f32(cw) / f32(out), f32(ch) / f32(out)
        for y in range(out):
            fy = max((f32(y) + f32(0.5)) * sy - f32(0.5), f32(0))
            y0 = int(fy)
            yb = min(y0 + 1, ch - 1)
            wy = fy - f32(y0)
            for x in range(out):
                fx = max((f32(x) + f32(0.5)) * sx - f32(0.5), f32(0))
                x0 = int(fx)
                xb = min(x0 + 1, cw - 1)
                wx = fx - f32(x0)
                for k in range(3):
                    kk = k if c == 3 else 0

                    def px(r, q):
                        return f32(frame[y1 + r, x1 + q, kk])
                    v = (px(y0, x0) * (f32(1) - wy) * (f32(1) - wx)
                         + px(y0, xb) * (f32(1) - wy) * wx
                         + px(yb, x0) * wy * (f32(1) - wx)
                         + px(yb, xb) * wy * wx)
                    assert int(got[y, x, k]) == int(v + f32(0.5)), (y, x, k)


def _crop_kernel_model(frames, boxes, out):
    """``crop_resize_kernel`` (``csrc/frame_decode.cu``) in numpy: each
    launch of ``crop_launches``, its grid (``plan.rows`` output rows of one
    frame a block), each block's staged source rows (the crop's bytes at
    their offsets from the 16-byte boundary ``lo``, ``plan.span`` bytes a
    row; a byte never staged reads -1), its geometry, and its threads'
    pixels (pixel i of the block's rows, in row order, to thread i mod
    ``CROP_THREADS``): the output, and how often each output pixel was
    written."""
    n, h, w, c = frames.shape
    f32 = np.float32
    y = np.zeros((n, out, out, 3), np.uint8)
    writes = np.zeros((n, out, out), np.int64)

    def axis(i, s, size):
        f = (i.astype(f32) + f32(0.5)) * s - f32(0.5)
        f[f < 0] = 0
        i0 = f.astype(np.int64)
        return i0, np.minimum(i0 + 1, size - 1), f - i0.astype(f32)

    for la in frame_decode.crop_launches(np.asarray(boxes), c, out):
        rows, span = la.plan
        for j, (x1, y1, cw, ch) in enumerate(la.boxes.tolist()):
            f = la.first + j
            lo = x1 * c // 16 * 16
            assert (x1 + cw) * c - lo <= span
            sx, sy = f32(cw) / f32(out), f32(ch) / f32(out)
            x0, xb, wx = axis(np.arange(out), sx, cw)
            offs = [(x1 + x0) * c - lo, (x1 + xb) * c - lo]
            ox = f32(1) - wx
            flat = frames[f].reshape(h, w * c).astype(np.int64)
            for ya in range(0, out, rows):
                nr = min(rows, out - ya)
                y0, yb, wy = axis(ya + np.arange(nr), sy, ch)
                oy = f32(1) - wy
                stage = np.full((2 * nr, span), -1, np.int64)
                for s in range(2 * nr):
                    src = y1 + (yb if s & 1 else y0)[s // 2]
                    stage[s, x1 * c - lo:(x1 + cw) * c - lo] = flat[
                        src, x1 * c:(x1 + cw) * c]
                items = np.concatenate([
                    np.arange(t, nr * out, frame_decode.CROP_THREADS)
                    for t in range(frame_decode.CROP_THREADS)])
                r, x = items // out, items % out
                for k in range(3):
                    q = k if c == 3 else 0
                    taps = [stage[2 * r + e, offs[d][x] + q]
                            for e in (0, 1) for d in (0, 1)]
                    assert all((t >= 0).all() for t in taps)
                    v00, v01, v10, v11 = (t.astype(f32) for t in taps)
                    v = v00 * oy[r] * ox[x]
                    v = v + v01 * oy[r] * wx[x]
                    v = v + v10 * wy[r] * ox[x]
                    v = v + v11 * wy[r] * wx[x]
                    y[f, ya + r, x, k] = (v + f32(0.5)).astype(np.int64)
                np.add.at(writes[f], (ya + r, x), 1)
    return y, writes


@pytest.mark.parametrize("out", [224, 112, 7, 1])
def test_crop_kernel_model_writes_every_pixel_once(out):
    """The kernel's work split (grid, staged rows, thread pixels) writes
    every output pixel of every frame once, reading only staged bytes of
    the crop, and gives ``crop_resize_plain``'s pixels: odd frame sizes,
    grey and RGB, boxes at odd offsets (``lo`` below the crop)."""
    rng = np.random.RandomState(4)
    for (n, h, w, c), boxes in [
            ((3, 37, 53, 3), [(0, 0, 37, 37), (5, 3, 31, 29),
                              (16, 0, 37, 37)]),
            ((2, 29, 41, 1), [(7, 1, 23, 27), (0, 0, 41, 29)])]:
        frames = rng.randint(0, 256, (n, h, w, c)).astype(np.uint8)
        got, writes = _crop_kernel_model(frames, boxes, out)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, frame_decode.crop_resize_plain(
            torch.from_numpy(frames), boxes, out).numpy())


def test_crop_launches_carry_the_boxes():
    """The boxes' launch argument: int32, box i at 4i of the launch's
    block whatever the layout of the boxes given, ``CROP_BOXES`` frames a
    launch (past the cap, further launches); each plan's span holds its
    crops and its rows fit ``CROP_SMEM`` (a wide crop takes fewer rows a
    block)."""
    cap = frame_decode.CROP_BOXES
    rng = np.random.RandomState(5)
    n = 2 * cap + 5
    b = np.stack([rng.randint(0, 50, n), rng.randint(0, 50, n),
                  rng.randint(1, 400, n), rng.randint(1, 400, n)], 1)
    launches = frame_decode.crop_launches(b, 3, 224)
    assert [(la.first, len(la.boxes)) for la in launches] == [
        (0, cap), (cap, cap), (2 * cap, 5)]
    for la in launches:
        assert la.boxes.dtype == np.int32 and la.boxes.flags.c_contiguous
        block = np.frombuffer(la.boxes.tobytes(), np.int32)
        np.testing.assert_array_equal(
            block, b[la.first:la.first + len(la.boxes)].ravel())
        x1, cw = la.boxes[:, 0], la.boxes[:, 2]
        assert la.plan.span % 16 == 0
        assert ((x1 + cw) * 3 - x1 * 3 // 16 * 16 <= la.plan.span).all()
        assert la.plan.rows == frame_decode.CROP_ROWS
    assert frame_decode.crop_launches(b[:1], 3, 224)[0].plan.span == 16 * (
        -(-((b[0, 0] + b[0, 2]) * 3 - b[0, 0] * 3 // 16 * 16) // 16))
    wide = frame_decode.crop_launches(np.array([[0, 0, 7000, 7000]]), 3, 224)
    assert wide[0].plan == (2, 21008)
    assert 2 * wide[0].plan.rows * wide[0].plan.span <= frame_decode.CROP_SMEM
    assert frame_decode.crop_launches(
        np.array([[3, 0, 20, 20]]), 1, 7)[0].plan == (7, 32)
    assert frame_decode.crop_launches(np.zeros((0, 4)), 3, 224) == []
    # boxes in any layout (a broadcast box, Fortran order) reach the
    # parameter block in C order: box i at 4i
    for odd in (np.broadcast_to(b[0], (5, 4)), np.asfortranarray(b[:5])):
        (la,) = frame_decode.crop_launches(odd, 3, 224)
        np.testing.assert_array_equal(
            np.frombuffer(la.boxes.tobytes(), np.int32),
            np.ascontiguousarray(odd).ravel())


def _charades(mod, tr, tree, split, pack_dir, **kw):
    if split == "training":
        t = tr.Compose([tr.MultiScaleRandomCropMultigrid([0.875, 0.7], 32),
                        tr.RandomHorizontalFlip(deferred=True)])
    else:
        t = tr.Compose([tr.CenterCropScaled(32)])
    return mod.CharadesDataset(tree["anno"], split, tree["frames"],
                               spatial_transform=t, frames=4, gamma_tau=1,
                               crops=2 if split == "testing" else 1,
                               min_frames=5, num_classes=5, crop_size=32,
                               decode_backend="native", pack_dir=pack_dir,
                               seed=4, **kw)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("split", ["training", "testing"])
def test_charades_dataset_matches_jax(tree, tmp_path, split, packed):
    """``CharadesDataset(decode_backend="native", pack_dir=...)`` in both
    packages: equal samples (clips, labels, meta, flips) and the same
    random draws (the global ``random`` and the start-frame RNG) over two
    passes; with packs for all videos but one, which reads its files."""
    pack_dir = None
    if packed:
        pack_dir = str(tmp_path / "packs")
        vids = sorted(os.listdir(tree["frames"]))
        pnative.pack_directory(tree["frames"], pack_dir, vids=vids[1:])
    got_ds = _charades(pds, ptr, tree, split, pack_dir, device="cpu")
    ref_ds = _charades(jds, jtr, tree, split, pack_dir)
    assert (got_ds.native_crop, got_ds.native_train is None) == (
        ref_ds.native_crop, ref_ds.native_train is None)
    assert got_ds.pack_dir == ref_ds.pack_dir
    runs = []
    for ds in (got_ds, ref_ds):
        random.seed(9)
        runs.append([ds[i] for _ in range(2) for i in range(len(ds))])
        runs[-1].append((random.getstate(), ds.rng.getstate()))
    *got, got_state = runs[0]
    *ref, ref_state = runs[1]
    assert got_state == ref_state
    for a, b in zip(got, ref):
        assert isinstance(a["clips"], np.ndarray)
        assert a["clips"].shape == b["clips"].shape
        np.testing.assert_array_equal(a["clips"], b["clips"])
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["meta"], b["meta"])
        assert (a["vid"], a["flip"], a["dur"]) == (b["vid"], b["flip"],
                                                   b["dur"])
    if split == "training":
        assert len({s["flip"] for s in got}) == 2


def test_native_needs_a_native_pipeline(tree):
    """``"native"`` raises where the pipeline is neither a
    ``CenterCropScaled`` alone nor the train crop with a deferred flip, as
    in JAX; ``"auto"`` takes Pillow there, and ``"pil"`` always."""
    t = ptr.Compose([ptr.CenterCrop(32)])
    for mod, tr in ((pds, ptr), (jds, jtr)):
        with pytest.raises(ValueError, match="native decode requires"):
            mod.CharadesDataset(tree["anno"], "testing", tree["frames"],
                                spatial_transform=tr.Compose(
                                    [tr.CenterCrop(32)]),
                                decode_backend="native")
    ds = pds.CharadesDataset(tree["anno"], "testing", tree["frames"],
                             spatial_transform=t)
    assert (ds.native_crop, ds.native_train) == (None, None)
    ds = pds.CharadesDataset(tree["anno"], "testing", tree["frames"],
                             spatial_transform=ptr.Compose(
                                 [ptr.CenterCropScaled(32)]),
                             decode_backend="pil", pack_dir="packs")
    assert (ds.native_crop, ds.pack_dir) == (None, None)


def test_collate_stacks_tensor_clips_like_arrays(tree):
    """Clips that come as tensors (the card's decode gives device tensors)
    stack to the host arrays' batch, padded with zeros."""
    ds = _charades(pds, ptr, tree, "testing", None, device="cpu")
    samples = [ds[i] for i in range(len(ds))]
    as_tensors = [dict(s, clips=torch.from_numpy(s["clips"]))
                  for s in samples]
    ref = pds.collate_clips(samples, pad_t_multiple=8)
    got = pds.collate_clips(as_tensors, pad_t_multiple=8)
    assert isinstance(got["clips"], torch.Tensor)
    np.testing.assert_array_equal(got["clips"].numpy(), ref["clips"])
    for k in ("labels", "masks", "clip_mask", "meta"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_jpeg_info_reads_the_header(tree):
    for p, (w, h, c) in zip(tree["odd"], [(64, 40, 3), (40, 64, 3),
                                          (56, 56, 1), (64, 40, 3)]):
        with open(p, "rb") as f:
            assert frame_decode.jpeg_info(f.read()) == (w, h, c)
    with pytest.raises(Exception):
        frame_decode.jpeg_info(io.BytesIO(b"x").read())
