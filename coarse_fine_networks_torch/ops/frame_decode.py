"""Clip frames decoded and cropped on the card: JPEG bytes → uint8 ``(N,
out, out, 3)``, the function of the JAX package's native path
(``native/cfn_data.cpp``: libjpeg's decode, then ``crop_resize``).

* ``crop_resize_kernel`` (``csrc/frame_decode.cu``; replaces no TPU kernel:
  its counterpart is the host C++ ``crop_resize``, ``cfn_data.cpp:132``, and
  ``center_crop_scale`` at :262): each frame's crop box bilinearly resized
  to ``out × out`` in f32, every operation rounded on its own as g++ -O3
  computes it on x86-64.  :func:`crop_resize_plain` is the same sequence in
  separate PyTorch ops; the two agree bit for bit.  Bound by bytes: the
  crop's rows read once, ``out²·3`` bytes written a frame.  A block covers
  up to ``CROP_ROWS`` output rows of one frame (:func:`crop_plan`), stages
  their source rows with 16-byte copies and its geometry once, gives
  neighbouring threads neighbouring pixels and writes its rows with
  16-byte stores; the boxes travel in the launch's parameters,
  ``CROP_BOXES`` at most a launch (:func:`crop_launches`).
* nvJPEG, the decoder shipped with the CUDA toolkit (no TPU kernel exists
  for it), behind a thin C wrapper in the same source, for the two kinds of
  frame the JAX library decodes and the port's own decoder refuses by their
  header (sampling factors 3 or 4; an RGB colour transform it would read
  as YCbCr): one ``nvjpegDecodeBatched`` call for a clip's RGB
  frames, into a pitched device buffer the wrapper allocates, which the
  kernel reads through its pitch.  Grey frames decode to one channel,
  which the kernel repeats.  Its pixels are not libjpeg's.

:func:`decode_crop_resize` decodes a list of JPEGs and crops them: every
frame the port's entropy decoder reads (baseline, progressive, arithmetic,
of one scan or many, cut short) through :mod:`.scaled_decode` (the host
entropy decoder, then ``idct_rgb_kernel`` on the card, its plain version on
the CPU) at the JAX library's scale, in both of its modes
(:func:`fast_decode`), then the crop and resize; those two kinds by nvJPEG
on the card (sampling factors 3 or 4 only: it reads an RGB transform as
YCbCr), Pillow on the CPU.  The libraries are built at first use
(never when this module is imported).
"""

from __future__ import annotations

import ctypes
import io
import os
import threading
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.hw import Work, kernel_work
from . import scaled_decode
from ._build import CudaLibrary, I, P, cuda_home

SZ = ctypes.c_size_t
LIBRARY = CudaLibrary("frame_decode.cu", {
    "cfn_crop_resize": [P, I, I, I, I, P, P, I, I, I, P],
    "cfn_jpeg_create": [ctypes.POINTER(P)],
    "cfn_jpeg_info": [P, P, SZ, P],
    "cfn_jpeg_decode": [P, P, P, I, I, P, I, SZ, P],
}, flags=("-lnvjpeg", "-Xlinker", f"-rpath={cuda_home()}/lib64"))

# Kernel launches since the last reset (only where the kernel is launched,
# never by the plain version); the frames of each route of
# decode_crop_resize (the port's own path, nvJPEG, Pillow) and nvJPEG's
# decode calls
LAUNCHES = {"crop_resize_kernel": 0}
DECODES = {"port": 0, "nvjpeg": 0, "pillow": 0, "nvjpeg_calls": 0}
_COUNT_LOCK = threading.Lock()

# rows of a decoded frame start PITCH_ALIGN bytes apart at least
PITCH_ALIGN = 128
# crop_resize_kernel's work split (csrc/frame_decode.cu's constants): a
# block of CROP_THREADS threads covers at most CROP_ROWS output rows of one
# frame, thread t its pixels t, t + CROP_THREADS, ... in row order; the
# staged source rows and the output tile take at most CROP_SMEM bytes a
# block (fewer rows a block for wider crops); a launch carries at most
# CROP_BOXES boxes in its parameters
CROP_THREADS, CROP_ROWS = 256, 8
CROP_SMEM = 96 * 1024
CROP_BOXES = 1024

Box = Tuple[int, int, int, int]


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES["crop_resize_kernel"] = 0
        for k in DECODES:
            DECODES[k] = 0


def _count(table: dict, key: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        table[key] += n


def _check_frames(frames: torch.Tensor, boxes) -> np.ndarray:
    """Raise on what the kernel does not take; the boxes as int64 ``(N,
    4)``: uint8 frames ``(N, h, w, C)``, C 1 or 3, channels and pixels
    contiguous (rows may lie a pitch apart, frames ``h`` rows apart), each
    box ``(x1, y1, cw, ch)`` inside its frame."""
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError(f"frames must be uint8 (N, h, w, C), got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    n, h, w, c = frames.shape
    if c not in (1, 3):
        raise ValueError(f"frames must have 1 or 3 channels, got {c}")
    sn, sh, sw, sc = frames.stride()
    if sc != 1 or sw != c or sh < w * c or (n > 1 and sn != h * sh):
        raise ValueError(f"frames' strides {frames.stride()} are not a "
                         f"pitched (N, h, w, {c}) layout")
    b = np.asarray(boxes, np.int64)
    if b.shape != (n, 4):
        b = b.reshape(n, 4)
    if n:
        lo, hi = b.min(0), (b[:, :2] + b[:, 2:]).max(0)
        if (lo[0] < 0 or lo[1] < 0 or lo[2] < 1 or lo[3] < 1 or hi[0] > w
                or hi[1] > h):
            raise ValueError(f"crop boxes {b.tolist()} outside {w}x{h} "
                             f"frames")
    return b


def crop_resize_plain(frames: torch.Tensor, boxes, out: int) -> torch.Tensor:
    """Each frame's box ``(x1, y1, cw, ch)`` resized bilinearly to ``(out,
    out)``: uint8 ``(N, h, w, C)`` → uint8 ``(N, out, out, 3)`` on the
    frames' device, C = 1 giving three equal channels.  The arithmetic of
    ``native/cfn_data.cpp``'s ``crop_resize``, each operation rounded to
    f32: the sample positions and weights in numpy, the four-tap sum in
    PyTorch, in the C++'s order."""
    b = _check_frames(frames, boxes)
    n = frames.shape[0]
    x1, y1, cw, ch = b.T
    f32 = np.float32
    grid = np.arange(out, dtype=f32) + f32(0.5)

    def axis(size):
        s = size.astype(f32) / f32(out)
        f = grid[None, :] * s[:, None] - f32(0.5)
        f[f < 0] = 0
        i0 = f.astype(np.int64)
        ib = np.minimum(i0 + 1, size[:, None] - 1)
        wgt = f - i0.astype(f32)
        return i0, ib, wgt, f32(1) - wgt

    y0, yb, wy, oy = axis(ch)
    x0, xb, wx, ox = axis(cw)
    dev = frames.device

    def t(a, shape):
        return torch.from_numpy(np.ascontiguousarray(a)).reshape(shape).to(dev)

    nn_ = t(np.arange(n), (n, 1, 1))
    rows = [t(y1[:, None] + r, (n, out, 1)) for r in (y0, yb)]
    cols = [t(x1[:, None] + c, (n, 1, out)) for c in (x0, xb)]
    wy, oy = t(wy, (n, out, 1, 1)), t(oy, (n, out, 1, 1))
    wx, ox = t(wx, (n, 1, out, 1)), t(ox, (n, 1, out, 1))

    def tap(r, c):
        v = frames[nn_, rows[r], cols[c]].to(torch.float32)
        return v.expand(n, out, out, 3) if v.shape[-1] == 1 else v

    v = tap(0, 0) * oy * ox
    v = v + tap(0, 1) * oy * wx
    v = v + tap(1, 0) * wy * ox
    v = v + tap(1, 1) * wy * wx
    return (v + 0.5).to(torch.int32).to(torch.uint8)


class CropPlan(NamedTuple):
    """``crop_resize_kernel``'s split of one launch: ``rows`` output rows a
    block, ``span`` bytes staged of each source row (the largest box's crop
    from the 16-byte boundary at or below its first byte, a multiple of
    16)."""
    rows: int
    span: int


def crop_plan(boxes: np.ndarray, channels: int, out: int) -> CropPlan:
    """The split of a launch over ``boxes`` (``(N, 4)``): the span its
    crops need, and up to ``CROP_ROWS`` rows a block, halved while the
    block's two staged source rows a row and its output tile pass
    ``CROP_SMEM`` bytes."""
    x1 = boxes[:, 0] * channels
    span = int(((x1 + boxes[:, 2] * channels) - x1 // 16 * 16).max())
    span = -(-span // 16) * 16
    rows = min(CROP_ROWS, out)
    while rows > 1 and rows * (2 * span + 3 * out) > CROP_SMEM:
        rows //= 2
    return CropPlan(rows, span)


class CropLaunch(NamedTuple):
    """One launch of ``crop_resize_kernel``: its frames from ``first``, their
    boxes as the kernel's parameter block takes them (int32, box i at 4i)
    and its split."""
    first: int
    boxes: np.ndarray
    plan: CropPlan


def crop_launches(boxes: np.ndarray, channels: int,
                  out: int) -> List[CropLaunch]:
    """The launches of a call on ``boxes`` (``(N, 4)``): ``CROP_BOXES``
    frames at most each."""
    b32 = np.ascontiguousarray(boxes, np.int32)
    return [CropLaunch(i, b32[i:i + CROP_BOXES],
                       crop_plan(b32[i:i + CROP_BOXES], channels, out))
            for i in range(0, len(b32), CROP_BOXES)]


def crop_work(y, frames, boxes, out: int) -> Work:
    """:func:`crop_resize`'s work, ``y`` its output: each frame's box
    read once and its ``out``² RGB pixels written once (uint8); about 20
    operations an output element (the bilinear taps' weights and sums, the
    rounding), none of them a product's FLOPs."""
    b = np.asarray(boxes, np.int64).reshape(-1, 4)
    return Work(int((b[:, 2] * b[:, 3]).sum()) * frames.shape[-1]
                + y.numel(), 0, y.numel() * 20)


@kernel_work(crop_work)
def crop_resize(frames: torch.Tensor, boxes, out: int) -> torch.Tensor:
    """:func:`crop_resize_plain`'s function: on a CPU tensor its plain
    version, on a CUDA tensor ``crop_resize_kernel`` on the current stream
    (or raises), the boxes in its launches' parameters
    (:func:`crop_launches`)."""
    b = _check_frames(frames, boxes)
    if frames.device.type == "cpu":
        return crop_resize_plain(frames, b, out)
    if frames.device.type != "cuda":
        raise ValueError(f"frames on {frames.device}: CPU or CUDA only")
    n, h, _, c = frames.shape
    dev = frames.device
    y = torch.empty((n, out, out, 3), dtype=torch.uint8, device=dev)
    if not n:
        return y
    src, dst = frames.data_ptr(), y.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for la in crop_launches(b, c, out):
            LIBRARY.call("cfn_crop_resize", src + la.first * frames.stride(0),
                         len(la.boxes), h, frames.stride(1), c,
                         la.boxes.ctypes.data, dst + la.first * out * out * 3,
                         out, la.plan.rows, la.plan.span, stream)
            _count(LAUNCHES, "crop_resize_kernel")
    return y


# ---- the decode --------------------------------------------------------------

class _Decoders:
    """nvJPEG contexts (a handle and a state each), lent to one thread at a
    time and kept for the process's life: a loader's worker threads end
    with each epoch, so contexts are pooled rather than per thread."""

    def __init__(self):
        self._free: List[int] = []
        self._lock = threading.Lock()

    def acquire(self) -> int:
        with self._lock:
            if self._free:
                return self._free.pop()
        ctx = P()
        st = LIBRARY.build().cfn_jpeg_create(ctypes.byref(ctx))
        if st != 0:
            raise RuntimeError(f"nvjpeg: creating a decoder failed "
                               f"(status {st})")
        return ctx.value

    def release(self, ctx: int) -> None:
        with self._lock:
            self._free.append(ctx)


_DECODERS = _Decoders()


def jpeg_info(blob: bytes) -> Tuple[int, int, int]:
    """``(width, height, components)`` of one JPEG, from its header, by
    Pillow (no decode)."""
    from PIL import Image

    with Image.open(io.BytesIO(blob)) as img:
        return img.width, img.height, len(img.getbands())


def _pitch(w: int, c: int) -> int:
    return -(-w * c // PITCH_ALIGN) * PITCH_ALIGN


def _decode_group_cuda(ctx, lib, blobs, names, c, h, w, dev):
    """One size's frames decoded by nvJPEG into a pitched buffer: the
    ``(n, h, w, c)`` view of it."""
    n = len(blobs)
    pitch = _pitch(w, c)
    buf = torch.empty((n, h, pitch), dtype=torch.uint8, device=dev)
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (SZ * n)(*[len(x) for x in blobs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    st = lib.cfn_jpeg_decode(ctx, datas, lens, n, c, buf.data_ptr(), pitch,
                             h * pitch, stream)
    if st != 0:
        raise IOError(f"nvjpeg: decoding {n} frames failed (status {st}), "
                      f"e.g. {list(names[:3])}")
    _count(DECODES, "nvjpeg_calls")
    return buf[:, :, :w * c].view(n, h, w, c)


def _decode_group_cpu(blobs, names, c):
    from PIL import Image

    frames = []
    for blob, name in zip(blobs, names):
        try:
            with Image.open(io.BytesIO(blob)) as img:
                frames.append(np.asarray(img.convert("RGB"), np.uint8))
        except Exception as e:  # noqa: BLE001 — reported by name
            raise IOError(f"1 frames failed to decode, e.g. [{name!r}]: "
                          f"{e}") from e
    return torch.from_numpy(np.stack(frames))


# ---- the mode: the JAX library's fast decode (default) or its exact path ----

_MODE = {"fast": None}
_MODE_LOCK = threading.Lock()


def fast_decode() -> bool:
    """Whether :func:`decode_crop_resize` takes the DCT-scaled decode (the
    JAX library's fast mode).  The default is read on first use, as
    ``cfn_data.cpp:57-63`` reads it: fast unless ``CFN_EXACT_DECODE`` is
    set (to anything)."""
    with _MODE_LOCK:
        if _MODE["fast"] is None:
            _MODE["fast"] = os.environ.get("CFN_EXACT_DECODE") is None
        return _MODE["fast"]


def set_fast_decode(enabled: bool) -> bool:
    """Set the mode for the whole process; returns the previous one."""
    prev = fast_decode()
    with _MODE_LOCK:
        _MODE["fast"] = bool(enabled)
    return prev


def decode_crop_resize(blobs: Sequence[bytes], names: Sequence[str],
                       out: int, box_of: Callable[[int, int], Box],
                       device: "str | torch.device" = "cuda",
                       num_threads: int = 1) -> torch.Tensor:
    """Decode JPEGs (``blobs``, named ``names`` in errors) and crop and
    resize each to ``(out, out)``: uint8 ``(N, out, out, 3)`` on ``device``.
    ``box_of(w, h)`` gives a frame's crop box ``(x1, y1, cw, ch)``; frames
    of one size and layout go through the kernels together.  ``out < 1``
    gives the frames whole, uint8 ``(N, h, w, 3)`` (one size only), as the
    JAX library's raw decode (``cfn_data.cpp:342-344``).

    Every frame the port's entropy decoder reads (its header's probe is 0:
    sequential or progressive, Huffman- or arithmetic-coded, in one scan or
    many) takes the port's own path, on the card and on the CPU alike: the
    crop's MCUs decoded by :mod:`.scaled_decode` (the host entropy decoder,
    then ``idct_rgb_kernel`` on the card, its plain version on the CPU),
    then the crop and resize.  In fast mode (:func:`fast_decode`, the
    default) at the JAX library's scale num/8
    (:func:`.scaled_decode.scale_num`), in the exact mode and for whole
    frames at 8/8, whose pixels inside the box are libjpeg's full decode's.
    A frame cut short decodes as libjpeg fills it (grey where its data
    ends).  ``num_threads`` threads share the entropy decode.  A frame that
    fails there (a cut progressive frame that libjpeg would smooth, a
    broken later scan) raises :class:`IOError` naming it and the reason;
    it never goes on to another decoder.

    The route is chosen from the header, before any decode.  The two kinds
    that the JAX library decodes and this decoder leaves to another (an RGB
    colour transform, sampling factors 3 or 4) raise the same in fast mode
    below 8/8, naming ``CFN_EXACT_DECODE=1``, and take
    :func:`_decode_exact` at 8/8 and in the exact mode; on the card an RGB
    transform raises in both modes (nvJPEG would read it as YCbCr).  A
    frame whose header the JAX library fails on too (not a JPEG, lossless
    or hierarchical, 12-bit, 2 or 4 components, a missing table) raises in
    both modes.  :data:`DECODES` counts the frames of each route."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {dev}: CPU or CUDA only")
    fast = fast_decode()
    groups: dict = {}
    for i, blob in enumerate(blobs):
        p = scaled_decode.probe(blob)
        groups.setdefault((p.status, p.w, p.h, p.samp), (p, []))[1].append(i)
    sizes = {(p.w, p.h) for p, _ in groups.values() if p.w > 0}
    if out < 1 and len(sizes) > 1:
        raise ValueError(f"whole frames (out {out}) of more than one size: "
                         f"{sorted(sizes)}")
    parts, exact = [], []
    for p, idx in groups.values():
        gn = [names[i] for i in idx]
        box = None
        if p.w > 0:
            box = (0, 0, p.w, p.h) if out < 1 else box_of(p.w, p.h)
        num = (scaled_decode.scale_num(box[2], out)
               if fast and out >= 1 and box is not None else 8)
        if p.status != 0:
            if p.status not in scaled_decode.EXACT_ROUTE:
                raise scaled_decode.refused(gn, p.status)
            if dev.type == "cuda" and p.status == scaled_decode.RGB_TRANSFORM:
                raise scaled_decode.refused(gn, p.status, card=True)
            if fast and out >= 1 and num < 8:
                raise scaled_decode.refused(gn, p.status, hint=True)
            exact += idx
            continue
        g = scaled_decode.geometry(p.w, p.h, p.samp, box, out, num)
        # the JAX library's full decode (the exact mode, whole frames) reads
        # each frame to its end, its partial decode stops after the window
        win = scaled_decode.decode_windows([blobs[i] for i in idx], gn, p, g,
                                           dev, num_threads,
                                           finish=not fast or out < 1)
        _count(DECODES, "port", len(idx))
        x, y, cw, ch = g.box
        parts.append((idx, win[:, y:y + ch, x:x + cw] if out < 1
                      else crop_resize(win, np.broadcast_to(
                          np.asarray(g.box, np.int64), (len(idx), 4)), out)))
    if exact:
        parts.append((exact, _decode_exact([blobs[i] for i in exact],
                                           [names[i] for i in exact], out,
                                           box_of, dev)))
    return _assemble(len(blobs), out, dev, parts)


def _assemble(n: int, out: int, dev: torch.device, parts) -> torch.Tensor:
    """The ``(n, ...)`` result of parts ``(indices, frames)`` (no part: an
    empty ``(0, out, out, 3)``)."""
    if len(parts) == 1 and len(parts[0][0]) == n:
        return parts[0][1].contiguous()
    shape = parts[0][1].shape[1:] if parts else (max(out, 0),) * 2 + (3,)
    y = torch.empty((n, *shape), dtype=torch.uint8, device=dev)
    for idx, part in parts:
        y[torch.as_tensor(idx, device=dev)] = part
    return y


def _decode_exact(blobs, names, out: int, box_of, dev: torch.device
                  ) -> torch.Tensor:
    """The frames the JAX library decodes and the port's entropy decoder
    refuses by their header (sampling factors 3 or 4; on the CPU also an
    RGB colour transform), by the JAX library's exact path's function
    where another decoder reads them: on a CUDA device nvJPEG and
    ``crop_resize_kernel`` on the current stream, which is synchronised
    before the decoder is lent again (its state's device buffers serve the
    stream's work); on the CPU Pillow's decode to RGB and
    :func:`crop_resize_plain`.  A frame the decoder
    cannot read raises :class:`IOError` naming it, and a failed build or
    load of a library raises: the card never falls back to Pillow or the
    CPU.  nvJPEG's pixels are not libjpeg's (``chip_smoke.py``'s
    ``DECODE_BOUND``)."""
    n = len(blobs)
    cuda = dev.type == "cuda"
    lib = LIBRARY.build() if cuda else None
    ctx = _DECODERS.acquire() if cuda else None
    try:
        groups: dict = {}
        bad = []
        info = (ctypes.c_int * 3)()
        for i, (blob, name) in enumerate(zip(blobs, names)):
            if cuda:
                ok = lib.cfn_jpeg_info(ctx, blob, len(blob), info) == 0
                w, h, comps = tuple(info)
            else:
                try:
                    w, h, comps = jpeg_info(blob)
                    ok = True
                except Exception:  # noqa: BLE001 — reported by name
                    ok = False
            if not ok or comps not in (1, 3):
                bad.append(name)
                continue
            groups.setdefault((w, h, 1 if comps == 1 else 3), []).append(i)
        if bad:
            raise IOError(f"{len(bad)} frames failed to decode, e.g. "
                          f"{bad[:3]}")
        parts = []
        for (w, h, c), idx in groups.items():
            gb = [blobs[i] for i in idx]
            gn = [names[i] for i in idx]
            frames = (_decode_group_cuda(ctx, lib, gb, gn, c, h, w, dev)
                      if cuda else _decode_group_cpu(gb, gn, c))
            _count(DECODES, "nvjpeg" if cuda else "pillow", len(idx))
            parts.append((idx, frames.expand(-1, -1, -1, 3) if out < 1
                          else crop_resize(frames, np.broadcast_to(
                              np.asarray(box_of(w, h), np.int64),
                              (len(idx), 4)), out)))
        return _assemble(n, out, dev, parts)
    finally:
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
            _DECODERS.release(ctx)
