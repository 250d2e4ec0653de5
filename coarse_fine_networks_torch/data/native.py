"""The native data plane (counterpart of
``coarse_fine_networks_tpu/data/native.py`` and ``native/cfn_data.cpp``):
clip frames decoded and cropped in one pass, and the ``.cfnpack``
containers.

The JAX package decodes with a C++ thread pool over libjpeg-turbo.  The
port computes the same function, bit for bit, with a decoder of its own
(:mod:`..ops.scaled_decode`: a hand-written host entropy decoder, then
``idct_rgb_kernel``, libjpeg's IDCT, upsampling and colour conversion in
one pass) and :mod:`..ops.frame_decode`'s crop and resize
(``crop_resize_kernel``):

* on a CUDA device the kernels run on the card: the clip lands there as
  uint8, ready for :func:`.transforms.device_normalize`, on the calling
  thread's own stream (:func:`thread_stream`), which each call
  synchronises before it returns, so another stream may read the result;
* on the CPU their plain versions run; the result is a host ``numpy``
  array, as the JAX package's is.

Both modes of the JAX library are here.  The fast mode (the default, as
there: fast unless ``CFN_EXACT_DECODE`` is set; :func:`set_fast_decode`)
decodes a crop's MCUs at the smallest DCT scale num/8 that still covers
the output; the exact mode, and the fast mode where only 8/8 covers it,
decode at 8/8 with libjpeg's fancy upsampling, whose pixels inside the
crop are the full decode's.  ``out_size`` 0 gives the frames whole.  The
port's decoder reads baseline, progressive and arithmetic-coded frames, of
one scan or many, and frames cut short (grey where the data ends, as
libjpeg fills them).  The two kinds it leaves to another decoder (an RGB
colour transform, sampling factors 3 or 4) raise in the fast mode below
8/8, naming them and the way to the exact mode; at 8/8 and in the exact
mode they take nvJPEG on the card (whose pixels are not libjpeg's; an RGB
transform, which nvJPEG reads as YCbCr, raises there) or Pillow on the
CPU.  A frame the JAX library fails on too raises in both modes, as does
a progressive frame cut before its last scan, which libjpeg smooths.

:func:`available` is true wherever the port runs.  A CUDA decode whose
library does not build or load raises; it never turns into Pillow or the
CPU.

The ``.cfnpack`` format is written and read here in Python, byte for byte
the C++'s (``cfn_data.cpp:426-471``): ``[int64 magic][int64 n][int64
offsets[n + 1]][frame bytes]``, little-endian, offsets from the file's
start; pack index ``i`` holds frame ``i + 1``.
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import frame_decode

MAGIC = 0x43464E50414B3143  # "CFNPAK1C"
_HEADER = struct.Struct("<qq")

def available() -> bool:
    """Whether the native path can run: wherever the port runs (the plain
    versions on the CPU; the kernels on the card, built at first use)."""
    return True


def fast_decode() -> bool:
    """Whether the DCT-scaled fast path is on (the default unless
    ``CFN_EXACT_DECODE`` is set, read on first use)."""
    return frame_decode.fast_decode()


def set_fast_decode(enabled: bool) -> bool:
    """Turn the DCT-scaled fast path on or off for the process (over the
    ``CFN_EXACT_DECODE`` default); returns the previous setting."""
    return frame_decode.set_fast_decode(enabled)


_LOCAL = threading.local()


def thread_stream(device: torch.device) -> "torch.cuda.Stream":
    """The calling thread's CUDA stream on ``device`` (one per thread and
    device, from PyTorch's pool): the decode, the crop and the stacking of a
    loader worker's clips run on it."""
    streams = getattr(_LOCAL, "streams", None)
    if streams is None:
        streams = _LOCAL.streams = {}
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device=device)
    return s


def resolve_device(device) -> torch.device:
    """``device`` with the current CUDA device's index filled in (a loader's
    worker threads do not share the main thread's current device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def on_device(device):
    """Context yielding the resolved device: on a CUDA device the thread's
    stream (:func:`thread_stream`) is current inside and is synchronised on
    leaving, so what it computed may be read on any stream; on the CPU,
    nothing."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        yield dev
        return
    stream = thread_stream(dev)
    with torch.cuda.stream(stream):
        try:
            yield dev
        finally:
            stream.synchronize()


# ---- crop geometry (computed in double, as cfn_data.cpp does) ---------------

def center_box(w: int, h: int) -> Tuple[int, int, int, int]:
    """CenterCropScaled's box: the shorter side, centred, rounding like
    ``int(round(.../2))`` (``cfn_data.cpp:262-268``)."""
    m = min(w, h)
    return (w - m + 1) // 2, (h - m + 1) // 2, m, m


def random_box(scale: float, tl_x: float, tl_y: float):
    """MultiScaleRandomCropMultigrid's box for ``(w, h)``: ``crop =
    int(min(w, h)·scale)`` clamped to [1, min side], ``x1 = int(tl_x·(w −
    crop))``, ``y1`` likewise (``cfn_data.cpp:331-340``)."""
    def box(w: int, h: int):
        m = min(w, h)
        crop = min(max(int(m * float(scale)), 1), m)
        return (int(float(tl_x) * (w - crop)), int(float(tl_y) * (h - crop)),
                crop, crop)
    return box


def _decode(blobs, names, out_size, box, device, num_threads):
    arr = frame_decode.decode_crop_resize(blobs, names, out_size, box, device,
                                          num_threads)
    return arr.numpy() if arr.device.type == "cpu" else arr


def _read_files(paths: Sequence[str]) -> List[bytes]:
    blobs, bad = [], []
    for p in paths:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
        except OSError:
            bad.append(p)
    if bad:
        raise IOError(f"{len(bad)} frames failed to decode, e.g. {bad[:3]}")
    return blobs


def decode_batch(paths: Sequence[str], out_size: int,
                 num_threads: int = 4, device="cuda"):
    """Decode + CenterCropScaled a list of JPEGs → ``(N, out, out, 3)``
    uint8 (a device tensor on the card, a numpy array on the CPU);
    ``out_size`` 0: the frames whole, ``(N, h, w, 3)``.  ``num_threads``
    threads share the entropy decode."""
    with on_device(device) as d:
        return _decode(_read_files(paths), list(paths), out_size,
                       center_box, d, num_threads)


def decode_batch_random_crop(paths: Sequence[str], out_size: int,
                             scale: float, tl_x: float, tl_y: float,
                             num_threads: int = 4, device="cuda"):
    """Train-path decode: the clip's one random scale-and-position crop
    (MultiScaleRandomCropMultigrid, drawn by the caller once per clip)
    resized to ``(out, out)``."""
    with on_device(device) as d:
        return _decode(_read_files(paths), list(paths), out_size,
                       random_box(scale, tl_x, tl_y), d, num_threads)


# ---- .cfnpack containers ------------------------------------------------------

def _pack_header(f, path: str) -> np.ndarray:
    head = f.read(_HEADER.size)
    if len(head) != _HEADER.size:
        raise IOError(f"bad pack {path}: short header")
    magic, n = _HEADER.unpack(head)
    if magic != MAGIC:
        raise IOError(f"bad pack {path}: magic {magic:#x}")
    offsets = np.frombuffer(f.read(8 * (n + 1)), "<i8")
    if len(offsets) != n + 1:
        raise IOError(f"bad pack {path}: short index")
    return offsets


def pack_num_frames(pack_path: str) -> int:
    """The frame count of a pack; :class:`IOError` for a missing or bad
    one."""
    with open(pack_path, "rb") as f:
        return len(_pack_header(f, pack_path)) - 1


def read_pack_frames(pack_path: str, indices: Sequence[int]) -> List[bytes]:
    """The JPEG bytes of frames ``indices`` (0-based) of a pack."""
    with open(pack_path, "rb") as f:
        offsets = _pack_header(f, pack_path)
        n = len(offsets) - 1
        blobs = []
        for i in indices:
            if not 0 <= int(i) < n:
                raise IOError(f"{pack_path}: frame index {i} outside "
                              f"[0, {n})")
            f.seek(int(offsets[i]))
            size = int(offsets[i + 1] - offsets[i])
            blob = f.read(size)
            if len(blob) != size:
                raise IOError(f"{pack_path}: frame {i} truncated")
            blobs.append(blob)
    return blobs


def _pack_names(pack_path: str, indices) -> List[str]:
    return [f"{pack_path}[{i}]" for i in indices]


def decode_packed(pack_path: str, indices: Sequence[int], out_size: int,
                  num_threads: int = 4, device="cuda"):
    """Decode selected frames of a pack → ``(N, out, out, 3)`` uint8, the
    CenterCropScaled crop."""
    with on_device(device) as d:
        return _decode(read_pack_frames(pack_path, indices),
                       _pack_names(pack_path, indices), out_size, center_box,
                       d, num_threads)


def decode_packed_random_crop(pack_path: str, indices: Sequence[int],
                              out_size: int, scale: float, tl_x: float,
                              tl_y: float, num_threads: int = 4,
                              device="cuda"):
    """Packed-container variant of :func:`decode_batch_random_crop`."""
    with on_device(device) as d:
        return _decode(read_pack_frames(pack_path, indices),
                       _pack_names(pack_path, indices), out_size,
                       random_box(scale, tl_x, tl_y), d, num_threads)


def pack_video(paths: Sequence[str], out_path: str) -> None:
    """Concatenate frame JPEGs into one indexed ``.cfnpack`` container (the
    C++'s bytes: header, offsets, then the frames in order)."""
    blobs = _read_files(paths)
    n = len(blobs)
    offsets = np.empty(n + 1, "<i8")
    offsets[0] = 8 * (2 + n + 1)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    offsets[1:] += offsets[0]
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, n))
        f.write(offsets.tobytes())
        for b in blobs:
            f.write(b)
    os.replace(tmp, out_path)


def video_frames(root: str, vid: str) -> List[str]:
    """The contiguous 1-based frame run ``root/<vid>/<vid>-%06d.jpg``,
    stopping at the first gap (the loaders' stop-at-gap rule)."""
    paths = []
    i = 1
    while True:
        p = os.path.join(root, vid, f"{vid}-{i:06d}.jpg")
        if not os.path.exists(p):
            return paths
        paths.append(p)
        i += 1


def pack_directory(root: str, out_dir: str, vids=None,
                   skip_existing: bool = True) -> int:
    """Pack every ``root/<vid>/<vid>-%06d.jpg`` frame directory into
    ``out_dir/<vid>.cfnpack``; returns the number of packs written."""
    os.makedirs(out_dir, exist_ok=True)
    if vids is None:
        vids = sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))
    written = 0
    for vid in vids:
        out = os.path.join(out_dir, vid + ".cfnpack")
        if skip_existing and os.path.exists(out):
            continue
        paths = video_frames(root, vid)
        if paths:
            pack_video(paths, out)
            written += 1
    return written


def pack_for(pack_dir: Optional[str], vid: str, cache: dict
             ) -> Tuple[Optional[str], int]:
    """``(pack path, frame count)`` of ``vid`` under ``pack_dir``, or
    ``(None, 0)`` when it has no pack (the video reads its JPEG files);
    ``cache`` keeps the counts by video."""
    if pack_dir is None:
        return None, 0
    path = os.path.join(pack_dir, vid + ".cfnpack")
    nf = cache.get(vid)
    if nf is None:
        nf = pack_num_frames(path) if os.path.exists(path) else -1
        cache[vid] = nf
    return (path, nf) if nf >= 0 else (None, 0)
