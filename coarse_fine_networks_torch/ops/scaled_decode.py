"""The DCT-scaled partial decode: JPEG bytes → the RGB window of a crop at
num/8 of the frame's size, the function of the JAX package's default
("fast") native path (``native/cfn_data.cpp``'s ``decode_crop_scaled``,
:171-255, over libjpeg-turbo 2.1 with fancy upsampling off).

* the geometry (:func:`scale_num`, :func:`scaled_box`,
  :func:`component_sizes`, :func:`geometry`): the C++'s scale, its crop box
  on the scaled grid, libjpeg's per-component scaled block sizes, and the
  window of whole MCUs that covers the box;
* the entropy decode (``csrc/jpeg_entropy.cpp``, host C++ written by hand,
  no JPEG library): :func:`probe` reads a frame's head,
  :func:`entropy_decode` a window's quantised coefficients;
* ``scaled_idct_kernel`` and ``ycc_rgb_kernel`` (``csrc/scaled_idct.cu``;
  replace no TPU kernel: their counterpart is libjpeg inside
  ``decode_crop_scaled``): libjpeg-turbo's integer IDCTs at the scaled
  sizes and its YCbCr → RGB conversion, bit for bit.
  :func:`scaled_idct_plain` and :func:`ycc_rgb_plain` are the same integer
  sequences in int32 PyTorch ops, vectorised over blocks and pixels.

:func:`decode_windows` runs them for frames of one layout: on a CUDA
device the coefficients go to the card through a pinned buffer on the
current stream and the kernels run there; on the CPU the plain versions
run.  :func:`..frame_decode.decode_crop_resize` then crops and resizes the
window (``crop_resize_kernel`` or its plain version).  Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.hw import Work, kernel_work
from ._build import CudaLibrary, HostLibrary, I, P

SZ, I64 = ctypes.c_size_t, ctypes.c_int64
ENTROPY = HostLibrary("jpeg_entropy.cpp", {
    "cfn_jpeg_probe": [P, SZ, P],
    "cfn_entropy_reason": [I, P, I],
    "cfn_entropy_decode": [P, P, I, P, P, I64, P, P, P, I],
})
LIBRARY = CudaLibrary("scaled_idct.cu", {
    "cfn_scaled_idct": [P, P, I, P, P, P],
    "cfn_ycc_rgb": [P, I, P, P, I64, I, P],
})

# Kernel launches since the last reset (only where a kernel is launched,
# never by a plain version), and the scaled decode's calls and frames (on
# either device)
LAUNCHES = {"scaled_idct_kernel": 0, "ycc_rgb_kernel": 0}
DECODES = {"calls": 0, "frames": 0}
_COUNT_LOCK = threading.Lock()

# a plane's rows and offsets are multiples of PLANE_ALIGN bytes (the
# kernel's row stores are up to 8 bytes wide)
PLANE_ALIGN = 16
# rows of an RGB window start WINDOW_ALIGN bytes apart at least (as the
# nvJPEG frames do, so crop_resize_kernel stages them 16 bytes at a time)
WINDOW_ALIGN = 128

EXACT_HINT = "CFN_EXACT_DECODE=1 selects the exact path (the full decode)"


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        DECODES["calls"] = DECODES["frames"] = 0


def _count(key: str, table: dict = LAUNCHES, n: int = 1) -> None:
    with _COUNT_LOCK:
        table[key] += n


# ---- the geometry (native/cfn_data.cpp:203-227, libjpeg's jdmaster.c) -------

def scale_num(crop: int, out: int) -> int:
    """The smallest scale num/8, num in {8, 4, 2, 1}, at which a ``crop``
    still covers ``out`` (``cfn_data.cpp:208-210``)."""
    num = 8
    while num > 1 and (crop * (num // 2)) // 8 >= out:
        num //= 2
    return num


def scaled_size(size: int, num: int) -> int:
    """libjpeg's output size at num/8: ``ceil(size·num / 8)``."""
    return -(-size * num // 8)


def scaled_box(x1: int, y1: int, crop: int, num: int, sw: int, sh: int
               ) -> Tuple[int, int, int, int]:
    """The crop box ``(sx1, sy1, scw, sch)`` on the ``sw × sh`` scaled
    grid: floor origin, ceil extent, then each clamp in the C++'s order
    (``cfn_data.cpp:218-227``)."""
    sx1 = x1 * num // 8
    sy1 = y1 * num // 8
    scw = sch = (crop * num + 7) // 8
    if sx1 >= sw:
        sx1 = sw - 1
    if sy1 >= sh:
        sy1 = sh - 1
    if sx1 + scw > sw:
        scw = sw - sx1
    if sy1 + sch > sh:
        sch = sh - sy1
    return sx1, sy1, max(scw, 1), max(sch, 1)


def component_sizes(samp: Sequence[Tuple[int, int]], num: int) -> List[int]:
    """Each component's scaled block size at num/8: libjpeg's
    ``jpeg_core_output_dimensions`` doubles a component's size from num
    while the sampling ratios still divide, so subsampled chroma grows
    through the IDCT instead of being upsampled (4:2:0 chroma at 2·num,
    4:2:2 and 4:4:4 at num)."""
    max_h = max(h for h, _ in samp)
    max_v = max(v for _, v in samp)
    sizes = []
    for h, v in samp:
        s = num
        while (s < 8 and (max_h * num) % (h * s * 2) == 0
               and (max_v * num) % (v * s * 2) == 0):
            s *= 2
        sizes.append(s)
    return sizes


class Comp(NamedTuple):
    """One component's part of a window: its blocks (``rows × cols``,
    from ``block_off`` in a frame's blocks), scaled block size ``s``, its
    plane (``rows·s × cols·s`` bytes, rows ``pitch`` apart, from
    ``plane_off`` in a frame's planes) and its repetition up to the luma
    grid (``hexp``, ``vexp``)."""
    block_off: int
    rows: int
    cols: int
    s: int
    plane_off: int
    pitch: int
    hexp: int
    vexp: int


class Geometry(NamedTuple):
    """A frame layout's scaled decode: ``num``, the window of MCUs ``win``
    = (mc0, mc1, mr0, mr1), its pixels (``height × width``), the crop box
    in the window (``box``: x, y, w, h), each component's part, and a
    frame's coefficient blocks and plane bytes."""
    num: int
    win: Tuple[int, int, int, int]
    height: int
    width: int
    box: Tuple[int, int, int, int]
    comps: Tuple[Comp, ...]
    frame_blocks: int
    plane_bytes: int


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def geometry(w: int, h: int, samp: Sequence[Tuple[int, int]],
             box: Tuple[int, int, int, int], out: int) -> Geometry:
    """The scaled decode of a ``w × h`` frame with sampling factors
    ``samp`` (a single component's are (1, 1)), cropped at ``box`` =
    (x1, y1, crop, crop) and resized to ``out``: the window is the whole
    MCUs that cover the scaled box.  ``num`` is 8 where no smaller scale
    covers ``out``; the caller then takes the exact path."""
    x1, y1, crop, _ = box
    num = scale_num(crop, out)
    max_h = max(hh for hh, _ in samp)
    max_v = max(v for _, v in samp)
    sw, sh = scaled_size(w, num), scaled_size(h, num)
    sx1, sy1, scw, sch = scaled_box(x1, y1, crop, num, sw, sh)
    mw, mh = max_h * num, max_v * num
    win = (sx1 // mw, -(-(sx1 + scw) // mw), sy1 // mh, -(-(sy1 + sch) // mh))
    wc, wr = win[1] - win[0], win[3] - win[2]
    sizes = component_sizes(samp, num)
    comps, blocks, plane = [], 0, 0
    for (hh, v), s in zip(samp, sizes):
        rows, cols = wr * v, wc * hh
        pitch = _align(cols * s, PLANE_ALIGN)
        comps.append(Comp(blocks, rows, cols, s, plane, pitch,
                          mw // (hh * s), mh // (v * s)))
        blocks += rows * cols
        plane += _align(rows * s * pitch, PLANE_ALIGN)
    return Geometry(num, win, wr * mh, wc * mw,
                    (sx1 - win[0] * mw, sy1 - win[2] * mh, scw, sch),
                    tuple(comps), blocks, plane)


# the int64 array the kernels' C functions read (scaled_idct.cu's
# read_geom): ncomp, frame_blocks, plane_bytes, height, width, then each
# component's block_off, rows, cols, s, plane_off, pitch, hexp, vexp
GEOM_HEAD, GEOM_COMP = 5, 8


def geom_array(g: Geometry) -> np.ndarray:
    a = [len(g.comps), g.frame_blocks, g.plane_bytes, g.height, g.width]
    for c in g.comps:
        a += list(c)
    return np.asarray(a, np.int64)


# ---- the entropy decode (host) ---------------------------------------------

class Probe(NamedTuple):
    """A frame's head: ``status`` 0 where the entropy decoder takes it
    (else the reason's code), ``w``, ``h`` (also of a refused frame; 0
    where no frame header was read) and the components' sampling factors
    (where it is taken)."""
    status: int
    w: int
    h: int
    samp: Tuple[Tuple[int, int], ...]


def reason(status: int) -> str:
    buf = ctypes.create_string_buffer(160)
    ENTROPY.build().cfn_entropy_reason(status, buf, len(buf))
    return buf.value.decode()


def refused(names: Sequence[str], status: int) -> IOError:
    """The error of frames the entropy decoder refuses (or cannot read)."""
    return IOError(f"{len(names)} frames failed to decode, e.g. "
                   f"{list(names[:3])}: {reason(status)}; the fast decode "
                   f"reads baseline JPEGs only ({EXACT_HINT})")


def probe(blob: bytes) -> Probe:
    """The head of one JPEG (``csrc/jpeg_entropy.cpp``'s markers up to its
    first scan)."""
    info = (ctypes.c_int32 * 9)()
    st = ENTROPY.build().cfn_jpeg_probe(blob, len(blob), info)
    n = info[2] if st == 0 else 0
    return Probe(st, info[0], info[1],
                 tuple((info[3 + 2 * c], info[4 + 2 * c]) for c in range(n)))


def entropy_decode(blobs: Sequence[bytes], names: Sequence[str],
                   p: Probe, g: Geometry, num_threads: int = 1,
                   pin: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The window's quantised coefficients of frames of one layout (each
    frame's head ``p``): int16 ``(n, frame_blocks, 64)`` in natural order
    and each component's quantisation table, int32 ``(n, ncomp, 64)``;
    in pinned host memory where ``pin``.  ``num_threads`` threads share
    the frames.  A frame that fails raises :class:`IOError` naming it."""
    n, nc = len(blobs), len(p.samp)
    coefs = torch.empty((n, g.frame_blocks, 64), dtype=torch.int16,
                        pin_memory=pin)
    qt = torch.empty((n, nc, 64), dtype=torch.int32, pin_memory=pin)
    if not n:
        return coefs, qt
    layout = (ctypes.c_int32 * 9)(p.w, p.h, nc, *[
        x for hv in p.samp for x in hv], *([0] * (6 - 2 * nc)))
    win = (ctypes.c_int32 * 4)(*g.win)
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (SZ * n)(*[len(b) for b in blobs])
    status = np.zeros(n, np.int32)
    fails = ENTROPY.build().cfn_entropy_decode(
        datas, lens, n, layout, win, g.frame_blocks, coefs.data_ptr(),
        qt.data_ptr(), status.ctypes.data, max(1, int(num_threads)))
    if fails:
        bad = np.nonzero(status)[0]
        raise refused([names[i] for i in bad], int(status[bad[0]]))
    return coefs, qt


# ---- the IDCTs (libjpeg-turbo 2.1's jidctint.c and jidctred.c) ---------------

CONST_BITS, PASS1_BITS = 13, 2


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _idct_limit_table() -> torch.Tensor:
    """libjpeg's IDCT range-limit table, indexed by (value & 1023)."""
    v = torch.arange(1024, dtype=torch.int32)
    t = torch.where(v < 128, v + 128, torch.where(
        v < 512, 255, torch.where(v < 896, 0, v - 896)))
    return t.to(torch.uint8)


def _limit(x: torch.Tensor, n: int) -> torch.Tensor:
    table = _idct_limit_table().to(x.device)
    return table[(_descale(x, n) & 1023).long()]


def _islow_1d(d):
    """jpeg_idct_islow's even and odd parts on d[0..7] (each a tensor):
    the 8 outputs before their descale."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * 4433
    tmp2e = z1 + z3 * -15137
    tmp3e = z1 + z2 * 6270
    tmp0e = (d[0] + d[4]) << CONST_BITS
    tmp1e = (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0e + tmp3e, tmp0e - tmp3e
    tmp11, tmp12 = tmp1e + tmp2e, tmp1e - tmp2e
    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * 9633
    tmp0, tmp1 = tmp0 * 2446, tmp1 * 16819
    tmp2, tmp3 = tmp2 * 25172, tmp3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    tmp0 = tmp0 + (z1 + z3)
    tmp1 = tmp1 + (z2 + z4)
    tmp2 = tmp2 + (z2 + z3)
    tmp3 = tmp3 + (z1 + z4)
    return [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]


def _red4_1d(d):
    """jpeg_idct_4x4's pass on d[0..7] (d[4] unused): 4 outputs."""
    tmp0e = d[0] << (CONST_BITS + 1)
    tmp2e = d[2] * 15137 + d[6] * -6270
    tmp10, tmp12 = tmp0e + tmp2e, tmp0e - tmp2e
    z1, z2, z3, z4 = d[7], d[5], d[3], d[1]
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995
    return [tmp10 + tmp2, tmp12 + tmp0, tmp12 - tmp0, tmp10 - tmp2]


def _red2_1d(d):
    """jpeg_idct_2x2's pass on d[0..7] (d[2], d[4], d[6] unused): 2
    outputs."""
    tmp10 = d[0] << (CONST_BITS + 2)
    tmp0 = d[7] * -5906 + d[5] * 6967 + d[3] * -10426 + d[1] * 29692
    return [tmp10 + tmp0, tmp10 - tmp0]


# each size's 1-D pass and its two descales (pass 1, pass 2)
_PASSES = {8: (_islow_1d, CONST_BITS - PASS1_BITS,
               CONST_BITS + PASS1_BITS + 3),
           4: (_red4_1d, CONST_BITS - PASS1_BITS + 1,
               CONST_BITS + PASS1_BITS + 3 + 1),
           2: (_red2_1d, CONST_BITS - PASS1_BITS + 2,
               CONST_BITS + PASS1_BITS + 3 + 2)}


def idct_blocks_plain(deq: torch.Tensor, s: int) -> torch.Tensor:
    """Dequantised int32 blocks ``(..., 8, 8)`` (row = vertical frequency)
    → uint8 ``(..., s, s)`` pixels, libjpeg-turbo's IDCT of size ``s``."""
    if s == 1:
        return _limit(deq[..., :1, :1], 3)
    fn, d1, d2 = _PASSES[s]
    cols = fn([deq[..., k, :] for k in range(8)])       # s × (..., 8)
    ws = torch.stack([_descale(c, d1) for c in cols], -2)  # (..., s, 8)
    rows = fn([ws[..., k] for k in range(8)])           # s × (..., s)
    return torch.stack([_limit(r, d2) for r in rows], -1)


def _check_coefs(coefs: torch.Tensor, qt: torch.Tensor, g: Geometry):
    n = coefs.shape[0]
    if (coefs.dtype != torch.int16 or coefs.shape != (n, g.frame_blocks, 64)
            or not coefs.is_contiguous()):
        raise ValueError(f"coefs must be contiguous int16 (n, "
                         f"{g.frame_blocks}, 64), got {coefs.dtype} "
                         f"{tuple(coefs.shape)}")
    if (qt.dtype != torch.int32 or qt.shape != (n, len(g.comps), 64)
            or not qt.is_contiguous() or qt.device != coefs.device):
        raise ValueError(f"qt must be contiguous int32 (n, {len(g.comps)}, "
                         f"64) beside coefs, got {qt.dtype} "
                         f"{tuple(qt.shape)} on {qt.device}")


def component_planes(planes: torch.Tensor, g: Geometry) -> List[torch.Tensor]:
    """Views of each component's plane in ``planes`` (``(n,
    plane_bytes)``): uint8 ``(n, rows·s, cols·s)``."""
    n = planes.shape[0]
    return [planes.as_strided((n, c.rows * c.s, c.cols * c.s),
                              (g.plane_bytes, c.pitch, 1),
                              planes.storage_offset() + c.plane_off)
            for c in g.comps]


def scaled_idct_plain(coefs: torch.Tensor, qt: torch.Tensor,
                      g: Geometry) -> torch.Tensor:
    """:func:`scaled_idct`'s function in int32 PyTorch ops: each block
    dequantised (``coef · q``) and inverse-transformed at its component's
    size, into uint8 planes ``(n, plane_bytes)`` (padding zero)."""
    _check_coefs(coefs, qt, g)
    n = coefs.shape[0]
    planes = torch.zeros((n, g.plane_bytes), dtype=torch.uint8,
                         device=coefs.device)
    for ci, (c, view) in enumerate(zip(g.comps, component_planes(planes, g))):
        blk = coefs[:, c.block_off:c.block_off + c.rows * c.cols]
        deq = (blk.to(torch.int32) * qt[:, ci:ci + 1]).view(
            n, c.rows, c.cols, 8, 8)
        px = idct_blocks_plain(deq, c.s)                 # (n, R, C, s, s)
        view.copy_(px.permute(0, 1, 3, 2, 4).reshape(
            n, c.rows * c.s, c.cols * c.s))
    return planes


def idct_work(planes, coefs, qt, g: Geometry) -> Work:
    """:func:`scaled_idct`'s work: the coefficients and tables read once
    (int16, int32), each component's plane pixels written once (uint8);
    the integer operations of libjpeg's passes as written (IDCT_OPS a
    block by size), none of them a product's FLOPs."""
    n = coefs.shape[0]
    px = sum(c.rows * c.cols * c.s * c.s for c in g.comps)
    ops = sum(c.rows * c.cols * IDCT_OPS[c.s] for c in g.comps)
    return Work(coefs.numel() * 2 + qt.numel() * 4 + n * px, 0, n * ops)


# integer operations (adds, multiplies, shifts, the range limit's mask and
# lookup) of one block's IDCT at each size, counted from libjpeg's code:
# islow 8 + 8 passes of 26 (+8 dequantising multiplies in pass 1) and 8
# descales (2 ops) and 8 limits (2 ops) a pass; 4x4 7 columns of 19 (+7
# multiplies), 4 descales each, 4 rows of 19 with 4 descales and limits;
# 2x2 5 columns of 10 (+5), 2 descales, 2 rows of 10 with 2 descales and
# limits; 1x1 a multiply, a descale and a limit
IDCT_OPS = {8: 8 * (26 + 8 + 16) + 8 * (26 + 32),
            4: 7 * (19 + 7 + 8) + 4 * (19 + 16),
            2: 5 * (10 + 5 + 4) + 2 * (10 + 8),
            1: 5}


@kernel_work(idct_work)
def scaled_idct(coefs: torch.Tensor, qt: torch.Tensor,
                g: Geometry) -> torch.Tensor:
    """:func:`scaled_idct_plain`'s function: on CPU tensors the plain
    version, on CUDA tensors ``scaled_idct_kernel`` on the current stream
    (or raises).  The planes' padding is not written on the card."""
    _check_coefs(coefs, qt, g)
    if coefs.device.type == "cpu":
        return scaled_idct_plain(coefs, qt, g)
    if coefs.device.type != "cuda":
        raise ValueError(f"coefs on {coefs.device}: CPU or CUDA only")
    n = coefs.shape[0]
    planes = torch.empty((n, g.plane_bytes), dtype=torch.uint8,
                         device=coefs.device)
    if n:
        geom = geom_array(g)
        with torch.cuda.device(coefs.device):
            LIBRARY.call("cfn_scaled_idct", coefs.data_ptr(), qt.data_ptr(),
                         n, geom.ctypes.data, planes.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
        _count("scaled_idct_kernel")
    return planes


# ---- YCbCr → RGB (libjpeg's jdcolor.c) ---------------------------------------

def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


FIX_R, FIX_B = _fix16(1.40200), _fix16(1.77200)
FIX_GR, FIX_GB = _fix16(0.71414), _fix16(0.34414)


def _expanded(view: torch.Tensor, c: Comp, g: Geometry) -> torch.Tensor:
    v = view.repeat_interleave(c.vexp, 1) if c.vexp > 1 else view
    v = v.repeat_interleave(c.hexp, 2) if c.hexp > 1 else v
    return v[:, :g.height, :g.width].to(torch.int32)


def ycc_rgb_plain(planes: torch.Tensor, g: Geometry) -> torch.Tensor:
    """:func:`ycc_rgb`'s function in int32 PyTorch ops: each plane
    repeated up to the window's grid, then ``ycc_rgb_convert``'s fixed
    point (grey repeated): uint8 ``(n, height, width, 3)``."""
    ys = [_expanded(v, c, g)
          for v, c in zip(component_planes(planes, g), g.comps)]
    if len(ys) == 1:
        return ys[0].to(torch.uint8)[..., None].expand(
            -1, -1, -1, 3).contiguous()
    y, cb, cr = ys[0], ys[1] - 128, ys[2] - 128
    r = y + ((FIX_R * cr + (1 << 15)) >> 16)
    gg = y + ((-FIX_GB * cb + (1 << 15) + -FIX_GR * cr) >> 16)
    b = y + ((FIX_B * cb + (1 << 15)) >> 16)
    return torch.stack([r, gg, b], -1).clamp_(0, 255).to(torch.uint8)


def ycc_work(rgb, planes, g: Geometry) -> Work:
    """:func:`ycc_rgb`'s work: each plane's pixels read once, the window's
    RGB written once (uint8); ~15 integer operations a pixel (three
    products, sums, shifts and clamps), none of them FLOPs."""
    n = planes.shape[0]
    px = sum(c.rows * c.cols * c.s * c.s for c in g.comps)
    return Work(n * (px + 3 * g.height * g.width), 0,
                n * 15 * g.height * g.width)


def _window_pitch(g: Geometry) -> int:
    return _align(3 * g.width, WINDOW_ALIGN)


@kernel_work(ycc_work)
def ycc_rgb(planes: torch.Tensor, g: Geometry) -> torch.Tensor:
    """:func:`ycc_rgb_plain`'s function: on a CPU tensor the plain version,
    on a CUDA tensor ``ycc_rgb_kernel`` on the current stream (or raises),
    into a pitched buffer: the ``(n, height, width, 3)`` view of it."""
    if planes.dtype != torch.uint8 or planes.shape[1:] != (g.plane_bytes,):
        raise ValueError(f"planes must be uint8 (n, {g.plane_bytes}), got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return ycc_rgb_plain(planes, g)
    if planes.device.type != "cuda":
        raise ValueError(f"planes on {planes.device}: CPU or CUDA only")
    n = planes.shape[0]
    pitch = _window_pitch(g)
    buf = torch.empty((n, g.height, pitch), dtype=torch.uint8,
                      device=planes.device)
    if n:
        geom = geom_array(g)
        with torch.cuda.device(planes.device):
            LIBRARY.call("cfn_ycc_rgb", planes.data_ptr(), n,
                         geom.ctypes.data, buf.data_ptr(),
                         g.height * pitch, pitch,
                         torch.cuda.current_stream().cuda_stream)
        _count("ycc_rgb_kernel")
    return buf[:, :, :3 * g.width].view(n, g.height, g.width, 3)


# ---- one layout's frames -----------------------------------------------------

def decode_windows(blobs: Sequence[bytes], names: Sequence[str], p: Probe,
                   g: Geometry, device: torch.device,
                   num_threads: int = 1) -> torch.Tensor:
    """Frames of one layout (head ``p``) to their RGB windows (``g``):
    uint8 ``(n, height, width, 3)`` on ``device``.  The entropy decode runs
    on the host; on a CUDA device its coefficients go to the card through
    a pinned buffer on the current stream, and the kernels run there."""
    cuda = device.type == "cuda"
    if cuda:
        LIBRARY.build()
    coefs, qt = entropy_decode(blobs, names, p, g, num_threads, pin=cuda)
    _count("calls", DECODES)
    _count("frames", DECODES, len(blobs))
    if cuda:
        coefs = coefs.to(device, non_blocking=True)
        qt = qt.to(device, non_blocking=True)
    return ycc_rgb(scaled_idct(coefs, qt, g), g)

