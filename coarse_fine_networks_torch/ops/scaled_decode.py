"""The DCT-scaled partial decode: JPEG bytes → the RGB window of a crop at
num/8 of the frame's size, the function of the JAX package's native path
(``native/cfn_data.cpp`` over libjpeg-turbo 2.1): its default ("fast")
mode's ``decode_crop_scaled`` (:171-255, fancy upsampling off below 8/8
and on at 8/8), and at num 8 also its exact mode's full decode
(``decode_rgb``, :68-95), whose pixels inside a crop box are the same.

* the geometry (:func:`scale_num`, :func:`scaled_box`,
  :func:`component_sizes`, :func:`fancy_upsampled`, :func:`geometry`): the
  C++'s scale, its crop box on the scaled grid, libjpeg's per-component
  scaled block sizes and upsampling, and the window of whole MCUs that
  covers the box (one more MCU on each side where a fancy filter needs
  neighbours);
* the entropy decode (``csrc/jpeg_entropy.cpp``, host C++ written by hand,
  no JPEG library): :func:`probe` reads a frame's head,
  :func:`entropy_decode` a window's quantised coefficients, of sequential
  and progressive frames, Huffman- or arithmetic-coded, in one scan or
  many, and of broken data as libjpeg-turbo reads it (data that ends
  early, bad codes, restart markers out of order);
* ``idct_rgb_kernel`` (``csrc/scaled_idct.cu``; replaces no TPU kernel: its
  counterpart is libjpeg inside the C++): libjpeg-turbo's integer IDCTs at
  the scaled sizes (as its SIMD code computes them, 16-bit lanes and all:
  :func:`idct_blocks_plain`), its upsampling (repetition, or
  ``jdsample.c``'s fancy filters at 8/8) and its YCbCr → RGB conversion,
  bit for bit, in one pass.  :func:`idct_rgb_plain` is the same integer
  sequence in int32 PyTorch ops, step by step (:func:`scaled_idct_plain`,
  :func:`fancy_upsample_plain`, :func:`ycc_rgb_plain`).

:func:`decode_windows` runs them for frames of one layout: on a CUDA
device the coefficients go to the card through a pinned buffer on the
current stream and the kernel runs there; on the CPU the plain version
runs.  :func:`..frame_decode.decode_crop_resize` then crops and resizes the
window (``crop_resize_kernel`` or its plain version).  Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.hw import Work, kernel_work
from ._build import CudaLibrary, HostLibrary, I, P

SZ, I64 = ctypes.c_size_t, ctypes.c_int64
ENTROPY = HostLibrary("jpeg_entropy.cpp", {
    "cfn_jpeg_probe": [P, SZ, P],
    "cfn_entropy_reason": [I, P, I],
    "cfn_entropy_decode": [P, P, I, P, P, I64, P, P, P, I, I],
})
LIBRARY = CudaLibrary("scaled_idct.cu", {
    "cfn_idct_rgb": [P, P, I, P, P, I64, I, P],
})

# Kernel launches since the last reset (only where a kernel is launched,
# never by a plain version), and the scaled decode's calls and frames (on
# either device)
LAUNCHES = {"idct_rgb_kernel": 0}
DECODES = {"calls": 0, "frames": 0}
_COUNT_LOCK = threading.Lock()

# a plane's rows and offsets are multiples of PLANE_ALIGN bytes (the plain
# versions' planes, between the IDCT and the colour step)
PLANE_ALIGN = 16
# rows of an RGB window start WINDOW_ALIGN bytes apart at least (as the
# nvJPEG frames do, so crop_resize_kernel stages them 16 bytes at a time)
WINDOW_ALIGN = 128

# the entropy decoder's statuses (csrc/jpeg_entropy.cpp's Status) of the
# two kinds of frame that the JAX library's libjpeg decodes and the port
# leaves to the exact mode's decoders (nvJPEG, Pillow): sampling factors 3
# or 4, an RGB colour transform.  Every other refusal is of a frame the JAX
# library fails on too.
SAMPLING, RGB_TRANSFORM = -8, -14
EXACT_ROUTE = (SAMPLING, RGB_TRANSFORM)
EXACT_HINT = ("CFN_EXACT_DECODE=1 selects the exact mode, which decodes "
              "these frames with nvJPEG or Pillow")
# nvJPEG reads three components as YCbCr whatever the frame says (255
# levels at most and 94 on average from Pillow on the RGB-transform
# fixture: chip_smoke.py's decode phase on an H100), so the card takes no
# such frame
CARD_RGB = ("the card's decoder for it, nvJPEG, would read it as YCbCr; "
            "the CPU decodes it with Pillow")


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


def scaled_box(x1: int, y1: int, crop: int, num: int, sw: int, sh: int,
               crop_h: Optional[int] = None) -> Tuple[int, int, int, int]:
    """The crop box ``(sx1, sy1, scw, sch)`` on the ``sw × sh`` scaled
    grid: floor origin, ceil extent, then each clamp in the C++'s order
    (``cfn_data.cpp:218-227``).  ``crop_h``: the box's height where it
    differs from its width (a caller's box; the C++'s are square)."""
    sx1 = x1 * num // 8
    sy1 = y1 * num // 8
    scw = (crop * num + 7) // 8
    sch = scw if crop_h is None else (crop_h * num + 7) // 8
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


def downsampled_size(size: int, f: int, max_f: int, s: int) -> int:
    """A component's real samples across ``size`` pixels (libjpeg's
    ``downsampled_width`` and ``_height`` after scaling, ``jdmaster.c``):
    ``ceil(size · f · s / (max_f · 8))``."""
    return -(-size * f * s // (max_f * 8))


def fancy_upsampled(samp: Sequence[Tuple[int, int]], w: int) -> List[bool]:
    """Which components libjpeg-turbo 2.1's ``jinit_upsampler``
    (``jdsample.c``) upsamples by its fancy (triangle) filters at 8/8,
    where ``do_fancy_upsampling`` is on: a component at half the width
    (``h2v1``, ``h2v2``) where its ``downsampled_width > 2``, one at half
    the height only (``h1v2``) always.  The rest are full size or repeat
    their samples (``h2v1_upsample``, ``h2v2_upsample``)."""
    max_h = max(h for h, _ in samp)
    max_v = max(v for _, v in samp)
    out = []
    for h, v in samp:
        if max_h == 2 * h:
            out.append(downsampled_size(w, h, max_h, 8) > 2)
        else:
            out.append(max_v == 2 * v)
    return out


class Comp(NamedTuple):
    """One component's part of a window: its blocks (``rows × cols``,
    from ``block_off`` in a frame's blocks), scaled block size ``s``, its
    plane (``rows·s × cols·s`` bytes, rows ``pitch`` apart, from
    ``plane_off`` in a frame's planes) and its way up to the luma grid:
    ``hexp × vexp`` repeated, or (``fancy``) libjpeg's fancy filter of
    that ratio, whose neighbours are clamped to the window's samples
    ``[0, xmax] × [0, ymax]`` (the frame's last real sample where the
    window reaches the frame's edge)."""
    block_off: int
    rows: int
    cols: int
    s: int
    plane_off: int
    pitch: int
    hexp: int
    vexp: int
    fancy: int
    xmax: int
    ymax: int


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
             box: Tuple[int, int, int, int], out: int,
             num: Optional[int] = None) -> Geometry:
    """The scaled decode of a ``w × h`` frame with sampling factors
    ``samp`` (a single component's are (1, 1)), cropped at ``box`` =
    (x1, y1, cw, ch) and resized to ``out``, at ``num``/8 (by default the
    C++'s scale for the box's width, :func:`scale_num`).  The window is the
    whole MCUs that cover the scaled box.  At 8/8 a component that libjpeg
    upsamples by its fancy filter (:func:`fancy_upsampled`) needs its
    neighbours' samples, so the window then takes one more MCU on each side
    (clipped to the frame's MCU grid): inside the box every pixel is then
    the full decode's (``cfn_data.cpp:229-235`` keeps a 4-pixel margin for
    the same reason)."""
    x1, y1, cw, ch = box
    if num is None:
        num = scale_num(cw, out)
    max_h = max(hh for hh, _ in samp)
    max_v = max(v for _, v in samp)
    sw, sh = scaled_size(w, num), scaled_size(h, num)
    sx1, sy1, scw, sch = scaled_box(x1, y1, cw, num, sw, sh, ch)
    mw, mh = max_h * num, max_v * num
    mc0, mc1 = sx1 // mw, -(-(sx1 + scw) // mw)
    mr0, mr1 = sy1 // mh, -(-(sy1 + sch) // mh)
    fancy = fancy_upsampled(samp, w) if num == 8 else [False] * len(samp)
    if any(fancy):
        mc0, mc1 = max(mc0 - 1, 0), min(mc1 + 1, -(-sw // mw))
        mr0, mr1 = max(mr0 - 1, 0), min(mr1 + 1, -(-sh // mh))
    win = (mc0, mc1, mr0, mr1)
    wc, wr = mc1 - mc0, mr1 - mr0
    sizes = component_sizes(samp, num)
    comps, blocks, plane = [], 0, 0
    for (hh, v), s, fy in zip(samp, sizes, fancy):
        rows, cols = wr * v, wc * hh
        pitch = _align(cols * s, PLANE_ALIGN)
        xmax = min(cols * s, downsampled_size(w, hh, max_h, s)
                   - mc0 * hh * s) - 1
        ymax = min(rows * s, downsampled_size(h, v, max_v, s)
                   - mr0 * v * s) - 1
        comps.append(Comp(blocks, rows, cols, s, plane, pitch,
                          mw // (hh * s), mh // (v * s), int(fy), xmax,
                          ymax))
        blocks += rows * cols
        plane += _align(rows * s * pitch, PLANE_ALIGN)
    return Geometry(num, win, wr * mh, wc * mw,
                    (sx1 - mc0 * mw, sy1 - mr0 * mh, scw, sch),
                    tuple(comps), blocks, plane)


# the int64 array the kernel's C function reads (scaled_idct.cu's
# read_geom): ncomp, frame_blocks, plane_bytes, height, width, the window's
# MCU rows and columns, then each component's fields (Comp, in order)
GEOM_HEAD, GEOM_COMP = 7, 11


def geom_array(g: Geometry) -> np.ndarray:
    a = [len(g.comps), g.frame_blocks, g.plane_bytes, g.height, g.width,
         g.win[3] - g.win[2], g.win[1] - g.win[0]]
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


def refused(names: Sequence[str], status: int, hint: bool = False,
            card: bool = False) -> IOError:
    """The error of frames the entropy decoder refuses (or cannot read),
    naming them and the reason; ``hint``: where the exact mode would take
    them, say so; ``card``: an RGB-transform frame on the card."""
    return IOError(f"{len(names)} frames failed to decode, e.g. "
                   f"{list(names[:3])}: {reason(status)}"
                   + (f" ({EXACT_HINT})" if hint else "")
                   + (f"; {CARD_RGB}" if card else ""))


def probe(blob: bytes) -> Probe:
    """The head of one JPEG (``csrc/jpeg_entropy.cpp``'s markers up to its
    first scan): status 0 for every frame the entropy decoder takes,
    whatever its process, coding or scans."""
    info = (ctypes.c_int32 * 9)()
    st = ENTROPY.build().cfn_jpeg_probe(blob, len(blob), info)
    n = info[2] if st == 0 else 0
    return Probe(st, info[0], info[1],
                 tuple((info[3 + 2 * c], info[4 + 2 * c]) for c in range(n)))


def entropy_decode(blobs: Sequence[bytes], names: Sequence[str],
                   p: Probe, g: Geometry, num_threads: int = 1,
                   pin: bool = False, finish: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The window's quantised coefficients of frames of one layout (each
    frame's head ``p``): int16 ``(n, frame_blocks, 64)`` in natural order
    and each component's quantisation table, int32 ``(n, ncomp, 64)``;
    in pinned host memory where ``pin``.  ``num_threads`` threads share
    the frames.  ``finish``: read each frame on to its end, as the JAX
    library's full decode does (``jpeg_finish_decompress``), where its
    partial decode stops after the window.  A frame that fails (a later
    scan's header, a cut progressive frame that libjpeg would smooth)
    raises :class:`IOError` naming it and the reason."""
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
        qt.data_ptr(), status.ctypes.data, max(1, int(num_threads)),
        int(finish))
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


def _clamp(x: torch.Tensor, n: int) -> torch.Tensor:
    """``DESCALE(x, n) + 128`` saturated to [0, 255], as the SIMD IDCTs'
    packs give it."""
    return (_descale(x, n) + 128).clamp_(0, 255).to(torch.uint8)


def _w16(x: torch.Tensor) -> torch.Tensor:
    """``x`` wrapped to a 16-bit lane (the SIMD code's ``pmullw``,
    ``paddw``, ``psubw``, ``psllw``)."""
    return ((x + 32768) & 65535) - 32768


def _s16(x: torch.Tensor) -> torch.Tensor:
    """``x`` saturated to a 16-bit lane (``packssdw``)."""
    return x.clamp(-32768, 32767)


def _islow_1d(d):
    """jpeg_idct_islow's even and odd parts on d[0..7] (each a tensor of
    16-bit values): the 8 outputs before their descale, as libjpeg-turbo's
    SIMD code sums them (``jidctint-avx2.asm``, ``-sse2.asm``): the
    products and their sums exact in 32 bits, in the merged constants of
    its comments, which equal jidctint.c's integer for integer; the four
    sums it forms in 16-bit lanes (d0 ± d4, d7 + d3, d5 + d1) wrapped."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * 4433
    tmp2e = z1 + z3 * -15137
    tmp3e = z1 + z2 * 6270
    tmp0e = _w16(d[0] + d[4]) << CONST_BITS
    tmp1e = _w16(d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0e + tmp3e, tmp0e - tmp3e
    tmp11, tmp12 = tmp1e + tmp2e, tmp1e - tmp2e
    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = _w16(tmp0 + tmp2), _w16(tmp1 + tmp3)
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


# the coefficient rows each size reads beside row 0: where all are zero in
# every column, the SIMD code's first pass takes its shortcut
_AC_ROWS = {8: (1, 2, 3, 4, 5, 6, 7), 4: (1, 2, 3, 5, 6, 7)}


def idct_blocks_plain(coef: torch.Tensor, s: int,
                      q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantised int32 blocks ``(..., 8, 8)`` (row = vertical frequency)
    and their table ``q`` (``(..., 64)``, natural order; ``None``: the
    blocks are dequantised already) → uint8 ``(..., s, s)`` pixels, the IDCT
    of size ``s`` as libjpeg-turbo 2.1 computes it for the JAX library.  At
    s = 8, 4 and 2 its SIMD code (x86-64 SSE2 and AVX2: ``jsimd_idct_islow``,
    ``_4x4``, ``_2x2``): each product ``coef · q`` in a 16-bit lane
    (``pmullw``), a block whose rows beside row 0 are all zero taking
    ``(coef · q) << 2`` in 16 bits as its first pass, the first pass's
    outputs saturated to 16 bits, the last saturated to [0, 255].  At s = 1
    ``jpeg_idct_1x1`` in C: its table's wrap.  On the values 8-bit blocks
    give, all of this is jidctint.c's and jidctred.c's arithmetic."""
    if q is None:
        deq = coef
    else:
        deq = coef * q.view(*q.shape[:-1], 8, 8)
    if s == 1:
        return _limit(deq[..., :1, :1], 3)
    deq = _w16(deq)
    fn, d1, d2 = _PASSES[s]
    cols = fn([deq[..., k, :] for k in range(8)])       # s × (..., 8)
    ws = torch.stack([_descale(c, d1) for c in cols], -2)
    if s == 2:
        # jsimd_idct_2x2 keeps column 0's two values in 32 bits and packs
        # the odd columns' to 16; it has no shortcut
        ws = torch.cat([ws[..., :1], _s16(ws[..., 1:])], -1)
    else:
        ws = _s16(ws)
        rows = (coef if q is not None else deq)[..., _AC_ROWS[s], :]
        flat = (rows == 0).all(-1).all(-1)[..., None, None]
        ws = torch.where(flat, _w16(deq[..., :1, :] << PASS1_BITS), ws)
    rows = fn([ws[..., k] for k in range(8)])           # s × (..., s)
    return torch.stack([_clamp(r, d2) for r in rows], -1)


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
    """:func:`idct_rgb_plain`'s first step in int32 PyTorch ops: each block
    dequantised (``coef · q``) and inverse-transformed at its component's
    size, into uint8 planes ``(n, plane_bytes)`` (padding zero)."""
    _check_coefs(coefs, qt, g)
    n = coefs.shape[0]
    planes = torch.zeros((n, g.plane_bytes), dtype=torch.uint8,
                         device=coefs.device)
    for ci, (c, view) in enumerate(zip(g.comps, component_planes(planes, g))):
        blk = coefs[:, c.block_off:c.block_off + c.rows * c.cols]
        px = idct_blocks_plain(
            blk.to(torch.int32).view(n, c.rows, c.cols, 8, 8), c.s,
            qt[:, ci].view(n, 1, 1, 64))                 # (n, R, C, s, s)
        view.copy_(px.permute(0, 1, 3, 2, 4).reshape(
            n, c.rows * c.s, c.cols * c.s))
    return planes


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


# ---- upsampling (libjpeg-turbo 2.1's jdsample.c) -----------------------------

def _expanded(view: torch.Tensor, c: Comp, g: Geometry) -> torch.Tensor:
    v = view.repeat_interleave(c.vexp, 1) if c.vexp > 1 else view
    v = v.repeat_interleave(c.hexp, 2) if c.hexp > 1 else v
    return v[:, :g.height, :g.width].to(torch.int32)


def _taps(n: int, exp: int, last: int, device):
    """The fancy filter's sample indices along one axis of ``n`` output
    pixels: the nearer sample (``i // 2`` where ``exp`` is 2), the further
    one (the previous for an even pixel, the next for an odd one), both
    clamped to ``[0, last]``, and the pixel's parity; ``exp`` 1: the
    samples themselves."""
    i = torch.arange(n, device=device)
    if exp == 1:
        return i, i, None
    near = i >> 1
    odd = i & 1
    far = (near + 2 * odd - 1).clamp(0, last)
    return near.clamp(0, last), far, odd


def fancy_upsample_plain(view: torch.Tensor, c: Comp,
                         g: Geometry) -> torch.Tensor:
    """One component's plane (uint8 ``(n, rows·s, cols·s)``) up to the
    window's grid by libjpeg-turbo 2.1's fancy filters (``jdsample.c``),
    int32 ``(n, height, width)``: 3/4 of the nearer sample and 1/4 of the
    further one along each halved axis, the further one the previous for
    an even output and the next for an odd one.  ``h2v1_fancy_upsample``
    and ``h1v2_fancy_upsample`` round ``(3·near + far + 1 or 2) >> 2``
    (1 for an even output, 2 for an odd one); ``h2v2_fancy_upsample``
    sums each column's rows first (``3·near + far``), then ``(3·this +
    other + 8 or 7) >> 4``.  At the frame's edges libjpeg's neighbour is
    the edge sample itself (its first and last columns, and the context
    rows ``jdmainct.c`` points at rows 0 and ``downsampled_height − 1``),
    which is the clamp to ``[0, xmax] × [0, ymax]``; at the window's other
    edges the same clamp stands in for samples the window does not hold,
    in pixels :func:`geometry` keeps outside the box."""
    p = view.to(torch.int32)
    ny, fy, oy = _taps(g.height, c.vexp, c.ymax, p.device)
    nx, fx, ox = _taps(g.width, c.hexp, c.xmax, p.device)
    if c.vexp == 2 and c.hexp == 2:
        col = 3 * p[:, ny] + p[:, fy]                  # (n, height, cols·s)
        return (3 * col[:, :, nx] + col[:, :, fx] + 8 - ox) >> 4
    if c.hexp == 2:
        q = p[:, :g.height]
        return (3 * q[:, :, nx] + q[:, :, fx] + 1 + ox) >> 2
    q = p[:, :, :g.width]
    return (3 * q[:, ny] + q[:, fy] + 1 + oy[:, None]) >> 2


# ---- YCbCr → RGB (libjpeg's jdcolor.c) ---------------------------------------

def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


FIX_R, FIX_B = _fix16(1.40200), _fix16(1.77200)
FIX_GR, FIX_GB = _fix16(0.71414), _fix16(0.34414)


def ycc_rgb_plain(planes: torch.Tensor, g: Geometry) -> torch.Tensor:
    """The planes to RGB in int32 PyTorch ops: each plane up to the
    window's grid (repeated, or :func:`fancy_upsample_plain` where its
    ``fancy`` is set), then ``ycc_rgb_convert``'s fixed point (grey
    repeated): uint8 ``(n, height, width, 3)``."""
    ys = [fancy_upsample_plain(v, c, g) if c.fancy else _expanded(v, c, g)
          for v, c in zip(component_planes(planes, g), g.comps)]
    if len(ys) == 1:
        return ys[0].to(torch.uint8)[..., None].expand(
            -1, -1, -1, 3).contiguous()
    y, cb, cr = ys[0], ys[1] - 128, ys[2] - 128
    r = y + ((FIX_R * cr + (1 << 15)) >> 16)
    gg = y + ((-FIX_GB * cb + (1 << 15) + -FIX_GR * cr) >> 16)
    b = y + ((FIX_B * cb + (1 << 15)) >> 16)
    return torch.stack([r, gg, b], -1).clamp_(0, 255).to(torch.uint8)


# ---- the fused kernel: coefficients → RGB rows ---------------------------------

def idct_rgb_plain(coefs: torch.Tensor, qt: torch.Tensor,
                   g: Geometry) -> torch.Tensor:
    """:func:`idct_rgb`'s function in int32 PyTorch ops, step by step:
    :func:`scaled_idct_plain`, then each plane repeated or
    :func:`fancy_upsample_plain`, then the colour conversion
    (:func:`ycc_rgb_plain`): uint8 ``(n, height, width, 3)``."""
    return ycc_rgb_plain(scaled_idct_plain(coefs, qt, g), g)


# integer operations of the colour conversion a pixel (three products,
# sums, shifts and clamps) and of a fancy filter an output sample (h2v2:
# two column sums and the weighted sum; h2v1, h1v2: one weighted sum)
YCC_OPS = 15
FANCY_OPS = {(2, 2): 8, (2, 1): 4, (1, 2): 4}


def idct_rgb_work(rgb, coefs, qt, g: Geometry) -> Work:
    """:func:`idct_rgb`'s work: the coefficients and tables read once
    (int16, int32) and the window's RGB written once (uint8); the integer
    operations of libjpeg's IDCT passes as written (``IDCT_OPS`` a block by
    size), of its fancy filters (``FANCY_OPS`` a sample) and of the colour
    conversion (``YCC_OPS`` a pixel), none of them a product's FLOPs.  The
    neighbouring rows the kernel computes again are its own cost, not the
    function's."""
    n = coefs.shape[0]
    px = g.height * g.width
    ops = sum(c.rows * c.cols * IDCT_OPS[c.s]
              + (FANCY_OPS[c.hexp, c.vexp] * px if c.fancy else 0)
              for c in g.comps) + YCC_OPS * px
    return Work(coefs.numel() * 2 + qt.numel() * 4 + n * 3 * px, 0, n * ops)


def window_pitch(g: Geometry) -> int:
    """The bytes between the rows of an RGB window: room for whole 16-pixel
    groups (the kernel's stores), at least ``WINDOW_ALIGN`` apart."""
    return _align(3 * _align(g.width, 16), WINDOW_ALIGN)


@kernel_work(idct_rgb_work)
def idct_rgb(coefs: torch.Tensor, qt: torch.Tensor,
             g: Geometry) -> torch.Tensor:
    """:func:`idct_rgb_plain`'s function: on CPU tensors the plain version,
    on CUDA tensors ``idct_rgb_kernel`` on the current stream (or raises),
    into a pitched buffer (:func:`window_pitch`): the ``(n, height, width,
    3)`` view of it."""
    _check_coefs(coefs, qt, g)
    if coefs.device.type == "cpu":
        return idct_rgb_plain(coefs, qt, g)
    if coefs.device.type != "cuda":
        raise ValueError(f"coefs on {coefs.device}: CPU or CUDA only")
    n = coefs.shape[0]
    pitch = window_pitch(g)
    buf = torch.empty((n, g.height, pitch), dtype=torch.uint8,
                      device=coefs.device)
    if n:
        geom = geom_array(g)
        with torch.cuda.device(coefs.device):
            LIBRARY.call("cfn_idct_rgb", coefs.data_ptr(), qt.data_ptr(), n,
                         geom.ctypes.data, buf.data_ptr(), g.height * pitch,
                         pitch, torch.cuda.current_stream().cuda_stream)
        _count("idct_rgb_kernel")
    return buf[:, :, :3 * g.width].view(n, g.height, g.width, 3)


# ---- one layout's frames -----------------------------------------------------

def decode_windows(blobs: Sequence[bytes], names: Sequence[str], p: Probe,
                   g: Geometry, device: torch.device, num_threads: int = 1,
                   finish: bool = False) -> torch.Tensor:
    """Frames of one layout (head ``p``) to their RGB windows (``g``):
    uint8 ``(n, height, width, 3)`` on ``device``.  The entropy decode runs
    on the host; on a CUDA device its coefficients go to the card through
    a pinned buffer on the current stream, and ``idct_rgb_kernel`` runs
    there.  ``finish`` as :func:`entropy_decode`'s."""
    cuda = device.type == "cuda"
    if cuda:
        LIBRARY.build()
    coefs, qt = entropy_decode(blobs, names, p, g, num_threads, pin=cuda,
                               finish=finish)
    _count("calls", DECODES)
    _count("frames", DECODES, len(blobs))
    if cuda:
        coefs = coefs.to(device, non_blocking=True)
        qt = qt.to(device, non_blocking=True)
    return idct_rgb(coefs, qt, g)
