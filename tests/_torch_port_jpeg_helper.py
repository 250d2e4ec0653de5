"""A small C helper over the system's libjpeg for the port's decode tests:
JPEG frames Pillow cannot write (4:4:0 and 4:1:1, arithmetic coding,
progressive scripts with restart intervals, sequential frames of several
scans, an RGB colour transform) and libjpeg's own coefficients of a frame
(``jpeg_read_coefficients``), to hold the port's entropy decoder against.
Built by g++ as ``native/`` builds, into the caller's directory.  Also the
byte-level views of a JPEG the tests cut and break frames by."""

import ctypes
import subprocess

import numpy as np

SOURCE = r"""
#include <setjmp.h>
#include <stdio.h>
#include <jpeglib.h>

// One frame: `px` (h x w x comps bytes), the luma's sampling factors (the
// chroma's are 1 x 1), a restart interval in MCUs, libjpeg's progressive
// script, arithmetic coding, `scans`: 1 one sequential scan per component,
// 2 the luma's scan then the chroma's interleaved; `rgb`: no colour
// transform (libjpeg writes an Adobe marker with transform 0).
extern "C" int write_jpeg(const unsigned char* px, int w, int h, int comps,
                          int quality, int h0, int v0, int restart,
                          int progressive, int arith, int scans, int rgb,
                          const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = comps;
  c.in_color_space = comps == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  if (rgb) jpeg_set_colorspace(&c, JCS_RGB);
  jpeg_set_quality(&c, quality, TRUE);
  if (comps == 3) {
    c.comp_info[0].h_samp_factor = h0;
    c.comp_info[0].v_samp_factor = v0;
    for (int i = 1; i < 3; ++i)
      c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
  }
  c.restart_interval = restart;
  c.arith_code = arith ? TRUE : FALSE;
  static jpeg_scan_info script[3];
  int n = 0;
  if (scans == 1) {
    for (int i = 0; i < comps; ++i) {
      script[n].comps_in_scan = 1;
      script[n++].component_index[0] = i;
    }
  } else if (scans == 2) {
    script[n].comps_in_scan = 1;
    script[n++].component_index[0] = 0;
    script[n].comps_in_scan = 2;
    script[n].component_index[0] = 1;
    script[n++].component_index[1] = 2;
  }
  for (int i = 0; i < n; ++i) {
    script[i].Ss = 0;
    script[i].Se = 63;
    script[i].Ah = script[i].Al = 0;
  }
  if (progressive) {
    jpeg_simple_progression(&c);
  } else if (n) {
    c.scan_info = script;
    c.num_scans = n;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(px + (size_t)c.next_scanline * w * comps);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(f);
  return 0;
}

// libjpeg's coefficients of every block of each component (its
// height_in_blocks x width_in_blocks, natural order) into `out`, and each
// component's block rows and columns into dims; returns the components, or
// -1 where libjpeg fails.
struct Err {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};
static void on_error(j_common_ptr c) { longjmp(((Err*)c->err)->jump, 1); }
static void quiet(j_common_ptr, int) {}

extern "C" int read_coefficients(const unsigned char* data, unsigned long size,
                                 short* out, long cap, int* dims) {
  jpeg_decompress_struct c;
  Err e;
  c.err = jpeg_std_error(&e.mgr);
  e.mgr.emit_message = quiet;
  e.mgr.error_exit = on_error;
  if (setjmp(e.jump)) {
    jpeg_destroy_decompress(&c);
    return -1;
  }
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, (unsigned char*)data, size);
  jpeg_read_header(&c, TRUE);
  jvirt_barray_ptr* arr = jpeg_read_coefficients(&c);
  long off = 0;
  for (int ci = 0; ci < c.num_components; ++ci) {
    jpeg_component_info* comp = &c.comp_info[ci];
    dims[2 * ci] = comp->height_in_blocks;
    dims[2 * ci + 1] = comp->width_in_blocks;
    for (unsigned r = 0; r < comp->height_in_blocks; ++r) {
      JBLOCKARRAY row = c.mem->access_virt_barray((j_common_ptr)&c, arr[ci],
                                                  r, 1, FALSE);
      for (unsigned x = 0; x < comp->width_in_blocks; ++x)
        for (int k = 0; k < 64 && off < cap; ++k) out[off++] = row[0][x][k];
    }
  }
  jpeg_abort_decompress(&c);
  jpeg_destroy_decompress(&c);
  return c.num_components;
}
"""


def build(root):
    """The helper, compiled into ``root`` (a directory)."""
    src = root / "jpeg_helper.cpp"
    src.write_text(SOURCE)
    so = root / "libjpeg_helper.so"
    proc = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", str(so),
                           str(src), "-ljpeg"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lib = ctypes.CDLL(str(so))
    lib.write_jpeg.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 11 + [
        ctypes.c_char_p]
    lib.read_coefficients.argtypes = [ctypes.c_char_p, ctypes.c_ulong,
                                      ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_void_p]
    return lib


def write(lib, a, path, quality=90, samp=(2, 2), restart=0,
          progressive=False, arith=False, scans=0, rgb=False):
    """Frame ``a`` (uint8 ``(h, w)`` grey or ``(h, w, 3)``) as a JPEG at
    ``path``; ``samp``: the luma's (h, v) sampling factors."""
    a = np.ascontiguousarray(a, np.uint8)
    comps = 1 if a.ndim == 2 else 3
    assert lib.write_jpeg(a.ctypes.data, a.shape[1], a.shape[0], comps,
                          quality, samp[0], samp[1], restart,
                          int(progressive), int(arith), scans, int(rgb),
                          str(path).encode()) == 0
    return str(path)


def coefficients(lib, blob):
    """libjpeg's quantised coefficients of each component of ``blob``:
    int16 ``(rows, cols, 64)`` over its own blocks, natural order."""
    cap = 1 << 22
    out = np.zeros(cap, np.int16)
    dims = np.zeros(6, np.int32)
    n = lib.read_coefficients(blob, len(blob), out.ctypes.data, cap,
                              dims.ctypes.data)
    assert n > 0, "libjpeg failed to read the frame"
    res, off = [], 0
    for c in range(n):
        r, w = dims[2 * c], dims[2 * c + 1]
        res.append(out[off:off + r * w * 64].reshape(r, w, 64))
        off += r * w * 64
    return res


def segments(blob):
    """``(marker, start, end)`` of each marker segment of ``blob`` (its
    entropy-coded data passed over), up to its EOI."""
    out, i = [], 2
    while i < len(blob) - 1:
        if blob[i] != 0xFF:
            i += 1
            continue
        m = blob[i + 1]
        if m == 0xFF:
            i += 1
            continue
        if m == 0 or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m == 0xD9:
            out.append((m, i, i + 2))
            break
        end = i + 2 + (blob[i + 2] << 8 | blob[i + 3])
        out.append((m, i, end))
        i = end
    return out


def scans(blob):
    """``(first, end)`` of each scan's entropy-coded data."""
    seg = segments(blob)
    return [(s[2], seg[k + 1][1] if k + 1 < len(seg) else len(blob))
            for k, s in enumerate(seg) if s[0] == 0xDA]


def restarts(blob):
    """The offsets of the RSTn markers in ``blob``."""
    return [i for i in range(len(blob) - 1)
            if blob[i] == 0xFF and 0xD0 <= blob[i + 1] <= 0xD7]
