// A baseline JPEG's entropy decode on the host: the quantised DCT
// coefficients of a window of MCUs, for the decode of ops/scaled_decode.py
// (the JAX package's native path at every scale: native/cfn_data.cpp's
// decode_crop_scaled and decode_rgb, which libjpeg-turbo runs there).
//
// Written by hand: no JPEG library is linked (the card's machine has no
// jpeglib.h), so this file parses the markers and decodes the Huffman
// stream itself. Built by the host compiler (g++ -O3) into a shared library
// with a plain C interface and loaded with ctypes (ops/_build.py's
// HostLibrary), on the CPU and on the card's host alike.
//
// What it reads: SOI; APPn and COM (skipped; APP0 "JFIF" and APP14 "Adobe"
// noted for the colour space, as libjpeg's default_decompress_parms does);
// DQT (8- and 16-bit tables); SOF0 and SOF1 at 8 bits; DHT; DRI; one SOS
// that covers every component (interleaved; a single component's scan is
// non-interleaved); RSTn markers in the entropy-coded data, which reset the
// DC predictions. 1 or 3 components, sampling factors 1 or 2.
// What it refuses, with a status and a reason (cfn_entropy_reason):
// progressive (SOF2), arithmetic coding, lossless and hierarchical frames,
// 12-bit samples, 2 or 4 components, other sampling factors, a scan that
// does not cover every component, an RGB colour transform, a missing table,
// a bad Huffman code, entropy data that ends before the window's last MCU,
// and a restart marker out of order. libjpeg warns on the last three and
// fills the rest of the frame with grey; a frame that needs that raises
// here.
//
// What it produces: for each frame, the window's blocks of each component,
// component by component, in raster order over the component's blocks
// inside the window's MCUs, each block 64 int16 coefficients in natural
// (row-major) order, not yet dequantised; and each component's quantisation
// table (natural order, int32). It decodes the MCU rows up to the window's
// last one and stops: rows below are never decoded, as libjpeg's partial
// decode stops with jpeg_abort_decompress. At 8/8 the caller's window holds
// one MCU row more below the crop (and one above, one column each side),
// whose samples libjpeg's fancy upsampling reads as context. Blocks outside
// the window's MCU columns are decoded (the Huffman stream is sequential)
// but not stored.
//
// Threads: no state outside a call; cfn_entropy_decode spreads its frames
// over num_threads threads of its own.

#include <stdint.h>
#include <string.h>

#include <atomic>
#include <thread>
#include <vector>

namespace {

enum Status {
  OK = 0,
  NOT_JPEG = -1,
  BAD_HEADER = -2,
  PROGRESSIVE = -3,
  ARITHMETIC = -4,
  LOSSLESS = -5,
  PRECISION = -6,
  COMPONENTS = -7,
  SAMPLING = -8,
  SCAN = -9,
  MISSING_TABLE = -10,
  BAD_CODE = -11,
  TRUNCATED = -12,
  BAD_RESTART = -13,
  RGB_TRANSFORM = -14,
  LAYOUT = -15,
  BAD_TABLE = -16,
  WINDOW = -17,
};

const char* reason(int status) {
  switch (status) {
    case OK: return "ok";
    case NOT_JPEG: return "not a JPEG (no SOI marker)";
    case BAD_HEADER: return "a marker segment is truncated or malformed";
    case PROGRESSIVE: return "progressive JPEG (SOF2)";
    case ARITHMETIC: return "arithmetic-coded JPEG";
    case LOSSLESS: return "lossless or hierarchical JPEG";
    case PRECISION: return "samples are not 8 bits";
    case COMPONENTS: return "component count is not 1 or 3";
    case SAMPLING: return "a sampling factor is not 1 or 2";
    case SCAN: return "the first scan does not cover every component "
                      "(multi-scan JPEG) or is not a baseline scan";
    case MISSING_TABLE: return "a Huffman or quantisation table is missing";
    case BAD_CODE: return "corrupt entropy-coded data (a bad Huffman code)";
    case TRUNCATED: return "the entropy-coded data ends early";
    case BAD_RESTART: return "a restart marker is missing or out of order";
    case RGB_TRANSFORM: return "RGB colour transform (not YCbCr)";
    case LAYOUT: return "its size or sampling differs from its group's";
    case BAD_TABLE: return "a Huffman table is malformed";
    case WINDOW: return "the MCU window lies outside the frame";
  }
  return "unknown status";
}

// natural order of the zig-zag index k, with 16 extra entries so that a
// corrupt run past 63 lands on 63 (libjpeg's jpeg_natural_order)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int LOOKAHEAD = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[17];    // largest code of each length, -1 if none
  int32_t valoffset[17];  // vals index of a length's code = code + offset
  // code of <= LOOKAHEAD bits at the top of the next LOOKAHEAD bits: its
  // length << 8 | symbol, or 0 where the code is longer
  uint16_t look[1 << LOOKAHEAD];

  bool build(const uint8_t* bits, const uint8_t* v, int nvals) {
    memcpy(vals, v, nvals);
    int code = 0, p = 0;
    uint16_t codes[256];
    uint8_t sizes[256];
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i) {
        codes[p] = static_cast<uint16_t>(code);
        sizes[p] = static_cast<uint8_t>(l);
        ++p;
        ++code;
      }
      if (code >= (1 << l) && bits[l - 1]) return false;
      code <<= 1;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valoffset[l] = p - codes[p];
        p += bits[l - 1];
        maxcode[l] = codes[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    memset(look, 0, sizeof(look));
    for (int i = 0; i < nvals; ++i) {
      int l = sizes[i];
      if (l > LOOKAHEAD) continue;
      int first = codes[i] << (LOOKAHEAD - l);
      for (int j = 0; j < (1 << (LOOKAHEAD - l)); ++j)
        look[first + j] = static_cast<uint16_t>(l << 8 | vals[i]);
    }
    defined = true;
    return true;
  }
};

struct Component {
  int id, h, v, tq, td, ta;
};

struct Header {
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  Component comp[3];
  bool qdefined[4] = {false, false, false, false};
  int32_t qt[4][64];
  Huffman dc[4], ac[4];
  const uint8_t* scan = nullptr;  // first byte of the entropy-coded data
};

int be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

// Parse the markers up to the first scan's data; every check of what this
// decoder takes is made here.
int parse_header(const uint8_t* data, size_t size, Header* hd) {
  const uint8_t* p = data;
  const uint8_t* end = data + size;
  if (size < 4 || p[0] != 0xFF || p[1] != 0xD8) return NOT_JPEG;
  p += 2;
  bool have_sof = false;
  for (;;) {
    // next marker: skip anything up to 0xFF, then the fill bytes
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) return BAD_HEADER;
    const int m = *p++;
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xD9) return have_sof ? SCAN : BAD_HEADER;
    if (end - p < 2) return BAD_HEADER;
    const int len = be16(p);
    if (len < 2 || end - p < len) return BAD_HEADER;
    const uint8_t* seg = p + 2;
    const uint8_t* seg_end = p + len;
    p = seg_end;
    const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                     m != 0xCC;
    if (sof && len >= 7) {  // the frame's size, also of a frame refused
      hd->height = be16(seg + 1);
      hd->width = be16(seg + 3);
    }
    if (m == 0xC0 || m == 0xC1) {
      if (len < 8) return BAD_HEADER;
      if (seg[0] != 8) return PRECISION;
      hd->ncomp = seg[5];
      if (hd->ncomp != 1 && hd->ncomp != 3) return COMPONENTS;
      if (len != 8 + 3 * hd->ncomp) return BAD_HEADER;
      if (hd->width < 1 || hd->height < 1) return BAD_HEADER;
      for (int c = 0; c < hd->ncomp; ++c) {
        const uint8_t* q = seg + 6 + 3 * c;
        Component& cc = hd->comp[c];
        cc.id = q[0];
        cc.h = q[1] >> 4;
        cc.v = q[1] & 15;
        cc.tq = q[2];
        if (cc.h < 1 || cc.h > 2 || cc.v < 1 || cc.v > 2) return SAMPLING;
        if (cc.tq > 3) return BAD_HEADER;
      }
      if (hd->ncomp == 1) {
        // a single component is never interleaved: its blocks are the
        // MCUs whatever factors it declares
        hd->comp[0].h = hd->comp[0].v = 1;
      }
      for (int c = 0; c < hd->ncomp; ++c) {
        if (hd->comp[c].h > hd->max_h) hd->max_h = hd->comp[c].h;
        if (hd->comp[c].v > hd->max_v) hd->max_v = hd->comp[c].v;
      }
      have_sof = true;
    } else if (m == 0xC2 || m == 0xC6) {
      return PROGRESSIVE;
    } else if (m == 0xC3 || m == 0xC5 || m == 0xC7) {
      return LOSSLESS;
    } else if (m >= 0xC9 && m <= 0xCF) {
      return ARITHMETIC;  // SOF9-11, SOF13-15 and DAC
    } else if (m == 0xC4) {
      const uint8_t* q = seg;
      while (q < seg_end) {
        if (seg_end - q < 17) return BAD_HEADER;
        const int tc = q[0] >> 4, th = q[0] & 15;
        if (tc > 1 || th > 3) return BAD_TABLE;
        int nvals = 0;
        for (int i = 0; i < 16; ++i) nvals += q[1 + i];
        if (nvals > 256 || seg_end - q < 17 + nvals) return BAD_TABLE;
        Huffman& t = tc == 0 ? hd->dc[th] : hd->ac[th];
        if (!t.build(q + 1, q + 17, nvals)) return BAD_TABLE;
        q += 17 + nvals;
      }
    } else if (m == 0xDB) {
      const uint8_t* q = seg;
      while (q < seg_end) {
        const int pq = q[0] >> 4, tq = q[0] & 15;
        if (pq > 1 || tq > 3) return BAD_HEADER;
        const int n = pq ? 128 : 64;
        if (seg_end - q < 1 + n) return BAD_HEADER;
        for (int k = 0; k < 64; ++k)
          hd->qt[tq][kNatural[k]] = pq ? be16(q + 1 + 2 * k) : q[1 + k];
        hd->qdefined[tq] = true;
        q += 1 + n;
      }
    } else if (m == 0xDD) {
      if (len != 4) return BAD_HEADER;
      hd->restart = be16(seg);
    } else if (m == 0xE0) {
      if (len >= 7 && memcmp(seg, "JFIF\0", 5) == 0) hd->jfif = true;
    } else if (m == 0xEE) {
      if (len >= 14 && memcmp(seg, "Adobe", 5) == 0) {
        hd->adobe = true;
        hd->adobe_transform = seg[11];
      }
    } else if (m == 0xDA) {
      if (!have_sof) return BAD_HEADER;
      const int ns = seg[0];
      if (len != 6 + 2 * ns) return BAD_HEADER;
      if (ns != hd->ncomp) return SCAN;
      for (int i = 0; i < ns; ++i) {
        const int id = seg[1 + 2 * i], tables = seg[2 + 2 * i];
        if (hd->comp[i].id != id) return SCAN;
        hd->comp[i].td = tables >> 4;
        hd->comp[i].ta = tables & 15;
        if (hd->comp[i].td > 3 || hd->comp[i].ta > 3) return BAD_TABLE;
      }
      const uint8_t* s = seg + 1 + 2 * ns;
      if (s[0] != 0 || s[1] != 63 || s[2] != 0) return SCAN;
      for (int c = 0; c < hd->ncomp; ++c) {
        const Component& cc = hd->comp[c];
        if (!hd->qdefined[cc.tq] || !hd->dc[cc.td].defined ||
            !hd->ac[cc.ta].defined)
          return MISSING_TABLE;
      }
      if (hd->ncomp == 3) {
        // libjpeg's guess of the colour space of three components
        bool rgb = false;
        if (hd->jfif) {
          rgb = false;
        } else if (hd->adobe) {
          rgb = hd->adobe_transform == 0;
        } else {
          rgb = hd->comp[0].id == 'R' && hd->comp[1].id == 'G' &&
                hd->comp[2].id == 'B';
        }
        if (rgb) return RGB_TRANSFORM;
      }
      hd->scan = seg_end;
      return OK;
    } else if (m == 0xDC) {
      return BAD_HEADER;  // DNL: the height comes after the scan
    }
    // any other marker segment is skipped
  }
}

// The entropy-coded data's bits, most significant first, with the stuffed
// zero bytes taken out. At a marker (or the data's end) it appends zero
// bits and counts them in `pad`; a decode that used any of them read past
// the data.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // `n` valid bits at the top
  int n = 0;
  int pad = 0;
  int marker = 0;  // the marker that stopped the data, -1 at its end

  void fill() {
    // whole bytes while none is 0xFF (no stuffing, no marker)
    while (n <= 56 && marker == 0 && p < end && *p != 0xFF) {
      buf |= static_cast<uint64_t>(*p++) << (56 - n);
      n += 8;
    }
    while (n <= 56) {
      int b = 0;
      if (marker == 0) {
        if (p >= end) {
          marker = -1;
        } else {
          b = *p++;
          if (b == 0xFF) {
            while (p < end && *p == 0xFF) ++p;
            if (p >= end) {
              marker = -1;
              b = 0;
            } else if (*p == 0) {
              ++p;
            } else {
              marker = *p++;
              b = 0;
            }
          }
        }
      }
      if (marker != 0) pad += 8;
      buf |= static_cast<uint64_t>(b) << (56 - n);
      n += 8;
    }
  }
  uint32_t peek(int k) const { return static_cast<uint32_t>(buf >> (64 - k)); }
  void skip(int k) {
    buf <<= k;
    n -= k;
  }
  int get(int k) {
    const int v = static_cast<int>(peek(k));
    skip(k);
    return v;
  }
  bool overran() const { return n < pad; }
};

// One Huffman symbol; -1 for a code no table entry has. The caller has
// filled at least 16 bits.
inline int decode_symbol(Bits& b, const Huffman& t) {
  const uint16_t e = t.look[b.peek(LOOKAHEAD)];
  if (e) {
    b.skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = LOOKAHEAD + 1; l <= 16; ++l) {
    const int32_t code = static_cast<int32_t>(b.peek(l));
    if (code <= t.maxcode[l]) {
      b.skip(l);
      return t.vals[code + t.valoffset[l]];
    }
  }
  return -1;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (static_cast<int>(~0u << s)) + 1 : v;
}

// One block's coefficients; into `out` (zeroed by the caller) when it is
// not null. Returns a status.
inline int decode_block(Bits& b, const Huffman& dc, const Huffman& ac,
                        int* pred, int16_t* out) {
  if (b.n < 32) b.fill();
  int s = decode_symbol(b, dc);
  if (s < 0 || s > 16) return BAD_CODE;
  int diff = 0;
  if (s) {
    if (b.n < 32) b.fill();
    diff = extend(b.get(s), s);
  }
  *pred += diff;
  if (out) out[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64; ++k) {
    if (b.n < 32) b.fill();
    const int rs = decode_symbol(b, ac);
    if (rs < 0) return BAD_CODE;
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (out)
        out[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
      else
        b.skip(s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return OK;
}

struct Window {
  int mc0, mc1, mr0, mr1;  // MCU columns [mc0, mc1), rows [mr0, mr1)
};

int mcu_cols(const Header& hd) {
  return (hd.width + 8 * hd.max_h - 1) / (8 * hd.max_h);
}
int mcu_rows(const Header& hd) {
  return (hd.height + 8 * hd.max_v - 1) / (8 * hd.max_v);
}

// Decode one frame's window into `coefs` (its blocks, as the file's head
// says) and `qt` (ncomp x 64).
int decode_frame(const uint8_t* data, size_t size, const int32_t* layout,
                 const Window& win, int16_t* coefs, int32_t* qt) {
  Header hd;
  int st = parse_header(data, size, &hd);
  if (st != OK) return st;
  if (hd.width != layout[0] || hd.height != layout[1] ||
      hd.ncomp != layout[2])
    return LAYOUT;
  for (int c = 0; c < hd.ncomp; ++c)
    if (hd.comp[c].h != layout[3 + 2 * c] || hd.comp[c].v != layout[4 + 2 * c])
      return LAYOUT;
  const int cols = mcu_cols(hd), rows = mcu_rows(hd);
  if (win.mc0 < 0 || win.mc1 > cols || win.mc0 >= win.mc1 || win.mr0 < 0 ||
      win.mr1 > rows || win.mr0 >= win.mr1)
    return WINDOW;
  const int wcols = win.mc1 - win.mc0, wrows = win.mr1 - win.mr0;
  // each component's first block in the frame's output, and its row length
  size_t base[3], row_len[3];
  size_t off = 0;
  for (int c = 0; c < hd.ncomp; ++c) {
    base[c] = off;
    row_len[c] = static_cast<size_t>(wcols) * hd.comp[c].h;
    off += row_len[c] * wrows * hd.comp[c].v;
  }
  memset(coefs, 0, off * 64 * sizeof(int16_t));
  for (int c = 0; c < hd.ncomp; ++c)
    memcpy(qt + 64 * c, hd.qt[hd.comp[c].tq], 64 * sizeof(int32_t));

  Bits b;
  b.p = hd.scan;
  b.end = data + size;
  int pred[3] = {0, 0, 0};
  int todo = hd.restart, next_rst = 0;
  for (int my = 0; my < win.mr1; ++my) {
    const bool row_in = my >= win.mr0;
    for (int mx = 0; mx < cols; ++mx) {
      if (hd.restart) {
        if (todo == 0) {
          if (b.overran()) return TRUNCATED;
          // the rest of the byte is padding; find the marker
          b.buf = 0;
          b.n = 0;
          b.pad = 0;
          if (b.marker == 0) {
            for (;;) {
              while (b.p < b.end && *b.p != 0xFF) ++b.p;
              while (b.p < b.end && *b.p == 0xFF) ++b.p;
              if (b.p >= b.end) return BAD_RESTART;
              if (*b.p != 0) {
                b.marker = *b.p++;
                break;
              }
              ++b.p;
            }
          }
          if (b.marker != 0xD0 + next_rst) return BAD_RESTART;
          b.marker = 0;
          next_rst = (next_rst + 1) & 7;
          pred[0] = pred[1] = pred[2] = 0;
          todo = hd.restart;
        }
        --todo;
      }
      const bool in = row_in && mx >= win.mc0 && mx < win.mc1;
      for (int c = 0; c < hd.ncomp; ++c) {
        const Component& cc = hd.comp[c];
        for (int yy = 0; yy < cc.v; ++yy) {
          for (int xx = 0; xx < cc.h; ++xx) {
            int16_t* out = nullptr;
            if (in) {
              const size_t by = static_cast<size_t>(my - win.mr0) * cc.v + yy;
              const size_t bx = static_cast<size_t>(mx - win.mc0) * cc.h + xx;
              out = coefs + (base[c] + by * row_len[c] + bx) * 64;
            }
            st = decode_block(b, hd.dc[cc.td], hd.ac[cc.ta], &pred[c], out);
            if (st != OK) return st;
          }
        }
      }
    }
  }
  return b.overran() ? TRUNCATED : OK;
}

}  // namespace

extern "C" {

// The head of one JPEG: info[0..2] = width, height, components, then each
// component's (h, v) sampling factors (a single component's are 1, 1).
// Returns 0, or a status (cfn_entropy_reason); then only the width and
// height are set, where a frame header was read (else 0).
int cfn_jpeg_probe(const uint8_t* data, size_t size, int32_t* info) {
  Header hd;
  const int st = parse_header(data, size, &hd);
  info[0] = hd.width;
  info[1] = hd.height;
  if (st != OK) return st;
  info[2] = hd.ncomp;
  for (int c = 0; c < 3; ++c) {
    info[3 + 2 * c] = c < hd.ncomp ? hd.comp[c].h : 0;
    info[4 + 2 * c] = c < hd.ncomp ? hd.comp[c].v : 0;
  }
  return OK;
}

// The reason of a status, copied into buf (len bytes, NUL-terminated).
int cfn_entropy_reason(int status, char* buf, int len) {
  const char* r = reason(status);
  int n = static_cast<int>(strlen(r));
  if (n > len - 1) n = len - 1;
  memcpy(buf, r, n);
  buf[n] = 0;
  return 0;
}

// Decode n frames of one layout (layout[0..8] as cfn_jpeg_probe's info) over the MCU window win = (mc0, mc1, mr0, mr1): frame i's blocks
// at coefs + i * frame_blocks * 64, its tables at qt + i * ncomp * 64.
// status[i] is frame i's status; returns the number of frames that failed.
int cfn_entropy_decode(const uint8_t* const* datas, const size_t* sizes,
                       int n, const int32_t* layout, const int32_t* win,
                       int64_t frame_blocks, int16_t* coefs, int32_t* qt,
                       int32_t* status, int num_threads) {
  const Window w{win[0], win[1], win[2], win[3]};
  const int ncomp = layout[2];
  std::atomic<int> next{0};
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = decode_frame(datas[i], sizes[i], layout, w,
                               coefs + static_cast<size_t>(i) * frame_blocks * 64,
                               qt + static_cast<size_t>(i) * ncomp * 64);
    }
  };
  int threads = num_threads < n ? num_threads : n;
  if (threads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  int failures = 0;
  for (int i = 0; i < n; ++i) failures += status[i] != OK;
  return failures;
}

}  // extern "C"
