// A JPEG's entropy decode on the host: the quantised DCT coefficients of a
// window of MCUs, for the decode of ops/scaled_decode.py (the JAX package's
// native path at every scale: native/cfn_data.cpp's decode_crop_scaled and
// decode_rgb, which libjpeg-turbo 2.1 runs there).
//
// Written by hand: no JPEG library is linked (the card's machine has no
// jpeglib.h), so this file parses the markers and decodes the Huffman and
// arithmetic streams itself. Built by the host compiler (g++ -O3) into a
// shared library with a plain C interface and loaded with ctypes
// (ops/_build.py's HostLibrary), on the CPU and on the card's host alike.
//
// What it reads: the sequential and progressive DCT processes of 8-bit
// samples, Huffman- or arithmetic-coded (SOF0, SOF1, SOF2, SOF9, SOF10), in
// one scan or many; 1 or 3 components, sampling factors 1 or 2. SOI; APPn
// and COM (skipped; APP0 "JFIF" and APP14 "Adobe" noted for the colour
// space, as libjpeg's default_decompress_parms does); DQT (8- and 16-bit
// tables), DHT, DRI and DAC, before the first scan and between scans; SOS
// of any subset of the components; RSTn markers. Huffman tables 0 and 1
// that no DHT defines before the first scan are the standard ones (T.81
// Annex K.3), as libjpeg-turbo's std_huff_tables sets them for Motion-JPEG
// frames.
//
// As libjpeg-turbo 2.1 (the JAX library's) handles broken data, so this
// decoder does, bit for bit:
//  * data that ends early (jpeg_mem_src inserts an EOI): a Huffman scan's
//    MCU in which the bits run out is decoded on zero bits and its later
//    MCUs are left as they are (zero in a frame's only scan: grey); an
//    arithmetic scan reads zero bytes to its end; scans that never arrive
//    leave their coefficients as they are;
//  * a bad Huffman code: 17 bits taken and symbol 0 (jpeg_huff_decode);
//    an arithmetic code past a block's end or a magnitude's range: the rest
//    of the restart interval left as it is;
//  * restart markers missing or out of order: jpeg_resync_to_restart's
//    choice among discarding the marker, scanning on and decoding an empty
//    segment;
//  * a marker segment cut short: read on the inserted EOIs' bytes.
// A full decode (`finish`, the JAX library's exact mode and raw frames)
// reads on to the frame's end as jpeg_finish_decompress does, and fails
// where it fails (a second scan after a frame of one sequential scan, a
// broken table); a partial decode stops after the window.
// What it refuses, with a status and a reason (cfn_entropy_reason): frames
// the JAX library's libjpeg refuses too (lossless and hierarchical
// processes, 12-bit samples, 2 or 4 components, sampling factors it cannot
// take, bad progression parameters, a missing table, malformed markers);
// two that it decodes and this decoder leaves to another (an RGB colour
// transform, sampling factors 3 or 4); and a progressive frame whose
// coefficients are incomplete at the end of its data, which libjpeg
// smooths (jdcoefct.c's block smoothing) and this decoder does not.
//
// What it produces: for each frame, the window's blocks of each component,
// component by component, in raster order over the component's blocks
// inside the window's MCUs, each block 64 int16 coefficients in natural
// (row-major) order, not yet dequantised; and each component's quantisation
// table (natural order, int32), latched at the component's first scan as
// libjpeg's latch_quant_tables does. It decodes the MCU rows up to the
// window's last one and no further: rows below are never decoded, as
// libjpeg's partial decode stops with jpeg_abort_decompress. At 8/8 the
// caller's window holds one MCU row more below the crop (and one above,
// one column each side), whose samples libjpeg's fancy upsampling reads as
// context.
//  * A frame of one sequential Huffman scan over every component (the
//    common case, and the fast path) is decoded straight into the output;
//    blocks outside the window's MCU columns are decoded (the stream is
//    sequential) but not stored.
//  * Any other frame is decoded into a coefficient buffer holding, for
//    each component, every block column of the block rows up to the
//    window's last (a refinement scan reads each block's history), scan by
//    scan: a scan is decoded up to the window's last row, its rest skipped
//    to the next marker. The window's blocks are copied out at the end.
//
// Threads: no state outside a call; cfn_entropy_decode spreads its frames
// over num_threads threads of its own.

#include <stdint.h>
#include <string.h>

#include <atomic>
#include <new>
#include <thread>
#include <vector>

namespace {

enum Status {
  OK = 0,
  NOT_JPEG = -1,
  BAD_HEADER = -2,
  BAD_PROGRESSION = -3,
  SMOOTHING = -4,
  LOSSLESS = -5,
  PRECISION = -6,
  COMPONENTS = -7,
  SAMPLING = -8,
  SCAN = -9,
  MISSING_TABLE = -10,
  BAD_SAMPLING = -11,
  NO_MEMORY = -13,
  RGB_TRANSFORM = -14,
  LAYOUT = -15,
  BAD_TABLE = -16,
  WINDOW = -17,
  EXTRA_SCAN = -18,
};

const char* reason(int status) {
  switch (status) {
    case OK: return "ok";
    case NOT_JPEG: return "not a JPEG (no SOI marker)";
    case BAD_HEADER: return "a marker segment is truncated or malformed";
    case BAD_PROGRESSION: return "a progressive scan's parameters are invalid";
    case SMOOTHING:
      return "a progressive frame whose coefficients are incomplete where "
             "its data ends (cut short or missing scans): libjpeg smooths "
             "its blocks, which this decoder does not reproduce";
    case LOSSLESS: return "lossless or hierarchical JPEG";
    case PRECISION: return "samples are not 8 bits";
    case COMPONENTS: return "component count is not 1 or 3";
    case SAMPLING: return "a sampling factor is 3 or 4";
    case SCAN: return "a scan's header is malformed, or the frame has no scan";
    case MISSING_TABLE: return "a Huffman or quantisation table is missing";
    case BAD_SAMPLING:
      return "sampling factors libjpeg refuses (outside 1-4, ratios that "
             "are not whole, or over 10 blocks an MCU)";
    case NO_MEMORY: return "its coefficient buffer could not be allocated";
    case RGB_TRANSFORM: return "RGB colour transform (not YCbCr)";
    case LAYOUT: return "its size or sampling differs from its group's";
    case BAD_TABLE: return "a Huffman or arithmetic table is malformed";
    case WINDOW: return "the MCU window lies outside the frame";
    case EXTRA_SCAN:
      return "a second scan after a frame of one interleaved sequential scan "
             "(libjpeg expects its end)";
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

// ---- the standard Huffman tables (T.81 Annex K.3, libjpeg's jstdhuff.c) ----

const uint8_t kBitsDcLuma[16] = {
    0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChroma[16] = {
    0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLuma[16] = {
    0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValsAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChroma[16] = {
    0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValsAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---- the arithmetic decoder's probability estimates (T.81 Table D.2) ------

// libjpeg's jpeg_aritab (jaricom.c): Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed estimate of
// 0.5 (T.851) for signs and DC refinements
#define V(qe, lps, mps, sw) \
  ((static_cast<int32_t>(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V
constexpr int kFixedBin = 113;

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
  int id, h, v, tq;
};

// One scan's header: its components (frame indices, in the scan's order),
// their tables and the spectral selection and successive approximation
struct Scan {
  int ns = 0;
  int ci[4], td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Header {
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
  bool progressive = false, arithmetic = false;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  Component comp[3];
  bool qdefined[4] = {false, false, false, false};
  int32_t qt[4][64];
  Huffman dc[4], ac[4];
  // arithmetic conditioning (DAC), libjpeg's defaults L 0, U 1, K 5
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  Scan first;                     // the first scan's header
  const uint8_t* scan = nullptr;  // first byte of its entropy-coded data

  Header() {
    memset(dc_l, 0, sizeof(dc_l));
    memset(dc_u, 1, sizeof(dc_u));
    memset(ac_k, 5, sizeof(ac_k));
  }
};

int be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

// Markers libjpeg's read_markers stops on with an error where a table or a
// scan may stand: DHP, EXP, JPGn and the reserved ones
bool unknown_marker(int m) {
  return m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD);
}

// A marker segment as libjpeg reads it: its length (with its two bytes)
// and the bytes after them; where the data ends inside it, the EOIs that
// jpeg_mem_src inserts there (FF D9 FF D9 ...) stand in for the rest, and
// the data is spent.
struct Segment {
  int len = 0;
  const uint8_t* seg = nullptr;
  const uint8_t* seg_end = nullptr;
  bool cut = false;
  std::vector<uint8_t> padded;
};

void read_segment(const uint8_t*& p, const uint8_t* end, Segment* s) {
  auto at = [&](size_t i) -> int {
    return p + i < end ? p[i] : ((p + i - end) % 2 ? 0xD9 : 0xFF);
  };
  s->len = at(0) << 8 | at(1);
  s->cut = end - p < 2 || end - p < s->len;
  if (!s->cut) {
    s->seg = p + 2;
    s->seg_end = p + s->len;
    p = s->seg_end;
    return;
  }
  s->padded.resize(s->len > 2 ? s->len - 2 : 0);
  for (size_t i = 0; i < s->padded.size(); ++i) s->padded[i] = at(2 + i);
  s->seg = s->padded.data();
  s->seg_end = s->seg + s->padded.size();
  p = end;
}

// The next marker from p (skipping anything up to 0xFF, the fill bytes and
// stuffed zeros, as libjpeg's next_marker does); at the data's end an EOI
// (jpeg_mem_src inserts one there).
int next_marker(const uint8_t*& p, const uint8_t* end) {
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) return 0xD9;
    const int m = *p++;
    if (m != 0) return m;
  }
}

// A table-defining segment (DHT, DQT, DRI, DAC, APP0, APP14), before the
// first scan or between scans; any other marker segment is skipped.
int table_segment(int m, const uint8_t* seg, const uint8_t* seg_end,
                  Header* hd) {
  const int len = static_cast<int>(seg_end - seg) + 2;
  if (m == 0xC4) {
    const uint8_t* q = seg;
    while (q < seg_end) {
      if (seg_end - q < 17) return BAD_HEADER;
      const int tc = q[0] >> 4, th = q[0] & 15;
      if (tc > 1 || th > 3) return BAD_TABLE;
      int nvals = 0;
      for (int i = 0; i < 16; ++i) nvals += q[1 + i];
      if (nvals > 256 || seg_end - q < 17 + nvals) return BAD_TABLE;
      if (tc == 0)  // libjpeg takes DC categories up to 15 only
        for (int i = 0; i < nvals; ++i)
          if (q[17 + i] > 15) return BAD_TABLE;
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
  } else if (m == 0xCC) {
    if ((len - 2) % 2) return BAD_HEADER;
    for (const uint8_t* q = seg; q < seg_end; q += 2) {
      const int index = q[0], val = q[1];
      if (index >= 32) return BAD_TABLE;
      if (index >= 16) {
        hd->ac_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        hd->dc_l[index] = static_cast<uint8_t>(val & 15);
        hd->dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (hd->dc_l[index] > hd->dc_u[index]) return BAD_TABLE;
      }
    }
  } else if (m == 0xE0) {
    if (len >= 7 && memcmp(seg, "JFIF\0", 5) == 0) hd->jfif = true;
  } else if (m == 0xEE) {
    if (len >= 14 && memcmp(seg, "Adobe", 5) == 0) {
      hd->adobe = true;
      hd->adobe_transform = seg[11];
    }
  }
  return OK;
}

// One SOS segment: its components and parameters, with libjpeg's checks
// (get_sos: the components in the frame header's order; for progressive
// frames start_pass_phuff_decoder's and jdarith.c's; MCUs of at most 10
// blocks, per_scan_setup).
int parse_sos(const uint8_t* seg, int len, const Header& hd, Scan* s) {
  if (len < 8) return SCAN;
  const int ns = seg[0];
  if (ns < 1 || ns > 4 || len != 6 + 2 * ns) return SCAN;
  s->ns = ns;
  int blocks = 0;
  for (int i = 0; i < ns; ++i) {
    const int id = seg[1 + 2 * i], tables = seg[2 + 2 * i];
    int c = i ? s->ci[i - 1] + 1 : 0;
    while (c < hd.ncomp && hd.comp[c].id != id) ++c;
    if (c == hd.ncomp) return SCAN;
    s->ci[i] = c;
    s->td[i] = tables >> 4;
    s->ta[i] = tables & 15;
    if (!hd.arithmetic && (s->td[i] > 3 || s->ta[i] > 3)) return BAD_TABLE;
    blocks += hd.comp[c].h * hd.comp[c].v;
  }
  if (ns > 1 && blocks > 10) return BAD_SAMPLING;
  const uint8_t* q = seg + 1 + 2 * ns;
  s->ss = q[0];
  s->se = q[1];
  s->ah = q[2] >> 4;
  s->al = q[2] & 15;
  if (hd.progressive) {
    bool bad = false;
    if (s->ss == 0) {
      bad = s->se != 0;
    } else {
      bad = s->ss > s->se || s->se > 63 || ns != 1;
    }
    if (s->ah != 0 && s->al != s->ah - 1) bad = true;
    if (s->al > 13) bad = true;
    if (bad) return BAD_PROGRESSION;
  }
  return OK;
}

// The Huffman tables a scan reads, and whether each is defined
bool scan_tables_defined(const Header& hd, const Scan& s) {
  if (hd.arithmetic) return true;
  for (int i = 0; i < s.ns; ++i) {
    const bool dc = !hd.progressive || (s.ss == 0 && s.ah == 0);
    const bool ac = !hd.progressive || s.ss != 0;
    if (dc && !hd.dc[s.td[i]].defined) return false;
    if (ac && !hd.ac[s.ta[i]].defined) return false;
  }
  return true;
}

// Parse the markers up to the first scan's data; every check of the frame
// and its first scan is made here.
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
    if (unknown_marker(m)) return BAD_HEADER;
    Segment sg;
    read_segment(p, end, &sg);
    const int len = sg.len;
    if (len < 2) return BAD_HEADER;
    const uint8_t* seg = sg.seg;
    const uint8_t* seg_end = sg.seg_end;
    const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC;
    if (sof && len >= 7) {  // the frame's size, also of a frame refused
      hd->height = be16(seg + 1);
      hd->width = be16(seg + 3);
    }
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
      if (have_sof) return BAD_HEADER;
      if (len < 8) return BAD_HEADER;
      if (seg[0] != 8) return PRECISION;
      hd->progressive = m == 0xC2 || m == 0xCA;
      hd->arithmetic = m >= 0xC9;
      hd->ncomp = seg[5];
      if (hd->ncomp != 1 && hd->ncomp != 3) return COMPONENTS;
      if (len != 8 + 3 * hd->ncomp) return BAD_HEADER;
      if (hd->width < 1 || hd->height < 1) return BAD_HEADER;
      bool big = false;
      for (int c = 0; c < hd->ncomp; ++c) {
        const uint8_t* q = seg + 6 + 3 * c;
        Component& cc = hd->comp[c];
        cc.id = q[0];
        cc.h = q[1] >> 4;
        cc.v = q[1] & 15;
        cc.tq = q[2];
        if (cc.h < 1 || cc.h > 4 || cc.v < 1 || cc.v > 4) return BAD_SAMPLING;
        if (cc.tq > 3) return BAD_HEADER;
        big = big || cc.h > 2 || cc.v > 2;
      }
      if (hd->ncomp == 1) {
        // a single component is never interleaved: its blocks are the
        // MCUs whatever factors it declares
        hd->comp[0].h = hd->comp[0].v = 1;
        big = false;
      }
      for (int c = 0; c < hd->ncomp; ++c) {
        if (hd->comp[c].h > hd->max_h) hd->max_h = hd->comp[c].h;
        if (hd->comp[c].v > hd->max_v) hd->max_v = hd->comp[c].v;
      }
      // libjpeg upsamples by whole ratios only (jdsample.c)
      for (int c = 0; c < hd->ncomp; ++c)
        if (hd->max_h % hd->comp[c].h || hd->max_v % hd->comp[c].v)
          return BAD_SAMPLING;
      if (big) return SAMPLING;
      have_sof = true;
    } else if (sof) {
      return LOSSLESS;  // SOF3, SOF5-7, JPG, SOF11, SOF13-15
    } else if (m == 0xDA) {
      if (!have_sof) return BAD_HEADER;
      int st = parse_sos(seg, len, *hd, &hd->first);
      if (st != OK) return st;
      if (!hd->arithmetic) {
        // Huffman tables 0 and 1 that are still undefined are the standard
        // ones (libjpeg-turbo's std_huff_tables, at jpeg_start_decompress)
        if (!hd->dc[0].defined) hd->dc[0].build(kBitsDcLuma, kValsDc, 12);
        if (!hd->dc[1].defined) hd->dc[1].build(kBitsDcChroma, kValsDc, 12);
        if (!hd->ac[0].defined) hd->ac[0].build(kBitsAcLuma, kValsAcLuma, 162);
        if (!hd->ac[1].defined)
          hd->ac[1].build(kBitsAcChroma, kValsAcChroma, 162);
      }
      if (!scan_tables_defined(*hd, hd->first)) return MISSING_TABLE;
      for (int i = 0; i < hd->first.ns; ++i)
        if (!hd->qdefined[hd->comp[hd->first.ci[i]].tq]) return MISSING_TABLE;
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
      hd->scan = sg.cut ? end : seg_end;
      return OK;
    } else if (m == 0xDC) {
      return BAD_HEADER;  // DNL: the height comes after the scan
    } else {
      int st = table_segment(m, seg, seg_end, hd);
      if (st != OK) return st;
    }
  }
}

// The entropy-coded data's bytes: the position and the marker that stopped
// the data (0 while none has; at the data's end an EOI, as jpeg_mem_src
// inserts one).
struct Src {
  const uint8_t* p;
  const uint8_t* end;
  int marker = 0;
};

// libjpeg's read_restart_marker with jpeg_resync_to_restart: the expected
// RSTn is taken; otherwise a marker below SOF0 or a restart two or fewer
// behind is scanned past, a marker that is no restart or a restart one or
// two ahead is left unread (its segment is then empty), and any other
// restart is taken.
void read_restart_marker(Src& s, int& next_rst) {
  if (s.marker == 0) s.marker = next_marker(s.p, s.end);
  if (s.marker == 0xD0 + next_rst) {
    s.marker = 0;
  } else {
    for (;;) {
      const int m = s.marker;
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((next_rst + 1) & 7) ||
                 m == 0xD0 + ((next_rst + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((next_rst - 1) & 7) ||
                 m == 0xD0 + ((next_rst - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        s.marker = 0;
        break;
      }
      if (action == 3) break;
      s.marker = next_marker(s.p, s.end);
    }
  }
  next_rst = (next_rst + 1) & 7;
}

// The markers after a scan, up to the next scan or the end, as libjpeg's
// read_markers takes them: tables are defined, APPn, COM and DNL skipped
// (one cut short ends the data, as libjpeg skips past its end), RSTn
// passed over, a segment cut short read on its inserted EOIs;
// 1 with the next scan's header in `next`, 0 at the end (EOI or the data's
// end), or a status.
int read_markers(Src& src, Header& hd, Scan* next) {
  int m = src.marker ? src.marker : next_marker(src.p, src.end);
  src.marker = 0;
  for (;;) {
    if (m == 0xD9) return 0;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
      m = next_marker(src.p, src.end);
      continue;
    }
    const bool skipped =
        m == 0xFE || (m >= 0xE0 && m <= 0xEF) || m == 0xDC;
    Segment sg;
    read_segment(src.p, src.end, &sg);
    if (sg.cut && skipped) return 0;  // skipped past the data's end
    const int len = sg.len;
    if (len < 2) return BAD_HEADER;
    const uint8_t* seg = sg.seg;
    const uint8_t* seg_end = sg.seg_end;
    if (m == 0xDA) {
      const int st = parse_sos(seg, len, hd, next);
      return st == OK ? 1 : st;
    }
    if ((m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) || m == 0xD8 ||
        unknown_marker(m))
      return BAD_HEADER;  // a second frame, or a marker libjpeg refuses
    if (m != 0xDC) {
      const int st = table_segment(m, seg, seg_end, &hd);
      if (st != OK) return st;
    }
    m = next_marker(src.p, src.end);
  }
}

// The entropy-coded data's bits, most significant first, with the stuffed
// zero bytes taken out. At a marker (or the data's end) it appends zero
// bits and counts them in `pad`; a decode that used any of them read past
// the data.
struct Bits {
  Src s;
  uint64_t buf = 0;  // `n` valid bits at the top
  int n = 0;
  int pad = 0;

  void fill() {
    // whole bytes while none is 0xFF (no stuffing, no marker)
    while (n <= 56 && s.marker == 0 && s.p < s.end && *s.p != 0xFF) {
      buf |= static_cast<uint64_t>(*s.p++) << (56 - n);
      n += 8;
    }
    while (n <= 56) {
      int b = 0;
      if (s.marker == 0) {
        if (s.p >= s.end) {
          s.marker = 0xD9;
        } else {
          b = *s.p++;
          if (b == 0xFF) {
            while (s.p < s.end && *s.p == 0xFF) ++s.p;
            if (s.p >= s.end) {
              s.marker = 0xD9;
              b = 0;
            } else if (*s.p == 0) {
              ++s.p;
            } else {
              s.marker = *s.p++;
              b = 0;
            }
          }
        }
      }
      if (s.marker != 0) pad += 8;
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
  int bit() {
    if (n < 1) fill();
    return get(1);
  }
  bool overran() const { return n < pad; }

  // libjpeg's process_restart: the rest of the bit buffer dropped, the
  // restart marker read; returns whether the data goes on (a marker left
  // unread makes the next segment empty)
  bool restart(int& next_rst) {
    buf = 0;
    n = 0;
    pad = 0;
    read_restart_marker(s, next_rst);
    return s.marker == 0;
  }
};

// One Huffman symbol; a code no table entry has takes 17 bits and gives 0,
// as libjpeg's jpeg_huff_decode does. The caller has filled at least 17
// bits.
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
  b.skip(17);
  return 0;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (static_cast<int>(~0u << s)) + 1 : v;
}

inline int16_t shifted(int v, int al) {
  return static_cast<int16_t>(static_cast<unsigned>(v) << al);
}

// One sequential block's coefficients; into `out` (zero) when it is not
// null.
inline void decode_block(Bits& b, const Huffman& dc, const Huffman& ac,
                         int* pred, int16_t* out) {
  if (b.n < 32) b.fill();
  int s = decode_symbol(b, dc);
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
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (b.n < 32) b.fill();
      if (out)
        out[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
      else
        b.skip(s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// ---- progressive Huffman blocks (T.81 Annex G, libjpeg's jdphuff.c) --------

inline void dc_first(Bits& b, const Huffman& dc, int* pred, int al,
                     int16_t* blk) {
  if (b.n < 32) b.fill();
  const int s = decode_symbol(b, dc);
  int diff = 0;
  if (s) {
    if (b.n < 32) b.fill();
    diff = extend(b.get(s), s);
  }
  *pred += diff;
  blk[0] = shifted(*pred, al);
}

inline void ac_first(Bits& b, const Huffman& ac, int ss, int se, int al,
                     int* eobrun, int16_t* blk) {
  if (*eobrun > 0) {
    --*eobrun;
    return;
  }
  for (int k = ss; k <= se; ++k) {
    if (b.n < 32) b.fill();
    const int rs = decode_symbol(b, ac);
    int r = rs >> 4;
    const int s = rs & 15;
    if (s) {
      k += r;
      if (b.n < 32) b.fill();
      blk[kNatural[k]] = shifted(extend(b.get(s), s), al);
    } else if (r == 15) {
      k += 15;
    } else {
      *eobrun = 1 << r;
      if (r) {
        if (b.n < 32) b.fill();
        *eobrun += b.get(r);
      }
      --*eobrun;
      break;
    }
  }
}

// libjpeg's decode_mcu_AC_refine: a correction bit for each coefficient
// already nonzero, newly nonzero ones of magnitude 1 << al
inline void ac_refine(Bits& b, const Huffman& ac, int ss, int se, int al,
                      int* eobrun, int16_t* blk) {
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  int k = ss;
  if (*eobrun == 0) {
    for (; k <= se; ++k) {
      if (b.n < 32) b.fill();
      const int rs = decode_symbol(b, ac);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        // a new coefficient's size is always 1 (libjpeg warns otherwise)
        s = b.bit() ? p1 : m1;
      } else if (r != 15) {
        *eobrun = 1 << r;
        if (r) {
          if (b.n < 32) b.fill();
          *eobrun += b.get(r);
        }
        break;
      }
      do {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          if (b.bit() && (*c & p1) == 0)
            *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (*eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t* c = blk + kNatural[k];
      if (*c != 0 && b.bit() && (*c & p1) == 0)
        *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
    }
    --*eobrun;
  }
}

// ---- the arithmetic decoder (T.81 Annex D and F, libjpeg's jdarith.c) ------

struct Arith {
  Src s;
  int64_t c = 0, a = 0;
  int ct = -16;  // -1: a bad code, the rest of the interval left as it is
  uint8_t fixed_bin = kFixedBin;

  // the next byte of the data, 0 from a marker on (libjpeg's convention)
  int byte() {
    if (s.marker) return 0;
    if (s.p >= s.end) {
      s.marker = 0xD9;
      return 0;
    }
    int d = *s.p++;
    if (d != 0xFF) return d;
    do {
      if (s.p >= s.end) {
        s.marker = 0xD9;
        return 0;
      }
      d = *s.p++;
    } while (d == 0xFF);
    if (d == 0) return 0xFF;
    s.marker = d;
    return 0;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct ArithStats {
  uint8_t dc[16][64];
  uint8_t ac[16][256];
  int last_dc[4], dc_context[4];
};

// A DC difference (Figures F.19-F.24); false on a magnitude past 15 bits
inline bool arith_dc(Arith& e, ArithStats& t, const Header& hd, int tbl,
                     int ci) {
  uint8_t* st = t.dc[tbl] + t.dc_context[ci];
  if (e.decode(st) == 0) {
    t.dc_context[ci] = 0;
    return true;
  }
  const int sign = e.decode(st + 1);
  st += 2 + sign;
  int m = e.decode(st);
  if (m != 0) {
    st = t.dc[tbl] + 20;
    while (e.decode(st)) {
      if ((m <<= 1) == 0x8000) return false;
      ++st;
    }
  }
  if (m < static_cast<int>((1L << hd.dc_l[tbl]) >> 1))
    t.dc_context[ci] = 0;
  else if (m > static_cast<int>((1L << hd.dc_u[tbl]) >> 1))
    t.dc_context[ci] = 12 + sign * 4;
  else
    t.dc_context[ci] = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (e.decode(st)) v |= m;
  v += 1;
  if (sign) v = -v;
  t.last_dc[ci] = (t.last_dc[ci] + v) & 0xffff;
  return true;
}

// AC coefficients ss..se (Figure F.20); false on a run past se or a
// magnitude past 15 bits
inline bool arith_ac(Arith& e, ArithStats& t, const Header& hd, int tbl,
                     int ss, int se, int al, int16_t* blk) {
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = t.ac[tbl] + 3 * (k - 1);
    if (e.decode(st)) break;  // EOB
    while (e.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) return false;
    }
    const int sign = e.decode(&e.fixed_bin);
    st += 2;
    int m = e.decode(st);
    if (m != 0) {
      if (e.decode(st)) {
        m <<= 1;
        st = t.ac[tbl] + (k <= hd.ac_k[tbl] ? 189 : 217);
        while (e.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          ++st;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (e.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = shifted(v, al);
  }
  return true;
}

// libjpeg's decode_mcu_AC_refine (arithmetic); false on a run past se
inline bool arith_ac_refine(Arith& e, ArithStats& t, int tbl, int ss, int se,
                            int al, int16_t* blk) {
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  int kex = se;
  for (; kex > 0; --kex)
    if (blk[kNatural[kex]]) break;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = t.ac[tbl] + 3 * (k - 1);
    if (k > kex && e.decode(st)) break;  // EOB
    for (;;) {
      int16_t* c = blk + kNatural[k];
      if (*c) {
        if (e.decode(st + 2))
          *c = static_cast<int16_t>(*c < 0 ? *c + m1 : *c + p1);
        break;
      }
      if (e.decode(st + 1)) {
        *c = static_cast<int16_t>(e.decode(&e.fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) return false;
    }
  }
  return true;
}

// ---- the frame ------------------------------------------------------------

struct Window {
  int mc0, mc1, mr0, mr1;  // MCU columns [mc0, mc1), rows [mr0, mr1)
};

int mcu_cols(const Header& hd) {
  return (hd.width + 8 * hd.max_h - 1) / (8 * hd.max_h);
}
int mcu_rows(const Header& hd) {
  return (hd.height + 8 * hd.max_v - 1) / (8 * hd.max_v);
}

// The output's layout: each component's first block in the frame's output
// and its row length, in blocks
struct OutLayout {
  size_t base[3], row_len[3], blocks;
};

OutLayout out_layout(const Header& hd, const Window& win) {
  OutLayout o;
  const int wcols = win.mc1 - win.mc0, wrows = win.mr1 - win.mr0;
  size_t off = 0;
  for (int c = 0; c < hd.ncomp; ++c) {
    o.base[c] = off;
    o.row_len[c] = static_cast<size_t>(wcols) * hd.comp[c].h;
    off += o.row_len[c] * wrows * hd.comp[c].v;
  }
  o.blocks = off;
  return o;
}

// A frame of one sequential Huffman scan over every component, decoded
// straight into the output (the fast path: decode_buffered reads these
// frames too, equal block for block but slower, as it zeroes and fills
// every block column and then copies the window; entropy_paths.py times
// both); with `finish`, the markers after the scan read to the end, where
// a second scan is an error.
int decode_single(Header& hd, const uint8_t* end, const Window& win,
                  bool finish, int16_t* coefs) {
  const OutLayout o = out_layout(hd, win);
  const int cols = mcu_cols(hd);
  Bits b;
  b.s.p = hd.scan;
  b.s.end = end;
  int pred[3] = {0, 0, 0};
  int todo = hd.restart, next_rst = 0;
  bool insufficient = false;  // libjpeg's: the rest of the segment is zero
  const Huffman* dc[3];
  const Huffman* ac[3];
  for (int c = 0; c < hd.ncomp; ++c) {
    dc[c] = &hd.dc[hd.first.td[c]];
    ac[c] = &hd.ac[hd.first.ta[c]];
  }
  for (int my = 0; my < win.mr1; ++my) {
    const bool row_in = my >= win.mr0;
    for (int mx = 0; mx < cols; ++mx) {
      if (hd.restart) {
        if (todo == 0) {
          if (b.restart(next_rst)) insufficient = false;
          pred[0] = pred[1] = pred[2] = 0;
          todo = hd.restart;
        }
        --todo;
      }
      if (insufficient) continue;
      const bool in = row_in && mx >= win.mc0 && mx < win.mc1;
      for (int c = 0; c < hd.ncomp; ++c) {
        const Component& cc = hd.comp[c];
        for (int yy = 0; yy < cc.v; ++yy) {
          for (int xx = 0; xx < cc.h; ++xx) {
            int16_t* out = nullptr;
            if (in) {
              const size_t by = static_cast<size_t>(my - win.mr0) * cc.v + yy;
              const size_t bx = static_cast<size_t>(mx - win.mc0) * cc.h + xx;
              out = coefs + (o.base[c] + by * o.row_len[c] + bx) * 64;
            }
            decode_block(b, *dc[c], *ac[c], &pred[c], out);
          }
        }
      }
      if (b.overran()) insufficient = true;
    }
  }
  if (!finish) return OK;
  Scan extra;
  const int r = read_markers(b.s, hd, &extra);
  return r == 1 ? EXTRA_SCAN : r;
}

// A component's part of the coefficient buffer: every block column of the
// block rows up to the window's last
struct Plane {
  int16_t* blk;
  int bw, rows;          // blocks a row (MCU-padded), rows kept
  int real_bw, real_bh;  // the component's own blocks (a lone scan's raster)
  int coef_bits[64];     // libjpeg's: each coefficient's Al, -1 before any
  bool latched;
  int32_t qt[64];
};

// One scan's MCUs: the raster's width, the rows decoded, and each block of
// an MCU (its scan component, and its offset in the component's blocks)
struct ScanGeom {
  int mcus_x, stop_y;
  int nblocks;
  int bsc[10], bx[10], by[10];
  bool interleaved;
};

ScanGeom scan_geom(const Header& hd, const Scan& s, const Window& win,
                   const Plane* pl) {
  ScanGeom g;
  g.interleaved = s.ns > 1;
  if (g.interleaved) {
    g.mcus_x = mcu_cols(hd);
    g.stop_y = win.mr1;
    g.nblocks = 0;
    for (int i = 0; i < s.ns; ++i) {
      const Component& cc = hd.comp[s.ci[i]];
      for (int yy = 0; yy < cc.v; ++yy)
        for (int xx = 0; xx < cc.h; ++xx) {
          g.bsc[g.nblocks] = i;
          g.bx[g.nblocks] = xx;
          g.by[g.nblocks] = yy;
          ++g.nblocks;
        }
    }
  } else {
    const Plane& p = pl[s.ci[0]];
    g.mcus_x = p.real_bw;
    g.stop_y = p.rows < p.real_bh ? p.rows : p.real_bh;
    g.nblocks = 1;
    g.bsc[0] = g.bx[0] = g.by[0] = 0;
  }
  return g;
}

inline int16_t* block_at(const Header& hd, const Scan& s, const ScanGeom& g,
                         Plane* pl, int j, int mx, int my) {
  const int c = s.ci[g.bsc[j]];
  Plane& p = pl[c];
  if (!g.interleaved) return p.blk + (static_cast<size_t>(my) * p.bw + mx) * 64;
  const Component& cc = hd.comp[c];
  const size_t row = static_cast<size_t>(my) * cc.v + g.by[j];
  const size_t col = static_cast<size_t>(mx) * cc.h + g.bx[j];
  return p.blk + (row * p.bw + col) * 64;
}

// A Huffman scan over the buffer, up to its rows in the window; `src` ends
// where the data was left.
void scan_huffman(const Header& hd, const Scan& s, Plane* pl, Src& src,
                  const Window& win) {
  const ScanGeom g = scan_geom(hd, s, win, pl);
  Bits b;
  b.s = src;
  int pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int todo = hd.restart, next_rst = 0;
  bool insufficient = false;
  enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind = SEQ;
  if (hd.progressive)
    kind = s.ss == 0 ? (s.ah == 0 ? DC_FIRST : DC_REFINE)
                     : (s.ah == 0 ? AC_FIRST : AC_REFINE);
  for (int my = 0; my < g.stop_y; ++my) {
    for (int mx = 0; mx < g.mcus_x; ++mx) {
      if (hd.restart) {
        if (todo == 0) {
          if (b.restart(next_rst)) insufficient = false;
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          eobrun = 0;
          todo = hd.restart;
        }
        --todo;
      }
      if (insufficient) continue;
      for (int j = 0; j < g.nblocks; ++j) {
        const int i = g.bsc[j];
        int16_t* blk = block_at(hd, s, g, pl, j, mx, my);
        switch (kind) {
          case SEQ:
            decode_block(b, hd.dc[s.td[i]], hd.ac[s.ta[i]], &pred[i], blk);
            break;
          case DC_FIRST:
            dc_first(b, hd.dc[s.td[i]], &pred[i], s.al, blk);
            break;
          case DC_REFINE:
            if (b.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << s.al));
            break;
          case AC_FIRST:
            ac_first(b, hd.ac[s.ta[i]], s.ss, s.se, s.al, &eobrun, blk);
            break;
          case AC_REFINE:
            ac_refine(b, hd.ac[s.ta[i]], s.ss, s.se, s.al, &eobrun, blk);
            break;
        }
      }
      if (b.overran()) insufficient = true;
    }
  }
  src = b.s;
}

void arith_reset(const Header& hd, const Scan& s, ArithStats& t, Arith& e) {
  for (int i = 0; i < s.ns; ++i) {
    if (!hd.progressive || (s.ss == 0 && s.ah == 0)) {
      memset(t.dc[s.td[i]], 0, sizeof(t.dc[0]));
      t.last_dc[i] = 0;
      t.dc_context[i] = 0;
    }
    if (!hd.progressive || s.ss) memset(t.ac[s.ta[i]], 0, sizeof(t.ac[0]));
  }
  e.c = 0;
  e.a = 0;
  e.ct = -16;
}

// An arithmetic scan over the buffer, up to its rows in the window
void scan_arith(const Header& hd, const Scan& s, Plane* pl, Src& src,
                const Window& win, ArithStats& t) {
  const ScanGeom g = scan_geom(hd, s, win, pl);
  Arith e;
  e.s = src;
  arith_reset(hd, s, t, e);
  int todo = hd.restart, next_rst = 0;
  for (int my = 0; my < g.stop_y; ++my) {
    for (int mx = 0; mx < g.mcus_x; ++mx) {
      if (hd.restart) {
        if (todo == 0) {
          read_restart_marker(e.s, next_rst);
          arith_reset(hd, s, t, e);
          todo = hd.restart;
        }
        --todo;
      }
      if (e.ct == -1) continue;
      for (int j = 0; j < g.nblocks; ++j) {
        const int i = g.bsc[j];
        int16_t* blk = block_at(hd, s, g, pl, j, mx, my);
        bool ok = true;
        if (!hd.progressive) {
          ok = arith_dc(e, t, hd, s.td[i], i);
          if (ok) {
            blk[0] = static_cast<int16_t>(t.last_dc[i]);
            ok = arith_ac(e, t, hd, s.ta[i], 1, 63, 0, blk);
          }
        } else if (s.ss == 0 && s.ah == 0) {
          ok = arith_dc(e, t, hd, s.td[i], i);
          if (ok) blk[0] = shifted(t.last_dc[i], s.al);
        } else if (s.ss == 0) {
          if (e.decode(&e.fixed_bin))
            blk[0] = static_cast<int16_t>(blk[0] | (1 << s.al));
        } else if (s.ah == 0) {
          ok = arith_ac(e, t, hd, s.ta[i], s.ss, s.se, s.al, blk);
        } else {
          ok = arith_ac_refine(e, t, s.ta[i], s.ss, s.se, s.al, blk);
        }
        if (!ok) {
          e.ct = -1;
          break;
        }
      }
    }
  }
  src = e.s;
}

// libjpeg-turbo 2.1's smoothing_ok (jdcoefct.c): whether it smooths the
// blocks of a progressive frame at output: every component latched, its
// first ten quantisers nonzero and its DC known, and some component's
// coefficients 1-9 (zig-zag) not yet at Al 0
bool smoothed(const Header& hd, const Plane* pl) {
  if (!hd.progressive) return false;
  bool useful = false;
  for (int c = 0; c < hd.ncomp; ++c) {
    const Plane& p = pl[c];
    if (!p.latched) return false;
    for (int k = 0; k < 10; ++k)
      if (p.qt[kNatural[k]] == 0) return false;
    if (p.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (p.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// Any other frame: scan by scan into the coefficient buffer (`work`), then
// the window's blocks copied out. A frame whose first scan covers every
// component sequentially is a single scan to libjpeg (has_multiple_scans
// false): a later scan is an error where the decode reads on to the end
// (`finish`, as jpeg_finish_decompress does), else never read.
int decode_buffered(Header& hd, const uint8_t* end, const Window& win,
                    bool finish, int16_t* coefs, int32_t* qt,
                    std::vector<int16_t>& work, ArithStats& stats) {
  Plane pl[3];
  size_t total = 0;
  for (int c = 0; c < hd.ncomp; ++c) {
    const Component& cc = hd.comp[c];
    Plane& p = pl[c];
    p.bw = mcu_cols(hd) * cc.h;
    p.rows = win.mr1 * cc.v;
    p.real_bw = static_cast<int>(
        (static_cast<int64_t>(hd.width) * cc.h + 8 * hd.max_h - 1) /
        (8 * hd.max_h));
    p.real_bh = static_cast<int>(
        (static_cast<int64_t>(hd.height) * cc.v + 8 * hd.max_v - 1) /
        (8 * hd.max_v));
    for (int k = 0; k < 64; ++k) p.coef_bits[k] = -1;
    p.latched = false;
    memset(p.qt, 0, sizeof(p.qt));
    total += static_cast<size_t>(p.bw) * p.rows * 64;
  }
  if (work.size() < total) {
    try {
      work.resize(total);
    } catch (const std::bad_alloc&) {
      return NO_MEMORY;
    }
  }
  memset(work.data(), 0, total * sizeof(int16_t));
  size_t off = 0;
  for (int c = 0; c < hd.ncomp; ++c) {
    pl[c].blk = work.data() + off;
    off += static_cast<size_t>(pl[c].bw) * pl[c].rows * 64;
  }
  const bool one_pass = !hd.progressive && hd.first.ns == hd.ncomp;

  Scan s = hd.first;
  Src src{hd.scan, end, 0};
  for (;;) {
    for (int i = 0; i < s.ns; ++i) {
      Plane& p = pl[s.ci[i]];
      if (!p.latched) {
        const int tq = hd.comp[s.ci[i]].tq;
        if (!hd.qdefined[tq]) return MISSING_TABLE;
        memcpy(p.qt, hd.qt[tq], sizeof(p.qt));
        p.latched = true;
      }
      if (hd.progressive)
        for (int k = s.ss; k <= s.se; ++k) p.coef_bits[k] = s.al;
    }
    if (!scan_tables_defined(hd, s)) return MISSING_TABLE;
    if (hd.arithmetic)
      scan_arith(hd, s, pl, src, win, stats);
    else
      scan_huffman(hd, s, pl, src, win);
    if (one_pass && !finish) break;
    const int r = read_markers(src, hd, &s);
    if (r < 0) return r;
    if (one_pass && r == 1) return EXTRA_SCAN;
    if (one_pass || r == 0) break;
  }
  if (smoothed(hd, pl)) return SMOOTHING;

  const OutLayout o = out_layout(hd, win);
  for (int c = 0; c < hd.ncomp; ++c) {
    const Component& cc = hd.comp[c];
    const Plane& p = pl[c];
    const int rows = (win.mr1 - win.mr0) * cc.v;
    for (int r = 0; r < rows; ++r) {
      const int16_t* from =
          p.blk + ((static_cast<size_t>(win.mr0) * cc.v + r) * p.bw +
                   static_cast<size_t>(win.mc0) * cc.h) * 64;
      memcpy(coefs + (o.base[c] + r * o.row_len[c]) * 64, from,
             o.row_len[c] * 64 * sizeof(int16_t));
    }
    memcpy(qt + 64 * c, p.qt, 64 * sizeof(int32_t));
  }
  return OK;
}

// Decode one frame's window into `coefs` (its blocks, as the file's head
// says) and `qt` (ncomp x 64); `finish`: read on to the frame's end as a
// full decode does (libjpeg's jpeg_finish_decompress), where a partial
// decode stops after the window (jpeg_abort_decompress).
int decode_frame(const uint8_t* data, size_t size, const int32_t* layout,
                 const Window& win, bool finish, int16_t* coefs, int32_t* qt,
                 std::vector<int16_t>& work, ArithStats& stats) {
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
  const OutLayout o = out_layout(hd, win);
  memset(coefs, 0, o.blocks * 64 * sizeof(int16_t));
  if (!hd.progressive && !hd.arithmetic && hd.first.ns == hd.ncomp) {
    for (int c = 0; c < hd.ncomp; ++c)
      memcpy(qt + 64 * c, hd.qt[hd.comp[c].tq], 64 * sizeof(int32_t));
    st = decode_single(hd, data + size, win, finish, coefs);
  } else {
    st = decode_buffered(hd, data + size, win, finish, coefs, qt, work,
                         stats);
  }
  return st;
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

// Decode n frames of one layout (layout[0..8] as cfn_jpeg_probe's info)
// over the MCU window win = (mc0, mc1, mr0, mr1): frame i's blocks at
// coefs + i * frame_blocks * 64, its tables at qt + i * ncomp * 64;
// `finish` nonzero: read each frame to its end, as a full decode does.
// status[i] is frame i's status; returns the number of frames that failed.
int cfn_entropy_decode(const uint8_t* const* datas, const size_t* sizes,
                       int n, const int32_t* layout, const int32_t* win,
                       int64_t frame_blocks, int16_t* coefs, int32_t* qt,
                       int32_t* status, int num_threads, int finish) {
  const Window w{win[0], win[1], win[2], win[3]};
  const int ncomp = layout[2];
  std::atomic<int> next{0};
  auto work = [&]() {
    std::vector<int16_t> buffer;  // a frame's coefficient buffer, reused
    ArithStats stats;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = decode_frame(datas[i], sizes[i], layout, w, finish != 0,
                               coefs + static_cast<size_t>(i) * frame_blocks * 64,
                               qt + static_cast<size_t>(i) * ncomp * 64,
                               buffer, stats);
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
