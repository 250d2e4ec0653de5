// The decode's pixel work on the card (sm_90a): a JPEG window's quantised
// coefficients (from the host entropy decoder, csrc/jpeg_entropy.cpp) to
// the window's RGB rows, at num/8 of the frame's size, in one kernel:
//
//   idct_rgb_kernel: each 8x8 block dequantised and inverse-transformed at
//                    its component's scaled size s (8, 4, 2 or 1) into
//                    shared memory, each component brought up to the luma
//                    grid (repeated, or libjpeg's fancy filters at 8/8),
//                    converted to RGB and written into a pitched window,
//                    which ops/frame_decode.py's crop_resize_kernel then
//                    crops and resizes.
//
// Replaces no TPU kernel. Its counterpart is host C++ of the JAX package:
// native/cfn_data.cpp's decode_rgb (:68, the exact mode's full decode) and
// decode_crop_scaled (:171, the default mode), which run libjpeg-turbo 2.1:
// below 8/8 with fancy upsampling off, at 8/8 with it on. The arithmetic is
// libjpeg-turbo's, in 32-bit integers, bit for bit:
//   * s = 8: jidctint.c's jpeg_idct_islow; s = 4, 2, 1: jidctred.c's
//     jpeg_idct_4x4, _2x2 and _1x1 (CONST_BITS 13, PASS1_BITS 2, the FIX_
//     constants, DESCALE(x, n) = (x + 2^(n-1)) >> n). jpeg_idct_4x4 skips
//     coefficient row and column 4, _2x2 rows and columns 2, 4, 6.
//   * at s = 8, 4 and 2 as libjpeg-turbo's SIMD code computes them (SSE2
//     and AVX2 on x86-64: jsimd_idct_islow, _4x4, _2x2), which the JAX
//     library runs there: each coef * q in a 16-bit lane (pmullw), islow's
//     sums d0 + d4, d0 - d4, d7 + d3 and d5 + d1 in 16-bit lanes, the first
//     pass's values packed to 16 bits with saturation (but for the 2x2's
//     column 0, kept in 32), and islow's and the 4x4's shortcut where a
//     block's rows beside row 0 are all zero: (coef * q) << 2 in 16 bits.
//     On the values 8-bit blocks give none of this departs from the C
//     code; corrupt data and blocks decoded on the zero bits of data cut
//     short reach it (w16, s16, flat_block below).
//   * the output's range limit: at s = 8, 4 and 2 saturated to [0, 255], as
//     libjpeg-turbo's SIMD IDCTs (jsimd_idct_islow, _4x4, _2x2; SSE2 and
//     AVX2 on x86-64), which the JAX library runs there, pack it (saturate
//     below); at s = 1 (jpeg_idct_1x1, C only) libjpeg's IDCT table with
//     (value & 1023): 0..127 -> +128, 128..511 -> 255, 512..895 -> 0,
//     896..1023 -> -896 (limit below). The two differ past +-512 only,
//     which no 8-bit block reaches but a block decoded on the zero bits of
//     data cut short can.
//   * each component's size s follows jdmaster.c's
//     jpeg_core_output_dimensions (ops/scaled_decode.py's component_sizes):
//     chroma grows through the IDCT while the sampling ratios allow it
//     (4:2:0 chroma at 2 * num, so 1:1 with luma).
//   * what remains is brought up to the luma grid as jdsample.c's
//     jinit_upsampler chooses (ops/scaled_decode.py's fancy_upsampled):
//     below 8/8 repeated (4:2:2 chroma across a pixel pair, which is what
//     the merged upsampler computes); at 8/8 by the fancy filters,
//     h2v1_fancy_upsample and h1v2_fancy_upsample ((3 near + far + 1 or 2)
//     >> 2) and h2v2_fancy_upsample (column sums 3 near + far, then (3 this
//     + other + 8 or 7) >> 4), the neighbours clamped to the frame's real
//     samples (downsampled_width and _height) and to the window's; or
//     repeated where the filter is off (a chroma width of 2 or less).
//   * jdcolor.c's ycc_rgb_convert with its tables (SCALEBITS 16): R = y +
//     Cr_r[cr], G = y + ((Cb_g[cb] + Cr_g[cr]) >> 16), B = y + Cb_b[cb],
//     each clamped to [0, 255]; grey repeated to three channels.
// ops/scaled_decode.py's idct_rgb_plain is the same integer sequence in
// PyTorch ops, step by step; kernel and plain version agree exactly.
//
// What bounds it on this card: bytes, by the roofline's count. A block's
// 128 bytes of coefficients are read once and the window's 3 RGB bytes a
// pixel written once, against some 50 integer operations a pixel
// (ops/scaled_decode.py's IDCT_OPS, FANCY_OPS, YCC_OPS). In practice the
// integer instructions are the nearer limit: the IDCT's butterflies,
// descales and range limits and the colour pass's byte handling take
// longer to issue than the bytes take to move (PERF.md §6 holds its times
// against the bound), so the design spends few instructions on everything
// but the arithmetic itself.
//
// Design: nothing goes through device memory between the coefficients and
// the RGB rows. A 256-thread block takes one MCU row of a frame's window
// (or a run of whole MCUs of it where the row's shared memory would pass
// SMEM_TARGET) and stages every component's blocks of that row with
// 16-byte cp.async copies (each staged block row is contiguous in the
// entropy decoder's layout; a staged block padded to BLOCK_STRIDE bytes,
// so that a warp's column loads meet no bank conflict), the first
// component in one group of copies and the others in a second, so that
// the first's IDCT runs while the others land. The IDCT runs into shared
// planes a component at a time, a warp four blocks at a time with no
// block-wide barrier: thread j of a block's eight runs column j's pass
// into the warp's workspace, then row j's, the quantisation table's column
// held in registers. A fancy filter's neighbours across the run's edges
// belong to other blocks: the block stages those blocks too and computes
// again only what the filter reads (for the blocks above and below, the
// one row next to the run: its column outputs alone, then one output
// pixel a thread as a row of jpeg_idct_islow's matrix; the whole block
// beside it). Then a thread takes 16 pixels of an output row, reads each
// component's samples from shared memory (16 or 8 bytes at once where
// they are repeated or inside the frame), converts them and writes the 48
// RGB bytes with three 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_COMP = 3;
constexpr int THREADS = 256;
constexpr int PASS_BLOCKS = THREADS / 8;  // coefficient blocks an IDCT pass
// a staged block's bytes: its 128 and 16 of padding, so that the four
// blocks of a warp's column pass read other banks
constexpr int BLOCK_STRIDE = 144;
constexpr int GROUP = 16;                 // output pixels a thread writes
// a block's shared memory: a whole MCU row where it fits SMEM_TARGET (so
// that several blocks share an SM), else the longest run of a multiple of
// 16 MCUs that does, else 16 MCUs up to the card's SMEM_MAX
constexpr int SMEM_TARGET = 64 * 1024, SMEM_MAX = 227 * 1024;

struct Comp {
  long long block_off;  // the component's first block in a frame
  int rows, cols;       // its blocks in the window
  int s;                // its scaled block size
  long long plane_off;  // the plain version's plane (not read here)
  int pitch;
  int hexp, vexp;       // its ratio to the luma grid
  int fancy;            // 1: libjpeg's fancy filter of that ratio
  int xmax, ymax;       // the filter's last sample in the window
};

struct Geom {
  int ncomp;
  long long frame_blocks;  // coefficient blocks of a frame
  long long plane_bytes;
  int height, width;  // the window's pixels
  int wr, wc;         // the window's MCU rows and columns
  Comp comp[MAX_COMP];
};

// ops/scaled_decode.py's GEOM_HEAD and GEOM_COMP: the int64 array the
// wrapper passes (geom_array)
constexpr int GEOM_HEAD = 7, GEOM_COMP = 11;

// A component's part of a block's run in shared memory: its staged
// coefficient blocks (up to (v + 2 ctx) rows of run * h + 2 halo blocks)
// and its plane (v * s + 2 ctx rows of pitch bytes: the context rows
// above and below, then halo * s columns left of the run's first)
struct Part {
  int h, v;   // blocks an MCU across and down
  int halo;   // 1: the blocks left and right of the run are staged
  int ctx;    // 1: the block rows above and below are staged
  int coef;   // byte offset of the staged blocks
  int plane;  // byte offset of the plane
  int pitch;  // the plane's row bytes (a multiple of 16)
};

struct Plan {
  int run, nruns;  // MCUs a block, blocks an MCU row
  int ws, qt;      // byte offsets of the IDCT workspace and the tables
  int smem;
  Part part[MAX_COMP];
};

constexpr int CONST_BITS = 13, PASS1_BITS = 2;

__device__ __forceinline__ int descale(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// DESCALE(x, n) through libjpeg's IDCT range-limit table at (value &
// RANGE_MASK): 0..127 -> +128, 128..511 -> 255, 512..895 -> 0, 896..1023 ->
// -896. With u = (value + 128) & 1023 (bits n..n+9 of x + 2^(n-1) + 128 *
// 2^n) that is u below 256, 255 below 640, else 0. The 1x1 IDCT's.
__device__ __forceinline__ uint32_t limit(int x, int n) {
  const uint32_t u =
      (static_cast<uint32_t>(x + (1 << (n - 1)) + (128 << n)) >> n) & 1023;
  return u < 256 ? u : u < 640 ? 255 : 0;
}

// DESCALE(x, n) + 128 saturated to [0, 255]: the SIMD IDCTs' packs, at
// s = 8, 4 and 2.
__device__ __forceinline__ uint32_t saturate(int x, int n) {
  const int v = static_cast<int>(static_cast<uint32_t>(x) +
                                 (1u << (n - 1))) >> n;
  return static_cast<uint32_t>(min(max(v + 128, 0), 255));
}

// x in a 16-bit lane: wrapped (pmullw, paddw, psubw, psllw) or saturated
// (packssdw)
__device__ __forceinline__ int w16(int x) { return static_cast<int16_t>(x); }
__device__ __forceinline__ int s16(int x) {
  return min(max(x, -32768), 32767);
}
__device__ __forceinline__ bool fits16(int x) { return x == w16(x); }

// jpeg_idct_islow's even and odd parts on one column or row d[0..7] (16-bit
// values: dequantised or from the workspace): o[i] before descale, the
// four sums the SIMD code forms in 16-bit lanes wrapped (its merged
// constants give the C code's products and sums integer for integer)
__device__ __forceinline__ void islow_1d(const int* d, int* o) {
  int z2 = d[2], z3 = d[6];
  int z1 = (z2 + z3) * 4433;
  const int tmp2e = z1 + z3 * -15137;
  const int tmp3e = z1 + z2 * 6270;
  z2 = d[0];
  z3 = d[4];
  const int tmp0e = w16(z2 + z3) * (1 << CONST_BITS);
  const int tmp1e = w16(z2 - z3) * (1 << CONST_BITS);
  const int tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const int tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;

  int tmp0 = d[7], tmp1 = d[5], tmp2 = d[3], tmp3 = d[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = w16(tmp0 + tmp2);
  int z4 = w16(tmp1 + tmp3);
  const int z5 = (z3 + z4) * 9633;
  tmp0 = tmp0 * 2446;
  tmp1 = tmp1 * 16819;
  tmp2 = tmp2 * 25172;
  tmp3 = tmp3 * 12299;
  z1 = z1 * -7373;
  z2 = z2 * -20995;
  z3 = z3 * -16069;
  z4 = z4 * -3196;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  o[0] = tmp10 + tmp3;
  o[7] = tmp10 - tmp3;
  o[1] = tmp11 + tmp2;
  o[6] = tmp11 - tmp2;
  o[2] = tmp12 + tmp1;
  o[5] = tmp12 - tmp1;
  o[3] = tmp13 + tmp0;
  o[4] = tmp13 - tmp0;
}

// jpeg_idct_4x4's column or row: o[0..3] before descale (d[4] unused)
__device__ __forceinline__ void red4_1d(const int* d, int* o) {
  const int tmp0e = d[0] << (CONST_BITS + 1);
  const int tmp2e = d[2] * 15137 + d[6] * -6270;
  const int tmp10 = tmp0e + tmp2e, tmp12 = tmp0e - tmp2e;
  const int z1 = d[7], z2 = d[5], z3 = d[3], z4 = d[1];
  const int tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
  const int tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
  o[0] = tmp10 + tmp2;
  o[3] = tmp10 - tmp2;
  o[1] = tmp12 + tmp0;
  o[2] = tmp12 - tmp0;
}

// jpeg_idct_2x2's column or row: o[0..1] before descale (d[2], d[4], d[6]
// unused; d[0] of a row may pass 16 bits, and its shift 32, which wraps as
// the SIMD code's pslld)
__device__ __forceinline__ void red2_1d(const int* d, int* o) {
  const int tmp10 =
      static_cast<int>(static_cast<uint32_t>(d[0]) << (CONST_BITS + 2));
  const int tmp0 = d[7] * -5906 + d[5] * 6967 + d[3] * -10426 + d[1] * 29692;
  o[0] = tmp10 + tmp0;
  o[1] = tmp10 - tmp0;
}

// whether a block's coefficient rows beside row 0 (rows 1-7, or for the
// 4x4 rows 1-3 and 5-7) are all zero in every column, where the SIMD code
// takes its shortcut; asked only where that changes a value (a column
// whose own rows are zero, with |coef * q| >= 8192)
__device__ bool flat_block(const int16_t* in, int s) {
  int any = 0;
  for (int k = 8; k < 64; ++k)
    if (s == 8 || (k >> 3) != 4) any |= in[k];
  return any == 0;
}

// one block's column pass, column j (dequantised by q, the table's
// column j): into ws[k][j]
__device__ __forceinline__ void column_pass(const int16_t* in,
                                            const int (&q)[8], int s, int j,
                                            int (*ws)[9]) {
  int d[8], o[8], ac = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    d[k] = w16(in[8 * k + j] * q[k]);
    if (k && (s == 8 || k != 4)) ac |= in[8 * k + j];
  }
  // the shortcut's 16-bit shift against the full sums' saturation
  const bool shortcut = ac == 0 && s != 2 && !fits16(d[0] * 4) &&
                        flat_block(in, s);
  if (s == 8) {
    islow_1d(d, o);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      ws[k][j] = shortcut ? w16(d[0] * 4)
                          : s16(descale(o[k], CONST_BITS - PASS1_BITS));
  } else if (s == 4) {
    if (j != 4) {
      red4_1d(d, o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ws[k][j] = shortcut ? w16(d[0] * 4)
                            : s16(descale(o[k], CONST_BITS - PASS1_BITS + 1));
    }
  } else if (j == 0 || (j & 1)) {
    red2_1d(d, o);
    // the 2x2 packs its odd columns to 16 bits, not column 0
    const int a = descale(o[0], CONST_BITS - PASS1_BITS + 2);
    const int b = descale(o[1], CONST_BITS - PASS1_BITS + 2);
    ws[0][j] = j ? s16(a) : a;
    ws[1][j] = j ? s16(b) : b;
  }
}

// jpeg_idct_islow's column pass of column j for one output row only, row 0
// (top) or 7 (!top): o[0] = tmp10 + tmp3, o[7] = tmp10 - tmp3, into
// ws[0 or 7][j]; the other rows are not computed
__device__ __forceinline__ void column_pass_edge(const int16_t* in,
                                                 const int (&q)[8], int j,
                                                 bool top, int (*ws)[9]) {
  int d[8], ac = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    d[k] = w16(in[8 * k + j] * q[k]);
    if (k) ac |= in[8 * k + j];
  }
  const int z1 = (d[2] + d[6]) * 4433;
  const int tmp10 = w16(d[0] + d[4]) * (1 << CONST_BITS) + z1 + d[2] * 6270;
  const int z3 = w16(d[7] + d[3]), z4 = w16(d[5] + d[1]);
  const int tmp3 = d[1] * 12299 + (d[7] + d[1]) * -7373 + z4 * -3196 +
                   (z3 + z4) * 9633;
  const int v = s16(descale(top ? tmp10 + tmp3 : tmp10 - tmp3,
                            CONST_BITS - PASS1_BITS));
  const bool shortcut = ac == 0 && !fits16(d[0] * 4) && flat_block(in, 8);
  ws[top ? 0 : 7][j] = shortcut ? w16(d[0] * 4) : v;
}

// row j of jpeg_idct_islow's pass as a matrix: output j of islow_1d over
// the unit vectors (the pass is a sum of integer multiples of its inputs,
// with no rounding inside, so the matrix gives its values exactly)
__device__ __forceinline__ void islow_row(int j, int (&a)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int d[8] = {0, 0, 0, 0, 0, 0, 0, 0}, o[8];
    d[k] = 1;
    islow_1d(d, o);
    int v = o[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) v = j == i ? o[i] : v;
    a[k] = v;
  }
}

// one block's row pass, row j < s, into dst (s bytes, s-aligned); s = 1
// takes the DC term itself (q0: the table's first entry)
__device__ __forceinline__ void row_pass(const int16_t* in, int q0, int s,
                                         int j, int (*ws)[9], uint8_t* dst) {
  if (s == 1) {
    *dst = static_cast<uint8_t>(limit(in[0] * q0, 3));
    return;
  }
  int d[8], o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = ws[j][k];
  if (s == 8) {
    islow_1d(d, o);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= saturate(o[k], CONST_BITS + PASS1_BITS + 3) << (8 * k);
      hi |= saturate(o[k + 4], CONST_BITS + PASS1_BITS + 3) << (8 * k);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  } else if (s == 4) {
    red4_1d(d, o);
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v |= saturate(o[k], CONST_BITS + PASS1_BITS + 3 + 1) << (8 * k);
    *reinterpret_cast<uint32_t*>(dst) = v;
  } else {
    red2_1d(d, o);
    const uint32_t v = saturate(o[0], CONST_BITS + PASS1_BITS + 3 + 2) |
                       saturate(o[1], CONST_BITS + PASS1_BITS + 3 + 2) << 8;
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v);
  }
}

// 16 bytes from device memory into shared memory, asynchronously
// (cp.async); copies_commit closes the thread's group of copies,
// copies_wait<N> waits until at most N of its groups are in flight
__device__ __forceinline__ void copy16(uint8_t* smem, const void* src) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(src));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// byte k of a 16-byte group, packed four to a word
__device__ __forceinline__ int byte_of(const uint32_t (&w)[4], int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 255;
}

__device__ __forceinline__ void put_byte(uint32_t (&w)[4], int k, int v) {
  w[k >> 2] |= static_cast<uint32_t>(v) << (8 * (k & 3));
}

// One component's samples at output pixels x0 .. x0 + 15 of window row
// y (the run's row yy), packed into w: its plane (rows pitch apart; row 0
// and column 0 are the run's first sample row and column, ctx rows above
// and halo * s columns left of them); rx: the run's first window column;
// ry: the window's sample row of the plane's first.
__device__ __forceinline__ void component_group(const Comp& cc, const Part& pt,
                                                const uint8_t* plane, int y,
                                                int yy, int x0, int rx,
                                                int ry, uint32_t (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0;
  if (!cc.fancy) {  // repeated (hexp, vexp 1 or 2; the rows 16-aligned)
    const uint8_t* row = plane + (yy / cc.vexp) * pt.pitch;
    if (cc.hexp == 1) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + x0);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(row + x0 / 2);
#pragma unroll
      for (int k = 0; k < GROUP; ++k)
        put_byte(w, k, ((k < 8 ? v.x : v.y) >> (8 * ((k >> 1) & 3))) & 255);
    }
    return;
  }
  // the fancy filters: the nearer and the further sample row
  int rn = yy, rf = yy, ybias = 0;
  if (cc.vexp == 2) {
    const int near = y >> 1;
    rn = min(near, cc.ymax) - ry + pt.ctx;
    rf = clampi(near + ((y & 1) ? 1 : -1), 0, cc.ymax) - ry + pt.ctx;
    ybias = (y & 1) ? 2 : 1;
  }
  const uint8_t* rown = plane + rn * pt.pitch;
  const uint8_t* rowf = plane + rf * pt.pitch;
  if (cc.hexp == 1) {  // h1v2
    const uint4 a = *reinterpret_cast<const uint4*>(rown + x0);
    const uint4 b = *reinterpret_cast<const uint4*>(rowf + x0);
    const uint32_t na[4] = {a.x, a.y, a.z, a.w};
    const uint32_t nb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      put_byte(w, k, (3 * byte_of(na, k) + byte_of(nb, k) + ybias) >> 2);
    return;
  }
  // h2v1, h2v2: samples c0 - 1 .. c0 + 8 of the group's nearer ones c0 ..
  // c0 + 7, each clamped to the window's [0, xmax]; inside it (no clamp)
  // from three 8-byte words a row
  const int c0 = (rx + x0) >> 1;
  const int at = x0 / 2 + pt.halo * 8;  // c0's plane column
  int cs[10];
  if (c0 >= 1 && c0 + 8 <= cc.xmax) {
    uint32_t n[6], fw[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint2 a = *reinterpret_cast<const uint2*>(rown + at - 8 + 8 * k);
      const uint2 b = *reinterpret_cast<const uint2*>(rowf + at - 8 + 8 * k);
      n[2 * k] = a.x;
      n[2 * k + 1] = a.y;
      fw[2 * k] = b.x;
      fw[2 * k + 1] = b.y;
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      const int b = k + 7;  // byte of column c0 - 1 + k in n, fw
      const int a = (n[b >> 2] >> (8 * (b & 3))) & 255;
      cs[k] = cc.vexp == 2 ? 3 * a + ((fw[b >> 2] >> (8 * (b & 3))) & 255)
                           : a;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      const int col = clampi(c0 - 1 + k, 0, cc.xmax) - (rx >> 1) +
                      pt.halo * 8;
      cs[k] = cc.vexp == 2 ? 3 * rown[col] + rowf[col] : rown[col];
    }
  }
  if (cc.vexp == 2) {  // h2v2
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      put_byte(w, 2 * k, (3 * cs[k + 1] + cs[k] + 8) >> 4);
      put_byte(w, 2 * k + 1, (3 * cs[k + 1] + cs[k + 2] + 7) >> 4);
    }
  } else {  // h2v1
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      put_byte(w, 2 * k, (3 * cs[k + 1] + cs[k] + 1) >> 2);
      put_byte(w, 2 * k + 1, (3 * cs[k + 1] + cs[k + 2] + 2) >> 2);
    }
  }
}

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : v > 255 ? 255 : v;
}

// jdcolor.c's build_ycc_rgb_table entries (FIX(x) = x * 65536 + 0.5)
constexpr int FIX_R = 91881, FIX_B = 116130, FIX_GR = 46802, FIX_GB = 22554;

__global__ void __launch_bounds__(THREADS)
idct_rgb_kernel(const int16_t* __restrict__ coefs,
                const int32_t* __restrict__ qt,
                const __grid_constant__ Geom g,
                const __grid_constant__ Plan p, uint8_t* __restrict__ out,
                long long out_frame, int out_pitch) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int tid = threadIdx.x;
  const int per_frame = g.wr * p.nruns;
  const int f = blockIdx.x / per_frame;
  const int rem = blockIdx.x - f * per_frame;
  const int r = rem / p.nruns;
  const int m0 = (rem - r * p.nruns) * p.run;
  const int m1 = min(m0 + p.run, g.wc);

  // each component's staged blocks: rows [bi0, bi0 + nbi), columns [bj0,
  // bj0 + nbj) of its blocks in the window
  int bi0[MAX_COMP], nbi[MAX_COMP], bj0[MAX_COMP], nbj[MAX_COMP];
#pragma unroll
  for (int c = 0; c < MAX_COMP; ++c) {
    bi0[c] = nbi[c] = bj0[c] = nbj[c] = 0;
    if (c < g.ncomp) {
      const Part& q = p.part[c];
      bi0[c] = r * q.v - (q.ctx && r > 0);
      nbi[c] = r * q.v + q.v + (q.ctx && r + 1 < g.wr) - bi0[c];
      bj0[c] = m0 * q.h - (q.halo && m0 > 0);
      nbj[c] = m1 * q.h + (q.halo && m1 < g.wc) - bj0[c];
    }
  }

  // stage them and the tables, 16 bytes a copy, a block BLOCK_STRIDE bytes
  // from the next: the first component and the tables in one group of
  // copies, the others in a second, so that the first's IDCT runs while
  // the others land
  const int16_t* fc = coefs + static_cast<long long>(f) * g.frame_blocks * 64;
#pragma unroll
  for (int c = 0; c < MAX_COMP; ++c) {
    if (c < g.ncomp) {
      const int n16 = nbj[c] * 8;
      for (int row = 0; row < nbi[c]; ++row) {
        const int16_t* src =
            fc + (g.comp[c].block_off +
                  static_cast<long long>(bi0[c] + row) * g.comp[c].cols +
                  bj0[c]) * 64;
        uint8_t* dst = sm + p.part[c].coef + row * nbj[c] * BLOCK_STRIDE;
        for (int k = tid; k < n16; k += THREADS)
          copy16(dst + (k >> 3) * BLOCK_STRIDE + (k & 7) * 16, src + 8 * k);
      }
    }
    if (c == 0) {
      for (int i = tid; i < g.ncomp * 16; i += THREADS)
        copy16(sm + p.qt + 16 * i,
               qt + static_cast<long long>(f) * g.ncomp * 64 + 4 * i);
      copies_commit();
    }
  }
  copies_commit();

  // the IDCT into the planes, a component at a time: a warp takes four
  // blocks at a time, thread j of a block's eight runs column j's pass,
  // then row j's, through the warp's own workspace; a context block (above
  // or below the run's rows) gives only the row next to them
  const int32_t* qs = reinterpret_cast<const int32_t*>(sm + p.qt);
  int (*ws)[9] = reinterpret_cast<int (*)[8][9]>(sm + p.ws)[tid >> 3];
  const int j = tid & 7;
  auto idct = [&](int c) {
    const Part& pt = p.part[c];
    const int s = g.comp[c].s, nj = nbj[c], cnt = nbi[c] * nj;
    const int top = r * pt.v - bi0[c];  // the run's first staged row
    int q[8], arow[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = qs[64 * c + 8 * k + j];
    islow_row(j, arow);
    int tt = (tid >> 5) * 4 + ((tid >> 3) & 3);
    int row = tt / nj, col = tt - row * nj;
    for (int base = tt - (tid >> 3 & 3); base < cnt; base += PASS_BLOCKS) {
      const bool live = tt < cnt;
      const int16_t* in = reinterpret_cast<const int16_t*>(
          sm + pt.coef + tt * BLOCK_STRIDE);
      const bool above = row < top, below = row >= top + pt.v;
      if (live && s > 1) {
        if (above || below)
          column_pass_edge(in, q, j, below, ws);
        else
          column_pass(in, q, s, j, ws);
      }
      __syncwarp();
      uint8_t* dst = sm + pt.plane + (bj0[c] + col - m0 * pt.h + pt.halo) * s;
      if (live && (above || below)) {  // pixel j of the one row (s = 8)
        const int* w = ws[below ? 0 : 7];
        int v = 0;
        if (fits16(w[0] + w[4]) && fits16(w[0] - w[4]) &&
            fits16(w[7] + w[3]) && fits16(w[5] + w[1])) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v += arow[k] * w[k];
        } else {  // a 16-bit sum wraps: the pass itself
          int d[8], o[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) d[k] = w[k];
          islow_1d(d, o);
#pragma unroll
          for (int k = 0; k < 8; ++k) v = j == k ? o[k] : v;
        }
        dst[(above ? 0 : pt.v * s + 1) * pt.pitch + j] = static_cast<uint8_t>(
            saturate(v, CONST_BITS + PASS1_BITS + 3));
      } else if (live && j < s) {
        row_pass(in, q[0], s, j, ws,
                 dst + ((row - top) * s + j + pt.ctx) * pt.pitch);
      }
      __syncwarp();
      tt += PASS_BLOCKS;
      col += PASS_BLOCKS;
      while (col >= nj) {
        col -= nj;
        ++row;
      }
    }
  };
  copies_wait<1>();
  __syncthreads();
  idct(0);
  copies_wait<0>();
  __syncthreads();
#pragma unroll
  for (int c = 1; c < MAX_COMP; ++c)
    if (c < g.ncomp) idct(c);
  __syncthreads();

  // the colour pass: 16 pixels of an output row a thread
  const int mw = g.width / g.wc, mh = g.height / g.wr;
  const int run_px = (m1 - m0) * mw;
  const int groups = (run_px + GROUP - 1) / GROUP;
  uint8_t* frame_out = out + static_cast<long long>(f) * out_frame;
  for (int i = tid; i < mh * groups; i += THREADS) {
    const int yy = i / groups, x0 = (i - yy * groups) * GROUP;
    const int y = r * mh + yy;
    uint32_t v[MAX_COMP][4];
#pragma unroll
    for (int c = 0; c < MAX_COMP; ++c) {
      if (c < g.ncomp) {
        const Comp& cc = g.comp[c];
        const Part& q = p.part[c];
        component_group(cc, q, sm + q.plane, y, yy, x0, m0 * mw,
                        r * q.v * cc.s, v[c]);
      }
    }
    uint32_t o[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int yv = byte_of(v[0], k);
      int rr = yv, gg = yv, bb = yv;
      if (g.ncomp == 3) {
        const int cb = byte_of(v[1], k) - 128, cr = byte_of(v[2], k) - 128;
        rr = clamp255(yv + ((FIX_R * cr + (1 << 15)) >> 16));
        gg = clamp255(yv + ((-FIX_GB * cb + (1 << 15) + -FIX_GR * cr) >> 16));
        bb = clamp255(yv + ((FIX_B * cb + (1 << 15)) >> 16));
      }
      const int b = 3 * k;
      o[b >> 2] |= static_cast<uint32_t>(rr) << (8 * (b & 3));
      o[(b + 1) >> 2] |= static_cast<uint32_t>(gg) << (8 * ((b + 1) & 3));
      o[(b + 2) >> 2] |= static_cast<uint32_t>(bb) << (8 * ((b + 2) & 3));
    }
    uint4* dst = reinterpret_cast<uint4*>(
        frame_out + static_cast<long long>(y) * out_pitch + 3 * (m0 * mw + x0));
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    dst[2] = make_uint4(o[8], o[9], o[10], o[11]);
  }
}

int read_geom(const long long* a, Geom* g) {
  g->ncomp = static_cast<int>(a[0]);
  g->frame_blocks = a[1];
  g->plane_bytes = a[2];
  g->height = static_cast<int>(a[3]);
  g->width = static_cast<int>(a[4]);
  g->wr = static_cast<int>(a[5]);
  g->wc = static_cast<int>(a[6]);
  if ((g->ncomp != 1 && g->ncomp != 3) || g->wr < 1 || g->wc < 1 ||
      g->height % g->wr || g->width % g->wc || g->frame_blocks < 1)
    return cudaErrorInvalidValue;
  const int mw = g->width / g->wc, mh = g->height / g->wr;
  for (int c = 0; c < g->ncomp; ++c) {
    const long long* b = a + GEOM_HEAD + GEOM_COMP * c;
    Comp& cc = g->comp[c];
    cc.block_off = b[0];
    cc.rows = static_cast<int>(b[1]);
    cc.cols = static_cast<int>(b[2]);
    cc.s = static_cast<int>(b[3]);
    cc.plane_off = b[4];
    cc.pitch = static_cast<int>(b[5]);
    cc.hexp = static_cast<int>(b[6]);
    cc.vexp = static_cast<int>(b[7]);
    cc.fancy = static_cast<int>(b[8]);
    cc.xmax = static_cast<int>(b[9]);
    cc.ymax = static_cast<int>(b[10]);
    if ((cc.s != 1 && cc.s != 2 && cc.s != 4 && cc.s != 8) || cc.rows < 1 ||
        cc.cols < 1 || cc.rows % g->wr || cc.cols % g->wc ||
        (cc.hexp != 1 && cc.hexp != 2) || (cc.vexp != 1 && cc.vexp != 2) ||
        cc.cols / g->wc * cc.s * cc.hexp != mw ||
        cc.rows / g->wr * cc.s * cc.vexp != mh || cc.block_off < 0 ||
        cc.block_off + static_cast<long long>(cc.rows) * cc.cols >
            g->frame_blocks ||
        (cc.fancy && (cc.s != 8 || cc.hexp * cc.vexp == 1 || cc.xmax < 0 ||
                      cc.ymax < 0 || cc.xmax >= cc.cols * cc.s ||
                      cc.ymax >= cc.rows * cc.s)))
      return cudaErrorInvalidValue;
  }
  return 0;
}

int align16(int v) { return (v + 15) / 16 * 16; }

// The layout of a block's run of `run` MCUs in shared memory.
void make_plan(const Geom& g, int run, Plan* p) {
  int off = 0;
  p->run = run;
  p->nruns = (g.wc + run - 1) / run;
  for (int c = 0; c < g.ncomp; ++c) {
    const Comp& cc = g.comp[c];
    Part& q = p->part[c];
    q.h = cc.cols / g.wc;
    q.v = cc.rows / g.wr;
    q.halo = cc.fancy && cc.hexp == 2;
    q.ctx = cc.fancy && cc.vexp == 2;
    q.coef = off;
    off += (q.v + 2 * q.ctx) * (run * q.h + 2 * q.halo) * BLOCK_STRIDE;
  }
  for (int c = 0; c < g.ncomp; ++c) {
    const int s = g.comp[c].s;
    Part& q = p->part[c];
    q.pitch = align16(run * q.h * s + 2 * q.halo * s);
    q.plane = off;
    off += align16((q.v * s + 2 * q.ctx) * q.pitch);
  }
  p->ws = off;
  off += PASS_BLOCKS * 8 * 9 * 4;
  p->qt = off;
  off += g.ncomp * 64 * 4;
  p->smem = off;
}

}  // namespace

// n frames' window coefficients (coefs: n * frame_blocks * 64 int16 in the
// entropy decoder's layout, 16-byte aligned; qt: n * ncomp * 64 int32,
// 16-byte aligned) to their RGB windows: frame i's at out + i * out_frame,
// rows out_pitch bytes apart (16-byte aligned, room for the width rounded
// up to 16 pixels). geom: the int64 array of ops/scaled_decode.py's
// geom_array. 0, cudaErrorInvalidValue for a geometry or layout the kernel
// does not take, or the launch's error.
extern "C" int cfn_idct_rgb(const void* coefs, const void* qt, int n,
                            const long long* geom, void* out,
                            long long out_frame, int out_pitch,
                            void* stream) {
  Geom g{};
  if (int e = read_geom(geom, &g)) return e;
  if (n < 1 || out_pitch % 16 || out_frame % 16 ||
      out_pitch < 3 * align16(g.width) ||
      out_frame < static_cast<long long>(out_pitch) * g.height ||
      (reinterpret_cast<uintptr_t>(coefs) | reinterpret_cast<uintptr_t>(qt) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorInvalidValue;
  Plan p{};
  make_plan(g, g.wc, &p);
  if (p.smem > SMEM_TARGET && g.wc > 16) {  // runs of 16k MCUs
    int run = (g.wc - 1) / 16 * 16;
    make_plan(g, run, &p);
    while (p.smem > SMEM_TARGET && run > 16) make_plan(g, run -= 16, &p);
  }
  if (p.smem > SMEM_MAX) return cudaErrorInvalidValue;
  const long long grid = static_cast<long long>(n) * g.wr * p.nruns;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (int e = cfn::set_smem(idct_rgb_kernel, p.smem)) return e;
  idct_rgb_kernel<<<static_cast<unsigned>(grid), THREADS, p.smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int32_t*>(qt), g,
      p, static_cast<uint8_t*>(out), out_frame, out_pitch);
  return static_cast<int>(cudaGetLastError());
}
