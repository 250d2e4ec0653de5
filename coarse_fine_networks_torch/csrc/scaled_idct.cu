// The DCT-scaled decode's pixel work on the card (sm_90a): a JPEG window's
// quantised coefficients (from the host entropy decoder,
// csrc/jpeg_entropy.cpp) to RGB, at num/8 of the frame's size.
//
//   scaled_idct_kernel: each 8x8 block dequantised and inverse-transformed
//                       at its component's scaled size s (8, 4, 2 or 1),
//                       into that component's plane;
//   ycc_rgb_kernel:     the planes to RGB uint8, each chroma plane repeated
//                       up to the luma grid, into a pitched window, which
//                       ops/frame_decode.py's crop_resize_kernel then crops
//                       and resizes.
//
// Replace no TPU kernel. Their counterpart is host C++ of the JAX package:
// native/cfn_data.cpp's decode_crop_scaled (:171-255), which runs
// libjpeg-turbo 2.1 at scale num/8 with fancy upsampling off. The
// arithmetic is libjpeg-turbo's, in 32-bit integers, bit for bit:
//   * s = 8: jidctint.c's jpeg_idct_islow; s = 4, 2, 1: jidctred.c's
//     jpeg_idct_4x4, _2x2 and _1x1 (CONST_BITS 13, PASS1_BITS 2, the FIX_
//     constants, DESCALE(x, n) = (x + 2^(n-1)) >> n). jpeg_idct_4x4 skips
//     coefficient row and column 4, _2x2 rows and columns 2, 4, 6. Their
//     zero-column and zero-row shortcuts give the same values as the full
//     sums, so every column takes the full sums here.
//   * the output's range limit indexes libjpeg's IDCT table with
//     (value & 1023): 0..127 -> +128, 128..511 -> 255, 512..895 -> 0,
//     896..1023 -> -896 (idct_limit below), so a value past +-512 wraps as
//     libjpeg's does.
//   * each component's size s follows jdmaster.c's
//     jpeg_core_output_dimensions (ops/scaled_decode.py's component_sizes):
//     chroma grows through the IDCT while the sampling ratios allow it
//     (4:2:0 chroma at 2 * num, so 1:1 with luma), and what remains is
//     repeated (fancy upsampling is off: 4:2:2 chroma repeated across a
//     pixel pair, which is what libjpeg's merged upsampler computes).
//   * jdcolor.c's ycc_rgb_convert with its tables (SCALEBITS 16): R = y +
//     Cr_r[cr], G = y + ((Cb_g[cb] + Cr_g[cr]) >> 16), B = y + Cb_b[cb],
//     each clamped to [0, 255]; grey repeated to three channels.
// ops/scaled_decode.py's scaled_idct_plain and ycc_rgb_plain are the same
// integer sequences in PyTorch ops; kernel and plain version agree exactly.
//
// What bounds them on this card: bytes. A block's 128 bytes of
// coefficients are read once and s^2 bytes written, against 378 (s = 4) to
// 864 (s = 8) integer operations (ops/scaled_decode.py's IDCT_OPS): under 7
// operations a byte, far below what the card's CUDA cores do for each byte
// its memory delivers. The colour pass reads 1-3 plane bytes and writes 3
// RGB bytes a pixel with ~15 operations.
//
// Design (simple first): a 256-thread block takes 32 coefficient blocks,
// copies their 4 KB with one 16-byte load a thread into shared memory, and
// gives each coefficient block 8 threads: thread j runs column j's pass
// into a shared workspace, then (j < s) row j's pass, writing its s output
// bytes with one store. Which component a block belongs to, and where its
// plane lies, come from the launch's parameters (Geom); a frame's blocks
// lie component after component, each in raster order (the entropy
// decoder's layout). The colour pass gives a thread one pixel of the window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_COMP = 3;
constexpr int IDCT_THREADS = 256;
constexpr int BLOCKS_PER_CTA = IDCT_THREADS / 8;
constexpr int YCC_THREADS = 256;

struct Comp {
  long long block_off;  // the component's first block in a frame
  int rows, cols;       // its blocks in the window
  int s;                // its scaled block size
  long long plane_off;  // its plane's first byte in a frame's planes
  int pitch;            // its plane's row bytes (a multiple of 16)
  int hexp, vexp;       // its repetition up to the luma grid
};

struct Geom {
  int ncomp;
  long long frame_blocks;  // coefficient blocks of a frame
  long long plane_bytes;   // plane bytes of a frame
  int height, width;       // the window's pixels
  Comp comp[MAX_COMP];
};

// ops/scaled_decode.py's GEOM_HEAD and GEOM_COMP: the int64 array the
// wrappers pass (geom_array)
constexpr int GEOM_HEAD = 5, GEOM_COMP = 8;

constexpr int CONST_BITS = 13, PASS1_BITS = 2;

__device__ __forceinline__ int descale(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// libjpeg's IDCT range-limit table at (x & RANGE_MASK)
__device__ __forceinline__ uint8_t idct_limit(int x) {
  const int v = x & 1023;
  return static_cast<uint8_t>(v < 128 ? v + 128
                              : v < 512 ? 255
                              : v < 896 ? 0
                                        : v - 896);
}

// jpeg_idct_islow's even and odd parts on one column or row d[0..7] (the
// inputs already dequantised or from the workspace): o[i] before descale.
__device__ __forceinline__ void islow_1d(const int* d, int* o) {
  int z2 = d[2], z3 = d[6];
  int z1 = (z2 + z3) * 4433;
  const int tmp2e = z1 + z3 * -15137;
  const int tmp3e = z1 + z2 * 6270;
  z2 = d[0];
  z3 = d[4];
  const int tmp0e = (z2 + z3) << CONST_BITS;
  const int tmp1e = (z2 - z3) << CONST_BITS;
  const int tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const int tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;

  int tmp0 = d[7], tmp1 = d[5], tmp2 = d[3], tmp3 = d[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int z4 = tmp1 + tmp3;
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
// unused)
__device__ __forceinline__ void red2_1d(const int* d, int* o) {
  const int tmp10 = d[0] << (CONST_BITS + 2);
  const int tmp0 = d[7] * -5906 + d[5] * 6967 + d[3] * -10426 + d[1] * 29692;
  o[0] = tmp10 + tmp0;
  o[1] = tmp10 - tmp0;
}

__global__ void __launch_bounds__(IDCT_THREADS)
scaled_idct_kernel(const int16_t* __restrict__ coefs,
                   const int32_t* __restrict__ qt, long long total,
                   const __grid_constant__ Geom g,
                   uint8_t* __restrict__ planes) {
  __shared__ __align__(16) int16_t cs[BLOCKS_PER_CTA * 64];
  __shared__ int ws[BLOCKS_PER_CTA][8][9];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * BLOCKS_PER_CTA;
  {  // the CTA's coefficient blocks, 16 bytes a thread
    const long long blk = first + tid / 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (blk < total)
      v = reinterpret_cast<const uint4*>(coefs + first * 64)[tid];
    reinterpret_cast<uint4*>(cs)[tid] = v;
  }
  const int lb = tid / 8, j = tid % 8;
  const long long blk = first + lb;
  const bool live = blk < total;
  int f = 0, c = 0, by = 0, bx = 0, s = 1;
  if (live) {
    f = static_cast<int>(blk / g.frame_blocks);
    long long r = blk - static_cast<long long>(f) * g.frame_blocks;
    while (c + 1 < g.ncomp && r >= g.comp[c + 1].block_off) ++c;
    r -= g.comp[c].block_off;
    by = static_cast<int>(r / g.comp[c].cols);
    bx = static_cast<int>(r - static_cast<long long>(by) * g.comp[c].cols);
    s = g.comp[c].s;
  }
  __syncthreads();

  // pass 1: column j, dequantised
  const int16_t* in = cs + lb * 64;
  const int32_t* q = qt + (static_cast<long long>(f) * g.ncomp + c) * 64;
  if (live && s > 1) {
    int d[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = in[8 * k + j] * __ldg(q + 8 * k + j);
    if (s == 8) {
      islow_1d(d, o);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        ws[lb][k][j] = descale(o[k], CONST_BITS - PASS1_BITS);
    } else if (s == 4) {
      if (j != 4) {
        red4_1d(d, o);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ws[lb][k][j] = descale(o[k], CONST_BITS - PASS1_BITS + 1);
      }
    } else if (j == 0 || (j & 1)) {
      red2_1d(d, o);
      ws[lb][0][j] = descale(o[0], CONST_BITS - PASS1_BITS + 2);
      ws[lb][1][j] = descale(o[1], CONST_BITS - PASS1_BITS + 2);
    }
  }
  __syncthreads();

  // pass 2: row j of the output
  if (!live || j >= s) return;
  const Comp& cc = g.comp[c];
  uint8_t* dst = planes + static_cast<long long>(f) * g.plane_bytes +
                 cc.plane_off + static_cast<long long>(by * s + j) * cc.pitch +
                 bx * s;
  if (s == 1) {
    const int dc = in[0] * __ldg(q);
    *dst = idct_limit(descale(dc, 3));
    return;
  }
  int d[8], o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = ws[lb][j][k];
  if (s == 8) {
    islow_1d(d, o);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= static_cast<uint32_t>(
                idct_limit(descale(o[k], CONST_BITS + PASS1_BITS + 3)))
            << (8 * k);
      hi |= static_cast<uint32_t>(
                idct_limit(descale(o[k + 4], CONST_BITS + PASS1_BITS + 3)))
            << (8 * k);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  } else if (s == 4) {
    red4_1d(d, o);
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v |= static_cast<uint32_t>(
               idct_limit(descale(o[k], CONST_BITS + PASS1_BITS + 3 + 1)))
           << (8 * k);
    *reinterpret_cast<uint32_t*>(dst) = v;
  } else {
    red2_1d(d, o);
    const uint32_t v =
        idct_limit(descale(o[0], CONST_BITS + PASS1_BITS + 3 + 2)) |
        static_cast<uint32_t>(
            idct_limit(descale(o[1], CONST_BITS + PASS1_BITS + 3 + 2)))
            << 8;
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v);
  }
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// jdcolor.c's build_ycc_rgb_table entries (FIX(x) = x * 65536 + 0.5)
constexpr int FIX_R = 91881, FIX_B = 116130, FIX_GR = 46802, FIX_GB = 22554;

__global__ void __launch_bounds__(YCC_THREADS)
ycc_rgb_kernel(const uint8_t* __restrict__ planes,
               const __grid_constant__ Geom g, uint8_t* __restrict__ out,
               long long out_frame, int out_pitch) {
  const int f = blockIdx.y;
  const int i = blockIdx.x * YCC_THREADS + threadIdx.x;
  if (i >= g.height * g.width) return;
  const int y = i / g.width, x = i - y * g.width;
  const uint8_t* p = planes + static_cast<long long>(f) * g.plane_bytes;
  int v[MAX_COMP];
#pragma unroll
  for (int c = 0; c < MAX_COMP; ++c) {
    if (c < g.ncomp) {
      const Comp& cc = g.comp[c];
      v[c] = __ldg(p + cc.plane_off +
                   static_cast<long long>(y / cc.vexp) * cc.pitch +
                   x / cc.hexp);
    }
  }
  uint8_t* o = out + static_cast<long long>(f) * out_frame +
               static_cast<long long>(y) * out_pitch + 3 * x;
  if (g.ncomp == 1) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(v[0]);
    return;
  }
  const int cb = v[1] - 128, cr = v[2] - 128;
  const int r = (FIX_R * cr + (1 << 15)) >> 16;
  const int b = (FIX_B * cb + (1 << 15)) >> 16;
  const int gg = (-FIX_GB * cb + (1 << 15) + -FIX_GR * cr) >> 16;
  o[0] = clamp255(v[0] + r);
  o[1] = clamp255(v[0] + gg);
  o[2] = clamp255(v[0] + b);
}

int read_geom(const long long* a, Geom* g) {
  g->ncomp = static_cast<int>(a[0]);
  g->frame_blocks = a[1];
  g->plane_bytes = a[2];
  g->height = static_cast<int>(a[3]);
  g->width = static_cast<int>(a[4]);
  if (g->ncomp != 1 && g->ncomp != 3) return cudaErrorInvalidValue;
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
    if ((cc.s != 1 && cc.s != 2 && cc.s != 4 && cc.s != 8) || cc.pitch % 16 ||
        cc.plane_off % 16 || cc.cols < 1 || cc.rows < 1 || cc.hexp < 1 ||
        cc.vexp < 1 || cc.cols * cc.s > cc.pitch)
      return cudaErrorInvalidValue;
  }
  if (g->plane_bytes % 16 || g->frame_blocks < 1) return cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Inverse-transform n frames' blocks (coefs: n * frame_blocks * 64 int16,
// 16-byte aligned; qt: n * ncomp * 64 int32) into their planes (n *
// plane_bytes, 16-byte aligned). geom: the int64 array of
// ops/scaled_decode.py's geom_array. 0, cudaErrorInvalidValue for a
// geometry the kernel does not take, or the launch's error.
extern "C" int cfn_scaled_idct(const void* coefs, const void* qt, int n,
                               const long long* geom, void* planes,
                               void* stream) {
  Geom g;
  if (int e = read_geom(geom, &g)) return e;
  if (n < 1 || (reinterpret_cast<uintptr_t>(coefs) |
                reinterpret_cast<uintptr_t>(planes)) % 16)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(n) * g.frame_blocks;
  const long long grid = (total + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  scaled_idct_kernel<<<static_cast<unsigned>(grid), IDCT_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int32_t*>(qt),
      total, g, static_cast<uint8_t*>(planes));
  return static_cast<int>(cudaGetLastError());
}

// The planes of n frames to RGB: frame i's window at out + i * out_frame,
// rows out_pitch bytes apart.
extern "C" int cfn_ycc_rgb(const void* planes, int n, const long long* geom,
                           void* out, long long out_frame, int out_pitch,
                           void* stream) {
  Geom g;
  if (int e = read_geom(geom, &g)) return e;
  if (n < 1 || n > 65535 || out_pitch < 3 * g.width ||
      out_frame < static_cast<long long>(out_pitch) * g.height)
    return cudaErrorInvalidValue;
  const dim3 grid((g.height * g.width + YCC_THREADS - 1) / YCC_THREADS, n);
  ycc_rgb_kernel<<<grid, YCC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), g, static_cast<uint8_t*>(out),
      out_frame, out_pitch);
  return static_cast<int>(cudaGetLastError());
}
