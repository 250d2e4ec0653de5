// The row-strip layout shared by the stride-1 plain, act and mm-weight-
// gradient kernels (dw_plain_s1.cu), the stride-2 plain and act kernels
// (dw_plain_s2.cu), the mm forwards and masked dx of both strides
// (dw_mm_act.cu, dw_plain_s2.cu, dw_dx_s1.cu) and the stride-2 mm weight
// gradient (dw_plain_s2.cu): a block owns
// R rows x WB columns x PG channel pairs of one sample over TT frames; rows
// are staged into shared memory by cp.async in the tensor's dtype; a thread
// owns one channel pair at one column. The split is computed by the wrappers
// (ops/dw_conv.py: plan_s1, plan_s2_fwd, plan_act_s2_fwd, plan_s2_dx,
// plan_act_dx_s2, plan_s2, plan_mm_s1, plan_mm_wgrad_s1, plan_act_dx_s1,
// plan_mm_dx_s1, plan_mm_s2_fwd, plan_mm_dx_s2, plan_mm_wgrad_s2).

#pragma once

#include "common.cuh"

namespace cfn {

constexpr int NT_MAX = 256;  // threads per block at most (WB * PG)
// threads per block at most in the masked dx kernels (dw_dx_s1.cu, the act
// and mm dx of dw_plain_s2.cu), K6 mm, K4 mm and K10 mm: at two blocks per
// SM a sub-partition holds 3 warps, so a thread may hold 168 registers
constexpr int NT_DX = 192;
constexpr int RMIN = 2;      // output rows per strip: a template argument
constexpr int RMAX = 4;      // in [RMIN, RMAX]
constexpr int NSTAGE = 3;    // frames in the shared-memory ring
// frames in the act kernels' ring: one more, since a frame is activated in
// place one step before it is read (act_own below)
constexpr int NSTAGE_ACT = NSTAGE + 1;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90

// A channel pair in the tensor's dtype, as read from shared memory
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, bool pair,
                                          bool second) {
  if (pair) {  // both channels exist and the address is pair-aligned
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    }
  } else {
    p[0] = from_f<T>(a);
    if (second) p[1] = from_f<T>(b);
  }
}

// One channel pair from global to shared memory: a cp.async of 4 (bf16) or
// 8 (f32) bytes where C is even and x pair-aligned (every shape of the
// path), else (odd C) plain loads of the one or two channels that exist.
template <typename T>
__device__ __forceinline__ void copy_pair(T* d, const T* s, bool pairs,
                                          bool second) {
  if (pairs) {
    const unsigned sa = (unsigned)__cvta_generic_to_shared(d);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
                 "l"(s), "n"(2 * sizeof(T)));
  } else {
    d[0] = s[0];
    if (second) d[1] = s[1];
  }
}
// 16 bytes from global to shared memory (both 16-byte aligned), bypassing L1
__device__ __forceinline__ void cp_async16(void* d, const void* s) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(d);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(s));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's tile: rows [h0, h0+R), columns [w0, w0+WB), channel pairs
// [p0, p0+PG) of sample b, frames [t0, t1).
struct Tile {
  int b, t0, t1, h0, w0, p0;
};

struct Plan {
  int R, WB, PG, TT;
  int n_strip, n_wt, n_pg, n_tseg;
  int pairs;  // channel pairs are staged by cp.async (C even, aligned)

  // work items of one channel group, in the order (b, frame segment, row
  // strip, column tile)
  __device__ __forceinline__ Tile tile(int item, int pg, int Tn) const {
    Tile tl;
    tl.w0 = (item % n_wt) * WB;
    item /= n_wt;
    tl.h0 = (item % n_strip) * R;
    item /= n_strip;
    tl.t0 = (item % n_tseg) * TT;
    tl.t1 = min(tl.t0 + TT, Tn);
    tl.b = item / n_tseg;
    tl.p0 = pg * PG;
    return tl;
  }
};

// The act kernels' activation of a staged pair v, stored in place at p: a
// = relu(x*sc + bi) rounded to T, the value act() returns, as the stencil
// reads it.
template <typename T>
__device__ __forceinline__ void act_store(T* p, float2 v, float2 sc,
                                          float2 bi) {
  const float a0 = relu(bn_apply(v.x, sc.x, bi.x));
  const float a1 = relu(bn_apply(v.y, sc.y, bi.y));
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a0, a1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a0, a1);
  }
}

// Staged rows an act kernel activates at a time (act_column): their loads
// are issued together, ahead of their stores (a store may alias a later
// load, so the compiler keeps them in order), and no row waits for the
// last row's store. Three rows at a time, or rows in a runtime loop, made
// the act kernels slower on the card (PERF.md).
constexpr int ACT_ROWS = 2;

// Activates in place ACT_ROWS staged pairs p + rr * rowlen of one column,
// rr = r0 .. r0 + ACT_ROWS - 1 below NR, whose input rows hs + rr lie in
// [0, H).
template <int NR, typename T>
__device__ __forceinline__ void act_group(T* p, int r0, int hs, int H,
                                          int rowlen, float2 sc, float2 bi) {
  float2 v[ACT_ROWS];
#pragma unroll
  for (int q = 0; q < ACT_ROWS; ++q)
    if (r0 + q < NR && (unsigned)(hs + r0 + q) < (unsigned)H)
      v[q] = load_pair(p + (r0 + q) * rowlen);
#pragma unroll
  for (int q = 0; q < ACT_ROWS; ++q)
    if (r0 + q < NR && (unsigned)(hs + r0 + q) < (unsigned)H)
      act_store(p + (r0 + q) * rowlen, v[q], sc, bi);
}

// Activates in place one staged column's pairs of the NR staged rows whose
// input rows lie in the frame, ACT_ROWS at a time; ROLLED keeps the groups
// in a runtime loop (for an instantiation that would spill unrolled).
template <int NR, bool ROLLED = false, typename T>
__device__ __forceinline__ void act_column(T* p, int hs, int H, int rowlen,
                                           float2 sc, float2 bi) {
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int r0 = 0; r0 < NR; r0 += ACT_ROWS)
      act_group<NR>(p, r0, hs, H, rowlen, sc, bi);
  } else {
#pragma unroll
    for (int r0 = 0; r0 < NR; r0 += ACT_ROWS)
      act_group<NR>(p, r0, hs, H, rowlen, sc, bi);
  }
}

// bn1's apply vectors of channel pair c (zero past C: relu(0*0 + 0) = 0)
__device__ __forceinline__ void pair_vecs(float2& scp, float2& bip,
                                          const float* __restrict__ sc,
                                          const float* __restrict__ bi,
                                          int c, int C) {
  scp = make_float2(c < C ? sc[c] : 0.f, c + 1 < C ? sc[c + 1] : 0.f);
  bip = make_float2(c < C ? bi[c] : 0.f, c + 1 < C ? bi[c + 1] : 0.f);
}

// The act kernels' pipeline (act_fwd_s1_kernel, act_wgrad_s1_kernel,
// act_s2_fwd_kernel, act_s2_wgrad_kernel): a ring of NSTAGE_ACT frames in
// which each thread activates in place the pairs it copied of frame i + 1
// (own(i + 1)) while the block reads frame i, between the same two
// barriers: the activation's loads and stores overlap other warps'
// stencils, and barrier i + 1 makes it visible before anyone reads it. Rows and columns outside the frame are
// never copied, so they are never activated and stay the zero the ring is
// cleared to: the padding is the zero of a, not relu(bi), for every sc and
// bi, with no mask. A pair is activated once, where an activation as read
// would take it three times at stride 1 and 1.5 times at stride 2.
//
// Commit group i holds the copies of frame i; load(i) commits one, empty
// past the last frame. Before the frame loop: load(0 .. NSTAGE_ACT - 2),
// then act_own(own, 0). Step i: the barrier, load(i + NSTAGE_ACT - 1) into
// frame i - 1's slot (read by no one since the barrier), act_own(own, i +
// 1) (another slot), then frame i's stencil. Slots i - 1, i and i + 1 are
// three of the four; frame i + 1's copies were committed two steps before
// its activation.
template <typename OWN>
__device__ __forceinline__ void act_own(OWN own, int i) {
  cp_wait<NSTAGE_ACT - 2>();  // groups 0 .. i have landed
  own(i);
}

// Zeroes the block's ring (bytes, a multiple of 16) and synchronises: the
// rows and columns of a tile that lie outside the frame are never copied, so
// they read as the zero padding for the whole tile.
__device__ __forceinline__ void zero_ring(unsigned char* ring, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(ring + i) = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// Elements of one staged frame of `rows` rows, padded to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int stage_elems(int rows, int WB, int PG) {
  return (rows * (WB + 2) * 2 * PG * (int)sizeof(T) + 15) / 16 * 16 /
         (int)sizeof(T);
}

// The stencil of one staged input frame at the thread's column and channel
// pair: for staged row rr (input row h0 - 1 + rr) and output row r with dy =
// rr - r in [0, 2], the 3 taps dx of each dt meet the 3 neighbours. FN(j, r,
// dy, dx, v) does one multiply-add; everything is unrolled, so the loop has
// no branch and the shared-memory reads of a row can run ahead.
template <typename T, int R, typename FN>
__device__ __forceinline__ void stencil_frame(const T* tile, int rowlen,
                                              int PG2, FN fn) {
#pragma unroll
  for (int rr = 0; rr < R + 2; ++rr) {
    const T* row = tile + rr * rowlen;
    const float2 v[3] = {load_pair(row), load_pair(row + PG2),
                         load_pair(row + 2 * PG2)};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dy = rr - r;
      if (dy < 0 || dy > 2) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) fn(j, r, dy, dx, v[dx]);
    }
  }
}

// The row-strip weight gradients' rule (K6 and K10, plain, act and mm): a
// product is added only where the register ring holds a g element of the
// item. While the item's x frame i of nf (frame t0 - 1 + i) is read, ring
// slot j holds g frame t0 - 2 + i + j, which lies in the item's segment
// [t0, t1) only for 2 <= i + j <= nf - 1 (bit j of wgrad_slots); output
// row r exists only for r < nr (a ragged last strip has nr < R), and the
// thread's column only within the frame. Elsewhere the ring holds a zero,
// and x * 0 would turn a NaN of x into a NaN of a tap that no output
// position reaches: the neighbouring item, or no item, adds the real
// product. For finite x, fmaf(x, 0, acc) == acc, so skipping moves no sum.
// All slots are admitted but on an item's first two and last two frames;
// the slots and nr are uniform across the block.
__device__ __forceinline__ unsigned wgrad_slots(int i, int nf) {
  unsigned m = 0u;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (i + j >= 2 && i + j <= nf - 1) m |= 1u << j;
  return m;
}

// stencil_frame under the rule: the ring slots j of bit j of slots, the
// output rows r < nr, each a block-uniform branch. Each tap (j, dy, dx)
// takes its products over r, so over staged rows rr = r + dy, ascending:
// stencil_frame's order. The variant runs on an item's edge frames and in
// a ragged strip only. ROWS_ONCE reads each staged row once per admitted
// slot; without it a row is read for each (j, r, dy) that meets it, so no
// more than three pairs are live at a time, for builds without registers
// to spare (the act modes).
template <typename T, int R, bool ROWS_ONCE, typename FN>
__device__ __forceinline__ void stencil_frame_masked(const T* tile,
                                                     int rowlen, int PG2,
                                                     FN fn, unsigned slots,
                                                     int nr) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (!((slots >> j) & 1u)) continue;
    if constexpr (ROWS_ONCE) {
#pragma unroll
      for (int rr = 0; rr < R + 2; ++rr) {
        const T* row = tile + rr * rowlen;
        const float2 v[3] = {load_pair(row), load_pair(row + PG2),
                             load_pair(row + 2 * PG2)};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int dy = rr - r;
          if (dy < 0 || dy > 2 || r >= nr) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) fn(j, r, dy, dx, v[dx]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) break;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const T* row = tile + (r + dy) * rowlen;
          const float2 v[3] = {load_pair(row), load_pair(row + PG2),
                               load_pair(row + 2 * PG2)};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) fn(j, r, dy, dx, v[dx]);
        }
      }
    }
  }
}

// One thread's share of staging a stride-1 tile (dw_plain_s1.cu,
// dw_dx_s1.cu): its channel pair c at staged columns wl and, for wl < 2,
// WB + wl (input columns w0 - 1 + that), every row (the stencil's input,
// with its column halo), or at staged column wl + 1 only (a tensor read at
// the thread's own column). Slot and source offsets within a row are fixed
// for the tile, so a frame costs the thread (rows) x (1 or 2) copies and no
// index arithmetic.
struct Stager {
  int src0, src1, dst0, dst1, PG2, C;
  bool u0, u1, uc, pairs, second;

  __device__ __forceinline__ Stager(const Tile& tl, int wl, int pi, int WB,
                                    int PG2_, int W, int C_, bool pairs_)
      : PG2(PG2_), C(C_), pairs(pairs_) {
    const int c = 2 * (tl.p0 + pi);
    const int g0 = tl.w0 - 1 + wl, g1 = tl.w0 - 1 + WB + wl;
    u0 = wl < WB && g0 >= 0 && g0 < W && c < C;
    u1 = wl < 2 && g1 < W && c < C;
    uc = wl < WB && g0 + 1 < W && c < C;
    src0 = g0 * C + c;
    src1 = g1 * C + c;
    dst0 = wl * PG2 + 2 * pi;
    dst1 = (WB + wl) * PG2 + 2 * pi;
    second = c + 1 < C;
  }

  // rows [hs, hs + nr) of frame f (H, W, C), clipped to the frame, into
  // dst laid out [nr][WB + 2][2PG]: every staged column (halo) or only the
  // thread's own (column wl + 1)
  template <typename T>
  __device__ __forceinline__ void rows(T* dst, const T* f, int hs, int nr,
                                       int H, int W, int rowlen,
                                       bool halo) const {
    const int lo = max(hs, 0), hi = min(hs + nr, H);
    for (int h = lo; h < hi; ++h) {
      const T* src = f + (size_t)h * W * C;
      T* d = dst + (h - hs) * rowlen;
      if (halo) {
        if (u0) copy_pair(d + dst0, src + src0, pairs, second);
        if (u1) copy_pair(d + dst1, src + src1, pairs, second);
      } else if (uc) {
        copy_pair(d + dst0 + PG2, src + src0 + C, pairs, second);
      }
    }
  }

  // The act kernels: activates in place the pairs rows(dst, ., hs, NR, H,
  // ., rowlen, true) copied: column by column, ACT_ROWS rows at a time
  // (ROLLED: act_column's)
  template <int NR, bool ROLLED = false, typename T>
  __device__ __forceinline__ void act_rows(T* dst, int hs, int H,
                                           int rowlen, float2 sc,
                                           float2 bi) const {
    if (u0) act_column<NR, ROLLED>(dst + dst0, hs, H, rowlen, sc, bi);
    if (u1) act_column<NR, ROLLED>(dst + dst1, hs, H, rowlen, sc, bi);
  }
};

// The end of a weight gradient's walk: a fixed-order sum over the block's
// columns, red[tap][wl][2PG] in smem, then slot (tap, channel) adds its WB
// columns in order and writes row blockIdx.x of the (rows, 27, C) partial
// buffer for channel group blockIdx.y. Every thread calls it; the caller
// synchronised after its last read of smem.
__device__ __forceinline__ void wgrad_partials(const float (&acc)[27][2],
                                               float* __restrict__ part,
                                               unsigned char* smem, int WB,
                                               int PG, int C) {
  const int PG2 = 2 * PG, tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG, pg = blockIdx.y;
  const size_t row = blockIdx.x;
  float* red = reinterpret_cast<float*>(smem);
  if (wl < WB) {
#pragma unroll
    for (int i = 0; i < 27; ++i) {
      red[(i * WB + wl) * PG2 + 2 * pi] = acc[i][0];
      red[(i * WB + wl) * PG2 + 2 * pi + 1] = acc[i][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < 27 * PG2; i += blockDim.x) {
    const int tap = i / PG2, s = i % PG2;
    const int ch = 2 * pg * PG + s;
    if (ch >= C) continue;
    float sum = 0.f;
    for (int q = 0; q < WB; ++q) sum += red[(tap * WB + q) * PG2 + s];
    part[(row * 27 + tap) * C + ch] = sum;
  }
}

// The plan's derived counts, or false where the kernels do not take it.
template <typename T>
bool make_plan(Plan& p, uintptr_t ptrs, int B, int Tn, int H, int W, int C,
               int R, int WB, int PG, int TT) {
  if (B < 1 || Tn < 1 || H < 1 || W < 1 || C < 1) return false;
  if (R < RMIN || R > RMAX || WB < 1 || PG < 1 || TT < 1) return false;
  // the halo columns WB and WB+1 are staged by the threads of columns 0
  // and 1, so a block has two columns unless the frame has one
  if (WB * PG > NT_MAX || WB > W || (WB < 2 && W > 1)) return false;
  const int esz = (int)sizeof(T), P2 = (C + 1) / 2;
  if (PG > P2) return false;
  p.R = R;
  p.WB = WB;
  p.PG = PG;
  p.TT = TT;
  p.n_strip = cdiv(H, R);
  p.n_wt = cdiv(W, WB);
  p.n_pg = cdiv(P2, PG);
  p.n_tseg = cdiv(Tn, TT);
  // pairs by cp.async where every pair is aligned to its size
  p.pairs = C % 2 == 0 && ptrs % (2 * esz) == 0;
  return true;
}

inline int threads_of(const Plan& p) { return (p.WB * p.PG + 31) / 32 * 32; }

// Blocks per SM a kernel reaches with its threads and dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
template <typename K>
int blocks_per_sm(K kern, size_t smem, int threads) {
  int n = -1;
  cudaError_t e = (cudaError_t)set_smem(kern, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                      smem);
  return e == cudaSuccess ? n : -1;
}


}  // namespace cfn
