// The mm forward at stride 1 for Hopper (sm_90a), K1 mm:
//
//   y = dwconv3x3x3( relu( (x @ W1) * sc + bi ) )
//
// (dw_mm_act_s1, mm_fwd_s1_kernel). x (B,T,H,W,C_in) and y (B,T,H,W,C_mid)
// are channels-last, f32 or bf16; W1 (C_in,C_mid) and the depthwise taps
// (27,C_mid) have x's dtype; sc/bi are f32 per-channel batch-norm apply
// vectors of bn1 (running statistics in eval, batch statistics in the train
// composite). The mm forward at stride (1,2,2), K4 mm (dw_mm_act_s2), is
// K4 plain's back end in dw_plain_s2.cu; the act and plain modes of both
// strides are in dw_plain_s1.cu and dw_plain_s2.cu.
//
// Replaces the mm mode of the TPU Pallas kernel
// coarse_fine_networks_tpu/ops/pallas/dw_fold.py: _dw_fold4_pcall ->
// _fwd_kernel (stride 1, mode mm), with the tile prologue _mm_act_tile.
// Semantics kept from it:
//   * the activation a is computed in f32 and rounded to x's dtype before
//     the stencil (the TPU tile is stored in x.dtype);
//   * positions outside the tensor are zero AFTER the activation (SAME
//     padding), never relu(bi) (_rezero_frame);
//   * the 27-tap sum accumulates in f32 and is written in x's dtype.
// The fold4 lane layout is TPU mechanics and is not carried over.
//
// What bounds it on this card: bytes. One read of x and one write of y per
// call is the floor; the product costs C_in MACs and the stencil 27 MACs per
// output element, far below the ~295 operations per byte where the H100's
// bf16 tensor cores would become the limit.
//
// What the design does about it: the activated tensor never goes to device
// memory (not even the C_mid product, 2.25x the bytes of x). dw_plain_s1.cu's
// row strips (a halo of (R+2)/R rows and no columns), W1's column group
// staged once per block, x staged whole by cp.async three frames deep, and
// conv1's product on the bf16 tensor cores (mma.m16n8k16, common.cuh) with
// its relu branch settled against mm_z_fmaf's in-order sum (mm_band); the
// staging and the product are mm_strip.cuh's, shared with K2 (dw_dx_s1.cu),
// K6 mm (dw_plain_s1.cu), K4 mm, K9 and K10 mm (dw_plain_s2.cu). Moving the product to
// wgmma and the staging to TMA is later work.

#include "mm_strip.cuh"

namespace {

using namespace cfn;

// ---- the mm forward at stride 1 (K1 mm): row strips, conv1 on mma ----------
// A block owns one tile of strip.cuh's layout (ops/dw_conv.py:plan_s1 over
// C_mid): R output rows x WB columns x PG channel pairs of one sample over
// TT frames. Per input frame it stages the R+2 rows of x (all C_in, the
// columns [cs0, cs1) its outputs and their halo read) by cp.async into a
// ring of XSTAGE_MM frames, computes conv1's product there (mm_activate,
// mm_strip.cuh, which the stride-1 masked dx shares: bf16 16 x 8 tiles on
// the tensor cores, each relu input within mm_band of 0 summed again in
// order by mm_z_fmaf; f32 fmaf over k in order, as mm_z_fmaf), applies
// bn1 and the relu, rounds to T and writes the
// activated frame into one of two slots [R+2][WB+2][2PG] (the layout
// dw_plain_s1.cu's forward stages x in); the stencil then walks the slot as
// that forward does (a channel pair per thread, a register ring of the 3
// output frames).
// In one step, between two barriers, the block copies x frame i+2, computes
// the product of frame i and the stencil of frame i-1. Rows and columns
// outside the frame are never written and stay the zero the slots are
// cleared to (SAME padding after the activation).
// Thread (wl, pi) = (tid / PG, tid % PG): column w0 + wl, channels c, c+1
// with c = 2*(p0 + pi), as in dw_plain_s1.cu's forward.
template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
mm_fwd_s1_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ k, const float* __restrict__ sc,
                 const float* __restrict__ bi, T* __restrict__ y, int Tn,
                 int H, int W, int Cin, int Cmid, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = (WB + 2) * PG2;
  const MmLayout L = mm_layout<T>(R, WB, PG, Cin, W);
  T* act_s = reinterpret_cast<T*>(smem_raw);  // [2][R+2][WB+2][2PG]
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs_off);
  T* wt = reinterpret_cast<T*>(smem_raw + L.wt_off);
  float* scs = reinterpret_cast<float*>(smem_raw + L.vec_off);
  float* bis = scs + (L.ng + 3) / 4 * 4;
  float* kbs = bis + (L.ng + 3) / 4 * 4;
  int* tab = reinterpret_cast<int*>(smem_raw + L.tab_off);
  const int aslot = L.aslot / (int)sizeof(T), xslot = L.xslot / (int)sizeof(T);
  const int ld = L.ld;

  const int blk = blockIdx.x;
  const int pg = blk % pl.n_pg;
  const Tile tl = pl.tile(blk / pl.n_pg, pg, Tn);
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int w = tl.w0 + wl;
  const int c0 = 2 * tl.p0, c = c0 + 2 * pi;
  const bool in = wl < WB;
  const bool live = in && w < W && c < Cmid;  // owns outputs
  const bool second = c + 1 < Cmid;

  float k0[27], k1[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    k0[i] = live ? to_f(k[i * Cmid + c]) : 0.f;
    k1[i] = live && second ? to_f(k[i * Cmid + c + 1]) : 0.f;
  }

  // the tile's staged rectangle of x (mm_strip.cuh): input rows h0-1 ..
  // h0+R+1, columns w0-1 .. w0+WB+1
  const MmRect mt(tl.h0 - 1, R + 2, tl.w0 - 1, WB + 2, H, W, Cin, ld,
                  16 / (int)sizeof(T));

  zero_ring(smem_raw, L.wt_off);  // both slots and the x ring
  // W1's columns c0 .. c0 + ng (zero past C_mid and past the group, and in
  // bf16 past C_in), bn1's apply vectors, and each staged position's place
  // in a slot, once per block
  mm_stage_vecs(scs, bis, kbs, sc, bi, Cmid, c0, PG2, L.ng,
                mm_band((ld - 8) / 16, Cin));
  mm_stage_w1<T>(wt, w1, Cin, Cmid, c0, PG2, L.ng, ld);
  mt.table(tab, L.rows, [&](int rr, int col) {
    return (rr * (WB + 2) + col - tl.w0 + 1) * PG2;
  });

  const size_t frame = (size_t)H * W * Cin;
  // x rows of the strip, from staged row 0 (input row h0 - 1) and column
  // cs0, of sample b
  const T* xb = x + (size_t)tl.b * Tn * frame +
                ((long long)(tl.h0 - 1) * W + mt.cs0) * Cin;
  const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;  // input frames
  // x frame f0 + i (its rows in the frame) into ring slot i % XSTAGE_MM
  auto stage_x = [&](int i) {
    const int ti = f0 + i;
    if (i < nf && ti >= 0 && ti < Tn)  // uniform across the block
      mt.stage(xs + (i % XSTAGE_MM) * xslot, xb + (size_t)ti * frame, W, Cin,
               ld);
    cp_commit();
  };

  float acc[3][R][2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r][0] = acc[j][r][1] = 0.f;

  for (int i = 0; i < XSTAGE_MM - 1; ++i) stage_x(i);
  for (int i = 0; i <= nf; ++i) {
    cp_wait<XSTAGE_MM - 2>();  // this thread's copies of x frame i landed
    __syncthreads();  // and everyone's; slot i-1 is written; slot i, and x
                      // ring slot i-1, are read by no one
    stage_x(i + XSTAGE_MM - 1);
    // conv1's product of x frame f0 + i, bn1, relu rounded to T ->
    // activated slot i % 2
    if (i < nf && f0 + i >= 0 && f0 + i < Tn)
      mm_activate<T>(act_s + (i & 1) * aslot, xs + (i % XSTAGE_MM) * xslot,
                     wt, L, PG, mt.M, Cin, scs, bis, kbs, tab);
    if (i == 0) continue;
    const int ti = f0 + i - 1;  // the frame the stencil reads now
    if (ti >= 0 && ti < Tn && in)  // frames outside the clip add nothing
      stencil_frame<T, R>(
          act_s + ((i - 1) & 1) * aslot + wl * PG2 + 2 * pi, rowlen, PG2,
          [&](int j, int r, int dy, int dx, float2 v) {
            const int tap = ((2 - j) * 3 + dy) * 3 + dx;
            acc[j][r][0] = fmaf(k0[tap], v.x, acc[j][r][0]);
            acc[j][r][1] = fmaf(k1[tap], v.y, acc[j][r][1]);
          });
    const int to = ti - 1;  // complete now
    if (to >= tl.t0 && live) {
      T* yo = y + (((size_t)tl.b * Tn + to) * H + tl.h0) * W * Cmid +
              (size_t)w * Cmid + c;
      const bool pair = second && !(Cmid & 1);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tl.h0 + r < H)
          store_pair(yo + (size_t)r * W * Cmid, acc[0][r][0], acc[0][r][1],
                     pair, second);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[0][r][0] = acc[1][r][0];
      acc[0][r][1] = acc[1][r][1];
      acc[1][r][0] = acc[2][r][0];
      acc[1][r][1] = acc[2][r][1];
      acc[2][r][0] = acc[2][r][1] = 0.f;
    }
  }
  cp_wait<0>();
}

template <typename T>
decltype(&mm_fwd_s1_kernel<T, RMAX>) mm_kernel_of(int R) {
  switch (R) {
    case 2: return mm_fwd_s1_kernel<T, 2>;
    case 3: return mm_fwd_s1_kernel<T, 3>;
    case 4: return mm_fwd_s1_kernel<T, 4>;
  }
  return nullptr;
}

template <typename T>
int launch_mm_s1(const void* x, const void* w1, const void* k, const void* sc,
                 const void* bi, void* y, int B, int Tn, int H, int W,
                 int Cin, int Cmid, int R, int WB, int PG, int TT,
                 cudaStream_t st) {
  Plan p;
  if (!make_plan<T>(p, (uintptr_t)x, B, Tn, H, W, Cmid, R, WB, PG, TT) ||
      Cin < 8 || Cin % 8 || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  const auto kern = mm_kernel_of<T>(R);
  const int smem = mm_layout<T>(R, WB, PG, Cin, W).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (int e = set_smem(kern, smem)) return e;
  const long long blocks =
      (long long)B * p.n_tseg * p.n_strip * p.n_wt * p.n_pg;
  kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(k), static_cast<const float*>(sc),
      static_cast<const float*>(bi), static_cast<T*>(y), Tn, H, W, Cin, Cmid,
      p);
  return (int)cudaGetLastError();
}

template <typename T>
int mm_occupancy(int R, int WB, int PG, int Cin, int W) {
  if (R < RMIN || R > RMAX || WB < 1 || PG < 1 || WB * PG > NT_MAX ||
      Cin < 8 || W < 1)
    return -1;
  const auto kern = mm_kernel_of<T>(R);
  const int smem = mm_layout<T>(R, WB, PG, Cin, W).total;
  if (smem > SMEM_MAX) return -1;
  int n = -1;
  cudaError_t e = (cudaError_t)set_smem(kern, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, (WB * PG + 31) / 32 * 32, smem);
  return e == cudaSuccess ? n : -1;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after the launch: 0 means the kernel was launched.
// (R, WB, PG, TT) is the wrapper's split over C_mid (ops/dw_conv.py:
// plan_s1): R output rows, WB columns and PG channel pairs per block, TT
// frames per segment.
extern "C" int dw_mm_act_s1(const void* x, const void* w1, const void* wdw,
                            const void* sc, const void* bi, void* y, int B,
                            int T, int H, int W, int Cin, int Cmid, int R,
                            int WB, int PG, int TT, int is_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mm_s1<__nv_bfloat16>(x, w1, wdw, sc, bi, y, B, T, H, W, Cin,
                                       Cmid, R, WB, PG, TT, st);
  return launch_mm_s1<float>(x, w1, wdw, sc, bi, y, B, T, H, W, Cin, Cmid, R,
                             WB, PG, TT, st);
}

// Blocks per SM mm_fwd_s1_kernel reaches at a plan (R, WB, PG), C_in and
// the frame's width W, with its threads and shared memory, or -1 where it
// does not take them.
extern "C" int dw_mm_act_s1_occupancy(int R, int WB, int PG, int Cin, int W,
                                      int is_bf16) {
  return is_bf16 ? mm_occupancy<__nv_bfloat16>(R, WB, PG, Cin, W)
                 : mm_occupancy<float>(R, WB, PG, Cin, W);
}
