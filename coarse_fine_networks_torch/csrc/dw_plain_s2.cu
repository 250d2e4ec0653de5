// The plain depthwise 3x3x3 conv at stride (1,2,2) of the split-batch-norm
// training route: its weight gradient, for Hopper (sm_90a):
//
//   dw_conv_wgrad_s2  dk[dt,dy,dx,c] = sum_{t,h,w} x_pad[t+dt, 2h+dy, 2w+dx, c]
//                                      * g[t,h,w,c]
//                     per block an f32 partial row (27, C)
//
// x is channels-last (B,T,H,W,C), g (B,T,Ho,Wo,C) with Ho = (H-1)/2 + 1,
// f32 or bf16; x_pad is x zero-padded by one on T, H and W. Every sum is in
// f32.
//
// Replaces the plain mode of the TPU Pallas kernel K10 of
// coarse_fine_networks_tpu/ops/pallas/dw_fold.py:
//   * dw_conv_wgrad_s2 <- _wgrad_s2_pcall (:1279) -> _wgrad_s2_kernel
//                         (:1122), plain mode.
// The fold4 lane layout and its even/odd de-interleave are TPU mechanics
// and are not carried over.
//
// What bounds it on this card: bytes. It reads x once (4x the elements of
// g) and g once, and does 27 MACs per element of g, far below the ~295
// operations per byte where the tensor cores would matter.
//
// What the design does about it (the layout of dw_plain_s1.cu's weight
// gradient, strip.cuh, over the output's rows and columns):
//   * A block owns R output rows x WB output columns (all Wo where Wo <=
//     256) x a group of PG channel pairs of one sample over TT frames. Its
//     input is the 2R+1 rows 2h0-1 .. 2h0+2R-1 at the 2WB+1 columns
//     2w0-1 .. 2w0+2WB-1: a halo of (2R+1)/2R rows and one column per
//     tile.
//   * Input rows are staged at full resolution into a shared-memory ring of
//     NSTAGE frames in x's dtype by cp.async, one commit group per frame
//     (the frame's g rows with it), so frame t+2 loads while frame t is
//     read. A staged row is stored de-interleaved: its even columns (input
//     columns 2(w0+e)-1, e = 0..WB) then its odd ones (2(w0+e)). The thread
//     of output column w0+wl reads even e = wl, odd e = wl and even e =
//     wl+1, so the words a warp reads are consecutive at every PG (no bank
//     conflict at C = 54, 108, 216 or 432, where a plain row would give a
//     stride of 2PG words between neighbouring columns). Each thread copies
//     the pair it reads (even and odd column wl; the threads of column 0
//     also the last even column), so a frame costs it 2-3 copies per row and
//     no index arithmetic.
//   * A thread owns one channel pair at one output column. A staged row read
//     once (3 pair reads) serves the one or two output rows it meets (dy =
//     rr - 2r), over the 3 frames of a register ring of g along T: (2R+1)*3
//     shared-memory reads per frame for 27 x 2 x R multiply-adds. g is read
//     once per output, coalesced along channels, and kept in that ring.
//   * The 27 x 2 sums stay in registers over the block's whole walk. The
//     grid is persistent: each block walks IPB consecutive work items
//     (sample, frame segment, row strip, column tile) of its channel group,
//     then sums its threads' columns in a fixed order and writes one partial
//     row; the wrapper adds the rows with one torch.sum, so runs repeat bit
//     for bit and nothing uses atomics.
//   * Rows and columns outside the frame are never copied and read as the
//     zero the ring is cleared to once per item; with R a template argument
//     (2..4) the loop over staged rows is fully unrolled and has no branch.
// The split (R, WB, PG, TT, IPB and the row count) is computed by the
// wrapper (ops/dw_conv.py:plan_s2) and checked here; a plan the kernel does
// not take returns cudaErrorInvalidValue.

#include "strip.cuh"

namespace {

using namespace cfn;

// One thread's share of staging a tile of output columns [w0, w0+WB): its
// channel pair c at the de-interleaved staged columns even wl (input column
// 2(w0+wl)-1), odd wl (2(w0+wl)) and, for wl == 0, even WB (2(w0+WB)-1), on
// every x row; and at column wl of every g row.
struct S2Stager {
  int srcE, srcO, srcX, dstE, dstO, dstX, srcG, C;
  bool uE, uO, uX, uG, pairs, second;

  __device__ __forceinline__ S2Stager(const Tile& tl, int wl, int pi, int WB,
                                      int PG2, int W, int Wo, int C_,
                                      bool pairs_)
      : C(C_), pairs(pairs_) {
    const int c = 2 * (tl.p0 + pi);
    const bool in = wl < WB && c < C;
    const int gE = 2 * (tl.w0 + wl) - 1, gX = 2 * (tl.w0 + WB) - 1;
    uE = in && gE >= 0 && gE < W;
    uO = in && gE + 1 < W;
    uX = wl == 0 && c < C && gX < W;
    uG = in && tl.w0 + wl < Wo;
    srcE = gE * C + c;
    srcO = srcE + C;
    srcX = gX * C + c;
    srcG = (tl.w0 + wl) * C + c;
    dstE = wl * PG2 + 2 * pi;
    dstO = (WB + 1) * PG2 + dstE;
    dstX = WB * PG2 + 2 * pi;
    second = c + 1 < C;
  }

  // x rows [hs, hs + nr) of frame f (H, W, C), clipped to the frame, into
  // dst laid out [nr][2][WB + 1][2PG]
  template <typename T>
  __device__ __forceinline__ void x_rows(T* dst, const T* f, int hs, int nr,
                                         int H, int W, int rowlen) const {
    const int lo = max(hs, 0), hi = min(hs + nr, H);
    for (int h = lo; h < hi; ++h) {
      const T* src = f + (size_t)h * W * C;
      T* d = dst + (h - hs) * rowlen;
      if (uE) copy_pair(d + dstE, src + srcE, pairs, second);
      if (uO) copy_pair(d + dstO, src + srcO, pairs, second);
      if (uX) copy_pair(d + dstX, src + srcX, pairs, second);
    }
  }

  // g rows [h0, h0 + nr) of frame f (Ho, Wo, C), clipped, into dst laid out
  // [nr][WB][2PG] (the thread's own column and pair)
  template <typename T>
  __device__ __forceinline__ void g_rows(T* dst, const T* f, int h0, int nr,
                                         int Ho, int Wo, int growlen) const {
    if (!uG) return;
    const int hi = min(h0 + nr, Ho);
    for (int h = h0; h < hi; ++h)
      copy_pair(dst + (h - h0) * growlen + dstE,
                f + (size_t)h * Wo * C + srcG, pairs, second);
  }
};

// Elements of one staged x frame (2R+1 rows) and one g frame (R rows),
// each padded to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int xstage_elems(int R, int WB, int PG) {
  return ((2 * R + 1) * 2 * (WB + 1) * 2 * PG * (int)sizeof(T) + 15) / 16 *
         16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ __forceinline__ int gstage_elems(int R, int WB, int PG) {
  return (R * WB * 2 * PG * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
}

// Thread (wl, pi) = (tid / PG, tid % PG): output column w0 + wl, channels
// c, c+1 with c = 2*(p0 + pi). Slot i of the ring holds x frame f0 + i
// (staged rows rr = 0..2R: input row 2h0 - 1 + rr) and g frame f0 + i + 1
// (rows h0 .. h0+R-1). While x frame ti is read, gr[j][r] holds g frame
// ti - 1 + j of output row h0 + r (zero outside [t0, t1) and the frame):
// x frame ti pairs with it through tap dt = 2 - j, and staged row rr with
// output row r through dy = rr - 2r.
template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_s2_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ part, int Tn, int H, int W, int Ho,
                      int Wo, int C, Plan pl, int n_items, int ipb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = 2 * (WB + 1) * PG2, growlen = WB * PG2;
  const int xstage = xstage_elems<T>(R, WB, PG);
  const int stage = xstage + gstage_elems<T>(R, WB, PG);

  const int pg = blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const bool in = wl < WB;
  const size_t xframe = (size_t)H * W * C, gframe = (size_t)Ho * Wo * C;
  // the thread's even column wl, odd column wl and even column wl + 1
  const int atE = wl * PG2 + 2 * pi, atO = (WB + 1) * PG2 + atE;

  float acc[27][2];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int row = blockIdx.x;
  const int it1 = min((row + 1) * ipb, n_items);
  for (int item = row * ipb; item < it1; ++item) {
    const Tile tl = pl.tile(item, pg, Tn);
    const T* xb = x + (size_t)tl.b * Tn * xframe;
    const T* gb = g + (size_t)tl.b * Tn * gframe;
    const S2Stager sg(tl, wl, pi, WB, PG2, W, Wo, C, pl.pairs);
    const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;
    auto load = [&](int i) {
      if (i < nf) {  // uniform across the block
        T* slot = ring + (i % NSTAGE) * stage;
        const int ti = f0 + i, tg = ti + 1;
        if (ti >= 0 && ti < Tn)
          sg.x_rows(slot, xb + (size_t)ti * xframe, 2 * tl.h0 - 1, 2 * R + 1,
                    H, W, rowlen);
        if (tg >= tl.t0 && tg < tl.t1)
          sg.g_rows(slot + xstage, gb + (size_t)tg * gframe, tl.h0, R, Ho,
                    Wo, growlen);
      }
      cp_commit();
    };

    float gr[3][R][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) gr[j][r][0] = gr[j][r][1] = 0.f;

    zero_ring(smem_raw, NSTAGE * stage * (int)sizeof(T));
    for (int i = 0; i < NSTAGE - 1; ++i) load(i);
    for (int i = 0; i < nf; ++i) {
      cp_wait<NSTAGE - 2>();  // this thread's copies of frame i have landed
      __syncthreads();        // and everyone's; slot i-1 is read by no one
      load(i + NSTAGE - 1);   // into slot i-1
      const int ti = f0 + i, tg = ti + 1;
      const T* slot = ring + (i % NSTAGE) * stage;
      const bool gin = in && tg >= tl.t0 && tg < tl.t1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gr[0][r][0] = gr[1][r][0];
        gr[0][r][1] = gr[1][r][1];
        gr[1][r][0] = gr[2][r][0];
        gr[1][r][1] = gr[2][r][1];
        const float2 v = gin ? load_pair(slot + xstage + r * growlen + atE)
                             : make_float2(0.f, 0.f);
        gr[2][r][0] = v.x;
        gr[2][r][1] = v.y;
      }
      if (ti >= 0 && ti < Tn && in) {  // frames outside the clip add nothing
#pragma unroll
        for (int rr = 0; rr < 2 * R + 1; ++rr) {
          const T* sr = slot + rr * rowlen;
          const float2 v[3] = {load_pair(sr + atE), load_pair(sr + atO),
                               load_pair(sr + atE + PG2)};
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dy = rr - 2 * r;
            if (dy < 0 || dy > 2) continue;
#pragma unroll
            for (int j = 0; j < 3; ++j)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const int tap = ((2 - j) * 3 + dy) * 3 + dx;
                acc[tap][0] = fmaf(v[dx].x, gr[j][r][0], acc[tap][0]);
                acc[tap][1] = fmaf(v[dx].y, gr[j][r][1], acc[tap][1]);
              }
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();  // the next item zeroes and refills every slot
  }

  // fixed-order sum over the block's columns: red[tap][wl][2PG], then slot
  // (tap, channel) adds its WB columns in order and writes row blockIdx.x
  float* red = reinterpret_cast<float*>(smem_raw);
  if (in) {
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
    part[((size_t)row * 27 + tap) * C + ch] = sum;
  }
}

// ---- launchers -----------------------------------------------------------------

// Dynamic shared memory: the ring of x and g frames, or the column sums if
// larger.
template <typename T>
size_t wgrad_smem(int R, int WB, int PG) {
  const size_t ring = sizeof(T) * NSTAGE *
                      (xstage_elems<T>(R, WB, PG) + gstage_elems<T>(R, WB, PG));
  const size_t red = sizeof(float) * 27 * WB * 2 * PG;
  return ring > red ? ring : red;
}

// The kernel instantiation for R output rows (RMIN..RMAX), or null.
template <typename T>
decltype(&plain_s2_wgrad_kernel<T, RMAX>) kernel_of(int R) {
  switch (R) {
    case 2: return plain_s2_wgrad_kernel<T, 2>;
    case 3: return plain_s2_wgrad_kernel<T, 3>;
    case 4: return plain_s2_wgrad_kernel<T, 4>;
  }
  return nullptr;
}

template <typename T>
int launch_wgrad(const void* x, const void* g, void* part, int B, int Tn,
                 int H, int W, int C, int R, int WB, int PG, int TT, int ipb,
                 int rows, cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over the output's rows and columns
  if (!make_plan<T>(p, (uintptr_t)x | (uintptr_t)g, B, Tn, Ho, Wo, C, R, WB,
                    PG, TT) ||
      ipb < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * p.n_tseg * p.n_strip * p.n_wt;
  // every block has an item, and the blocks cover them all
  if (rows < 1 || (long long)rows * ipb < items ||
      (long long)(rows - 1) * ipb >= items)
    return (int)cudaErrorInvalidValue;
  const auto kern = kernel_of<T>(R);
  const size_t smem = wgrad_smem<T>(R, WB, PG);
  if (int e = set_smem(kern, smem)) return e;
  kern<<<dim3(rows, p.n_pg), threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(part), Tn, H, W, Ho, Wo, C, p, (int)items, ipb);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int R, int WB, int PG) {
  if (R < RMIN || R > RMAX || WB < 1 || PG < 1 || WB * PG > NT_MAX) return -1;
  const auto kern = kernel_of<T>(R);
  const size_t smem = wgrad_smem<T>(R, WB, PG);
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
//
// x is (B,T,H,W,C), g (B,T,(H-1)/2+1,(W-1)/2+1,C); part is (rows, 27, C)
// f32; block row r walks items [r*IPB, (r+1)*IPB). (R, WB, PG, TT) is the
// wrapper's split over the output: R rows, WB columns and PG channel pairs
// per item, TT frames per segment.
extern "C" int dw_conv_wgrad_s2(const void* x, const void* g, void* part,
                                int B, int T, int H, int W, int C, int R,
                                int WB, int PG, int TT, int ipb, int rows,
                                int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_wgrad<__nv_bfloat16>(x, g, part, B, T, H, W, C, R, WB, PG,
                                       TT, ipb, rows, st);
  return launch_wgrad<float>(x, g, part, B, T, H, W, C, R, WB, PG, TT, ipb,
                             rows, st);
}

// Blocks per SM the kernel reaches at a plan (R, WB, PG), with its threads
// and shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1
// where it does not take the plan.
extern "C" int dw_plain_s2_occupancy(int R, int WB, int PG, int is_bf16) {
  return is_bf16 ? occupancy<__nv_bfloat16>(R, WB, PG)
                 : occupancy<float>(R, WB, PG);
}
