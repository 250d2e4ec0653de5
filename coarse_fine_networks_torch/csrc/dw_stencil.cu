// Plain-layout depthwise 3-D stencils for Hopper (sm_90a):
//
//   dw_stencil_s1 (K11):  y[t,h,w,c] = sum_{dt,dy,dx} k[dt,dy,dx,c] *
//                             x[t+dt-PT, h+dy-PS, w+dx-PS, c]
//                         stride 1, zero padding PT = KT/2, PS = KS/2 (SAME)
//   dw_stencil_wgrad:     dk[dt,dy,dx,c] = sum_pos x_pad[pos + tap, c] g[pos, c]
//                         the taps' gradient of dw_stencil_s1; per block
//                         row an f32 partial (KT*KS*KS, C)
//
// x, y and g are channels-last (B,T,H,W,C), f32 or bf16; the taps k
// (KT*KS*KS, C) have x's dtype; every sum is in f32 and y is written in x's
// dtype. KT is odd and at most 7, KS = KH = KW is 1 or 3: the largest tap
// count is 7*3*3 = 63 (the stem's conv1_t is 5x1x1; (3,1,1), (3,3,3) and
// (1,3,3) are taken too); any other shape returns cudaErrorInvalidValue.
//
// Replaces a TPU Pallas kernel and an XLA reduction of the JAX package:
//   * dw_stencil_s1    <- coarse_fine_networks_tpu/ops/pallas/dw_conv.py
//                         _dw_pallas_raw -> _stencil_kernel (K11), also the
//                         dx of its custom VJP (_dw_bwd: the same stencil on
//                         g with the flipped taps);
//   * dw_stencil_wgrad <- the per-tap multiply-reduce of _dw_bwd, which the
//                         JAX package leaves to XLA.
// K7 (dw_fold.py _dw_fold4_s2_raw, the 3x3x3 stencil at stride (1,2,2)) is
// the same function as K4 plain: ops/dw_stencil.py launches dw_plain_s2.cu's
// dw_conv_s2 (plain_s2_fwd_kernel, plan_s2_fwd) for it, and this file holds
// no stride-2 kernel.
//
// What bounds them on this card: bytes. The forward reads x and writes y
// once (2*KT*KS^2 operations per output, at most 126); the weight gradient
// reads x and g once. Both sit far below the ~295 operations per byte where
// the H100's tensor cores would become the limit.
//
// What the design does about it. Both kernels give a thread a vector of V
// consecutive channels (V = 8 for 1x1 spatial taps up to KT 5: one 16-byte
// copy of bf16, two of f32; fewer for 7x1x1 and 3x3, so the KT*KS*KS*V
// taps or sums stay in registers: wg_vec) at one pixel, and a block whole
// pixels, the channel vectors of a pixel on consecutive threads: at the
// stem's C = 24, 3 threads a pixel, 64 pixels in 192 threads, every lane
// busy, a warp's copies one contiguous run of a frame. Each thread walks its
// frame segment in order and copies the next frames of x by cp.async into
// its own slots of a shared-memory ring (no barrier: a thread reads only
// what it copied), so several frames of loads are in flight without
// registers to hold them (a dk that held them in registers waited on every
// move; PERF.md).
//   * Forward: the thread keeps the KT output vectors a frame of x feeds in
//     a register ring, adds the frame's taps to each, and writes the
//     finished one with one 16-byte store (two in f32): x is read once
//     (plus a halo of KT-1 frames a segment), y written once. The ring of x
//     is FWD_DEPTH frames deep, twice the dk's, as a thread copies one
//     vector a frame where the dk copies two. One block per (sample, frame
//     segment, pixel range) item, no persistent grid (no reduction):
//     fwd_plan is wg_plan's split with the frames halved further until the
//     grid has FWD_BLOCKS blocks. At the stem's coarse step (B8 T64 112²)
//     that is the whole clip a segment, 1,568 blocks.
//   * Weight gradient: the thread keeps the KT g vectors a frame of x pairs
//     with in a register ring, the ring of x and g is WG_DEPTH frames deep,
//     and the grid is persistent, about two blocks per SM, each walking IPB
//     consecutive (sample, frame segment, pixel range) items; it then sums
//     its threads' pixels in a fixed order and writes one partial row, and
//     the wrapper adds the rows with one torch.sum, so runs repeat bit for
//     bit (no atomics).
// The forward adds each output's taps in the order dt, dy, dx, each with one
// fmaf onto an f32 sum from 0; frames outside the clip add nothing, and
// spatial neighbours outside the frame add w*0. So at 3x3x3 it equals
// dw_conv_s1 (K1 plain) bit for bit, and on g placed at the even positions
// of a zero tensor with the flipped taps it equals dw_conv_dx_s2 (K8).

#include "strip.cuh"

namespace {

using namespace cfn;

struct Args {
  const void* in;   // x
  const void* aux;  // the taps (forward) or g (weight gradient)
  void* out;        // y, or the (rows, KT*KS*KS, C) f32 partials
  int B, Tn, H, W, C;
  cudaStream_t st;
};

// ---- the channel-vector split, shared by both kernels ----------------------
constexpr int WG_THREADS = 192;  // threads per block at most (two blocks an SM)
constexpr int WG_BLOCKS = 264;   // the persistent grid: two blocks per SM
constexpr int WG_TT_MIN = 8;     // frames per segment at least, where T splits
// blocks of the forward's grid at least, where T splits: eight an SM, so a
// partial last wave is a small part of the run
constexpr int FWD_BLOCKS = 1056;

// Channels per thread: V = 8 for 1x1 spatial taps up to KT = 5 (16 bytes
// of bf16), fewer where the KT*KS*KS*V sums and the KT g vectors of the
// ring would crowd the 168 registers of two blocks an SM.
__host__ __device__ constexpr int wg_vec(int KT, int KS) {
  return KS == 1 ? (KT <= 5 ? 8 : 4) : (KT <= 3 ? 2 : 1);
}

// The work split of the taps' gradient (ops/dw_stencil.py mirrors it:
// plan_stencil_wgrad). A block owns NVB channel vectors (a channel group;
// all of them where C <= V * WG_THREADS) at PP pixels, thread tid at pixel
// tid / NVB and vector tid % NVB: whole warps of whole pixels where 32
// pixels fit. Items are (sample, frame segment of TT frames, range of PP
// pixels), in that order, ranges fastest; frames are halved (down to
// WG_TT_MIN) until there are WG_BLOCKS items; block row r walks items
// [r*IPB, (r+1)*IPB) of every channel group.
struct WgPlan {
  int NVB, n_cg, PP, TT, n_tseg, npr, items, ipb, rows;
};

inline WgPlan wg_plan(int B, int Tn, int H, int W, int C, int KT, int KS) {
  WgPlan p;
  const int nv = cdiv(C, wg_vec(KT, KS));
  p.NVB = nv < WG_THREADS ? nv : WG_THREADS;
  p.n_cg = cdiv(nv, p.NVB);
  p.PP = 32 * p.NVB <= WG_THREADS ? WG_THREADS / (32 * p.NVB) * 32
                                  : WG_THREADS / p.NVB;
  p.npr = cdiv(H * W, p.PP);
  p.TT = Tn;
  while (p.TT > WG_TT_MIN && B * cdiv(Tn, p.TT) * p.npr < WG_BLOCKS)
    p.TT = cdiv(p.TT, 2) > WG_TT_MIN ? cdiv(p.TT, 2) : WG_TT_MIN;
  p.n_tseg = cdiv(Tn, p.TT);
  p.items = B * p.n_tseg * p.npr;
  const int per_cg = WG_BLOCKS / p.n_cg > 1 ? WG_BLOCKS / p.n_cg : 1;
  p.ipb = cdiv(p.items, p.items < per_cg ? p.items : per_cg);
  p.rows = cdiv(p.items, p.ipb);
  return p;
}

// The forward's split (ops/dw_stencil.py mirrors it: plan_stencil_fwd):
// wg_plan's vectors, pixels and items, the frames halved on (down to
// WG_TT_MIN) until there are FWD_BLOCKS items; one item a block, block
// (item, channel group).
inline WgPlan fwd_plan(int B, int Tn, int H, int W, int C, int KT, int KS) {
  WgPlan p = wg_plan(B, Tn, H, W, C, KT, KS);
  while (p.TT > WG_TT_MIN && p.items < FWD_BLOCKS) {
    p.TT = cdiv(p.TT, 2) > WG_TT_MIN ? cdiv(p.TT, 2) : WG_TT_MIN;
    p.n_tseg = cdiv(Tn, p.TT);
    p.items = B * p.n_tseg * p.npr;
  }
  p.ipb = 1;
  p.rows = p.items;
  return p;
}

// Frames of copies in flight a thread (cp.async, into its own slots of a
// shared-memory ring), ahead of the frame it sums: the weight gradient's
// ring (x and g) and the forward's (x)
constexpr int WG_DEPTH = 4;
constexpr int FWD_DEPTH = 8;

// A vector of V channels moves in words of E elements, EB bytes (at most
// 16), of type Word
template <int B> struct WordOf;
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<4> { using type = unsigned; };
template <> struct WordOf<2> { using type = unsigned short; };
template <typename T, int V> struct VecWords {
  static constexpr int E = V * sizeof(T) > 16 ? 16 / (int)sizeof(T) : V;
  static constexpr int EB = E * (int)sizeof(T);
  using Word = typename WordOf<EB>::type;
};

// The n (<= V) channels of a vector at src into shared memory at dst, zero
// past n. vec: all V exist and src is aligned to min(16 bytes, the vector),
// so the vector goes by cp.async in copies of at most 16 bytes (of at least
// 4: a 2-byte vector is copied by the thread).
template <typename T, int V>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, int n,
                                         bool vec) {
  constexpr int E = VecWords<T, V>::E, EB = VecWords<T, V>::EB;
  if constexpr (EB >= 4) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < V / E; ++q) {
        const unsigned sa = (unsigned)__cvta_generic_to_shared(dst + q * E);
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
                     "l"(src + q * E), "n"(EB));
      }
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) dst[v] = v < n ? src[v] : from_f<T>(0.f);
}

// A vector's V channels in shared memory (a slot: aligned to the vector) as
// floats, read a word at a time
template <typename T, int V>
__device__ __forceinline__ void read_vec(float (&o)[V], const T* p) {
  using VW = VecWords<T, V>;
#pragma unroll
  for (int q = 0; q < V / VW::E; ++q) {
    const typename VW::Word u =
        *reinterpret_cast<const typename VW::Word*>(p + q * VW::E);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VW::E; ++i) o[q * VW::E + i] = to_f(e[i]);
  }
}

// The n (<= V) channels of a vector of sums to global memory at dst, in T.
// vec: all V exist and dst is aligned to min(16 bytes, the vector), so the
// vector goes a word (at most 16 bytes) at a time.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const float (&a)[V], int n,
                                          bool vec) {
  using VW = VecWords<T, V>;
  if (vec) {
#pragma unroll
    for (int q = 0; q < V / VW::E; ++q) {
      typename VW::Word u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < VW::E; ++i) e[i] = from_f<T>(a[q * VW::E + i]);
      *reinterpret_cast<typename VW::Word*>(dst + q * VW::E) = u;
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (v < n) dst[v] = from_f<T>(a[v]);
}

// ---- forward, stride 1 (K11) -----------------------------------------------
// Thread (pixel tid / NVB, vector j = blockIdx.y*NVB + tid % NVB, channels
// c0 = j*V ..) of block (item, group): the item's pixel pos and output
// frames [t0, t1) of its segment. While x frame ti is read, acc[j] holds
// output frame ti - PT + j, to which frame ti adds tap dt = KT-1-j; after
// frame ti, acc[0] (output ti - PT) is complete, is written, and the ring
// shifts. The thread copies frame ti + FWD_DEPTH - 1 (its KS*KS neighbours,
// one commit group a frame) into its own slots of the ring while it sums
// frame ti, which it reads from its own slots once its group has landed.
template <typename T, int KT, int KS>
__global__ void __launch_bounds__(WG_THREADS, 2)
stencil_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k,
                   T* __restrict__ y, int Tn, int H, int W, int C, WgPlan pl,
                   bool vec) {
  constexpr int PT = KT / 2, PS = KS / 2, NS = KS * KS, K = KT * NS;
  constexpr int V = wg_vec(KT, KS), D = FWD_DEPTH;
  // the ring [D][NS][threads][V] of x neighbours
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int p = tid / pl.NVB, jl = tid % pl.NVB;
  const int c0 = (blockIdx.y * pl.NVB + jl) * V;
  const int nc = C - c0 < V ? C - c0 : V;  // channels of the vector
  const int HW = H * W, item = blockIdx.x;
  const int pos = item % pl.npr * pl.PP + p;
  if (pos >= HW || nc <= 0) return;  // the kernel never synchronises
  const int ts = item / pl.npr % pl.n_tseg, b = item / pl.npr / pl.n_tseg;
  const int t0 = ts * pl.TT, t1 = min(t0 + pl.TT, Tn);
  const int h = pos / W, w = pos % W;
  int off[NS];  // the neighbours' offsets in a frame, -1 outside it
#pragma unroll
  for (int dy = 0; dy < KS; ++dy)
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const int iy = h + dy - PS, ix = w + dx - PS;
      off[dy * KS + dx] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                              ? (iy * W + ix) * C + c0
                              : -1;
    }
  const size_t frame = (size_t)HW * C;
  const T* xb = x + (size_t)b * Tn * frame;
  T* yb = y + (size_t)b * Tn * frame + (size_t)pos * C + c0;
  // the thread's slot of neighbour s of ring frame u
  auto slot = [&](int u, int s) {
    return ring + ((size_t)(u * NS + s) * nthr + tid) * V;
  };
  float wt[K][V];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v)
      wt[i][v] = v < nc ? to_f(k[(size_t)i * C + c0 + v]) : 0.f;

  // x frames ta .. tb-1 feed the segment's outputs; what lies outside the
  // clip, the frame and the segment's reach is not copied
  const int ta = t0 - PT, tb = t1 + PT;
  auto x_in = [&](int ti, int s) {
    return ti >= 0 && ti < Tn && ti < tb && off[s] >= 0;
  };
  // x frame ti's neighbours into ring frame (ti - ta) % D, one commit group
  auto issue = [&](int ti) {
    const int u = (ti - ta) % D;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (x_in(ti, s))
        copy_vec<T, V>(slot(u, s), xb + (size_t)ti * frame + off[s], nc,
                       vec);
    cp_commit();
  };
  float acc[KT][V];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[j][v] = 0.f;
#pragma unroll
  for (int i = 0; i < D - 1; ++i) issue(ta + i);
  for (int ti = ta; ti < tb; ++ti) {
    issue(ti + D - 1);  // into the ring frame read at step ti - 1
    cp_wait<D - 1>();   // this thread's copies of frame ti have landed
    if (ti >= 0 && ti < Tn) {  // frames outside the clip add nothing
      const int u = (ti - ta) % D;
      float xv[NS][V];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (off[s] >= 0) {
          read_vec<T, V>(xv[s], slot(u, s));
        } else {  // outside the frame: w * 0
#pragma unroll
          for (int v = 0; v < V; ++v) xv[s][v] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[j][v] = fmaf(wt[(KT - 1 - j) * NS + s][v], xv[s][v],
                             acc[j][v]);
    }
    const int to = ti - PT;  // complete now; to < t1 always
    if (to >= t0) store_vec<T, V>(yb + (size_t)to * frame, acc[0], nc, vec);
#pragma unroll
    for (int j = 0; j + 1 < KT; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[j][v] = acc[j + 1][v];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[KT - 1][v] = 0.f;
  }
  cp_wait<0>();  // the last (empty) groups
}

// Dynamic shared memory of the forward's ring, in bytes
template <typename T, int KT, int KS>
size_t fwd_smem(int threads) {
  return sizeof(T) * FWD_DEPTH * KS * KS * (size_t)threads * wg_vec(KT, KS);
}

template <typename T, int KT, int KS> struct StencilS1 {
  static int run(const Args& a) {
    constexpr int V = wg_vec(KT, KS);
    const WgPlan p = fwd_plan(a.B, a.Tn, a.H, a.W, a.C, KT, KS);
    const bool vec = a.C % V == 0 &&
                     ((uintptr_t)a.in | (uintptr_t)a.out) %
                             VecWords<T, V>::EB == 0;
    const int threads = p.PP * p.NVB;
    const size_t smem = fwd_smem<T, KT, KS>(threads);
    if (int e = set_smem(stencil_fwd_kernel<T, KT, KS>, smem)) return e;
    stencil_fwd_kernel<T, KT, KS><<<dim3(p.items, p.n_cg), threads, smem,
                                    a.st>>>(
        static_cast<const T*>(a.in), static_cast<const T*>(a.aux),
        static_cast<T*>(a.out), a.Tn, a.H, a.W, a.C, p, vec);
    return (int)cudaGetLastError();
  }
};

// Blocks per SM of the forward at channels a.C (its threads and ring depend
// on C and the taps only), or -1 on an error
template <typename T, int KT, int KS> struct FwdOccupancy {
  static int run(const Args& a) {
    const WgPlan p = fwd_plan(1, 1, 1, 1, a.C, KT, KS);
    const int threads = p.PP * p.NVB;
    return blocks_per_sm(stencil_fwd_kernel<T, KT, KS>,
                         fwd_smem<T, KT, KS>(threads), threads);
  }
};

// ---- weight gradient, stride 1 ---------------------------------------------
// Thread (pixel tid / NVB, vector j = blockIdx.y*NVB + tid % NVB, channels
// c0 = j*V ..): for each item of its block row, the pixel pos of the item's
// range and g frames [t0, t1) of its segment. While x frame ti is read,
// gr[KT-1-dt] holds g frame ti + PT - dt, which pairs with it through tap
// dt; a product is added only where that frame lies in [t0, t1), so a NaN of
// x reaches only the taps it reaches in the plain version (for finite x,
// fmaf(x, 0, acc) == acc). acc[dt*NS + s] sums x[ti, neighbour s] * g over
// the thread's pixels and frames. The thread copies frame ti + WG_DEPTH - 1
// (its x neighbours and its g vector, one commit group a frame) into its own
// slots of the ring while it sums frame ti, which it reads from its own
// slots once its group has landed: no barrier. Then the block's fixed-order
// sum: slot (tap, channel) adds its PP pixels in order into row blockIdx.x
// of the (rows, K, C) partials.
template <typename T, int KT, int KS>
__global__ void __launch_bounds__(WG_THREADS, 2)
stencil_dk_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ part, int Tn, int H, int W, int C,
                  WgPlan pl, bool vec) {
  constexpr int PT = KT / 2, PS = KS / 2, NS = KS * KS, K = KT * NS;
  constexpr int V = wg_vec(KT, KS), D = WG_DEPTH;
  // the ring [D][NS + 1][threads][V] of x neighbours and g, reused at the
  // end for the block's sums [K * V][threads]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int p = tid / pl.NVB, jl = tid % pl.NVB;
  const int c0 = (blockIdx.y * pl.NVB + jl) * V;
  const int nc = C - c0 < V ? C - c0 : V;  // channels of the vector (<= 0:
  const int HW = H * W;                    // none: the last group's tail)
  const size_t frame = (size_t)HW * C;
  // the thread's slot of vector s (s = NS: g) of ring frame u
  auto slot = [&](int u, int s) {
    return ring + ((size_t)(u * (NS + 1) + s) * nthr + tid) * V;
  };

  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;

  const int row = blockIdx.x;
  const int it1 = min((row + 1) * pl.ipb, pl.items);
  for (int item = row * pl.ipb; item < it1; ++item) {
    const int pos = item % pl.npr * pl.PP + p;
    if (pos >= HW || nc <= 0) continue;  // no synchronisation in this loop
    const int ts = item / pl.npr % pl.n_tseg, b = item / pl.npr / pl.n_tseg;
    const int t0 = ts * pl.TT, t1 = min(t0 + pl.TT, Tn);
    const int h = pos / W, w = pos % W;
    int off[NS];  // the neighbours' offsets in a frame, -1 outside it
#pragma unroll
    for (int dy = 0; dy < KS; ++dy)
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        const int iy = h + dy - PS, ix = w + dx - PS;
        off[dy * KS + dx] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                                ? (iy * W + ix) * C + c0
                                : -1;
      }
    const T* xb = x + (size_t)b * Tn * frame;
    const T* gb = g + (size_t)b * Tn * frame + (size_t)pos * C + c0;
    // x frames ta .. tb-1 meet the segment's g frames; what lies outside
    // the clip, the frame and the segment is not copied and reads as zero
    const int ta = t0 - PT, tb = t1 + PT;
    auto g_in = [&](int ti) { return ti + PT >= t0 && ti + PT < t1; };
    auto x_in = [&](int ti, int s) {
      return ti >= 0 && ti < Tn && ti < tb && off[s] >= 0;
    };
    // x frame ti's neighbours and g frame ti + PT into ring frame
    // (ti - ta) % D, one commit group
    auto issue = [&](int ti) {
      const int u = (ti - ta) % D;
      if (g_in(ti))
        copy_vec<T, V>(slot(u, NS), gb + (size_t)(ti + PT) * frame, nc, vec);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (x_in(ti, s))
          copy_vec<T, V>(slot(u, s), xb + (size_t)ti * frame + off[s], nc,
                         vec);
      cp_commit();
    };
    float gr[KT][V];
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) gr[i][v] = 0.f;
#pragma unroll
    for (int i = 0; i < D - 1; ++i) issue(ta + i);
    for (int ti = ta; ti < tb; ++ti) {
      issue(ti + D - 1);  // into the ring frame read at step ti - 1
      cp_wait<D - 1>();   // this thread's copies of frame ti have landed
      const int u = (ti - ta) % D;
#pragma unroll
      for (int i = 0; i + 1 < KT; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) gr[i][v] = gr[i + 1][v];
      if (g_in(ti)) {
        read_vec<T, V>(gr[KT - 1], slot(u, NS));
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) gr[KT - 1][v] = 0.f;
      }
      if (ti < 0 || ti >= Tn) continue;  // frames outside the clip add nothing
      float xv[NS][V];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (x_in(ti, s)) {
          read_vec<T, V>(xv[s], slot(u, s));
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) xv[s][v] = 0.f;
        }
      }
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        const int tg = ti + PT - dt;  // the g frame of gr[KT - 1 - dt]
        if (tg < t0 || tg >= t1) continue;  // uniform across the block
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[dt * NS + s][v] =
                fmaf(xv[s][v], gr[KT - 1 - dt][v], acc[dt * NS + s][v]);
      }
    }
    cp_wait<0>();  // the last (empty) groups
  }
  // the block's fixed-order sum: slot (tap, channel) adds its PP pixels in
  // order
  __syncthreads();  // every thread's copies have landed: the ring is free
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) red[(k * V + v) * nthr + tid] = acc[k][v];
  __syncthreads();
  for (int o = tid; o < K * pl.NVB * V; o += nthr) {
    const int v = o % V, jj = o / V % pl.NVB, k = o / (V * pl.NVB);
    const int ch = (blockIdx.y * pl.NVB + jj) * V + v;
    if (ch >= C) continue;
    float sum = 0.f;
    for (int q = 0; q < pl.PP; ++q)
      sum += red[(k * V + v) * nthr + q * pl.NVB + jj];
    part[((size_t)row * K + k) * C + ch] = sum;
  }
}

template <typename T, int KT, int KS> struct Wgrad {
  static int run(const Args& a) {
    constexpr int V = wg_vec(KT, KS);
    constexpr int EB = VecWords<T, V>::EB;
    const WgPlan p = wg_plan(a.B, a.Tn, a.H, a.W, a.C, KT, KS);
    const bool vec = a.C % V == 0 &&
                     ((uintptr_t)a.in | (uintptr_t)a.aux) % EB == 0;
    const int threads = p.PP * p.NVB;
    const size_t ring =
        sizeof(T) * WG_DEPTH * (KS * KS + 1) * (size_t)threads * V;
    const size_t red = sizeof(float) * KT * KS * KS * V * (size_t)threads;
    const size_t smem = ring > red ? ring : red;
    if (int e = set_smem(stencil_dk_kernel<T, KT, KS>, smem)) return e;
    stencil_dk_kernel<T, KT, KS><<<dim3(p.rows, p.n_cg), threads, smem,
                                   a.st>>>(
        static_cast<const T*>(a.in), static_cast<const T*>(a.aux),
        static_cast<float*>(a.out), a.Tn, a.H, a.W, a.C, p, vec);
    return (int)cudaGetLastError();
  }
};

// ---- tap-shape dispatch ----------------------------------------------------
// Op<T, KT, KS>::run for the taken shapes: KT in {1, 3, 5, 7}, KS in {1, 3}.
template <template <typename, int, int> class Op, typename T, int KS>
int by_kt(int KT, const Args& a) {
  switch (KT) {
    case 1: return Op<T, 1, KS>::run(a);
    case 3: return Op<T, 3, KS>::run(a);
    case 5: return Op<T, 5, KS>::run(a);
    case 7: return Op<T, 7, KS>::run(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <template <typename, int, int> class Op, typename T>
int by_taps(int KT, int KS, const Args& a) {
  switch (KS) {
    case 1: return by_kt<Op, T, 1>(KT, a);
    case 3: return by_kt<Op, T, 3>(KT, a);
  }
  return (int)cudaErrorInvalidValue;
}

template <template <typename, int, int> class Op>
int dispatch(int KT, int KS, const Args& a, int is_bf16) {
  return is_bf16 ? by_taps<Op, __nv_bfloat16>(KT, KS, a)
                 : by_taps<Op, float>(KT, KS, a);
}

bool taps_taken(int KT, int KS) {
  return KT >= 1 && KT <= 7 && KT % 2 == 1 && (KS == 1 || KS == 3);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launching entry returns
// cudaGetLastError() after the launch: 0 means the kernel was launched.

// Rows of dw_stencil_wgrad's partial buffer for x (B,T,H,W,C) and taps
// KT x KS x KS (wg_plan), or -1 for a tap shape the kernel does not take.
extern "C" int dw_stencil_partial_rows(int B, int T, int H, int W, int C,
                                       int KT, int KS) {
  if (!taps_taken(KT, KS)) return -1;
  return wg_plan(B, T, H, W, C, KT, KS).rows;
}

extern "C" int dw_stencil_s1(const void* x, const void* k, void* y, int B,
                             int T, int H, int W, int C, int KT, int KS,
                             int is_bf16, void* stream) {
  const Args a{x, k, y, B, T, H, W, C, static_cast<cudaStream_t>(stream)};
  return dispatch<StencilS1>(KT, KS, a, is_bf16);
}

// Blocks per SM of dw_stencil_s1's kernel at C channels and taps KT x KS x
// KS (the occupancy API), or -1 for a tap shape it does not take
extern "C" int dw_stencil_s1_occupancy(int C, int KT, int KS, int is_bf16) {
  if (!taps_taken(KT, KS) || C < 1) return -1;
  const Args a{nullptr, nullptr, nullptr, 1, 1, 1, 1, C, nullptr};
  return dispatch<FwdOccupancy>(KT, KS, a, is_bf16);
}

extern "C" int dw_stencil_wgrad(const void* x, const void* g, void* part,
                                int B, int T, int H, int W, int C, int KT,
                                int KS, int is_bf16, void* stream) {
  const Args a{x, g, part, B, T, H, W, C, static_cast<cudaStream_t>(stream)};
  return dispatch<Wgrad>(KT, KS, a, is_bf16);
}
