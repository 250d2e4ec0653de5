// Plain-layout depthwise 3-D stencils for Hopper (sm_90a):
//
//   dw_stencil_s1 (K11):  y[t,h,w,c] = sum_{dt,dy,dx} k[dt,dy,dx,c] *
//                             x[t+dt-PT, h+dy-PS, w+dx-PS, c]
//                         stride 1, zero padding PT = KT/2, PS = KS/2 (SAME)
//   dw_stencil_s2 (K7):   y[t,m,n,c] = sum_{dt,dy,dx} k[dt,dy,dx,c] *
//                             x[t+dt-1, 2m+dy-1, 2n+dx-1, c]
//                         the 3x3x3 stencil at stride (1,2,2), any H and W;
//                         y is (B,T,ceil(H/2),ceil(W/2),C)
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
// Replaces two TPU Pallas kernels and an XLA reduction of the JAX package:
//   * dw_stencil_s1    <- coarse_fine_networks_tpu/ops/pallas/dw_conv.py
//                         _dw_pallas_raw -> _stencil_kernel (K11), also the
//                         dx of its custom VJP (_dw_bwd: the same stencil on
//                         g with the flipped taps);
//   * dw_stencil_s2    <- ops/pallas/dw_fold.py _dw_fold4_s2_raw ->
//                         _fwd_kernel(stride2=True) (K7), without the fold4
//                         lanes, the u32 sublane-pair bitcast of
//                         _s2_epilogue or the lane rolls: only the kept
//                         quarter of the positions is computed;
//   * dw_stencil_wgrad <- the per-tap multiply-reduce of _dw_bwd, which the
//                         JAX package leaves to XLA.
//
// What bounds them on this card: bytes. The forward reads x and writes y
// once (2*KT*KS^2 operations per output, at most 126); the weight gradient
// reads x and g once. Both sit far below the ~295 operations per byte where
// the H100's tensor cores would become the limit.
//
// What the design does about it. Forward: one thread per output column
// (b, h, w, c), consecutive threads on consecutive channels, so every load
// and store of a warp is contiguous whatever C is (the stem has C = 24, which
// a lane-per-channel block would fill to three quarters). The thread walks
// TT frames in order and keeps the KT outputs a frame contributes to in a
// register ring, so each input frame is read once per thread (plus a halo of
// KT-1 frames per TT); the KS*KS spatial neighbours come through L1 from the
// neighbouring threads' loads. Weight gradient: a thread owns a vector of V
// consecutive channels (V = 8 for the stem's 5x1x1 taps: one 16-byte copy of
// bf16, two of f32; fewer for 7x1x1 and 3x3, so the KT*KS*KS*V sums stay in
// registers) at one pixel, and a block whole pixels, the channel vectors of
// a pixel on consecutive threads: at the stem's C = 24, 3 threads a pixel,
// 64 pixels in 192 threads, every lane busy, a warp reading one contiguous
// run of x and one of g. Each thread walks its frame segment in order with a
// register ring of the KT g vectors a frame of x pairs with, so x and g are
// each read once per segment (plus a halo of KT-1 x frames), the copies of
// the next WG_DEPTH - 1 frames in flight by cp.async into the thread's own
// slots of a shared-memory ring while it sums one. The grid is persistent,
// about two blocks per SM, each walking IPB consecutive (sample, frame
// segment, pixel range) items; it then sums its threads' pixels in a fixed
// order and writes one partial row, and the wrapper adds the rows with one
// torch.sum, so runs
// repeat bit for bit (no atomics).

#include "strip.cuh"

namespace {

using namespace cfn;

constexpr int THREADS = 256;  // forward: columns per block
constexpr int TT = 32;        // forward: frames per thread

struct Args {
  const void* in;   // x
  const void* aux;  // the taps (forward) or g (weight gradient)
  void* out;        // y, or the (rows, KT*KS*KS, C) f32 partials
  int B, Tn, H, W, C;
  cudaStream_t st;
};

// ---- forward: stride 1 (K11) or (1,2,2) (K7) --------------------------------
// Thread (column) col = ((b*Ho + oh)*Wo + ow)*C + c over the output; it owns
// output frames [t0, t0 + TT). acc[j] holds output frame ti - PT + j while
// input frame ti is read: frame ti adds tap dt = KT-1-j to it. After frame
// ti, acc[0] (output ti - PT) is complete, is written, and the ring shifts.
// The taps of one output are summed in the order dt, dy, dx.
template <typename T, int KT, int KS, int S>
__global__ void __launch_bounds__(THREADS)
stencil_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k,
                   T* __restrict__ y, int Tn, int H, int W, int Ho, int Wo,
                   int C, long long ncol) {
  constexpr int PT = KT / 2, PS = KS / 2, NS = KS * KS;
  const long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (col >= ncol) return;  // the kernel never synchronises
  const int c = (int)(col % C);
  long long pos = col / C;
  const int ow = (int)(pos % Wo);
  pos /= Wo;
  const int oh = (int)(pos % Ho);
  const int b = (int)(pos / Ho);
  const int t0 = blockIdx.y * TT, t1 = min(t0 + TT, Tn);

  float wt[KT * NS];
#pragma unroll
  for (int i = 0; i < KT * NS; ++i) wt[i] = to_f(k[(size_t)i * C + c]);
  // the spatial neighbours within a frame: offset, or -1 outside the frame
  int off[NS];
#pragma unroll
  for (int dy = 0; dy < KS; ++dy)
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const int iy = S * oh + dy - PS, ix = S * ow + dx - PS;
      off[dy * KS + dx] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                              ? (iy * W + ix) * C + c
                              : -1;
    }
  const size_t frame = (size_t)H * W * C;
  const T* xb = x + (size_t)b * Tn * frame;
  T* yb = y + ((size_t)b * Tn * Ho + oh) * Wo * C + (size_t)ow * C + c;
  const size_t yframe = (size_t)Ho * Wo * C;

  float acc[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) acc[j] = 0.f;
  for (int ti = t0 - PT; ti < t1 + PT; ++ti) {
    if (ti >= 0 && ti < Tn) {  // frames outside the tensor are zero
      const T* xf = xb + (size_t)ti * frame;
      float v[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) v[s] = off[s] >= 0 ? to_f(xf[off[s]]) : 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          acc[j] = fmaf(wt[(KT - 1 - j) * NS + s], v[s], acc[j]);
    }
    const int to = ti - PT;  // complete now; to < t1 always
    if (to >= t0) yb[(size_t)to * yframe] = from_f<T>(acc[0]);
#pragma unroll
    for (int j = 0; j + 1 < KT; ++j) acc[j] = acc[j + 1];
    acc[KT - 1] = 0.f;
  }
}

template <typename T, int KT, int KS, int S>
int launch_stencil(const Args& a) {
  const int Ho = (a.H - 1) / S + 1, Wo = (a.W - 1) / S + 1;
  const long long ncol = (long long)a.B * Ho * Wo * a.C;
  const dim3 grid((unsigned)((ncol + THREADS - 1) / THREADS), cdiv(a.Tn, TT));
  stencil_fwd_kernel<T, KT, KS, S><<<grid, THREADS, 0, a.st>>>(
      static_cast<const T*>(a.in), static_cast<const T*>(a.aux),
      static_cast<T*>(a.out), a.Tn, a.H, a.W, Ho, Wo, a.C, ncol);
  return (int)cudaGetLastError();
}

template <typename T, int KT, int KS> struct StencilS1 {
  static int run(const Args& a) { return launch_stencil<T, KT, KS, 1>(a); }
};

// ---- weight gradient, stride 1 ----------------------------------------------
constexpr int WG_THREADS = 192;  // threads per block at most (two blocks an SM)
constexpr int WG_BLOCKS = 264;   // the persistent grid: two blocks per SM
constexpr int WG_TT_MIN = 8;     // frames per segment at least, where T splits

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

// Frames of x and g copies in flight a thread (cp.async, into its own
// slots of a shared-memory ring), ahead of the frame it sums
constexpr int WG_DEPTH = 4;

// The n (<= V) channels of a vector at src into shared memory at dst, zero
// past n. vec: all V exist and src is aligned to min(16 bytes, the vector),
// so the vector goes by cp.async in copies of at most 16 bytes (of at least
// 4: a 2-byte vector is copied by the thread).
template <typename T, int V>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, int n,
                                         bool vec) {
  constexpr int E = V * sizeof(T) > 16 ? 16 / (int)sizeof(T) : V;
  constexpr int EB = E * (int)sizeof(T);
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

// The n (<= V) channels of a vector in shared memory as floats
template <typename T, int V>
__device__ __forceinline__ void read_vec(float (&o)[V], const T* p) {
#pragma unroll
  for (int v = 0; v < V; ++v) o[v] = to_f(p[v]);
}

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
    constexpr int EB = V * sizeof(T) > 16 ? 16 : V * (int)sizeof(T);
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

// ---- tap-shape dispatch -------------------------------------------------------
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

}  // namespace

// Plain C entry points (bound with ctypes). Each launching entry returns
// cudaGetLastError() after the launch: 0 means the kernel was launched.

// Rows of dw_stencil_wgrad's partial buffer for x (B,T,H,W,C) and taps
// KT x KS x KS (wg_plan), or -1 for a tap shape the kernel does not take.
extern "C" int dw_stencil_partial_rows(int B, int T, int H, int W, int C,
                                       int KT, int KS) {
  if (KT < 1 || KT > 7 || KT % 2 == 0 || (KS != 1 && KS != 3)) return -1;
  return wg_plan(B, T, H, W, C, KT, KS).rows;
}

extern "C" int dw_stencil_s1(const void* x, const void* k, void* y, int B,
                             int T, int H, int W, int C, int KT, int KS,
                             int is_bf16, void* stream) {
  const Args a{x, k, y, B, T, H, W, C, static_cast<cudaStream_t>(stream)};
  return dispatch<StencilS1>(KT, KS, a, is_bf16);
}

extern "C" int dw_stencil_s2(const void* x, const void* k, void* y, int B,
                             int T, int H, int W, int C, int is_bf16,
                             void* stream) {
  const Args a{x, k, y, B, T, H, W, C, static_cast<cudaStream_t>(stream)};
  if (is_bf16) return launch_stencil<__nv_bfloat16, 3, 3, 2>(a);
  return launch_stencil<float, 3, 3, 2>(a);
}

extern "C" int dw_stencil_wgrad(const void* x, const void* g, void* part,
                                int B, int T, int H, int W, int C, int KT,
                                int KS, int is_bf16, void* stream) {
  const Args a{x, g, part, B, T, H, W, C, static_cast<cudaStream_t>(stream)};
  return dispatch<Wgrad>(KT, KS, a, is_bf16);
}
