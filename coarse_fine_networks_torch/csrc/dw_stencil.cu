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
//                         the taps' gradient of dw_stencil_s1; per block an
//                         f32 partial (KT*KS*KS, C)
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
// neighbouring threads' loads. Weight gradient: the layout of the other
// weight gradients (dw_act_bwd.cu): a block owns 32 channels (one per
// lane), 64 positions (8 per warp) and 16 frames; each thread walks its
// frames with a ring of the KT g values a frame of x pairs with and sums all
// taps in registers; then a fixed-order sum over the warps writes the
// block's row of partials, and the wrapper adds the rows with one torch.sum,
// so runs repeat bit for bit (no atomics). 16-byte loads and several
// channels per thread are later work.

#include "common.cuh"

namespace {

using namespace cfn;

constexpr int THREADS = 256;  // forward: columns per block
constexpr int TT = 32;        // forward: frames per thread
constexpr int NPOS = 64;      // weight gradient: positions per block
constexpr int TT_WG = 16;     // weight gradient: frames per block

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
// Block (lane = channel c0 + lane, warp): positions p = blockIdx.x*NPOS +
// warp + j*WARPS of the H*W plane, g frames [t0, t0 + TT_WG) of sample b.
// While x frame ti is read, gr[j] holds g frame ti - PT + j (zero outside
// [t0, t1) and the tensor): x frame ti pairs with it through tap dt =
// KT-1-j. acc[dt*NS + s] sums x[ti, neighbour s] * g over the thread's
// positions and frames.
template <typename T, int KT, int KS>
__global__ void __launch_bounds__(WARPS * 32)
stencil_dk_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ part, int Tn, int H, int W, int C,
                  int n_tseg) {
  constexpr int PT = KT / 2, PS = KS / 2, NS = KS * KS, K = KT * NS;
  __shared__ float red[WARPS][CC];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.y * CC + lane;
  const bool cval = c < C;
  const int b = blockIdx.z / n_tseg;
  const int t0 = (blockIdx.z % n_tseg) * TT_WG, t1 = min(t0 + TT_WG, Tn);
  const size_t frame = (size_t)H * W * C;
  const T* xb = x + (size_t)b * Tn * frame;
  const T* gb = g + (size_t)b * Tn * frame;

  float acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = 0.f;
  for (int j = 0; j < NPOS / WARPS; ++j) {
    const int p = blockIdx.x * NPOS + warp + j * WARPS;
    if (p >= H * W || !cval) continue;  // no synchronisation in this loop
    const int h = p / W, w = p % W;
    int off[NS];
#pragma unroll
    for (int dy = 0; dy < KS; ++dy)
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        const int iy = h + dy - PS, ix = w + dx - PS;
        off[dy * KS + dx] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                                ? (iy * W + ix) * C + c
                                : -1;
      }
    const int goff = p * C + c;
    float gr[KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) gr[i] = 0.f;
    for (int ti = t0 - PT; ti < t1 + PT; ++ti) {
#pragma unroll
      for (int i = 0; i + 1 < KT; ++i) gr[i] = gr[i + 1];
      const int tg = ti + PT;  // the g frame entering the ring
      gr[KT - 1] = tg < t1 ? to_f(gb[(size_t)tg * frame + goff]) : 0.f;
      if (ti < 0 || ti >= Tn) continue;
      const T* xf = xb + (size_t)ti * frame;
      float v[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) v[s] = off[s] >= 0 ? to_f(xf[off[s]]) : 0.f;
#pragma unroll
      for (int dt = 0; dt < KT; ++dt)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          acc[dt * NS + s] = fmaf(v[s], gr[KT - 1 - dt], acc[dt * NS + s]);
    }
  }
  // fixed-order sum over the warps, one tap at a time; warp 0 writes row
  // (blockIdx.z, blockIdx.x) of the (rows, K, C) partials
  const size_t row = (size_t)blockIdx.z * gridDim.x + blockIdx.x;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    red[warp][lane] = acc[i];
    __syncthreads();
    if (warp == 0 && cval) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) s += red[q][lane];
      part[(row * K + i) * C + c] = s;
    }
    __syncthreads();
  }
}

int partial_rows(int B, int Tn, int H, int W) {
  return cdiv(H * W, NPOS) * B * cdiv(Tn, TT_WG);
}

template <typename T, int KT, int KS> struct Wgrad {
  static int run(const Args& a) {
    const int n_tseg = cdiv(a.Tn, TT_WG);
    const dim3 grid(cdiv(a.H * a.W, NPOS), cdiv(a.C, CC), a.B * n_tseg);
    stencil_dk_kernel<T, KT, KS><<<grid, dim3(32, WARPS), 0, a.st>>>(
        static_cast<const T*>(a.in), static_cast<const T*>(a.aux),
        static_cast<float*>(a.out), a.Tn, a.H, a.W, a.C, n_tseg);
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

// Rows of dw_stencil_wgrad's partial buffer.
extern "C" int dw_stencil_partial_rows(int B, int T, int H, int W) {
  return partial_rows(B, T, H, W);
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
