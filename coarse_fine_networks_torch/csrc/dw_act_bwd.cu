// Backward of the matmul-fused X3D bottleneck entry for Hopper (sm_90a):
// the entries not yet on the row-strip layout.
//
//     y = dwconv3x3x3_(1,2,2)( a ),   a = relu( (x @ W1) * sc + bi )   (mm)
//
// x (B,T,H,W,Cin) is conv1's input and W1 (Cin,C) its weight, channels-
// last, f32 or bf16; the depthwise taps w (27,C) have x's dtype; sc/bi are
// bn1's f32 per-channel apply vectors (from the batch statistics in the
// train composite, the running ones in the eval entry). g is dL/dy (y's
// shape and dtype).
//
// Two kernel entries, both at stride (1,2,2), each replacing a TPU Pallas
// kernel of coarse_fine_networks_tpu/ops/pallas/dw_fold.py (mm mode: the
// backward of the train composite dw_fold4_mm_bn_train, _mm_bn_train_bwd,
// and of the eval entry dw_fold4_mm_act, _dw_mm_bwd):
//   * dw_mm_dx_mask_s2  <- _dx_s2_mask_pcall -> _dx_s2_kernel(mask) (K9)
//   * dw_mm_wgrad_s2    <- _wgrad_s2_pcall -> _wgrad_s2_kernel (mm mode,
//                          K10 mm)
// (the plain mode, the backward of dw_fold4 and dw_fold4_stride2, is in
// dw_plain_s1.cu and dw_plain_s2.cu, and so is the whole backward of the act
// mode, _dw_act_bwd: K5, K6 act and K10 act, and the stride-1 weight
// gradient of the mm mode, K6 mm; the stride-1 dx of both modes, K3 and
// K2, is in dw_dx_s1.cu).
//
// dx:    da  = dL/da: the half-resolution gather
//              da[t,r,c] = sum w[dt,dy,dx] g[t-dt+1, (r-dy+1)/2, (c-dx+1)/2]
//              over the terms whose divisions are integral (dw_fold.py:825);
//        dam = da * 1[(x @ W1)*sc + bi > 0] in g's dtype: the mask
//              recomputes conv1's product per output position with the
//              forward's prologue (mm_prologue, common.cuh), the same sum in
//              the same order and the same apply, x*sc and + bi each rounded
//              (no fused multiply-add), as PyTorch's two elementwise ops
//              round them: mask and forward take the same relu branch even
//              for inputs within one rounding of 0 (a flipped mask is an
//              O(1) error in dx).
// wgrad: dk[tap,c] = sum_pos a_pad[2*pos + tap] * g[pos], with the same
//        rounded, zero-padded activation as the forward (the forward's
//        prologue over the halo), summed in f32; per block an f32 partial
//        (27, C).
//
// Reductions: no atomics. Each weight-gradient block writes its partial
// sums to its own row of a (rows, 27, C) buffer after a fixed-order sum over
// its warps; the wrapper sums the rows with one torch.sum, so runs repeat
// bit for bit.
//
// What bounds them on this card: bytes. dx reads g and x and writes dam
// (27 MACs per element); wgrad reads x and g (27 MACs per element). Both sit
// far below the ~295 operations per byte where the H100's tensor cores
// would become the limit, and the stencil's MACs run on the FP32 cores.
// conv1's product adds Cin MACs per (position, channel): at most 2*192
// operations per 2 bytes of C_mid output, still below that line, but on
// the FP32 cores here (moving it to wgmma is later work).
//
// What the design does about it: the layout of dw_mm_act.cu's stride-2
// entry. A block owns (frame segment, spatial tile, 32-channel chunk),
// walks its frames in order, and keeps the three frames its stencil reads
// (g for dx, the activated x for wgrad) in a shared-memory ring, so each
// frame is read once per tile plus a halo. Each lane owns one channel: ring
// reads are conflict-free, loads and stores of channels-last tensors are
// contiguous along C. g is loaded per element because C = 54, 108, ... is
// no multiple of 8 (x is staged with 16-byte loads, Cin % 8 == 0). The
// activation, the mask and the reduction are fused in, so neither a nor da
// nor conv1's C-wide product ever goes to device memory.

#include "common.cuh"

namespace {

using namespace cfn;

constexpr int TT_DX = 8;   // frames per block, dx
constexpr int TT_WG = 16;  // frames per block, wgrad (fewer partial rows)

// ---- geometry ---------------------------------------------------------------
// The weight gradients use StencilGeom<S> (common.cuh), the forward's
// tiles, over the stencil's output resolution.
template <int S> using SGeom = StencilGeom<S>;

// Stride-2 dx: an OH x OW tile of full-resolution dx; g rows (r-dy+1)/2 for
// r in [r0, r0+OH) span OH/2 + 1 half-resolution rows from r0/2 (cols alike).
struct GGeom {
  static constexpr int OH = 8, OW = 8;
  static constexpr int HR = OH / 2 + 1, WR = OW / 2 + 1;
  static constexpr int P = HR * WR;
  static constexpr int NPA = (P + WARPS - 1) / WARPS;
  static constexpr int NO = OH * OW / WARPS;
};

// Loads one frame of a (B,T,h,w,C) tensor over a halo of HR x WR positions
// at (iy0, ix0) into a ring slot, zero outside the tensor and for channels
// >= C.
template <typename T, int P, int WR, int NPA>
__device__ __forceinline__ void load_frame(float* slot, const T* src, int b,
                                           int ti, int Tn, int h, int w,
                                           int C, int iy0, int ix0, int c,
                                           bool cval) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const bool tin = ti >= 0 && ti < Tn;  // uniform across the block
  const T* f = src + (size_t)(b * Tn + (tin ? ti : 0)) * h * w * C;
#pragma unroll
  for (int j = 0; j < NPA; ++j) {
    const int p = warp + j * WARPS;
    if (p < P) {
      const int gy = iy0 + p / WR, gx = ix0 + p % WR;
      float v = 0.f;
      if (tin && cval && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = to_f(f[((size_t)gy * w + gx) * C + c]);
      slot[p * CC + lane] = v;
    }
  }
}

// The weight gradient's ring of three frames of P positions, reused at the
// end for the warps' partial sums (K per lane and warp), in floats.
template <int K, int P>
__host__ __device__ constexpr int ring_floats() {
  return 3 * P * CC > WARPS * K * CC ? 3 * P * CC : WARPS * K * CC;
}

// Fixed-order sum of K per-thread values over the block's warps; warp 0
// writes row `row` of a (rows, K, C) partial buffer. `red` is shared memory
// of WARPS*K*CC floats, free for use (the caller synchronised).
template <int K>
__device__ __forceinline__ void block_partials(float* red, const float* v,
                                               float* part, size_t row, int C,
                                               int c, bool cval) {
  const int lane = threadIdx.x, warp = threadIdx.y;
#pragma unroll
  for (int k = 0; k < K; ++k) red[(warp * K + k) * CC + lane] = v[k];
  __syncthreads();
  for (int k = warp; k < K; k += WARPS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += red[(q * K + k) * CC + lane];
    if (cval) part[(row * K + k) * C + c] = s;
  }
}

// ---- masked dx, stride (1,2,2) (mm mode) ----------------------------------------
// g is (B,T,Ho,Wo,C), dam (B,T,H,W,C), Ho = (H-1)/2 + 1; x (B,T,H,W,Cin) and
// w1 (Cin,C): dam = da where the recomputed relu input is > 0, in g's dtype.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dx_s2_kernel(const T* __restrict__ g, const T* __restrict__ x,
             const T* __restrict__ w1, const T* __restrict__ wdw,
             const float* __restrict__ sc, const float* __restrict__ bi,
             T* __restrict__ dx, int Tn, int H, int W, int Ho, int Wo,
             int Cin, int C, int n_tx, int n_tseg) {
  using G = GGeom;
  constexpr int NP = G::OH * G::OW;  // the mask's positions: the outputs
  extern __shared__ __align__(16) float ring[];  // [3][P][CC]
  float* xs = ring + 3 * G::P * CC;              // [NP][KC]
  float* ws = xs + NP * KC;                      // [KC][CC]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int r0 = (blockIdx.x / n_tx) * G::OH;  // even
  const int q0 = (blockIdx.x % n_tx) * G::OW;  // even
  const int c0 = blockIdx.y * CC;
  const int c = c0 + lane;
  const bool cval = c < C;
  const int b = blockIdx.z / n_tseg;
  const int t0 = (blockIdx.z % n_tseg) * TT_DX;
  const int t1 = min(t0 + TT_DX, Tn);
  const float scv = cval ? sc[c] : 0.f;
  const float biv = cval ? bi[c] : 0.f;
  float wt[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) wt[k] = cval ? to_f(wdw[k * C + c]) : 0.f;

  auto load = [&](int ti) {
    load_frame<T, G::P, G::WR, G::NPA>(ring + slot_of(ti) * G::P * CC, g, b,
                                       ti, Tn, Ho, Wo, C, r0 / 2, q0 / 2, c,
                                       cval);
  };
  load(t0 - 1);
  load(t0);
  for (int t = t0; t < t1; ++t) {
    load(t + 1);
    // output j of this warp is mask position j: both are warp + j*WARPS;
    // positions past H or W (the ragged edge of odd sizes) are masked off
    float keep[G::NO];
    mm_prologue<T, true, NP, G::OW, G::NO>(
        keep, xs, ws, x + (size_t)(b * Tn + t) * H * W * Cin, w1, H, W, Cin,
        C, c0, r0, q0, scv, biv);
    __syncthreads();
    // tap dt reads g frame t - dt + 1
    const float* fr[3] = {ring + slot_of(t + 1) * G::P * CC,
                          ring + slot_of(t) * G::P * CC,
                          ring + slot_of(t - 1) * G::P * CC};
#pragma unroll
    for (int j = 0; j < G::NO; ++j) {
      const int o = warp + j * WARPS;
      const int oy = o / G::OW, ox = o % G::OW;  // parity of r, of col
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        if ((oy - dy + 1) & 1) continue;  // uniform across the warp
        const int hy = (oy - dy + 1) / 2;
#pragma unroll
        for (int dxx = 0; dxx < 3; ++dxx) {
          if ((ox - dxx + 1) & 1) continue;
          const int p = hy * G::WR + (ox - dxx + 1) / 2;
#pragma unroll
          for (int dt = 0; dt < 3; ++dt)
            acc = fmaf(wt[(dt * 3 + dy) * 3 + dxx], fr[dt][p * CC + lane],
                       acc);
        }
      }
      const int gy = r0 + oy, gx = q0 + ox;
      if (cval && gy < H && gx < W) {
        const size_t idx = (((size_t)(b * Tn + t) * H + gy) * W + gx) * C + c;
        dx[idx] = from_f<T>(keep[j] != 0.f ? acc : 0.f);
      }
    }
    __syncthreads();
  }
}

// ---- wgrad, stride (1,2,2) -----------------------------------------------------
// x (B,T,H,W,Cin) with w1 (Cin,C); g (B,T,Ho,Wo,C), Ho = (H-1)/S + 1 (S =
// 2: the stride-1 one, K6 mm, is dw_plain_s1.cu's). The tile is over g. The
// stencil reads relu((x@W1)*sc + bi).
template <typename T, int S>
__global__ void __launch_bounds__(WARPS * 32)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ w1,
             const T* __restrict__ g, const float* __restrict__ sc,
             const float* __restrict__ bi, float* __restrict__ part, int Tn,
             int H, int W, int Ho, int Wo, int Cin, int C, int n_tx,
             int n_tseg) {
  using G = SGeom<S>;
  extern __shared__ __align__(16) float ring[];  // [3][P][CC]
  float* xs = ring + ring_floats<27, G::P>();    // [P][KC]
  float* ws = xs + G::P * KC;                    // [KC][CC]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int oy0 = (blockIdx.x / n_tx) * G::OH;
  const int ox0 = (blockIdx.x % n_tx) * G::OW;
  const int c0 = blockIdx.y * CC;
  const int c = c0 + lane;
  const bool cval = c < C;
  const int b = blockIdx.z / n_tseg;
  const int t0 = (blockIdx.z % n_tseg) * TT_WG;
  const int t1 = min(t0 + TT_WG, Tn);
  const float scv = cval ? sc[c] : 0.f;
  const float biv = cval ? bi[c] : 0.f;

  auto load = [&](int ti) {
    float* slot = ring + slot_of(ti) * G::P * CC;
    if (ti < 0 || ti >= Tn) {  // uniform across the block
      for (int i = warp * 32 + lane; i < G::P * CC; i += WARPS * 32)
        slot[i] = 0.f;
      return;
    }
    // the forward's prologue over the halo
    float a[G::NPA];
    mm_prologue<T, false, G::P, G::WR, G::NPA>(
        a, xs, ws, x + (size_t)(b * Tn + ti) * H * W * Cin, w1, H, W, Cin, C,
        c0, S * oy0 - 1, S * ox0 - 1, scv, biv);
#pragma unroll
    for (int j = 0; j < G::NPA; ++j) {
      const int p = warp + j * WARPS;
      if (p < G::P) slot[p * CC + lane] = a[j];
    }
  };
  float acc[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) acc[k] = 0.f;
  load(t0 - 1);
  load(t0);
  for (int t = t0; t < t1; ++t) {
    load(t + 1);
    __syncthreads();
    const float* fr[3] = {ring + slot_of(t - 1) * G::P * CC,
                          ring + slot_of(t) * G::P * CC,
                          ring + slot_of(t + 1) * G::P * CC};
#pragma unroll
    for (int j = 0; j < G::NO; ++j) {
      const int o = warp + j * WARPS;
      const int oy = o / G::OW, ox = o % G::OW;
      const int gy = oy0 + oy, gx = ox0 + ox;
      if (gy < Ho && gx < Wo && cval) {  // warp-uniform position
        const float gv = to_f(
            g[(((size_t)(b * Tn + t) * Ho + gy) * Wo + gx) * C + c]);
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dxx = 0; dxx < 3; ++dxx)
              acc[(dt * 3 + dy) * 3 + dxx] = fmaf(
                  gv, fr[dt][((S * oy + dy) * G::WR + S * ox + dxx) * CC + lane],
                  acc[(dt * 3 + dy) * 3 + dxx]);
      }
    }
    __syncthreads();
  }
  block_partials<27>(ring, acc, part,
                     (size_t)blockIdx.z * gridDim.x + blockIdx.x, C, c, cval);
}

// ---- launchers ----------------------------------------------------------------
// Dynamic shared memory: the ring (reused at the end for the warps' partial
// sums, K per lane and warp), then the staged x chunk of NP positions and
// the staged W1 chunk.
constexpr size_t smem_bytes(size_t ring, int np) {
  return sizeof(float) * (ring + np * KC + KC * CC);
}

template <typename T>
int launch_dx_s2(const void* g, const void* x, const void* w1, const void* w,
                 const void* sc, const void* bi, void* dx, int B, int Tn,
                 int H, int W, int Cin, int C, cudaStream_t st) {
  using G = GGeom;
  constexpr size_t smem = smem_bytes(3 * G::P * CC, G::OH * G::OW);
  if (int e = set_smem(dx_s2_kernel<T>, smem)) return e;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int n_tx = cdiv(W, G::OW), n_tseg = cdiv(Tn, TT_DX);
  const dim3 grid(cdiv(H, G::OH) * n_tx, cdiv(C, CC), B * n_tseg);
  dx_s2_kernel<T><<<grid, dim3(32, WARPS), smem, st>>>(
      (const T*)g, (const T*)x, (const T*)w1, (const T*)w, (const float*)sc,
      (const float*)bi, (T*)dx, Tn, H, W, Ho, Wo, Cin, C, n_tx, n_tseg);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int launch_wgrad(const void* x, const void* w1, const void* g, const void* sc,
                 const void* bi, void* part, int B, int Tn, int H, int W,
                 int Cin, int C, cudaStream_t st) {
  using G = SGeom<S>;
  constexpr size_t smem = smem_bytes(ring_floats<27, G::P>(), G::P);
  if (int e = set_smem(wgrad_kernel<T, S>, smem)) return e;
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int n_tx = cdiv(Wo, G::OW), n_tseg = cdiv(Tn, TT_WG);
  const dim3 grid(cdiv(Ho, G::OH) * n_tx, cdiv(C, CC), B * n_tseg);
  wgrad_kernel<T, S><<<grid, dim3(32, WARPS), smem, st>>>(
      (const T*)x, (const T*)w1, (const T*)g, (const float*)sc,
      (const float*)bi, (float*)part, Tn, H, W, Ho, Wo, Cin, C, n_tx, n_tseg);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after the launch: 0 means the kernel was launched. The partial buffers
// have the row counts of dw_act_partial_rows.

// Rows of the partial-sum buffer of the weight gradient (kind 2: K10 mm,
// at stride (1,2,2)).
extern "C" int dw_act_partial_rows(int kind, int B, int T, int H, int W,
                                   int C) {
  (void)C;
  switch (kind) {
    case 2: {
      const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
      return cdiv(Ho, SGeom<2>::OH) * cdiv(Wo, SGeom<2>::OW) * B *
             cdiv(T, TT_WG);
    }
  }
  return -1;
}

// x is conv1's input (B,T,H,W,Cin), w1 (Cin,C) its weight; g and
// dam have C channels: dam = da * relu'((x@W1)*sc + bi) in g's dtype.
extern "C" int dw_mm_dx_mask_s2(const void* g, const void* x, const void* w1,
                                const void* w, const void* sc, const void* bi,
                                void* dam, int B, int T, int H, int W, int Cin,
                                int C, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dx_s2<__nv_bfloat16>(g, x, w1, w, sc, bi, dam, B, T, H, W,
                                       Cin, C, st);
  return launch_dx_s2<float>(g, x, w1, w, sc, bi, dam, B, T, H, W, Cin, C,
                             st);
}

extern "C" int dw_mm_wgrad_s2(const void* x, const void* w1, const void* g,
                              const void* sc, const void* bi, void* part, int B,
                              int T, int H, int W, int Cin, int C, int is_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_wgrad<__nv_bfloat16, 2>(x, w1, g, sc, bi, part, B, T, H,
                                          W, Cin, C, st);
  return launch_wgrad<float, 2>(x, w1, g, sc, bi, part, B, T, H, W, Cin, C,
                                st);
}
