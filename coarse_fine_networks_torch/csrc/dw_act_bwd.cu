// The stride-2 weight gradient of the matmul-fused X3D bottleneck entry
// for Hopper (sm_90a), K10 mm: the entry not yet on the row-strip layout.
//
//     y = dwconv3x3x3_(1,2,2)( a ),   a = relu( (x @ W1) * sc + bi )   (mm)
//
// x (B,T,H,W,Cin) is conv1's input and W1 (Cin,C) its weight, channels-
// last, f32 or bf16; sc/bi are bn1's f32 per-channel apply vectors (from the
// batch statistics in the train composite, the running ones in the eval
// entry). g is dL/dy (y's shape and dtype).
//
//   dw_mm_wgrad_s2 <- _wgrad_s2_pcall -> _wgrad_s2_kernel (mm mode, K10 mm)
// of coarse_fine_networks_tpu/ops/pallas/dw_fold.py: the backward of the
// train composite dw_fold4_mm_bn_train (_mm_bn_train_bwd) and of the eval
// entry dw_fold4_mm_act (_dw_mm_bwd). (The plain mode, the backward of
// dw_fold4_stride2, and the whole backward of the act mode are in
// dw_plain_s1.cu and dw_plain_s2.cu, with the stride-1 mm weight gradient,
// K6 mm, and the stride-2 masked dx, K9; the stride-1 dx of both modes, K3
// and K2, is in dw_dx_s1.cu.)
//
// wgrad: dk[tap,c] = sum_pos a_pad[2*pos + tap] * g[pos], with the forward's
//        rounded, zero-padded activation (the forward's prologue over the
//        halo, mm_prologue, common.cuh: conv1's product summed in order,
//        x*sc and + bi each rounded, so its relu branch is that of every
//        other mm kernel), summed in f32; per block an f32 partial (27, C).
//
// Reductions: no atomics. Each block writes its partial sums to its own row
// of a (rows, 27, C) buffer after a fixed-order sum over its warps; the
// wrapper sums the rows with one torch.sum, so runs repeat bit for bit.
//
// What bounds it on this card: bytes. It reads x and g (27 MACs per element
// of g), far below the ~295 operations per byte where the H100's tensor
// cores would become the limit, and the stencil's MACs run on the FP32
// cores. conv1's product adds Cin MACs per (position, channel), on the FP32
// cores here.
//
// What the design does about it: a block owns (frame segment, spatial tile,
// 32-channel chunk), walks its frames in order, and keeps the three
// activated frames its stencil reads in a shared-memory ring, so each frame
// is read once per tile plus a halo. Each lane owns one channel: ring reads
// are conflict-free, loads of channels-last tensors are contiguous along C.
// The activation and the reduction are fused in, so neither a nor conv1's
// C-wide product ever goes to device memory. Moving it onto K10 plain's row
// strips, as K6 mm is on K6 plain's, is later work.

#include "common.cuh"

namespace {

using namespace cfn;

constexpr int TT_WG = 16;  // frames per block (fewer partial rows)

// ---- geometry ---------------------------------------------------------------
// The weight gradients use StencilGeom<S> (common.cuh), the forward's
// tiles, over the stencil's output resolution.
template <int S> using SGeom = StencilGeom<S>;

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
    mm_prologue<T, G::P, G::WR, G::NPA>(
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
