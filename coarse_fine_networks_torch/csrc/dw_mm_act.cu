// X3D bottleneck entry for Hopper (sm_90a), three modes:
//
//   mm    (eval):            y = dwconv3x3x3( relu( (x @ W1) * sc + bi ) )
//   act   (train):           y = dwconv3x3x3( relu( x * sc + bi ) )
//   plain (train, split bn): y = dwconv3x3x3( x )
//
// mm and act at stride 1 or (1,2,2), plain at stride (1,2,2) only (its
// stride-1 entry, dw_conv_s1, has a layout of its own in dw_plain_s1.cu).
// x (B,T,H,W,C_in) and y (B,T,Ho,Wo,C_mid) are channels-last, f32 or bf16; W1 (C_in,C_mid) and the depthwise taps
// (27,C_mid) have x's dtype; sc/bi are f32 per-channel batch-norm apply
// vectors of bn1 (running statistics in eval, batch statistics in train). In
// act and plain mode x is the conv1 output (plain: already normalised per
// split and activated) and C_in == C_mid.
//
// Replaces three modes of two TPU Pallas kernels of
// coarse_fine_networks_tpu/ops/pallas/dw_fold.py:
//   * dw_mm_act_s1 / dw_act_s1 <- _dw_fold4_pcall -> _fwd_kernel (stride 1,
//     modes mm and act), and
//   * dw_mm_act_s2 / dw_act_s2 / dw_conv_s2 <- _fwd_s2_direct_pcall ->
//     _fwd_s2_direct_kernel (stride (1,2,2), only the kept quarter of
//     positions is computed; modes mm, act and plain),
// with the tile prologues _mm_act_tile (mm) and _act_tile (act); plain mode
// has none. Semantics kept from them:
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
// memory (in mm mode not even the C_mid product, 2.25x the bytes of x). A
// block owns one (frame segment, output tile, 32-channel chunk); it walks its
// frames in order and keeps the three activated frames the stencil needs in
// a shared-memory ring, so each input frame is activated once per tile (plus
// the spatial halo) rather than three times. In mm mode x is staged 32 input
// channels at a time with 16-byte loads along C, by the prologue the
// backward shares (mm_prologue, common.cuh); in act mode each lane loads
// its own channel (C_mid = 54, 108, ... is no multiple of 8, so 16-byte
// loads would straddle positions); plain mode loads as act mode does, with
// no prologue. Each lane owns one output channel, so
// shared-memory reads of the ring are conflict-free and stores of y are
// coalesced along C. The product runs on the FP32 cores; moving it to wgmma
// and overlapping the staging with TMA is later work.

#include "common.cuh"

namespace {

using namespace cfn;

constexpr int TT = 8;      // output frames per block

enum Mode { MM, ACT, PLAIN };

template <int S, int MODE> struct Geom : StencilGeom<S> {
  using SG = StencilGeom<S>;
  // act and plain mode stage nothing besides the ring
  static constexpr size_t SMEM =
      sizeof(float) *
      (3 * SG::P * CC + (MODE != MM ? 0 : SG::P * KC + KC * CC));
};

template <typename T, int S, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
dw_mm_act_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ wdw, const float* __restrict__ sc,
                 const float* __restrict__ bi, T* __restrict__ y, int B,
                 int Tn, int H, int W, int Cin, int Cmid, int Ho, int Wo,
                 int n_tx, int n_tseg) {
  using G = Geom<S, MODE>;
  constexpr int P = G::P, WR = G::WR;

  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                 // [3][P][CC] activated frames
  float* xs = ring + 3 * P * CC;      // [P][KC]   staged input chunk
  float* ws = xs + P * KC;            // [KC][CC]  staged W1 chunk

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int oy0 = (blockIdx.x / n_tx) * G::OH;
  const int ox0 = (blockIdx.x % n_tx) * G::OW;
  const int iy0 = S * oy0 - 1, ix0 = S * ox0 - 1;  // halo origin
  const int c0 = blockIdx.y * CC;
  const int b = blockIdx.z / n_tseg;
  const int t0 = (blockIdx.z % n_tseg) * TT;
  const int t1 = min(t0 + TT, Tn);
  const int c = c0 + lane;
  const bool cval = c < Cmid;

  const float scv = (MODE != PLAIN && cval) ? sc[c] : 0.f;
  const float biv = (MODE != PLAIN && cval) ? bi[c] : 0.f;
  float wt[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) wt[k] = cval ? to_f(wdw[k * Cmid + c]) : 0.f;

  // ring slot <- relu((x[b, ti] @ W1) * sc + bi) (mm), relu(x[b, ti] * sc
  // + bi) (act) or x[b, ti] (plain) over the halo, zero outside the tensor
  // (frame, rows, cols) and for channels >= Cmid
  auto activate = [&](int ti) {
    float* slot = ring + slot_of(ti) * P * CC;
    if (ti < 0 || ti >= Tn) {  // uniform across the block
      for (int i = tid; i < P * CC; i += WARPS * 32) slot[i] = 0.f;
      return;
    }
    if constexpr (MODE != MM) {
      const T* xf = x + (size_t)(b * Tn + ti) * H * W * Cmid;
#pragma unroll
      for (int j = 0; j < G::NPA; ++j) {
        const int p = warp + j * WARPS;
        if (p < P) {
          const int gy = iy0 + p / WR, gx = ix0 + p % WR;
          float a = 0.f;
          if (cval && gy >= 0 && gy < H && gx >= 0 && gx < W) {
            a = to_f(xf[((size_t)gy * W + gx) * Cmid + c]);
            // the relu branch the backward's mask takes (dw_act_bwd.cu)
            if (MODE == ACT) a = act<T>(a, scv, biv);
          }
          slot[p * CC + lane] = a;
        }
      }
      return;
    }
    // the prologue the backward's mask and weight gradient share
    float a[G::NPA];
    mm_prologue<T, false, P, WR, G::NPA>(
        a, xs, ws, x + (size_t)(b * Tn + ti) * H * W * Cin, w1, H, W, Cin,
        Cmid, c0, iy0, ix0, scv, biv);
#pragma unroll
    for (int j = 0; j < G::NPA; ++j) {
      const int p = warp + j * WARPS;
      if (p < P) slot[p * CC + lane] = a[j];
    }
  };

  activate(t0 - 1);
  activate(t0);
  for (int t = t0; t < t1; ++t) {
    activate(t + 1);
    __syncthreads();  // the three frames of the stencil are in the ring
    const float* fm = ring + slot_of(t - 1) * P * CC;
    const float* f0 = ring + slot_of(t) * P * CC;
    const float* fp = ring + slot_of(t + 1) * P * CC;
#pragma unroll
    for (int j = 0; j < G::NO; ++j) {
      const int o = warp + j * WARPS;
      const int oy = o / G::OW, ox = o % G::OW;
      float acc = 0.f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const float* f = dt == 0 ? fm : (dt == 1 ? f0 : fp);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int p = (S * oy + dy) * WR + S * ox + dx;
            acc = fmaf(wt[(dt * 3 + dy) * 3 + dx], f[p * CC + lane], acc);
          }
        }
      }
      const int gy = oy0 + oy, gx = ox0 + ox;
      if (cval && gy < Ho && gx < Wo)
        y[(((size_t)(b * Tn + t) * Ho + gy) * Wo + gx) * Cmid + c] =
            from_f<T>(acc);
    }
    __syncthreads();  // the next activate overwrites frame t-1's slot
  }
}

template <typename T, int S, int MODE>
int launch(const void* x, const void* w1, const void* wdw, const void* sc,
           const void* bi, void* y, int B, int Tn, int H, int W, int Cin,
           int Cmid, cudaStream_t stream) {
  using G = Geom<S, MODE>;
  if (int e = set_smem(dw_mm_act_kernel<T, S, MODE>, G::SMEM)) return e;
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int n_tx = cdiv(Wo, G::OW), n_tseg = cdiv(Tn, TT);
  const dim3 grid(cdiv(Ho, G::OH) * n_tx, cdiv(Cmid, CC), B * n_tseg);
  dw_mm_act_kernel<T, S, MODE><<<grid, dim3(32, WARPS), G::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(wdw), static_cast<const float*>(sc),
      static_cast<const float*>(bi), static_cast<T*>(y), B, Tn, H, W, Cin,
      Cmid, Ho, Wo, n_tx, n_tseg);
  return (int)cudaGetLastError();
}

template <int S, int MODE>
int dispatch(const void* x, const void* w1, const void* wdw, const void* sc,
             const void* bi, void* y, int B, int Tn, int H, int W, int Cin,
             int Cmid, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, S, MODE>(x, w1, wdw, sc, bi, y, B, Tn, H, W,
                                          Cin, Cmid, s);
  return launch<float, S, MODE>(x, w1, wdw, sc, bi, y, B, Tn, H, W, Cin, Cmid,
                                s);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after the launch: 0 means the kernel was launched.
extern "C" int dw_mm_act_s1(const void* x, const void* w1, const void* wdw,
                            const void* sc, const void* bi, void* y, int B,
                            int T, int H, int W, int Cin, int Cmid,
                            int is_bf16, void* stream) {
  return dispatch<1, MM>(x, w1, wdw, sc, bi, y, B, T, H, W, Cin, Cmid,
                         is_bf16, stream);
}

extern "C" int dw_mm_act_s2(const void* x, const void* w1, const void* wdw,
                            const void* sc, const void* bi, void* y, int B,
                            int T, int H, int W, int Cin, int Cmid,
                            int is_bf16, void* stream) {
  return dispatch<2, MM>(x, w1, wdw, sc, bi, y, B, T, H, W, Cin, Cmid,
                         is_bf16, stream);
}

// act mode: x is (B,T,H,W,C), the conv1 output; no W1.
extern "C" int dw_act_s1(const void* x, const void* wdw, const void* sc,
                         const void* bi, void* y, int B, int T, int H, int W,
                         int C, int is_bf16, void* stream) {
  return dispatch<1, ACT>(x, nullptr, wdw, sc, bi, y, B, T, H, W, C, C,
                          is_bf16, stream);
}

extern "C" int dw_act_s2(const void* x, const void* wdw, const void* sc,
                         const void* bi, void* y, int B, int T, int H, int W,
                         int C, int is_bf16, void* stream) {
  return dispatch<2, ACT>(x, nullptr, wdw, sc, bi, y, B, T, H, W, C, C,
                          is_bf16, stream);
}

// plain mode: x is (B,T,H,W,C), already activated; no W1, sc or bi.
extern "C" int dw_conv_s2(const void* x, const void* wdw, void* y, int B,
                          int T, int H, int W, int C, int is_bf16,
                          void* stream) {
  return dispatch<2, PLAIN>(x, nullptr, wdw, nullptr, nullptr, y, B, T, H, W,
                            C, C, is_bf16, stream);
}
