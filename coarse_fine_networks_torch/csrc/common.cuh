// Pieces shared by the bottleneck-entry kernels (dw_mm_act.cu) and their
// backward (dw_act_bwd.cu): the block shape, the dtype converters, the
// stencil tile geometry, the batch-norm apply and the activation.
//
// The activation is defined once here because the forward's relu branch and
// the backward's relu' mask must agree element for element: a flipped mask
// is an O(1) error in dx.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cfn {

constexpr int CC = 32;     // channels per block, one per lane
constexpr int WARPS = 8;   // 256 threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x*sc + bi with each operation rounded to f32 (no contraction to an FMA),
// as PyTorch's two elementwise ops round them, so the kernels and the plain
// versions take the same relu branch even within one rounding of 0
__device__ __forceinline__ float bn_apply(float v, float sc, float bi) {
  return __fadd_rn(__fmul_rn(v, sc), bi);
}

// The train entry's activation a = relu(x*sc + bi), rounded to x's dtype T
// (the stencil reads a as stored in T) and returned as f32
template <typename T>
__device__ __forceinline__ float act(float v, float sc, float bi) {
  return to_f(from_f<T>(fmaxf(bn_apply(v, sc, bi), 0.f)));
}

// Stencil tiles: an OH x OW tile of outputs at stride (1,S,S), with a halo
// of S*(O-1)+3 input rows/cols around it (origin S*o0 - 1). Each warp takes
// every WARPS-th halo position (NPA of them) and every WARPS-th output (NO).
template <int S> struct StencilTile;
template <> struct StencilTile<1> { static constexpr int OH = 8, OW = 8; };
template <> struct StencilTile<2> { static constexpr int OH = 4, OW = 8; };

template <int S> struct StencilGeom {
  static constexpr int OH = StencilTile<S>::OH, OW = StencilTile<S>::OW;
  static constexpr int HR = S * (OH - 1) + 3, WR = S * (OW - 1) + 3;
  static constexpr int P = HR * WR;
  static constexpr int NPA = (P + WARPS - 1) / WARPS;
  static constexpr int NO = OH * OW / WARPS;
};

// ring slot of frame t (frames t-1, t, t+1 live in three slots)
__device__ __forceinline__ int slot_of(int t) { return ((t % 3) + 3) % 3; }

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The shared-memory limit is a per-device attribute: set it on every launch,
// so the kernel runs on whichever card is current.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace cfn
