// Pieces shared by the port's kernels: the dtype converters, the batch-norm
// apply and the activation, and conv1's product on the tensor cores with
// its in-order f32 sum (mm_strip.cuh builds on them).
//
// The activation is defined once here because the forward's relu branch and
// the backward's relu' mask must agree element for element: a flipped mask
// is an O(1) error in dx.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cfn {

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

// The relu of every kernel: one compare that keeps a NaN input, as
// torch.relu and the JAX package's jnp.maximum(v, 0) keep it (fmaxf would
// return 0: it returns its non-NaN operand). It gives -0 for -0, as
// torch.relu does; no sum's value depends on the sign of a zero term.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// ---- conv1's product in bf16 on the tensor cores ---------------------------
// ldmatrix of four (x4) or two (x2) 8x8 b16 matrices from shared memory, and
// mma.sync.m16n8k16 with bf16 inputs and f32 accumulation.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// conv1's product in bf16 on the tensor cores (mm_strip_product,
// mm_strip.cuh: the mm forwards, the masked dx, K6 mm): one 16 x 8 tile of z = x @ W1 (16 positions x 8
// channels), with s = |x| @ |W1| beside it: acc += a . bt^T and sacc += |a|
// . |bt|^T in nk k-steps of 16, ascending, two mma.m16n8k16 each (|.|
// clears the fragments' sign bits). a holds the tile's 16 positions (row
// stride lda elements), bt its 8 channels' W1 columns (W1 transposed, row
// stride ldb); both in shared memory, rows 16-byte aligned, zero past C_in.
// The thread's elements are acc[0..1] at row lane/4, columns 2*(lane%4) and
// +1, and acc[2..3] at row lane/4 + 8.
__device__ __forceinline__ void mm_ksteps_bf16(float (&acc)[4],
                                               float (&sacc)[4],
                                               const __nv_bfloat16* a,
                                               int lda,
                                               const __nv_bfloat16* bt,
                                               int ldb, int nk) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* ap = a + (lane & 15) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* bp = bt + (lane & 7) * ldb + ((lane >> 3) & 1) * 8;
  for (int s = 0; s < nk; ++s) {
    uint32_t fa[4], fb[2];
    ldsm_x4(fa, ap + 16 * s);
    ldsm_x2(fb, bp + 16 * s);
    mma_bf16(acc, fa, fb);
#pragma unroll
    for (int i = 0; i < 4; ++i) fa[i] &= 0x7fff7fffu;
    fb[0] &= 0x7fff7fffu;
    fb[1] &= 0x7fff7fffu;
    mma_bf16(sacc, fa, fb);
  }
}

// z = x . w over k = 0 .. Cin-1, summed in f32 with fmaf in order from 0:
// the in-order sum that settles every mm kernel's relu branch near 0 (and
// the arithmetic of mm_strip_product in f32), for x and w contiguous along
// k, 16-byte aligned, with Cin % 8 == 0 (read 16 bytes at a time). It runs
// only within mm_band of a relu input's 0, a few elements in ten thousand
// or fewer.
template <typename T>
__device__ __forceinline__ float mm_z_fmaf(const T* x, const T* w,
                                           int Cin) {
  constexpr int VE = 16 / sizeof(T);
  float z = 0.f;
  for (int k = 0; k < Cin; k += VE) {
    const uint4 xu = *reinterpret_cast<const uint4*>(x + k);
    const uint4 wu = *reinterpret_cast<const uint4*>(w + k);
    const T* xv = reinterpret_cast<const T*>(&xu);
    const T* wv = reinterpret_cast<const T*>(&wu);
#pragma unroll
    for (int j = 0; j < VE; ++j) z = fmaf(to_f(xv[j]), to_f(wv[j]), z);
  }
  return z;
}

// The tensor cores add an mma's products (and the accumulator) aligned to
// the largest and drop the bits below, at most 17 units of 2^-23 of s = |x|
// . |W1| per k-step; mm_z_fmaf's f32 sum in order is within Cin units of
// 2^-24 of s of the exact sum. So where a relu input v = bn_apply(z, sc, bi)
// from the tensor cores' z has |v| >= mm_band(nk, Cin) |sc| s (twice both
// bounds), it has the sign mm_z_fmaf's z gives it. Where it has not,
// mm_strip_product sums z again with mm_z_fmaf, so every mm kernel takes
// that sum's relu branch element for element, whatever its tile: a
// flipped mask is an O(1) error in dx. (Where s = 0 every product is 0 and
// both sums are 0.)
__device__ __forceinline__ float mm_band(int nk, int Cin) {
  return 0x1p-18f * nk + 0x1p-23f * Cin;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The shared-memory limit is a per-device attribute of a kernel, and a
// launch that asks for more than the limit is refused (cudaErrorInvalidValue).
// Threads launch the same kernel at once (a loader's workers), so a limit is
// only ever raised, under a lock, on the current card: a lower value set
// between another thread's set and its launch would refuse that launch.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> limit;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(mu);
  size_t& cur = limit[{reinterpret_cast<const void*>(kernel), dev}];
  if (bytes <= cur) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) cur = bytes;
  return (int)e;
}

}  // namespace cfn
