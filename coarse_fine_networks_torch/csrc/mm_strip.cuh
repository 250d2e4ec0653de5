// conv1's product on the row-strip layout, shared by the stride-1 mm
// forward (dw_mm_act.cu, mm_fwd_s1_kernel, K1 mm) and the stride-1 masked
// dx (dw_dx_s1.cu, mm_dx_s1_kernel, K2): W1's column group and bn1's apply
// vectors staged once per block, and the product of one staged x frame
// with its relu inputs, each within mm_band of 0 settled against
// mm_prologue's sum. Both kernels call the same code, so the forward's
// activation and the masked dx's mask take one relu branch, element for
// element (a flipped mask is an O(1) error in dx).

#pragma once

#include "strip.cuh"

namespace cfn {

// W1's columns c0 .. c0 + ng of (Cin, Cmid) into shared memory: bf16
// wt[n][k] (W1 transposed, row stride ld, k < ld - 8), f32 wt[k][PG2]; zero
// past C_mid, past the group (n >= PG2) and in bf16 past C_in. Eight loads
// in flight per thread.
template <typename T>
__device__ __forceinline__ void mm_stage_w1(T* wt, const T* __restrict__ w1,
                                            int Cin, int Cmid, int c0,
                                            int PG2, int ng, int ld) {
  constexpr bool BF = sizeof(T) == 2;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int kn = BF ? ld - 8 : Cin;  // k rows staged
  const int total = kn * ng;
  for (int i0 = tid; i0 < total; i0 += 8 * nthreads) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads, kk = i / ng, n = i % ng;
      v[u] = i < total && kk < Cin && n < PG2 && c0 + n < Cmid
                 ? w1[(size_t)kk * Cmid + c0 + n]
                 : from_f<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads, kk = i / ng, n = i % ng;
      if (i < total) wt[BF ? n * ld + kk : kk * PG2 + n] = v[u];
    }
  }
}

// bn1's apply vectors of the group's channels c0 .. c0 + ng, and mm_band's
// bound per unit of s, band |sc|; all 0 past C_mid and past the group
// (never near the band)
__device__ __forceinline__ void mm_stage_vecs(float* scs, float* bis,
                                              float* kbs,
                                              const float* __restrict__ sc,
                                              const float* __restrict__ bi,
                                              int Cmid, int c0, int PG2,
                                              int ng, float band) {
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    const bool cv = i < PG2 && c0 + i < Cmid;
    scs[i] = cv ? sc[c0 + i] : 0.f;
    bis[i] = cv ? bi[c0 + i] : 0.f;
    kbs[i] = cv ? band * fabsf(sc[c0 + i]) : 0.f;
  }
}

// conv1's product of a staged x frame xf (positions p < M, row stride ld
// elements, all C_in) with the staged W1 columns wt, and bn1's apply from
// scs/bis: put2(at, ch, v0, v1) gets the relu inputs v = bn_apply(z, sc,
// bi) of channels ch and ch+1 (ch even, < PG2) at each position with at =
// tab[p] >= 0 (-1: outside the frame; rows up to M rounded up to 16 need
// an entry); put1(at, cc, v) writes one channel anew.
//   bf16: 16 x 8 tiles of (position, channel) on the tensor cores
//     (mm_ksteps_bf16), every nwarps-th to a warp, with s = |x| . |W1|
//     beside z. A relu input within mm_band of 0 (kbs s) sets a bit of the
//     lane's mask (bit 4*(tile's turn % 16) + 2*half + channel); every 16
//     turns, and after the last, the lane sums its marked elements again
//     in order (mm_z_fmaf) and puts them anew: no branch in the tiles' loop.
//   f32: fmaf over k = 0 .. C_in-1 in order, as mm_z_fmaf.
// Every thread of the block calls it; it does not synchronise.
template <typename T, typename PUT2, typename PUT1>
__device__ __forceinline__ void mm_strip_product(
    const T* xf, const T* wt, int ld, int ng, int PG, int M, int Cin,
    const float* scs, const float* bis, const float* kbs, const int* tab,
    PUT2 put2, PUT1 put1) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int PG2 = 2 * PG;
  if constexpr (sizeof(T) == 2) {
    const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
    const int ntl = ng / 8, tiles = (M + 15) / 16 * ntl;
    const int nk = (ld - 8) / 16;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    unsigned long long marks = 0;
    int turn = 0;
    for (int q = warp; q < tiles; q += nwarps, ++turn) {
      const int m = q / ntl, n = q % ntl;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, sacc[4] = {0.f, 0.f, 0.f, 0.f};
      mm_ksteps_bf16(acc, sacc, xf + m * 16 * ld, ld, wt + n * 8 * ld, ld,
                     nk);
      const int ch = n * 8 + c2;
      const bool chok = ch < PG2;
      const float sc0 = scs[ch], sc1 = scs[ch + 1];
      const float bi0 = bis[ch], bi1 = bis[ch + 1];
      const float kb0 = kbs[ch], kb1 = kbs[ch + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = tab[m * 16 + g + 8 * h];
        const float v0 = bn_apply(acc[2 * h], sc0, bi0);
        const float v1 = bn_apply(acc[2 * h + 1], sc1, bi1);
        if (at >= 0 && chok) put2(at, ch, v0, v1);
        const int bit = 4 * (turn & 15) + 2 * h;
        marks |= (unsigned long long)(at >= 0 &&
                                      fabsf(v0) < kb0 * sacc[2 * h])
                 << bit;
        marks |= (unsigned long long)(at >= 0 &&
                                      fabsf(v1) < kb1 * sacc[2 * h + 1])
                 << (bit + 1);
      }
      if ((turn & 15) == 15 || q + nwarps >= tiles) {  // uniform
        for (; marks; marks &= marks - 1) {  // rare
          const int b = __ffsll(marks) - 1;
          const int qq = q - (turn & 15) * nwarps + (b >> 2) * nwarps;
          const int p = qq / ntl * 16 + g + 8 * ((b >> 1) & 1);
          const int cc = qq % ntl * 8 + c2 + (b & 1);
          const float z = mm_z_fmaf(xf + p * ld, wt + cc * ld, Cin);
          put1(tab[p], cc, bn_apply(z, scs[cc], bis[cc]));
        }
      }
    }
  } else {
    for (int q = tid; q < M * PG; q += nthreads) {
      const int p = q / PG, ch = 2 * (q % PG);
      const int at = tab[p];
      if (at < 0) continue;
      const T* xp = xf + p * ld;
      float z0 = 0.f, z1 = 0.f;
      for (int kk = 0; kk < Cin; ++kk) {
        const float xv = to_f(xp[kk]);
        z0 = fmaf(xv, to_f(wt[kk * PG2 + ch]), z0);
        z1 = fmaf(xv, to_f(wt[kk * PG2 + ch + 1]), z1);
      }
      put2(at, ch, bn_apply(z0, scs[ch], bis[ch]),
           bn_apply(z1, scs[ch + 1], bis[ch + 1]));
    }
  }
}

}  // namespace cfn
