// conv1's product on the row-strip layout, shared by the stride-1 mm
// forward (dw_mm_act.cu, mm_fwd_s1_kernel, K1 mm), the stride-1 masked dx
// (dw_dx_s1.cu, mm_dx_s1_kernel, K2) and the stride-1 mm weight gradient
// (dw_plain_s1.cu, mm_wgrad_s1_kernel, K6 mm): W1's column group and bn1's
// apply vectors staged once per block, and the product of one staged x
// frame with its relu inputs, each within mm_band of 0 settled against
// mm_prologue's sum. All three call the same code, so the forward's
// activation, the masked dx's mask and the weight gradient's activation
// take one relu branch, element for element (a flipped mask is an O(1)
// error in dx). K1 mm and K6 mm also share the tile's staging of x
// (MmTile), its shared-memory layout (mm_layout) and the activated slot
// (mm_activate).

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

// x frames in the mm kernels' staging ring (mm_fwd_s1_kernel,
// mm_wgrad_s1_kernel)
constexpr int XSTAGE_MM = 3;

// The shared memory of a row-strip mm kernel (mm_fwd_s1_kernel; the first
// part of mm_wgrad_s1_kernel's): two activated slots [R+2][WB+2][2PG] in T
// at 0, a ring of XSTAGE_MM staged x frames, W1's columns, bn1's vectors
// and the positions' table.
struct MmLayout {
  int ld;      // staged x row stride, elements: bf16 C_in rounded up to 16,
               // + 8 (an odd multiple of 16 bytes: ldmatrix without bank
               // conflicts); f32 C_in
  int ng;      // W1 columns staged: 2PG, rounded up to 8 in bf16
  int rows;    // staged positions: (R+2) x min(WB+2, W), rounded up to 16
  int aslot;   // bytes of one activated slot
  int xslot;   // bytes of one staged x frame
  int xs_off, wt_off, vec_off, tab_off, total;  // byte offsets and size
};

template <typename T>
__host__ __device__ __forceinline__ MmLayout mm_layout(int R, int WB, int PG,
                                                       int Cin, int W) {
  const bool bf = sizeof(T) == 2;
  MmLayout L;
  L.rows = ((R + 2) * min(WB + 2, W) + 15) / 16 * 16;
  L.ld = bf ? (Cin + 15) / 16 * 16 + 8 : Cin;
  L.ng = bf ? (2 * PG + 7) / 8 * 8 : 2 * PG;
  L.aslot = stage_elems<T>(R + 2, WB, PG) * (int)sizeof(T);
  L.xslot = L.rows * L.ld * (int)sizeof(T);
  L.xs_off = 2 * L.aslot;
  L.wt_off = L.xs_off + XSTAGE_MM * L.xslot;
  const int wt = bf ? L.ng * L.ld * 2 : Cin * 2 * PG * 4;
  L.vec_off = L.wt_off + (wt + 15) / 16 * 16;
  // bn1's sc and bi, and mm_band's bound per unit of s, per channel
  L.tab_off = L.vec_off + 3 * ((L.ng * 4 + 15) / 16 * 16);
  L.total = L.tab_off + L.rows * 4;
  return L;
}

// One tile's staging of conv1's input (mm_fwd_s1_kernel, mm_wgrad_s1_kernel):
// staged positions p = rr * ncs + col, staged row rr (input row h0-1+rr;
// rows [rlo, rhi) lie in the frame) at input column cs0 + col, all C_in
// channels, rows of ld elements.
struct MmTile {
  int cs0, ncs, M, rlo, rhi, n16, nch, my_src, my_dst;

  // VE: elements in 16 bytes
  __device__ __forceinline__ MmTile(const Tile& tl, int R, int WB, int H,
                                    int W, int Cin, int ld, int VE) {
    cs0 = max(tl.w0 - 1, 0);
    ncs = min(tl.w0 + WB + 1, W) - cs0;
    M = (R + 2) * ncs;
    rlo = max(0, 1 - tl.h0);
    rhi = min(R + 2, H + 1 - tl.h0);
    n16 = Cin / VE;  // 16-byte chunks of a position
    nch = ncs * n16;  // ... of a row
    // the thread's chunk of every staged row (where a row has no more
    // chunks than the block has threads: every shape of the path)
    my_src = (threadIdx.x / n16) * Cin + (threadIdx.x % n16) * VE;
    my_dst = (threadIdx.x / n16) * ld + (threadIdx.x % n16) * VE;
  }

  // each staged position's place in an activated slot (-1: outside the
  // frame or past M), for the rows positions the product reads
  __device__ __forceinline__ void table(int* tab, int rows, int WB, int PG2,
                                        int w0) const {
    for (int p = threadIdx.x; p < rows; p += blockDim.x) {
      const int rr = p / ncs;
      tab[p] = p < M && rr >= rlo && rr < rhi
                   ? (rr * (WB + 2) + p - rr * ncs + cs0 - w0 + 1) * PG2
                   : -1;
    }
  }

  // x rows of one frame, f pointing at staged row 0 (input row h0 - 1),
  // column cs0, into d; by cp.async, 16 bytes at a time (no commit)
  template <typename T>
  __device__ __forceinline__ void stage(T* d, const T* f, int W, int Cin,
                                        int ld) const {
    const int tid = threadIdx.x, nthreads = blockDim.x;
    if (nch <= nthreads) {
      if (tid < nch)
        for (int rr = rlo; rr < rhi; ++rr)
          cp_async16(d + rr * ncs * ld + my_dst,
                     f + (size_t)rr * W * Cin + my_src);
    } else {
      const int VE = Cin / n16;
      for (int q = tid; q < (rhi - rlo) * nch; q += nthreads) {
        const int v = q % n16, r2 = q / n16;
        const int col = r2 % ncs, rr = rlo + r2 / ncs;
        cp_async16(d + (rr * ncs + col) * ld + v * VE,
                   f + ((size_t)rr * W + col) * Cin + v * VE);
      }
    }
  }
};

// conv1's product of the staged x frame xf, bn1's apply and the relu,
// rounded to T, into the activated slot sl at each position's place
// (mm_strip_product; the other positions are not written). Every thread of
// the block calls it; it does not synchronise.
template <typename T>
__device__ __forceinline__ void mm_activate(T* sl, const T* xf, const T* wt,
                                            const MmLayout& L, int PG, int M,
                                            int Cin, const float* scs,
                                            const float* bis,
                                            const float* kbs,
                                            const int* tab) {
  mm_strip_product<T>(
      xf, wt, L.ld, L.ng, PG, M, Cin, scs, bis, kbs, tab,
      [&](int at, int ch, float v0, float v1) {
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(sl + at + ch) =
              __floats2bfloat162_rn(relu(v0), relu(v1));
        } else {
          *reinterpret_cast<float2*>(sl + at + ch) =
              make_float2(relu(v0), relu(v1));
        }
      },
      [&](int at, int cc, float v) { sl[at + cc] = from_f<T>(relu(v)); });
}

}  // namespace cfn
