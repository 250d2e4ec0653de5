// conv1's product on the row-strip layout, shared by the mm forwards
// (dw_mm_act.cu, mm_fwd_s1_kernel, K1 mm; dw_plain_s2.cu,
// mm_s2_fwd_kernel, K4 mm), the masked dx (dw_dx_s1.cu, mm_dx_s1_kernel,
// K2; dw_plain_s2.cu, mm_s2_dx_kernel, K9) and the stride-1 mm weight
// gradients (dw_plain_s1.cu, mm_wgrad_s1_kernel, K6 mm; dw_plain_s2.cu,
// mm_s2_wgrad_kernel, K10 mm): W1's column group and bn1's apply vectors
// staged once per block, and the product of one staged x frame with its
// relu inputs, each within mm_band of 0 settled against mm_z_fmaf's
// in-order sum. All six call the same code, so the forwards' activation,
// the masked dx's mask and the weight gradients' activation take one relu
// branch, element for element (a flipped mask is an O(1) error in dx). All
// six also stage a rectangle of x the same way (MmRect, each with its own
// places) in one shared-memory layout from the x ring on (mm_front); the
// forwards and the weight gradients activate into a slot (mm_activate: K1
// mm's and K6 mm's [R+2][WB+2][2PG], mm_layout; K4 mm's and K10 mm's in
// the stride-2 kernels' de-interleaved layout), and K2 and K9 take their
// masks in one phase (mm_masks).

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
// mm_wgrad_s1_kernel, mm_s2_fwd_kernel, mm_s2_wgrad_kernel, mm_masks)
constexpr int XSTAGE_MM = 3;

// The shared memory of a row-strip mm kernel from its x ring on (mm_front):
// a ring of XSTAGE_MM staged x frames at xs_off, W1's columns, bn1's
// vectors and the positions' table, which ends at total. The forwards put
// two activated slots of aslot bytes each before the ring (mm_layout,
// mm_s2_fwd_layout); the masked dx puts its mask slots after the table
// (mm_mask_layout).
struct MmLayout {
  int ld;      // staged x row stride, elements: bf16 C_in rounded up to 16,
               // + 8 (an odd multiple of 16 bytes: ldmatrix without bank
               // conflicts); f32 C_in
  int ng;      // W1 columns staged: 2PG, rounded up to 8 in bf16
  int rows;    // staged positions, rounded up to 16
  int aslot;   // bytes of one activated slot (the forwards)
  int xslot;   // bytes of one staged x frame
  int xs_off, wt_off, vec_off, tab_off, total;  // byte offsets and size
};

// The layout from the x ring on: frames of `positions` staged positions at
// xs_off, the ring at least ring_min bytes (a ring another phase reuses)
template <typename T>
__host__ __device__ __forceinline__ MmLayout mm_front(int positions, int Cin,
                                                      int PG, int xs_off,
                                                      int ring_min) {
  const bool bf = sizeof(T) == 2;
  MmLayout L;
  L.rows = (positions + 15) / 16 * 16;
  L.ld = bf ? (Cin + 15) / 16 * 16 + 8 : Cin;
  L.ng = bf ? (2 * PG + 7) / 8 * 8 : 2 * PG;
  L.aslot = 0;
  L.xslot = L.rows * L.ld * (int)sizeof(T);
  L.xs_off = xs_off;
  const int xring = XSTAGE_MM * L.xslot;
  L.wt_off = xs_off + (xring > ring_min ? xring : ring_min);
  const int wt = bf ? L.ng * L.ld * 2 : Cin * 2 * PG * 4;
  L.vec_off = L.wt_off + (wt + 15) / 16 * 16;
  // bn1's sc and bi, and mm_band's bound per unit of s, per channel
  L.tab_off = L.vec_off + 3 * ((L.ng * 4 + 15) / 16 * 16);
  L.total = L.tab_off + L.rows * 4;
  return L;
}

// K1 mm's layout (mm_fwd_s1_kernel; the first part of mm_wgrad_s1_kernel's):
// two activated slots [R+2][WB+2][2PG] in T at 0, then mm_front's of the
// (R+2) x min(WB+2, W) staged positions
template <typename T>
__host__ __device__ __forceinline__ MmLayout mm_layout(int R, int WB, int PG,
                                                       int Cin, int W) {
  const int aslot = stage_elems<T>(R + 2, WB, PG) * (int)sizeof(T);
  MmLayout L = mm_front<T>((R + 2) * min(WB + 2, W), Cin, PG, 2 * aslot, 0);
  L.aslot = aslot;
  return L;
}

// A rectangle of conv1's input staged whole: input rows r0 .. r0+nr and
// columns c0 .. c0+nc, clipped to the frame. Staged positions p = rr * ncs
// + col: staged row rr (input row r0 + rr; rows [rlo, rhi) lie in the
// frame) at input column cs0 + col, all C_in channels, rows of ld
// elements; the product reads the M positions up to the frame's last row.
// K1 mm and K6 mm stage rows h0-1 .. h0+R+1 and columns w0-1 .. w0+WB+1,
// K4 mm and K10 mm rows 2h0-1 .. 2h0+2R and columns 2w0-1 .. 2w0+2WB, the
// masked dx
// (mm_masks) the dx positions a block writes.
struct MmRect {
  int cs0, ncs, M, rlo, rhi, n16, nch, my_src, my_dst;

  // VE: elements in 16 bytes
  __device__ __forceinline__ MmRect(int r0, int nr, int c0, int nc, int H,
                                    int W, int Cin, int ld, int VE) {
    cs0 = max(c0, 0);
    ncs = min(c0 + nc, W) - cs0;
    rlo = max(0, -r0);
    rhi = min(nr, H - r0);
    M = rhi * ncs;
    n16 = Cin / VE;   // 16-byte chunks of a position
    nch = ncs * n16;  // ... of a row
    // the thread's chunk of every staged row (where a row has no more
    // chunks than the block has threads: every shape of the path)
    my_src = (threadIdx.x / n16) * Cin + (threadIdx.x % n16) * VE;
    my_dst = (threadIdx.x / n16) * ld + (threadIdx.x % n16) * VE;
  }

  // each staged position's place (-1: outside the frame or past M) for the
  // rows positions the product reads: place(rr, input column)
  template <typename PLACE>
  __device__ __forceinline__ void table(int* tab, int rows,
                                        PLACE place) const {
    for (int p = threadIdx.x; p < rows; p += blockDim.x) {
      const int rr = p / ncs;
      tab[p] = p < M && rr >= rlo ? place(rr, cs0 + p - rr * ncs) : -1;
    }
  }

  // x rows of one frame, f pointing at staged row 0 (input row r0), column
  // cs0, into d; by cp.async, 16 bytes at a time (no commit)
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

// The masked dx's shared memory (mm_masks): mm_front's at 0, its x ring at
// least ring_min bytes (the stencil's g ring, which reuses it), then TT
// mask slots of mbytes each
struct MmMaskLayout {
  MmLayout f;
  int mbytes, mask_off, total;
};

template <typename T>
__host__ __device__ __forceinline__ MmMaskLayout mm_mask_layout(
    int positions, int Cin, int PG, int ring_min, int mask_elems, int TT) {
  MmMaskLayout L;
  L.f = mm_front<T>(positions, Cin, PG, 0, ring_min);
  L.mbytes = (mask_elems + 15) / 16 * 16;
  L.mask_off = L.f.total;
  L.total = L.mask_off + TT * L.mbytes;
  return L;
}

// The relu branch of every (frame, position, channel) of a block's frame
// segment, the masked dx's first phase (dw_dx_s1.cu: mm_dx_s1_kernel, K2;
// dw_plain_s2.cu: mm_s2_dx_kernel, K9): nx frames of mr's rectangle of x
// (xb: its staged row 0 and column cs0 in the segment's first frame; frames
// `frame` elements apart), staged by cp.async XSTAGE_MM frames deep into
// the ring at smem; conv1's product by mm_strip_product with W1's columns
// c0 .. c0+2PG staged once; frame j's branches (relu input > 0), a byte per
// channel, into mask slot j at place(rr, input column). Every thread of the
// block calls it; on return every mask is written and the ring is read by
// no one.
template <typename T, typename PLACE>
__device__ __forceinline__ void mm_masks(
    unsigned char* smem, const MmMaskLayout& L, const MmRect& mr, PLACE place,
    const T* xb, size_t frame, int nx, const T* __restrict__ w1,
    const float* __restrict__ sc, const float* __restrict__ bi, int W,
    int Cin, int C, int c0, int PG) {
  const MmLayout& F = L.f;
  T* ring = reinterpret_cast<T*>(smem);
  T* wt = reinterpret_cast<T*>(smem + F.wt_off);
  float* scs = reinterpret_cast<float*>(smem + F.vec_off);
  float* bis = scs + (F.ng + 3) / 4 * 4;
  float* kbs = bis + (F.ng + 3) / 4 * 4;
  int* tab = reinterpret_cast<int*>(smem + F.tab_off);
  unsigned char* mask = smem + L.mask_off;
  const int PG2 = 2 * PG, xslot = F.xslot / (int)sizeof(T);
  // the staged rows' columns past C_in (bf16: up to ld - 8) are never
  // copied and stay zero
  zero_ring(smem, F.wt_off);
  mm_stage_vecs(scs, bis, kbs, sc, bi, C, c0, PG2, F.ng,
                mm_band((F.ld - 8) / 16, Cin));
  mm_stage_w1<T>(wt, w1, Cin, C, c0, PG2, F.ng, F.ld);
  mr.table(tab, F.rows, place);
  auto load_x = [&](int j) {  // x frame j into ring slot j % XSTAGE_MM
    if (j < nx)               // uniform across the block
      mr.stage(ring + (j % XSTAGE_MM) * xslot, xb + (size_t)j * frame, W,
               Cin, F.ld);
    cp_commit();
  };
  for (int j = 0; j < XSTAGE_MM - 1; ++j) load_x(j);
  for (int j = 0; j < nx; ++j) {
    cp_wait<XSTAGE_MM - 2>();  // this thread's copies of frame j have landed
    __syncthreads();           // and everyone's; slot j-1 is read by no one
    load_x(j + XSTAGE_MM - 1);
    unsigned char* mk = mask + j * L.mbytes;
    mm_strip_product<T>(
        ring + (j % XSTAGE_MM) * xslot, wt, F.ld, F.ng, PG, mr.M, Cin, scs,
        bis, kbs, tab,
        [&](int at, int ch, float v0, float v1) {
          *reinterpret_cast<unsigned short*>(mk + at + ch) =
              (unsigned short)((v0 > 0.f) | ((v1 > 0.f) << 8));
        },
        [&](int at, int cc, float v) { mk[at + cc] = v > 0.f; });
  }
  cp_wait<0>();
  __syncthreads();  // every mask is written; the ring is read by no one
}

}  // namespace cfn
