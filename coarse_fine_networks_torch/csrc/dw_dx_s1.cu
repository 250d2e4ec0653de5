// The stride-1 dx of the train-mode bottleneck entries, for Hopper (sm_90a):
//
//   dw_act_dx_s1      dam = da * 1[x*sc + bi > 0];  dx = dam*sc in x's
//                     dtype, and per block the f32 partial sums
//                     (sum dam*x, sum dam) per channel -> (dsc, dbi)
//   dw_mm_dx_mask_s1  dam = da * 1[(x @ W1)*sc + bi > 0] in g's dtype
//
// with da[t,h,w,c] = sum_{dt,dy,dx} k[2-dt, 2-dy, 2-dx, c] *
// g[t+dt-1, h+dy-1, w+dx-1, c] (SAME zero padding): the correlation of g
// with the flipped taps, in f32. g (B,T,H,W,C) is dL/dy, channels-last, f32
// or bf16; the taps k (27,C) have g's dtype; sc/bi are bn1's f32
// per-channel apply vectors. act: x (B,T,H,W,C) is conv1's output; mm: x
// (B,T,H,W,Cin) is conv1's input and W1 (Cin,C) its weight.
//
// Replaces two TPU Pallas kernels of
// coarse_fine_networks_tpu/ops/pallas/dw_fold.py:
//   * dw_act_dx_s1      <- _dx_act_pcall (:615) -> _fwd_kernel(actmask) (K3)
//   * dw_mm_dx_mask_s1  <- _dx_mask_pcall (:576) -> _fwd_kernel(dxmask) (K2)
// The fold4 lane layout is TPU mechanics and is not carried over.
//
// The relu test rounds x*sc and + bi apart (bn_apply, common.cuh), as
// PyTorch's two elementwise ops and the forward do; the mm mask is conv1's
// product by mm_strip_product (mm_strip.cuh), the code of the stride-1 mm
// forward, with every relu input within mm_band of 0 summed again in
// order (mm_z_fmaf): mask and forward take one relu branch.
//
// What bounds them on this card: bytes. act reads g and x and writes dx;
// mm reads g and x (C_in channels) and writes dam. The stencil is 27 MACs
// per element and conv1's product C_in MACs per (position, channel), on the
// bf16 tensor cores, far below the ~295 operations per byte where they
// would matter.
//
// What the design does about it: dw_plain_s1.cu's forward layout on g.
//   * A block owns R output rows x WB columns x PG channel pairs of one
//     sample over a segment of TT frames (ops/dw_conv.py: plan_act_dx_s1,
//     plan_mm_dx_s1; channel pairs first, so a warp's loads and stores are
//     runs of whole pixels at the path's widths). Its g rows (R+2, with the
//     column halo) are staged by cp.async into a ring of NSTAGE frames in
//     g's dtype, frame t+2 loading while frame t is computed.
//   * A thread owns one channel pair at one column over the R rows and
//     walks the frames with a register ring of the 3 output frames an input
//     frame feeds, adding each output's taps in the order dt, dy, dx with
//     one fmaf each: da equals dw_conv_s1 of g with the flipped taps, run
//     in f32, bit for bit.
//   * act: x's R rows at the thread's own column travel in the same ring
//     slot as g, one frame behind (slot i holds g frame t0-1+i and x frame
//     t0-2+i, the output frame step i completes), so the epilogue reads its
//     x pair from shared memory: mask, dx = dam*sc stored as a pair, and
//     (sum dam*x, sum dam) per channel kept in registers over the block's
//     walk, summed over the block's columns in a fixed order into the
//     block's row of a partial buffer that the wrapper adds with one
//     torch.sum: runs repeat bit for bit and nothing uses atomics.
//   * mm, in two phases: first the segment's relu branches, one byte per
//     (frame, position, channel) in shared memory (mm_strip.cuh's
//     mm_masks, which K9 shares): x's R rows (all C_in, the block's
//     columns, no halo) staged by cp.async three frames deep, conv1's
//     product by mm_strip_product (16x8 tiles on mma.m16n8k16 in bf16,
//     fmaf in order in f32) with W1's column group staged once; then
//     the stencil on g, each output frame written as dam = keep ? da : 0.
//     The product's registers and the stencil's (54 taps, the ring of 3R
//     pairs) are never live together, so neither spills.
//   * At most NT_DX = 192 threads (6 warps) a block: at two blocks per SM a
//     sub-partition holds 3 warps, so a thread may hold 168 registers (the
//     stencil's state and staging take 141-165, without spills; with 7
//     warps a block the limit is 128, and the act kernel spilled).
// A plan the kernels do not take returns cudaErrorInvalidValue.

#include "mm_strip.cuh"

namespace {

using namespace cfn;

// act: x is conv1's output, the epilogue masks, scales and reduces; mm: x
// is conv1's input, the mask is recomputed from conv1's product
enum Mode { ACT, MM };

template <typename T>
struct DxArgs {
  const T* g;    // (B,T,H,W,C)
  const T* x;    // act (B,T,H,W,C), mm (B,T,H,W,Cin)
  const T* w1;   // mm (Cin, C)
  const T* k;    // (27, C)
  const float* sc;
  const float* bi;
  T* out;        // act dx, mm dam: (B,T,H,W,C)
  float* part;   // act (blocks of a channel group, 2, C)
  int Tn, H, W, Cin, C;
  Plan pl;
};

// Shared memory. act: NSTAGE ring slots, each a g frame then an x frame.
// mm: mm_strip.cuh's mm_mask_layout: the ring (phase 1: XSTAGE_MM x frames
// of R x min(WB, W) positions; phase 2: NSTAGE g frames), then W1's
// columns, bn1's vectors, the positions' places and TT mask slots
// [R][WB][2PG] of bytes.
struct DxLayout {
  int gstage;  // elements of a staged g frame: [R+2][WB+2][2PG]
  int xstage;  // act: elements of a staged x frame [R][WB+2][2PG] (own
               // column only)
  int slot;    // act: elements of one ring slot (g, then x)
  int ring;    // bytes of the ring
  MmMaskLayout mm;  // mm: phase 1's layout
  int mask_off, mbytes, total;  // mm: the mask slots; the size
};

template <typename T, int MODE>
__host__ __device__ __forceinline__ DxLayout dx_layout(int R, int WB, int PG,
                                                       int Cin, int W,
                                                       int TT) {
  const int esz = (int)sizeof(T);
  DxLayout L;
  L.gstage = stage_elems<T>(R + 2, WB, PG);
  L.xstage = stage_elems<T>(R, WB, PG);
  L.slot = L.gstage + L.xstage;
  if (MODE == MM) {
    L.mm = mm_mask_layout<T>(R * min(WB, W), Cin, PG,
                             NSTAGE * L.gstage * esz, R * WB * 2 * PG, TT);
    L.ring = L.mm.f.wt_off;
    L.mask_off = L.mm.mask_off;
    L.mbytes = L.mm.mbytes;
    L.total = L.mm.total;
  } else {
    L.ring = NSTAGE * L.slot * esz;
    // the ring, reused at the end for the column sums [2][WB][2PG]
    const int red = 4 * 2 * WB * 2 * PG;
    L.mask_off = L.mbytes = 0;
    L.total = L.ring > red ? L.ring : red;
  }
  return L;
}

// Thread (wl, pi) = (tid / PG, tid % PG): column w0 + wl, channels c, c+1
// with c = 2*(p0 + pi). acc[j][r] holds output frame ti - 1 + j of row
// h0 + r while g frame ti is read: frame ti adds tap dt = 2 - j to it.
// After frame ti, acc[0] (output ti - 1) is complete, is written, and the
// ring shifts. Staged row rr is g row h0 - 1 + rr; staged column j is g
// column w0 - 1 + j.
template <typename T, int R, int MODE>
__device__ __forceinline__ void dx_s1_body(const DxArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const Plan& pl = a.pl;
  const int Tn = a.Tn, H = a.H, W = a.W, C = a.C, Cin = a.Cin;
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = (WB + 2) * PG2;
  const DxLayout L = dx_layout<T, MODE>(R, WB, PG, Cin, W, pl.TT);

  const int item = blockIdx.x;
  const Tile tl = pl.tile(item, blockIdx.y, Tn);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int wl = tid / PG, pi = tid % PG;
  const int w = tl.w0 + wl;
  const int c0 = 2 * tl.p0, c = c0 + 2 * pi;
  const bool in = wl < WB;  // threads past the block's columns read nothing
  const bool live = in && w < W && c < C;  // owns outputs
  const bool second = c + 1 < C;
  const size_t frame = (size_t)H * W * C;
  const int nrow = min(R, H - tl.h0);  // the tile's rows in the frame
  unsigned char* mask = smem_raw + L.mask_off;

  if constexpr (MODE == MM) {
    // ---- phase 1: the relu branch of every (frame, position, channel) of
    // the tile (mm_strip.cuh): x's R rows at the block's columns, no halo;
    // staged position (rr, input column w0 + e) -> mask slot place
    // [rr][e][2PG]
    const MmRect mr(tl.h0, R, tl.w0, WB, H, W, Cin, L.mm.f.ld,
                    16 / (int)sizeof(T));
    mm_masks<T>(smem_raw, L.mm, mr,
                [&](int rr, int col) { return (rr * WB + col - tl.w0) * PG2; },
                a.x + (((size_t)tl.b * Tn + tl.t0) * H + tl.h0) * W * Cin +
                    (size_t)tl.w0 * Cin,
                (size_t)H * W * Cin, tl.t1 - tl.t0, a.w1, a.sc, a.bi, W, Cin,
                C, c0, PG);
  }

  // ---- the stencil on g, and the epilogue
  float k0[27], k1[27];  // the flipped taps
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    k0[i] = live ? to_f(a.k[(26 - i) * C + c]) : 0.f;
    k1[i] = live && second ? to_f(a.k[(26 - i) * C + c + 1]) : 0.f;
  }
  // act: bn1's apply of the pair, and (sum dam*x, sum dam) per channel
  const float sc0 = live ? a.sc[c] : 0.f, bi0 = live ? a.bi[c] : 0.f;
  const float sc1 = live && second ? a.sc[c + 1] : 0.f;
  const float bi1 = live && second ? a.bi[c + 1] : 0.f;
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  const int stride = MODE == ACT ? L.slot : L.gstage;  // ring slot, elements
  const T* gb = a.g + (size_t)tl.b * Tn * frame;
  const T* xb = a.x + (size_t)tl.b * Tn * frame;  // act
  const Stager sg(tl, wl, pi, WB, PG2, W, C, pl.pairs);
  const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;  // g frames
  auto load = [&](int i) {
    if (i < nf) {  // uniform across the block
      T* sl = ring + (i % NSTAGE) * stride;
      const int ti = f0 + i;
      if (ti >= 0 && ti < Tn)
        sg.rows(sl, gb + (size_t)ti * frame, tl.h0 - 1, R + 2, H, W, rowlen,
                true);
      if constexpr (MODE == ACT) {
        const int tx = ti - 1;  // the output frame step i completes
        if (tx >= tl.t0 && tx < tl.t1)
          sg.rows(sl + L.gstage, xb + (size_t)tx * frame, tl.h0, R, H, W,
                  rowlen, false);
      }
    }
    cp_commit();
  };

  float acc[3][R][2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r][0] = acc[j][r][1] = 0.f;

  // rows and columns outside the frame are never copied: they read as the
  // zero padding for the whole tile
  zero_ring(smem_raw, L.ring);
  for (int i = 0; i < NSTAGE - 1; ++i) load(i);
  for (int i = 0; i < nf; ++i) {
    cp_wait<NSTAGE - 2>();  // this thread's copies of slot i have landed
    __syncthreads();        // and everyone's; slot i-1 is read by no one
    load(i + NSTAGE - 1);   // into slot i-1
    const int ti = f0 + i;
    const T* sl = ring + (i % NSTAGE) * stride;
    if (ti >= 0 && ti < Tn && in)  // frames outside the clip add nothing
      stencil_frame<T, R>(sl + wl * PG2 + 2 * pi, rowlen, PG2,
                          [&](int j, int r, int dy, int dx, float2 v) {
                            const int tap = ((2 - j) * 3 + dy) * 3 + dx;
                            acc[j][r][0] = fmaf(k0[tap], v.x, acc[j][r][0]);
                            acc[j][r][1] = fmaf(k1[tap], v.y, acc[j][r][1]);
                          });
    const int to = ti - 1;  // complete now
    if (to >= tl.t0 && live) {
      T* o = a.out + (((size_t)tl.b * Tn + to) * H + tl.h0) * W * C +
             (size_t)w * C + c;
      const bool pair = second && !(C & 1);  // a pair-aligned store
      if constexpr (MODE == ACT) {
        // x frame `to` at the thread's own column
        const T* xs = sl + L.gstage + (wl + 1) * PG2 + 2 * pi;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nrow) {
            const float2 xv = load_pair(xs + r * rowlen);
            const float d0 =
                bn_apply(xv.x, sc0, bi0) > 0.f ? acc[0][r][0] : 0.f;
            const float d1 =
                bn_apply(xv.y, sc1, bi1) > 0.f ? acc[0][r][1] : 0.f;
            store_pair(o + (size_t)r * W * C, d0 * sc0, d1 * sc1, pair,
                       second);
            sum[0][0] = fmaf(d0, xv.x, sum[0][0]);
            sum[1][0] += d0;
            sum[0][1] = fmaf(d1, xv.y, sum[0][1]);
            sum[1][1] += d1;
          }
      } else {
        // the relu branch of x frame `to`
        const unsigned char* mk =
            mask + (to - tl.t0) * L.mbytes + wl * PG2 + 2 * pi;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nrow) {
            const unsigned short kp =
                *reinterpret_cast<const unsigned short*>(mk + r * WB * PG2);
            store_pair(o + (size_t)r * W * C,
                       (kp & 0xff) ? acc[0][r][0] : 0.f,
                       (kp >> 8) ? acc[0][r][1] : 0.f, pair, second);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[0][r][0] = acc[1][r][0];
      acc[0][r][1] = acc[1][r][1];
      acc[1][r][0] = acc[2][r][0];
      acc[1][r][1] = acc[2][r][1];
      acc[2][r][0] = acc[2][r][1] = 0.f;
    }
  }
  cp_wait<0>();

  if constexpr (MODE == ACT) {
    // fixed-order sum over the block's columns: red[q][wl][2PG], then slot
    // (q, channel) adds its WB columns in order and writes row `item`
    __syncthreads();  // the ring is read by no one
    float* red = reinterpret_cast<float*>(smem_raw);
    if (in) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        red[(q * WB + wl) * PG2 + 2 * pi] = sum[q][0];
        red[(q * WB + wl) * PG2 + 2 * pi + 1] = sum[q][1];
      }
    }
    __syncthreads();
    for (int i = tid; i < 2 * PG2; i += nthreads) {
      const int q = i / PG2, s = i % PG2;
      const int ch = c0 + s;
      if (ch >= C) continue;
      float v = 0.f;
      for (int u = 0; u < WB; ++u) v += red[(q * WB + u) * PG2 + s];
      a.part[((size_t)item * 2 + q) * C + ch] = v;
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_DX, 2)
act_dx_s1_kernel(const DxArgs<T> a) {
  dx_s1_body<T, R, ACT>(a);
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_DX, 2)
mm_dx_s1_kernel(const DxArgs<T> a) {
  dx_s1_body<T, R, MM>(a);
}

// ---- launchers ---------------------------------------------------------------

// The kernel of a mode for R output rows (RMIN..RMAX), or null.
template <typename T, int MODE, int R>
inline decltype(&act_dx_s1_kernel<T, R>) kernel_at() {
  if constexpr (MODE == ACT) {
    return &act_dx_s1_kernel<T, R>;
  } else {
    return &mm_dx_s1_kernel<T, R>;
  }
}
template <typename T, int MODE>
decltype(&act_dx_s1_kernel<T, RMAX>) kernel_of(int R) {
  switch (R) {
    case 2: return kernel_at<T, MODE, 2>();
    case 3: return kernel_at<T, MODE, 3>();
    case 4: return kernel_at<T, MODE, 4>();
  }
  return nullptr;
}

template <typename T, int MODE>
int launch_dx(DxArgs<T> a, int B, int R, int WB, int PG, int TT, int rows,
              cudaStream_t st) {
  Plan p;
  // the tensors staged a channel pair at a time: g, and act's x
  const uintptr_t ptrs =
      (uintptr_t)a.g | (MODE == ACT ? (uintptr_t)a.x : (uintptr_t)0);
  if (!make_plan<T>(p, ptrs, B, a.Tn, a.H, a.W, a.C, R, WB, PG, TT) ||
      WB * PG > NT_DX)
    return (int)cudaErrorInvalidValue;
  // mm stages x with 16-byte copies
  if (MODE == MM && (a.Cin < 8 || a.Cin % 8 || (uintptr_t)a.x % 16))
    return (int)cudaErrorInvalidValue;
  // one block per work item and channel group; act: a partial row each
  const long long items = (long long)B * p.n_tseg * p.n_strip * p.n_wt;
  if (items > 0x7fffffff || (MODE == ACT && rows != items))
    return (int)cudaErrorInvalidValue;
  const int smem = dx_layout<T, MODE>(R, WB, PG, a.Cin, a.W, TT).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kern = kernel_of<T, MODE>(R);
  if (int e = set_smem(kern, smem)) return e;
  a.pl = p;
  kern<<<dim3((unsigned)items, p.n_pg), threads_of(p), smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int dx_entry(const void* g, const void* x, const void* w1, const void* k,
             const void* sc, const void* bi, void* out, void* part, int B,
             int Tn, int H, int W, int Cin, int C, int R, int WB, int PG,
             int TT, int rows, cudaStream_t st) {
  DxArgs<T> a;
  a.g = static_cast<const T*>(g);
  a.x = static_cast<const T*>(x);
  a.w1 = static_cast<const T*>(w1);
  a.k = static_cast<const T*>(k);
  a.sc = static_cast<const float*>(sc);
  a.bi = static_cast<const float*>(bi);
  a.out = static_cast<T*>(out);
  a.part = static_cast<float*>(part);
  a.Tn = Tn;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.C = C;
  return launch_dx<T, MODE>(a, B, R, WB, PG, TT, rows, st);
}

template <typename T, int MODE>
int occupancy(int R, int WB, int PG, int TT, int Cin, int W) {
  if (R < RMIN || R > RMAX || WB < 1 || PG < 1 || TT < 1 ||
      WB * PG > NT_DX || W < 1 || Cin < 1 || (MODE == MM && Cin < 8))
    return -1;
  const int smem = dx_layout<T, MODE>(R, WB, PG, Cin, W, TT).total;
  if (smem > SMEM_MAX) return -1;
  const auto kern = kernel_of<T, MODE>(R);
  int n = -1;
  cudaError_t e = (cudaError_t)set_smem(kern, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, (WB * PG + 31) / 32 * 32, smem);
  return e == cudaSuccess ? n : -1;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after the launch: 0 means the kernel was launched. (R, WB, PG, TT) is the
// wrapper's split: R output rows, WB columns and PG channel pairs per
// block (WB * PG at most 192), TT frames per segment; one block per work
// item (sample, frame segment, row strip, column tile) and channel group.

// part is (rows, 2, C) f32, rows the work items of a channel group: (sum
// dam*x, sum dam) per item.
extern "C" int dw_act_dx_s1(const void* g, const void* x, const void* w,
                            const void* sc, const void* bi, void* dx,
                            void* part, int B, int T, int H, int W, int C,
                            int R, int WB, int PG, int TT, int rows,
                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dx_entry<__nv_bfloat16, ACT>(g, x, nullptr, w, sc, bi, dx, part,
                                        B, T, H, W, C, C, R, WB, PG, TT, rows,
                                        st);
  return dx_entry<float, ACT>(g, x, nullptr, w, sc, bi, dx, part, B, T, H, W,
                              C, C, R, WB, PG, TT, rows, st);
}

// x is conv1's input (B,T,H,W,Cin), w1 (Cin,C) its weight; g and dam have
// C channels: dam = da * relu'((x@W1)*sc + bi) in g's dtype.
extern "C" int dw_mm_dx_mask_s1(const void* g, const void* x, const void* w1,
                                const void* w, const void* sc, const void* bi,
                                void* dam, int B, int T, int H, int W, int Cin,
                                int C, int R, int WB, int PG, int TT,
                                int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dx_entry<__nv_bfloat16, MM>(g, x, w1, w, sc, bi, dam, nullptr, B,
                                       T, H, W, Cin, C, R, WB, PG, TT, 0, st);
  return dx_entry<float, MM>(g, x, w1, w, sc, bi, dam, nullptr, B, T, H, W,
                             Cin, C, R, WB, PG, TT, 0, st);
}

// Blocks per SM the act (mm = 0) or mm (mm = 1) kernel reaches at a plan
// (R, WB, PG, TT), C_in (act: C) and the frame's width W, with its threads
// and shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1
// where it does not take them.
extern "C" int dw_dx_s1_occupancy(int mm, int R, int WB, int PG, int TT,
                                  int Cin, int W, int is_bf16) {
  if (mm)
    return is_bf16 ? occupancy<__nv_bfloat16, MM>(R, WB, PG, TT, Cin, W)
                   : occupancy<float, MM>(R, WB, PG, TT, Cin, W);
  return is_bf16 ? occupancy<__nv_bfloat16, ACT>(R, WB, PG, TT, Cin, W)
                 : occupancy<float, ACT>(R, WB, PG, TT, Cin, W);
}
