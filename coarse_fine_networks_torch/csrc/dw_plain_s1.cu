// The plain depthwise 3x3x3 conv at stride 1 of the split-batch-norm
// training route and its weight gradient, and the same two of the act
// training entry, for Hopper (sm_90a):
//
//   dw_conv_s1        y[t,h,w,c]  = sum_{dt,dy,dx} k[dt,dy,dx,c] *
//                                   x[t+dt-1, h+dy-1, w+dx-1, c]
//                     (SAME zero padding; on g with the flipped taps it is
//                     also the stride-1 dx, as in the JAX package)
//   dw_conv_wgrad_s1  dk[dt,dy,dx,c] = sum_{t,h,w} x_pad[t+dt, h+dy, w+dx, c]
//                                      * g[t,h,w,c]
//                     per block an f32 partial row (27, C)
//   dw_act_s1         dw_conv_s1 of a = relu(x*sc + bi) rounded to x's
//                     dtype (x*sc and + bi rounded apart, as act<T>), zero-
//                     padded after the activation; sc/bi are bn1's f32
//                     per-channel apply vectors
//   dw_act_wgrad_s1   dw_conv_wgrad_s1's sum over a_pad, a as above
//
// x, y and g are channels-last (B,T,H,W,C), f32 or bf16; the taps k (27,C)
// have x's dtype. Every sum is in f32; y is written in x's dtype.
//
// Replaces the plain and act modes of two TPU Pallas kernels of
// coarse_fine_networks_tpu/ops/pallas/dw_fold.py:
//   * dw_conv_s1       <- _dw_fold4_pcall (:532) -> _fwd_kernel (:379),
//                         plain mode (K1 plain), also the stride-1 dx of
//                         _dw_fold4_bwd;
//   * dw_act_s1        <- the same, act mode with the prologue _act_tile
//                         (:261) (K1 act): the forward of dw_fold4_act;
//   * dw_conv_wgrad_s1 <- _dw_fold4_wgrad_pcall (:705) -> _wgrad_kernel
//                         (:478), plain mode (K6 plain);
//   * dw_act_wgrad_s1  <- the same, act mode (K6 act): the backward of
//                         dw_fold4_act, _dw_act_bwd.
// The fold4 lane layout is TPU mechanics and is not carried over.
//
// What bounds them on this card: bytes. The forward reads x once and
// writes y once; the weight gradient reads x and g once. Each does 27 MACs
// per element, far below the ~295 operations per byte where the tensor
// cores would matter; at bf16 the 27 f32 FMAs per element cost about 0.7x
// the time of the bytes, so the instructions around them must stay few.
//
// What the design does about it:
//   * A block owns R output rows x WB full-width columns (all W where W <=
//     256) x a group of PG channel pairs, for one sample and a segment of
//     TT frames. Its spatial halo is (R+2)/R rows and no columns (a column
//     halo only where W is split), its temporal halo 2 frames per TT.
//   * Input rows are staged into a shared-memory ring of NSTAGE frames in
//     x's own dtype by asynchronous copies (cp.async, one commit group per
//     frame), so frame t+2 loads while frame t is computed. Each thread
//     copies the channel pair it computes (4 bytes in bf16, 8 in f32; a
//     warp's copies are contiguous runs of a row), with offsets fixed for
//     the tile: a frame costs it R+2 copies (R+2 more at the two halo
//     columns) and no index arithmetic. At odd C (no path shape has one) a
//     pair is not aligned, and the same kernel stages it with plain loads.
//   * Each thread owns one channel pair (one 4-byte bf16x2 or 8-byte float2
//     shared-memory read) at one column over the R rows, and walks the
//     frames with a register ring of the 3 output frames an input frame
//     feeds (K11's ring, dw_stencil.cu). A staged value read once serves up
//     to 3 rows x 3 frames of outputs: (R+2)*3 reads per frame for 2R
//     output elements, against 27 f32 reads per output element before.
//   * Rows and columns of a tile that lie outside the frame are zeroed in
//     the ring once per tile and never copied, so they read as the zero
//     padding; with R a template argument (2..4) the stencil loop is fully
//     unrolled and has no branch.
//   * The forward adds each output's taps in the order dt, dy, dx with one
//     fmaf each, as K11 does: at 3x3x3 it equals dw_stencil_s1 bit for bit
//     (a tap on the zero padding adds fmaf(k, 0, acc) = acc, as in K11).
//   * The weight gradient keeps its 27 x 2 sums in registers over its whole
//     walk. Its grid is persistent: each block walks IPB consecutive work
//     items (sample, frame segment, row strip, column tile) of its channel
//     group, then sums its threads' columns in a fixed order and writes one
//     partial row; the wrapper adds the rows with one torch.sum, so runs
//     repeat bit for bit and nothing uses atomics.
//   * The act modes are the same kernel bodies with a template flag
//     (act_fwd_s1_kernel beside plain_fwd_kernel, act_wgrad_s1_kernel
//     beside plain_wgrad_kernel). The ring holds one frame more
//     (NSTAGE_ACT), and each thread activates in place the x pairs it
//     copied of the next frame while the block reads this one (act_own,
//     strip.cuh): a pair is activated once, not once per reader (the
//     forward's pairs have three), and off the barrier's path. Rows and
//     columns outside the frame are never copied, so they stay the zero
//     of a, not relu(bi), with no mask. The stencil is the plain one, so y
//     and the sums equal K1 and K6 plain's on the activated x bit for bit.
// The split (R, WB, PG, TT and, for the weight gradients, IPB and the row
// count) is computed by the wrappers (ops/dw_conv.py:plan_s1, for all four)
// and checked here; a plan the kernels do not take returns
// cudaErrorInvalidValue.

#include "strip.cuh"

namespace {

using namespace cfn;

// ---- forward (K1 plain; K1 act) ---------------------------------------------------
// Thread (wl, pi) = (tid / PG, tid % PG): column w0 + wl, channels c, c+1
// with c = 2*(p0 + pi). acc[j][r] holds output frame ti - 1 + j of row
// h0 + r while input frame ti is read: frame ti adds tap dt = 2 - j to it.
// After frame ti, acc[0] (output ti - 1) is complete, is written, and the
// ring shifts. Staged row rr is input row h0 - 1 + rr; staged column j is
// input column w0 - 1 + j.
//
// ACT (the act entry's forward, K1 act): the stencil reads a = relu(x*sc +
// bi) rounded to T, activated in place a frame ahead in a ring of
// NSTAGE_ACT frames (act_own, strip.cuh); the stencil and its order are
// K1 plain's, so y is K1 plain's on the activated x bit for bit.
template <typename T, int R, bool ACT>
__device__ __forceinline__ void fwd_body(const T* __restrict__ x,
                                         const T* __restrict__ k,
                                         const float* __restrict__ sc,
                                         const float* __restrict__ bi,
                                         T* __restrict__ y, int Tn, int H,
                                         int W, int C, const Plan& pl) {
  constexpr int NS = ACT ? NSTAGE_ACT : NSTAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = (WB + 2) * PG2;
  const int stage = stage_elems<T>(R + 2, WB, PG);

  const int blk = blockIdx.x;
  const int pg = blk % pl.n_pg;
  const Tile tl = pl.tile(blk / pl.n_pg, pg, Tn);
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int w = tl.w0 + wl;
  const int c = 2 * (tl.p0 + pi);
  // threads past the block's columns read nothing (the last warp's tail)
  const bool in = wl < WB;
  const bool live = in && w < W && c < C;  // owns outputs
  const bool second = c + 1 < C;

  float k0[27], k1[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    k0[i] = live ? to_f(k[i * C + c]) : 0.f;
    k1[i] = live && second ? to_f(k[i * C + c + 1]) : 0.f;
  }
  float2 scp, bip;  // ACT: bn1's apply of the thread's pair
  if constexpr (ACT) pair_vecs(scp, bip, sc, bi, c, C);

  const size_t frame = (size_t)H * W * C;
  const T* xb = x + (size_t)tl.b * Tn * frame;
  const Stager sg(tl, wl, pi, WB, PG2, W, C, pl.pairs);
  const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;  // input frames
  auto load = [&](int i) {
    const int ti = f0 + i;
    if (i < nf && ti >= 0 && ti < Tn)  // uniform across the block
      sg.rows(ring + (i % NS) * stage, xb + (size_t)ti * frame, tl.h0 - 1,
              R + 2, H, W, rowlen, true);
    cp_commit();
  };
  auto own = [&](int i) {  // ACT: the thread's copies of frame i, in place
    const int ti = f0 + i;
    if (i < nf && ti >= 0 && ti < Tn)
      sg.act_rows<R + 2>(ring + (i % NS) * stage, tl.h0 - 1, H, rowlen, scp,
                         bip);
  };

  float acc[3][R][2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r][0] = acc[j][r][1] = 0.f;

  zero_ring(smem_raw, NS * stage * (int)sizeof(T));
  for (int i = 0; i < NS - 1; ++i) load(i);
  if constexpr (ACT) act_own(own, 0);
  for (int i = 0; i < nf; ++i) {
    // this thread's copies of frame i have landed (ACT: and everyone's are
    // activated); after the barrier everyone's, and frame i-1 is read by
    // no one
    if constexpr (!ACT) cp_wait<NS - 2>();
    __syncthreads();
    load(i + NS - 1);  // into frame i-1's slot
    if constexpr (ACT) act_own(own, i + 1);
    const int ti = f0 + i;
    if (ti >= 0 && ti < Tn && in)  // frames outside the clip add nothing
      stencil_frame<T, R>(
          ring + (i % NS) * stage + wl * PG2 + 2 * pi, rowlen, PG2,
          [&](int j, int r, int dy, int dx, float2 v) {
            const int tap = ((2 - j) * 3 + dy) * 3 + dx;
            acc[j][r][0] = fmaf(k0[tap], v.x, acc[j][r][0]);
            acc[j][r][1] = fmaf(k1[tap], v.y, acc[j][r][1]);
          });
    const int to = ti - 1;  // complete now
    if (to >= tl.t0 && live) {
      T* yo = y + (((size_t)tl.b * Tn + to) * H + tl.h0) * W * C +
              (size_t)w * C + c;
      const bool pair = second && !(C & 1);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tl.h0 + r < H)
          store_pair(yo + (size_t)r * W * C, acc[0][r][0], acc[0][r][1],
                     pair, second);
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
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k,
                 T* __restrict__ y, int Tn, int H, int W, int C, Plan pl) {
  fwd_body<T, R, false>(x, k, nullptr, nullptr, y, Tn, H, W, C, pl);
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
act_fwd_s1_kernel(const T* __restrict__ x, const T* __restrict__ k,
                  const float* __restrict__ sc, const float* __restrict__ bi,
                  T* __restrict__ y, int Tn, int H, int W, int C, Plan pl) {
  fwd_body<T, R, true>(x, k, sc, bi, y, Tn, H, W, C, pl);
}

// ---- weight gradient ------------------------------------------------------------
// Thread (wl, pi) as in the forward. Slot i of the ring holds x frame
// f0 + i (rows h0-1 .. h0+R, columns w0-1 .. w0+WB) and g frame f0 + i + 1
// (rows h0 .. h0+R-1 at columns w0 .. w0+WB-1, slots 1 .. WB). While x
// frame ti is read, gr[j][r] holds g frame ti - 1 + j of row h0 + r (zero
// outside [t0, t1) and the frame): x frame ti pairs with it through tap
// dt = 2 - j. acc[tap] sums x * g over the thread's whole walk.
//
// ACT (the act entry's weight gradient, K6 act): the stencil reads a =
// relu(x*sc + bi) rounded to T, the x part of each slot activated in place
// a frame ahead in a ring of NSTAGE_ACT frames (act_own, strip.cuh); rows
// and columns outside the frame are never copied and stay the zero padding
// of a. Nothing else changes, so the sums are K6 plain's on the activated
// x, in its order.
template <typename T, int R, bool ACT>
__device__ __forceinline__ void wgrad_body(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ sc, const float* __restrict__ bi,
    float* __restrict__ part, int Tn, int H, int W, int C, const Plan& pl,
    int n_items, int ipb) {
  constexpr int NS = ACT ? NSTAGE_ACT : NSTAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = (WB + 2) * PG2;
  const int xstage = stage_elems<T>(R + 2, WB, PG);
  const int stage = xstage + stage_elems<T>(R, WB, PG);

  const int pg = blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const bool in = wl < WB;
  const size_t frame = (size_t)H * W * C;
  const int at = (wl + 1) * PG2 + 2 * pi;  // the thread's column in a slot

  float acc[27][2];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i][0] = acc[i][1] = 0.f;
  float2 scp, bip;  // ACT: bn1's apply of the thread's pair
  if constexpr (ACT) pair_vecs(scp, bip, sc, bi, 2 * (pg * PG + pi), C);

  const int row = blockIdx.x;
  const int it1 = min((row + 1) * ipb, n_items);
  for (int item = row * ipb; item < it1; ++item) {
    const Tile tl = pl.tile(item, pg, Tn);
    const T* xb = x + (size_t)tl.b * Tn * frame;
    const T* gb = g + (size_t)tl.b * Tn * frame;
    const Stager sg(tl, wl, pi, WB, PG2, W, C, pl.pairs);
    const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;
    auto load = [&](int i) {
      if (i < nf) {  // uniform across the block
        T* slot = ring + (i % NS) * stage;
        const int ti = f0 + i, tg = ti + 1;
        if (ti >= 0 && ti < Tn)
          sg.rows(slot, xb + (size_t)ti * frame, tl.h0 - 1, R + 2, H, W,
                  rowlen, true);
        if (tg >= tl.t0 && tg < tl.t1)
          sg.rows(slot + xstage, gb + (size_t)tg * frame, tl.h0, R, H, W,
                  rowlen, false);
      }
      cp_commit();
    };
    auto own = [&](int i) {  // ACT: the thread's x copies of frame i
      const int ti = f0 + i;
      if (i < nf && ti >= 0 && ti < Tn)
        sg.act_rows<R + 2>(ring + (i % NS) * stage, tl.h0 - 1, H, rowlen,
                           scp, bip);
    };

    float gr[3][R][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) gr[j][r][0] = gr[j][r][1] = 0.f;

    zero_ring(smem_raw, NS * stage * (int)sizeof(T));
    for (int i = 0; i < NS - 1; ++i) load(i);
    if constexpr (ACT) act_own(own, 0);
    for (int i = 0; i < nf; ++i) {
      if constexpr (!ACT) cp_wait<NS - 2>();
      __syncthreads();
      load(i + NS - 1);
      if constexpr (ACT) act_own(own, i + 1);
      const int ti = f0 + i, tg = ti + 1;
      const T* slot = ring + (i % NS) * stage;
      const bool gin = in && tg >= tl.t0 && tg < tl.t1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gr[0][r][0] = gr[1][r][0];
        gr[0][r][1] = gr[1][r][1];
        gr[1][r][0] = gr[2][r][0];
        gr[1][r][1] = gr[2][r][1];
        const float2 v = gin ? load_pair(slot + xstage + r * rowlen + at)
                             : make_float2(0.f, 0.f);
        gr[2][r][0] = v.x;
        gr[2][r][1] = v.y;
      }
      if (ti >= 0 && ti < Tn && in)
        stencil_frame<T, R>(
            slot + at - PG2, rowlen, PG2,
            [&](int j, int r, int dy, int dx, float2 v) {
              const int tap = ((2 - j) * 3 + dy) * 3 + dx;
              acc[tap][0] = fmaf(v.x, gr[j][r][0], acc[tap][0]);
              acc[tap][1] = fmaf(v.y, gr[j][r][1], acc[tap][1]);
            });
    }
    cp_wait<0>();
    __syncthreads();  // the next item zeroes and refills every slot
  }

  // fixed-order sum over the block's columns: red[tap][wl][2PG], then slot
  // (tap, channel) adds its WB columns in order and writes row blockIdx.x
  float* red = reinterpret_cast<float*>(smem_raw);
  if (in) {
#pragma unroll
    for (int i = 0; i < 27; ++i) {
      red[(i * WB + wl) * PG2 + 2 * pi] = acc[i][0];
      red[(i * WB + wl) * PG2 + 2 * pi + 1] = acc[i][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < 27 * PG2; i += blockDim.x) {
    const int tap = i / PG2, s = i % PG2;
    const int ch = 2 * pg * PG + s;
    if (ch >= C) continue;
    float sum = 0.f;
    for (int q = 0; q < WB; ++q) sum += red[(tap * WB + q) * PG2 + s];
    part[((size_t)row * 27 + tap) * C + ch] = sum;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   float* __restrict__ part, int Tn, int H, int W, int C,
                   Plan pl, int n_items, int ipb) {
  wgrad_body<T, R, false>(x, g, nullptr, nullptr, part, Tn, H, W, C, pl,
                          n_items, ipb);
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
act_wgrad_s1_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ sc,
                    const float* __restrict__ bi, float* __restrict__ part,
                    int Tn, int H, int W, int C, Plan pl, int n_items,
                    int ipb) {
  wgrad_body<T, R, true>(x, g, sc, bi, part, Tn, H, W, C, pl, n_items, ipb);
}

// ---- launchers -----------------------------------------------------------------

// Dynamic shared memory of the forward (the ring) and of the weight
// gradient (the ring of x and g frames, or the column sums if larger); the
// act modes' rings hold NSTAGE_ACT frames.
template <typename T>
size_t fwd_smem(int R, int WB, int PG, bool act) {
  return sizeof(T) * (act ? NSTAGE_ACT : NSTAGE) *
         stage_elems<T>(R + 2, WB, PG);
}
template <typename T>
size_t wgrad_smem(int R, int WB, int PG, bool act) {
  const size_t ring =
      sizeof(T) * (act ? NSTAGE_ACT : NSTAGE) *
      (stage_elems<T>(R + 2, WB, PG) + stage_elems<T>(R, WB, PG));
  const size_t red = sizeof(float) * 27 * WB * 2 * PG;
  return ring > red ? ring : red;
}

// The kernel instantiations for R output rows (RMIN..RMAX), or null.
template <typename T>
decltype(&plain_fwd_kernel<T, RMAX>) fwd_kernel(int R) {
  switch (R) {
    case 2: return plain_fwd_kernel<T, 2>;
    case 3: return plain_fwd_kernel<T, 3>;
    case 4: return plain_fwd_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&act_fwd_s1_kernel<T, RMAX>) act_fwd_kernel_of(int R) {
  switch (R) {
    case 2: return act_fwd_s1_kernel<T, 2>;
    case 3: return act_fwd_s1_kernel<T, 3>;
    case 4: return act_fwd_s1_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&plain_wgrad_kernel<T, RMAX>) wgrad_kernel_of(int R) {
  switch (R) {
    case 2: return plain_wgrad_kernel<T, 2>;
    case 3: return plain_wgrad_kernel<T, 3>;
    case 4: return plain_wgrad_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&act_wgrad_s1_kernel<T, RMAX>) act_wgrad_kernel_of(int R) {
  switch (R) {
    case 2: return act_wgrad_s1_kernel<T, 2>;
    case 3: return act_wgrad_s1_kernel<T, 3>;
    case 4: return act_wgrad_s1_kernel<T, 4>;
  }
  return nullptr;
}

// The forward of x (plain) or of relu(x*sc + bi) (ACT; sc and bi unused
// otherwise): one block per tile.
template <typename T, bool ACT>
int launch_fwd(const void* x, const void* k, const void* sc, const void* bi,
               void* y, int B, int Tn, int H, int W, int C, int R, int WB,
               int PG, int TT, cudaStream_t st) {
  Plan p;
  if (!make_plan<T>(p, (uintptr_t)x, B, Tn, H, W, C, R, WB, PG, TT))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem<T>(R, WB, PG, ACT);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)B * p.n_tseg * p.n_strip * p.n_wt * p.n_pg;
  if constexpr (ACT) {
    const auto kern = act_fwd_kernel_of<T>(R);
    if (int e = set_smem(kern, smem)) return e;
    kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(k),
        static_cast<const float*>(sc), static_cast<const float*>(bi),
        static_cast<T*>(y), Tn, H, W, C, p);
  } else {
    const auto kern = fwd_kernel<T>(R);
    if (int e = set_smem(kern, smem)) return e;
    kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(k),
        static_cast<T*>(y), Tn, H, W, C, p);
  }
  return (int)cudaGetLastError();
}

// The weight gradient of x (plain) or of relu(x*sc + bi) (ACT; sc and bi
// unused otherwise).
template <typename T, bool ACT>
int launch_wgrad(const void* x, const void* g, const void* sc,
                 const void* bi, void* part, int B, int Tn, int H, int W,
                 int C, int R, int WB, int PG, int TT, int ipb, int rows,
                 cudaStream_t st) {
  Plan p;
  if (!make_plan<T>(p, (uintptr_t)x | (uintptr_t)g, B, Tn, H, W, C, R, WB, PG,
                    TT) ||
      ipb < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * p.n_tseg * p.n_strip * p.n_wt;
  // every block has an item, and the blocks cover them all
  if (rows < 1 || (long long)rows * ipb < items ||
      (long long)(rows - 1) * ipb >= items)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgrad_smem<T>(R, WB, PG, ACT);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid(rows, p.n_pg);
  if constexpr (ACT) {
    const auto kern = act_wgrad_kernel_of<T>(R);
    if (int e = set_smem(kern, smem)) return e;
    kern<<<grid, threads_of(p), smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<const float*>(sc), static_cast<const float*>(bi),
        static_cast<float*>(part), Tn, H, W, C, p, (int)items, ipb);
  } else {
    const auto kern = wgrad_kernel_of<T>(R);
    if (int e = set_smem(kern, smem)) return e;
    kern<<<grid, threads_of(p), smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<float*>(part), Tn, H, W, C, p, (int)items, ipb);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int kind, int R, int WB, int PG) {
  if (R < RMIN || R > RMAX || WB * PG > NT_MAX) return -1;
  const int threads = (WB * PG + 31) / 32 * 32;
  switch (kind) {
    case 0:
      return blocks_per_sm(fwd_kernel<T>(R), fwd_smem<T>(R, WB, PG, false),
                           threads);
    case 1:
      return blocks_per_sm(wgrad_kernel_of<T>(R),
                           wgrad_smem<T>(R, WB, PG, false), threads);
    case 2:
      return blocks_per_sm(act_wgrad_kernel_of<T>(R),
                           wgrad_smem<T>(R, WB, PG, true), threads);
    case 3:
      return blocks_per_sm(act_fwd_kernel_of<T>(R),
                           fwd_smem<T>(R, WB, PG, true), threads);
  }
  return -1;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after the launch: 0 means the kernel was launched. (R, WB, PG, TT) is the
// wrapper's split: R output rows, WB columns and PG channel pairs per block,
// TT frames per segment.
extern "C" int dw_conv_s1(const void* x, const void* k, void* y, int B, int T,
                          int H, int W, int C, int R, int WB, int PG, int TT,
                          int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16, false>(x, k, nullptr, nullptr, y, B, T,
                                            H, W, C, R, WB, PG, TT, st);
  return launch_fwd<float, false>(x, k, nullptr, nullptr, y, B, T, H, W, C, R,
                                  WB, PG, TT, st);
}

// The act entry's forward (K1 act): y of a = relu(x*sc + bi) rounded to x's
// dtype, zero-padded; sc and bi are f32 (C,). The split is dw_conv_s1's.
extern "C" int dw_act_s1(const void* x, const void* k, const void* sc,
                         const void* bi, void* y, int B, int T, int H, int W,
                         int C, int R, int WB, int PG, int TT, int is_bf16,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16, true>(x, k, sc, bi, y, B, T, H, W, C, R,
                                           WB, PG, TT, st);
  return launch_fwd<float, true>(x, k, sc, bi, y, B, T, H, W, C, R, WB, PG,
                                 TT, st);
}

// part is (rows, 27, C) f32; block row r walks items [r*IPB, (r+1)*IPB).
extern "C" int dw_conv_wgrad_s1(const void* x, const void* g, void* part,
                                int B, int T, int H, int W, int C, int R,
                                int WB, int PG, int TT, int ipb, int rows,
                                int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_wgrad<__nv_bfloat16, false>(x, g, nullptr, nullptr, part,
                                              B, T, H, W, C, R, WB, PG, TT,
                                              ipb, rows, st);
  return launch_wgrad<float, false>(x, g, nullptr, nullptr, part, B, T, H, W,
                                    C, R, WB, PG, TT, ipb, rows, st);
}

// The act entry's weight gradient (K6 act): dk of a = relu(x*sc + bi)
// rounded to x's dtype, zero-padded; sc and bi are f32 (C,). The split and
// part are dw_conv_wgrad_s1's.
extern "C" int dw_act_wgrad_s1(const void* x, const void* g, const void* sc,
                               const void* bi, void* part, int B, int T,
                               int H, int W, int C, int R, int WB, int PG,
                               int TT, int ipb, int rows, int is_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_wgrad<__nv_bfloat16, true>(x, g, sc, bi, part, B, T, H, W,
                                             C, R, WB, PG, TT, ipb, rows, st);
  return launch_wgrad<float, true>(x, g, sc, bi, part, B, T, H, W, C, R, WB,
                                   PG, TT, ipb, rows, st);
}

// Blocks per SM a kernel reaches at a plan (R, WB, PG), with its threads
// and shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1
// where it does not take the plan; kind 0 is the forward, 1 the weight
// gradient, 2 the act weight gradient, 3 the act forward.
extern "C" int dw_plain_s1_occupancy(int kind, int R, int WB, int PG,
                                     int is_bf16) {
  return is_bf16 ? occupancy<__nv_bfloat16>(kind, R, WB, PG)
                 : occupancy<float>(kind, R, WB, PG);
}
