// The plain depthwise 3x3x3 conv at stride 1 of the split-batch-norm
// training route and its weight gradient, the same two of the act
// training entry, and the weight gradient of the mm entry, for Hopper
// (sm_90a):
//
//   dw_conv_s1        y[t,h,w,c]  = sum_{dt,dy,dx} k[dt,dy,dx,c] *
//                                   x[t+dt-1, h+dy-1, w+dx-1, c]
//                     (SAME zero padding; on g with the flipped taps it is
//                     also the stride-1 dx, as in the JAX package)
//   dw_conv_wgrad_s1  dk[dt,dy,dx,c] = sum_{t,h,w} x_pad[t+dt, h+dy, w+dx, c]
//                                      * g[t,h,w,c]
//                     per block an f32 partial row (27, C)
//   dw_act_s1         dw_conv_s1 of a = relu(x*sc + bi) rounded to x's
//                     dtype (x*sc and + bi rounded apart, as act_store), zero-
//                     padded after the activation; sc/bi are bn1's f32
//                     per-channel apply vectors
//   dw_act_wgrad_s1   dw_conv_wgrad_s1's sum over a_pad, a as above
//   dw_mm_wgrad_s1    dw_conv_wgrad_s1's sum over a_pad, a = relu((x @ W1)
//                     *sc + bi) rounded to x's dtype: x (B,T,H,W,C_in) is
//                     conv1's input, W1 (C_in,C) its weight (the train
//                     composite's and the eval entry's backward)
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
//                         dw_fold4_act, _dw_act_bwd;
//   * dw_mm_wgrad_s1   <- the same, mm mode (K6 mm): the backward of
//                         dw_fold4_mm_bn_train and dw_fold4_mm_act.
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
//     repeat bit for bit and nothing uses atomics. It adds x * g only where
//     the register ring of g holds an element of the item (wgrad_slots,
//     strip.cuh): not for a g frame outside the item's segment (on its
//     first two and last two x frames), an output row past H (a ragged last
//     strip) or a column past W. There the ring holds a zero, and x * 0
//     would carry a NaN of x into a tap no output position reaches; the
//     rule only selects between two unrolled variants per frame, and moves
//     no finite sum (fmaf(x, 0, acc) == acc).
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
//   * K6 mm (mm_wgrad_s1_kernel) is K1 mm's front end on that back end:
//     x staged whole (all C_in) by cp.async, conv1's product on mma into
//     an activated slot (mm_strip.cuh, shared with K1 mm and K2, so its
//     relu branch is theirs element for element), g staged beside it, and
//     the weight gradient's register ring, rule and sums; see the kernel.
//     At most NT_DX = 192 threads a block, so a thread may hold 168
//     registers (the product's beside the 54 sums and the ring of g).
// The split (R, WB, PG, TT and, for the weight gradients, IPB and the row
// count) is computed by the wrappers (ops/dw_conv.py: plan_s1 for the
// plain and act kernels, plan_mm_wgrad_s1 for K6 mm) and checked here; a
// plan the kernels do not take returns cudaErrorInvalidValue.

#include "mm_strip.cuh"

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
// acc[tap] += x * g over one staged x frame (stencil_frame at the thread's
// column) with the register ring gr of g: every slot and row where all
// exist, else only the ring slots and rows the rule admits
// (stencil_frame_masked; ROWS_ONCE where the build has registers to spare),
// so no x meets the zero of a g element outside the item (strip.cuh).
template <typename T, int R, bool ROWS_ONCE>
__device__ __forceinline__ void wgrad_frame(const T* tile, int rowlen, int PG2,
                                            unsigned slots, int nr,
                                            const float (&gr)[3][R][2],
                                            float (&acc)[27][2]) {
  auto fma = [&](int j, int r, int dy, int dx, float2 v) {
    const int tap = ((2 - j) * 3 + dy) * 3 + dx;
    acc[tap][0] = fmaf(v.x, gr[j][r][0], acc[tap][0]);
    acc[tap][1] = fmaf(v.y, gr[j][r][1], acc[tap][1]);
  };
  if (slots == 7u && nr == R)
    stencil_frame<T, R>(tile, rowlen, PG2, fma);
  else
    stencil_frame_masked<T, R, ROWS_ONCE>(tile, rowlen, PG2, fma, slots,
                                          nr);
}

// Thread (wl, pi) as in the forward. Slot i of the ring holds x frame
// f0 + i (rows h0-1 .. h0+R, columns w0-1 .. w0+WB) and g frame f0 + i + 1
// (rows h0 .. h0+R-1 at columns w0 .. w0+WB-1, slots 1 .. WB). While x
// frame ti is read, gr[j][r] holds g frame ti - 1 + j of row h0 + r (zero
// outside [t0, t1) and the frame): x frame ti pairs with it through tap
// dt = 2 - j, where wgrad_slots admits the pair. acc[tap] sums x * g over
// the thread's whole walk.
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
    // output rows of the strip, and whether the thread's column exists
    const int nr = min(R, H - tl.h0);
    const bool live = in && tl.w0 + wl < W;
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
        // the f32 builds keep their groups rolled: unrolled, the R = 4
        // build spills beside the rule's variant (wgrad_frame)
        sg.act_rows<R + 2, sizeof(T) == 4>(ring + (i % NS) * stage,
                                           tl.h0 - 1, H, rowlen, scp, bip);
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
      const bool gin = live && tg >= tl.t0 && tg < tl.t1;
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
      if (ti >= 0 && ti < Tn && live)
        wgrad_frame<T, R, !ACT>(slot + at - PG2, rowlen, PG2,
                                wgrad_slots(i, nf), nr, gr, acc);
    }
    cp_wait<0>();
    __syncthreads();  // the next item zeroes and refills every slot
  }

  wgrad_partials(acc, part, smem_raw, WB, PG, C);
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

// ---- mm weight gradient (K6 mm) ---------------------------------------------------
// dk of a = relu((x @ W1)*sc + bi), rounded to T and zero-padded after the
// activation: K1 mm's front end (dw_mm_act.cu, mm_fwd_s1_kernel; the shared
// pieces are mm_strip.cuh's) on K6 plain's back end (wgrad_body above).
// Per block, once: W1's column group and bn1's vectors. Per item (the
// persistent walk of wgrad_body): x frame f0 + i staged whole (all C_in)
// by cp.async into ring slot i % XSTAGE_MM, in one commit group with g
// frame f0 + i (rows h0 .. h0+R-1 at the thread's own column, as K6
// plain stages them). Step i (i = 0 .. nf, between two barriers, K1 mm's
// schedule): stage frame i + 2; conv1's product of x frame f0 + i into
// activated slot i % 2 (mm_activate: its relu branch is K1 mm's and K2's,
// element for element); the register ring takes g frame f0 + i; the
// stencil reads activated frame f0 + i - 1 (slot (i - 1) % 2) with the
// ring, under wgrad_slots, so the ring's slot j holds g frame
// f0 + i - 2 + j as in wgrad_body. Rows and columns outside the frame are
// never written and stay the zero each item clears the activated slots
// to. The sums, their column sum and the partial row are wgrad_body's.
// At most NT_DX threads: the product's registers beside the 27 x 2 sums and
// the ring of g need more than 128.
template <typename T, int R>
__global__ void __launch_bounds__(NT_DX, 2)
mm_wgrad_s1_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ g, const float* __restrict__ sc,
                   const float* __restrict__ bi, float* __restrict__ part,
                   int Tn, int H, int W, int Cin, int Cmid, Plan pl,
                   int n_items, int ipb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = (WB + 2) * PG2;
  const MmLayout L = mm_layout<T>(R, WB, PG, Cin, W);
  T* act_s = reinterpret_cast<T*>(smem_raw);  // [2][R+2][WB+2][2PG]
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs_off);
  T* wt = reinterpret_cast<T*>(smem_raw + L.wt_off);
  float* scs = reinterpret_cast<float*>(smem_raw + L.vec_off);
  float* bis = scs + (L.ng + 3) / 4 * 4;
  float* kbs = bis + (L.ng + 3) / 4 * 4;
  int* tab = reinterpret_cast<int*>(smem_raw + L.tab_off);
  T* gring = reinterpret_cast<T*>(smem_raw + L.total);  // after the table
  const int aslot = L.aslot / (int)sizeof(T), xslot = L.xslot / (int)sizeof(T);
  const int gslot = stage_elems<T>(R, WB, PG);  // g rows [R][WB+2][2PG]
  const int ld = L.ld;

  const int pg = blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int c0 = 2 * pg * PG;
  const bool in = wl < WB;
  const int at = (wl + 1) * PG2 + 2 * pi;  // the thread's column in a slot

  zero_ring(smem_raw, L.wt_off);  // both slots and the x ring
  mm_stage_vecs(scs, bis, kbs, sc, bi, Cmid, c0, PG2, L.ng,
                mm_band((ld - 8) / 16, Cin));
  mm_stage_w1<T>(wt, w1, Cin, Cmid, c0, PG2, L.ng, ld);

  float acc[27][2];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i][0] = acc[i][1] = 0.f;

  const size_t xframe = (size_t)H * W * Cin, gframe = (size_t)H * W * Cmid;
  const int row = blockIdx.x;
  const int it1 = min((row + 1) * ipb, n_items);
  for (int item = row * ipb; item < it1; ++item) {
    const Tile tl = pl.tile(item, pg, Tn);
    const MmRect mt(tl.h0 - 1, R + 2, tl.w0 - 1, WB + 2, H, W, Cin, ld,
                    16 / (int)sizeof(T));
    const Stager sg(tl, wl, pi, WB, PG2, W, Cmid, pl.pairs);
    const T* xb = x + (size_t)tl.b * Tn * xframe +
                  ((long long)(tl.h0 - 1) * W + mt.cs0) * Cin;
    const T* gb = g + (size_t)tl.b * Tn * gframe;
    const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;
    const int nr = min(R, H - tl.h0);
    const bool live = in && tl.w0 + wl < W;
    // x frame f0 + i and g frame f0 + i (where they exist) into ring slot
    // i % XSTAGE_MM, one commit group
    auto stage = [&](int i) {
      if (i < nf) {  // uniform across the block
        const int ti = f0 + i;
        if (ti >= 0 && ti < Tn)
          mt.stage(xs + (i % XSTAGE_MM) * xslot, xb + (size_t)ti * xframe, W,
                   Cin, ld);
        if (ti >= tl.t0 && ti < tl.t1)
          sg.rows(gring + (i % XSTAGE_MM) * gslot, gb + (size_t)ti * gframe,
                  tl.h0, R, H, W, rowlen, false);
      }
      cp_commit();
    };

    // the slots' padding is this tile's (the previous item's readers are
    // done: the barrier closing its walk)
    zero_ring(smem_raw, L.xs_off);
    mt.table(tab, L.rows, [&](int rr, int col) {
      return (rr * (WB + 2) + col - tl.w0 + 1) * PG2;
    });
    float gr[3][R][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) gr[j][r][0] = gr[j][r][1] = 0.f;

    for (int i = 0; i < XSTAGE_MM - 1; ++i) stage(i);
    for (int i = 0; i <= nf; ++i) {
      cp_wait<XSTAGE_MM - 2>();  // this thread's copies of frame i landed
      __syncthreads();  // and everyone's; activated slot i-1 is written;
                        // slot i, and ring slot i-1, are read by no one
      stage(i + XSTAGE_MM - 1);
      const int tx = f0 + i;
      if (i < nf && tx >= 0 && tx < Tn)
        mm_activate<T>(act_s + (i & 1) * aslot, xs + (i % XSTAGE_MM) * xslot,
                       wt, L, PG, mt.M, Cin, scs, bis, kbs, tab);
      // g frame f0 + i (the thread's own copies) into the register ring
      const bool gin = live && i < nf && tx >= tl.t0 && tx < tl.t1;
      const T* gs = gring + (i % XSTAGE_MM) * gslot + at;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gr[0][r][0] = gr[1][r][0];
        gr[0][r][1] = gr[1][r][1];
        gr[1][r][0] = gr[2][r][0];
        gr[1][r][1] = gr[2][r][1];
        const float2 v =
            gin ? load_pair(gs + r * rowlen) : make_float2(0.f, 0.f);
        gr[2][r][0] = v.x;
        gr[2][r][1] = v.y;
      }
      if (i == 0) continue;
      const int ti = tx - 1;  // the activated frame the stencil reads
      if (ti >= 0 && ti < Tn && live)
        wgrad_frame<T, R, true>(act_s + ((i - 1) & 1) * aslot + at - PG2,
                                rowlen, PG2, wgrad_slots(i - 1, nf), nr, gr,
                                acc);
    }
    cp_wait<0>();
    __syncthreads();  // the next item clears the slots and the table
  }
  wgrad_partials(acc, part, smem_raw, WB, PG, Cmid);
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

// K6 mm's shared memory: K1 mm's layout (mm_layout), then a ring of
// XSTAGE_MM g frames; or the column sums if larger.
template <typename T>
size_t mm_wgrad_smem(int R, int WB, int PG, int Cin, int W) {
  const size_t ring = mm_layout<T>(R, WB, PG, Cin, W).total +
                      sizeof(T) * XSTAGE_MM * stage_elems<T>(R, WB, PG);
  const size_t red = sizeof(float) * 27 * WB * 2 * PG;
  return ring > red ? ring : red;
}

template <typename T>
decltype(&mm_wgrad_s1_kernel<T, RMAX>) mm_wgrad_kernel_of(int R) {
  switch (R) {
    case 2: return mm_wgrad_s1_kernel<T, 2>;
    case 3: return mm_wgrad_s1_kernel<T, 3>;
    case 4: return mm_wgrad_s1_kernel<T, 4>;
  }
  return nullptr;
}

// The weight gradient of relu((x @ W1)*sc + bi) (K6 mm): x (B, T, H, W,
// C_in) with C_in % 8 == 0 and 16-byte aligned; the split is over g (B, T,
// H, W, C_mid).
template <typename T>
int launch_mm_wgrad(const void* x, const void* w1, const void* g,
                    const void* sc, const void* bi, void* part, int B, int Tn,
                    int H, int W, int Cin, int Cmid, int R, int WB, int PG,
                    int TT, int ipb, int rows, cudaStream_t st) {
  Plan p;
  if (!make_plan<T>(p, (uintptr_t)g, B, Tn, H, W, Cmid, R, WB, PG, TT) ||
      WB * PG > NT_DX || ipb < 1 || Cin < 8 || Cin % 8 || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * p.n_tseg * p.n_strip * p.n_wt;
  // every block has an item, and the blocks cover them all
  if (rows < 1 || (long long)rows * ipb < items ||
      (long long)(rows - 1) * ipb >= items)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mm_wgrad_smem<T>(R, WB, PG, Cin, W);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kern = mm_wgrad_kernel_of<T>(R);
  if (int e = set_smem(kern, smem)) return e;
  kern<<<dim3(rows, p.n_pg), threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(g), static_cast<const float*>(sc),
      static_cast<const float*>(bi), static_cast<float*>(part), Tn, H, W,
      Cin, Cmid, p, (int)items, ipb);
  return (int)cudaGetLastError();
}

template <typename T>
int mm_wgrad_occupancy(int R, int WB, int PG, int Cin, int W) {
  if (R < RMIN || R > RMAX || WB < 1 || PG < 1 || WB * PG > NT_DX ||
      Cin < 8 || W < 1)
    return -1;
  const size_t smem = mm_wgrad_smem<T>(R, WB, PG, Cin, W);
  if (smem > SMEM_MAX) return -1;
  return blocks_per_sm(mm_wgrad_kernel_of<T>(R), smem,
                       (WB * PG + 31) / 32 * 32);
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

// The mm entry's weight gradient (K6 mm): dk of a = relu((x @ W1)*sc + bi)
// rounded to x's dtype, zero-padded; x (B,T,H,W,C_in) is conv1's input, W1
// (C_in,C_mid) its weight, g (B,T,H,W,C_mid); sc and bi are f32 (C_mid,).
// The split is over g (ops/dw_conv.py: plan_mm_wgrad_s1); part is (rows,
// 27, C_mid) f32.
extern "C" int dw_mm_wgrad_s1(const void* x, const void* w1, const void* g,
                              const void* sc, const void* bi, void* part,
                              int B, int T, int H, int W, int Cin, int Cmid,
                              int R, int WB, int PG, int TT, int ipb,
                              int rows, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mm_wgrad<__nv_bfloat16>(x, w1, g, sc, bi, part, B, T, H, W,
                                          Cin, Cmid, R, WB, PG, TT, ipb, rows,
                                          st);
  return launch_mm_wgrad<float>(x, w1, g, sc, bi, part, B, T, H, W, Cin, Cmid,
                                R, WB, PG, TT, ipb, rows, st);
}

// Blocks per SM mm_wgrad_s1_kernel reaches at a plan (R, WB, PG), C_in and
// the frame's width W, with its threads and shared memory, or -1 where it
// does not take them.
extern "C" int dw_mm_wgrad_s1_occupancy(int R, int WB, int PG, int Cin, int W,
                                        int is_bf16) {
  return is_bf16 ? mm_wgrad_occupancy<__nv_bfloat16>(R, WB, PG, Cin, W)
                 : mm_wgrad_occupancy<float>(R, WB, PG, Cin, W);
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
