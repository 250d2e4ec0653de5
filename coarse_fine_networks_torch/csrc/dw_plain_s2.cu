// The plain depthwise 3x3x3 conv at stride (1,2,2) of the split-batch-norm
// training route, for Hopper (sm_90a): its forward, its dx and its weight
// gradient; the forward, the dx and the weight gradient of the act training
// entry; and the forward, the masked dx and the weight gradient of the mm
// entry:
//
//   dw_conv_s2        y[t,h,w,c]  = sum_{dt,dy,dx} k[dt,dy,dx,c] *
//                                   x[t+dt-1, 2h+dy-1, 2w+dx-1, c]
//                     (SAME zero padding)
//   dw_conv_dx_s2     dx[t,r,q,c] = sum k[dt,dy,dx,c] *
//                                   g[t-dt+1, (r-dy+1)/2, (q-dx+1)/2, c]
//                     over the terms whose divisions are integral
//   dw_conv_wgrad_s2  dk[dt,dy,dx,c] = sum_{t,h,w} x_pad[t+dt, 2h+dy, 2w+dx, c]
//                                      * g[t,h,w,c]
//                     per block an f32 partial row (27, C)
//   dw_act_dx_s2      the act training entry's dx: da as dw_conv_dx_s2's,
//                     dam = da * 1[x*sc + bi > 0] (x*sc and + bi rounded
//                     apart, as the forward's activation), dx = dam*sc in
//                     x's dtype, and per block the f32 partial sums
//                     (sum dam*x, sum dam) per channel -> (dsc, dbi)
//   dw_act_s2         dw_conv_s2 of a = relu(x*sc + bi) rounded to x's
//                     dtype (x*sc and + bi rounded apart, as act_store), zero-
//                     padded after the activation
//   dw_act_wgrad_s2   dw_conv_wgrad_s2's sum over a_pad, a as above
//   dw_mm_act_s2      dw_conv_s2 of a = relu((x @ W1)*sc + bi) rounded to
//                     x's dtype, zero-padded after the activation; x is
//                     conv1's input (B,T,H,W,Cin), W1 (Cin,C) its weight
//   dw_mm_dx_mask_s2  dam = da * 1[(x @ W1)*sc + bi > 0] in g's dtype, da
//                     as dw_conv_dx_s2's, x and W1 as above
//   dw_mm_wgrad_s2    dw_conv_wgrad_s2's sum over a_pad, a as
//                     dw_mm_act_s2's
//   dw_conv_t2, dw_conv_dx_t2, dw_conv_wgrad_t2
//                     the first three at stride (2,2,2): y[t,h,w,c] = sum
//                     k * x[2t+dt-1, 2h+dy-1, 2w+dx-1, c], y and g
//                     (B,To,Ho,Wo,C) with To = (T-1)/2 + 1
//
// x and dx are channels-last (B,T,H,W,C), y and g (B,T,Ho,Wo,C) with Ho =
// (H-1)/2 + 1, f32 or bf16; the taps k (27,C) have the input's dtype;
// x_pad is x zero-padded by one on T, H and W. Every sum is in f32; y and dx
// are written in the input's dtype.
//
// Replaces the plain mode of three TPU Pallas kernels, the act mode of all
// three and the mm mode of two, of
// coarse_fine_networks_tpu/ops/pallas/dw_fold.py:
//   * dw_conv_s2       <- _fwd_s2_direct_pcall (:1078) ->
//                         _fwd_s2_direct_kernel (:1035), plain mode
//                         (K4 plain);
//   * dw_act_s2        <- the same, act mode with the prologue _act_tile
//                         (:261) (K4 act): the forward of dw_fold4_act;
//   * dw_conv_dx_s2    <- _dx_s2_pcall (:1208) -> _dx_s2_kernel (:888),
//                         plain mode (K8);
//   * dw_act_dx_s2     <- _dx_s2_act_pcall (:660) -> _dx_s2_kernel (:888),
//                         act mode (K5): the backward of dw_fold4_act,
//                         _dw_act_bwd;
//   * dw_conv_wgrad_s2 <- _wgrad_s2_pcall (:1279) -> _wgrad_s2_kernel
//                         (:1122), plain mode (K10 plain);
//   * dw_act_wgrad_s2  <- the same, act mode (K10 act): the backward of
//                         dw_fold4_act, _dw_act_bwd;
//   * dw_mm_act_s2     <- _fwd_s2_direct_pcall (:1078), mm mode with the
//                         prologue _mm_act_tile (:275) (K4 mm): the forward
//                         of dw_fold4_mm_act and dw_fold4_mm_bn_train;
//   * dw_mm_dx_mask_s2 <- _dx_s2_mask_pcall (:1239) -> _dx_s2_kernel (:888),
//                         mask mode (K9): the backward of
//                         dw_fold4_mm_bn_train, _mm_bn_train_bwd;
//   * dw_mm_wgrad_s2   <- _wgrad_s2_pcall (:1279) -> _wgrad_s2_kernel
//                         (:1122), mm mode (K10 mm): the backward of
//                         dw_fold4_mm_bn_train and of dw_fold4_mm_act
//                         (_dw_mm_bwd).
// The fold4 lane layout, its even/odd de-interleave and the sublane-pair
// bitcasts are TPU mechanics and are not carried over. The stride-(2,2,2)
// kernels (dw_conv_t2, dw_conv_dx_t2, dw_conv_wgrad_t2: FineNet's
// t_downsample) replace no TPU kernel: the JAX package runs that conv in
// XLA (_lax_conv, coarse_fine_networks_tpu/ops/pallas/dw_conv.py:287, on
// its plain layout). Each has a body of its own (below): the forward on K4
// plain's threads and taps, whole pixels staged as they lie in x and one
// barrier per output frame; the dx on K8's threads, g ring and order, its
// dx frames written out of a tile in shared memory as contiguous runs; the
// weight gradient on K10 plain's threads and rows. Bound by bytes alike,
// they read their input once and write their output once, with the same
// row strips.
//
// What bounds them on this card: bytes. The forward reads x once and
// writes y (a quarter of x) once; the dx reads g and writes dx (4x the
// elements of g); the act dx also reads x and writes 2C sums per block; the
// weight gradient reads x and g once. Each does 27 MACs
// per element of y or g (the dx 6.75 per element of dx), far below the ~295
// operations per byte where the tensor cores would matter. The mm forward
// reads x (C_in channels) instead of a, and the masked dx reads x besides
// g; conv1's product adds C_in MACs per (position, channel), on the bf16
// tensor cores, still far below that line.
//
// What the design does about it (the row strips of strip.cuh, over the
// output's rows and columns for the forward and the weight gradient and
// over g's for the dx):
//   * A block owns R rows (2..4, a template argument) x WB columns x a
//     group of PG channel pairs of one sample over TT frames. A thread owns
//     one channel pair at one column, so every shared-memory read of a warp
//     is consecutive words and every global access of a warp is runs of
//     2PG channels along C. The forward and the weight gradient take the
//     columns first (all of a row up to 256), the dx the channel pairs
//     first (groups of at most 32 pairs, then columns to fill the block):
//     its stores are 4/5 of its bytes, and runs of 2PG = 54-62 channels at
//     the path's widths, whole pixels where C <= 64, fill whole 32-byte
//     sectors, where the columns-first split's runs of 8-18 channels at
//     C = 54 left them part written.
//   * The forward and the weight gradient read the 2R+1 input rows
//     2h0-1 .. 2h0+2R-1 at the 2WB+1 columns 2w0-1 .. 2w0+2WB-1: a halo of
//     (2R+1)/2R rows and one column per tile. They are staged at full
//     resolution into a shared-memory ring of NSTAGE frames in x's dtype
//     by cp.async, one commit group per frame (the weight gradient's g rows
//     with it), so frame t+2 loads while frame t is read. A staged row is
//     stored de-interleaved: its even columns (input columns 2(w0+e)-1,
//     e = 0..WB) then its odd ones (2(w0+e)). The thread of output column
//     w0+wl reads even e = wl, odd e = wl and even e = wl+1, so the words a
//     warp reads are consecutive at every PG (no bank conflict at C = 54,
//     108, 216 or 432, where a plain row would give a stride of 2PG words
//     between neighbouring columns). Each thread copies the pair it reads
//     (even and odd column wl; the threads of column 0 also the last even
//     column), so a frame costs it 2-3 copies per row and no index
//     arithmetic.
//   * The forward (K4 plain) keeps a register ring of the 3 output frames
//     an input frame feeds, as dw_plain_s1.cu's forward does: a staged row
//     read once (3 pair reads) serves the one or two output rows it meets
//     (dy = rr - 2r) in all three frames, 3 x R x 2 accumulators beside the
//     54 tap registers. Each output's taps are added in the order dt, dy,
//     dx with one fmaf each, as K11 (dw_stencil.cu) adds them. It is also
//     K7 (dw_stencil_s2): ops/dw_stencil.py launches it at stride (1,2,2).
//     The grid is one block per tile.
//   * The act forward (K4 act) is the same body with a template flag
//     (act_s2_fwd_kernel beside plain_s2_fwd_kernel), activating in place
//     as K10 act below does, with a plan of its own ring (plan_act_s2_fwd):
//     y equals K4 plain's on the activated x bit for bit.
//   * The dx (K8) is a gather from half-resolution g: the 2x2 quad of dx
//     rows 2i, 2i+1 and columns 2j, 2j+1 reads only the 2x2 g window (i..
//     i+1, j..j+1) of 3 frames (the even row through dy = 1, the odd row
//     through dy = 2 on g row i and dy = 0 on row i+1; columns alike), 27
//     MACs per quad with no branch and no wasted tap. A block stages its R+1
//     g rows at WB+1 columns (the halo column by the threads of column 0)
//     into a shared-memory ring of GSTAGE = 5 frames, so the two frames
//     after the three being read are in flight. A register ring of dx
//     frames (24R floats beside the 54 taps) would not fit in 128
//     registers, so a thread reads the 3 g frames of each dx frame from the
//     ring (6(R+1) pair reads), sums one dx frame (8R floats) and writes it
//     once: a warp's two stores of a row (columns 2j and 2j+1) together
//     cover 2PG channels of each of its dx columns, one contiguous run where
//     the group holds every pair. Each element's terms are added with one
//     fmaf each in g's frame, row, then column order, the order in which
//     K11 (dw_stencil_s1) adds them on g put at the even positions of a zero
//     full-resolution tensor with the flipped taps: it equals that bit for
//     bit.
//   * The act dx (K5) is the same body with a template flag
//     (act_s2_dx_kernel beside plain_s2_dx_kernel), so da equals K8's f32
//     dx bit for bit, plus K3's epilogue (dw_dx_s1.cu): each thread stages
//     by cp.async the x pairs of its own quads (2R rows x 2 columns) into a
//     ring of XSTAGE = 3 frames, x frame o in the commit group of g frame
//     o + 1, the last one dx frame o waits for, so x arrives with no barrier
//     and no load on the step's path; masks (bn_apply, rounded apart),
//     stores dx = dam*sc as a
//     pair, and keeps (sum dam*x, sum dam) in registers over its walk; the
//     block sums its threads' columns in a fixed order into its row of a
//     partial buffer, added by the wrapper's one torch.sum (no atomics).
//     At most NT_DX = 192 threads a block (plan_act_dx_s2), so a thread may
//     hold 168 registers: K8's 114-125 plus the epilogue's state.
//   * The weight gradient (K10 plain) keeps a register ring of g along T
//     and its 27 x 2 sums in registers over the block's whole walk. Its
//     grid is persistent: each block walks IPB consecutive work items
//     (sample, frame segment, row strip, column tile) of its channel group,
//     then sums its threads' columns in a fixed order and writes one partial
//     row; the wrapper adds the rows with one torch.sum, so runs repeat bit
//     for bit and nothing uses atomics. It adds x * g only where the ring
//     holds a g element of the item (wgrad_slots, strip.cuh): not for a g
//     frame outside the item's segment, an output row past Ho or a column
//     past Wo, where x * 0 would carry a NaN of x into a tap.
//   * The act weight gradient (K10 act) is the same body with a template
//     flag (act_s2_wgrad_kernel beside plain_s2_wgrad_kernel): the ring
//     holds one frame more (NSTAGE_ACT), and each thread activates in place
//     the x pairs it copied of the next frame (its even, odd and halo
//     columns) while the block reads this one (act_own, strip.cuh): once
//     per pair, where an activation as read would take 1.5 per pair, and
//     off the barrier's path. Rows and columns outside the frame are never
//     copied and stay the zero of a, not relu(bi). Its sums equal K10
//     plain's on the activated x bit for bit, with the same plan.
//   * The mm forward (K4 mm, mm_s2_fwd_kernel) is K1 mm's front end
//     (dw_mm_act.cu) on K4 plain's back end: per input frame the block
//     stages the rectangle of x its outputs read (2R+1 rows, 2WB+1 columns,
//     all C_in) by cp.async three frames deep (MmRect, mm_strip.cuh), runs
//     conv1's product there on mma (mm_activate: K1 mm's code, its relu
//     branch settled against mm_z_fmaf's in-order sum) and writes the activated
//     frame into one of two slots laid out as K4 plain stages x; s2_frame
//     then reads the slot as K4 plain reads its ring, so y equals K4 plain's
//     on K1 mm's activation bit for bit. In one step, between two barriers,
//     the block copies x frame i+2, multiplies frame i and runs the stencil
//     on frame i-1 (K1 mm's schedule); at most NT_DX threads, since the taps
//     and the 6R sums stay live through the product (133-168 registers).
//   * The masked dx (K9, mm_s2_dx_kernel) is K8's body with K2's mask phase
//     (dw_dx_s1.cu): first the segment's relu branches, one byte per
//     (frame, dx position, channel) in shared memory (K2's mm_masks,
//     mm_strip.cuh, on the block's dx positions of x: no halo, all C_in,
//     staged three frames deep; conv1's product by mm_strip_product with
//     W1's column group staged once), then K8's stencil on g, each dx
//     element written as keep ? da : 0. The product's registers and the
//     stencil's are never live together; at most NT_DX threads, as K5. The
//     masks take TT slots beside the ring, so its plan (plan_mm_dx_s2)
//     shortens the segments until two blocks fit an SM. da is K8's f32 sum
//     bit for bit.
//   * The mm weight gradient (K10 mm, mm_s2_wgrad_kernel) is K4 mm's front
//     end on K10 plain's back end, on K6 mm's schedule (dw_plain_s1.cu):
//     per frame the product of x's staged rectangle into one of two
//     activated slots at K4 mm's places, g frames by cp.async into a ring
//     of their own beside it, then s2_wgrad_body's register ring, sums,
//     rule (wgrad_slots) and persistent walk on the slot, so dk equals K10
//     plain's on the activation bit for bit, with the same plan
//     (plan_mm_wgrad_s2); at most NT_DX threads, as K4 mm.
//   * Rows and columns outside the frame are never copied and read as the
//     zero the ring is cleared to once per tile; frames outside the clip add
//     nothing. With R a template argument the loops over staged rows are
//     fully unrolled and have no branch.
// The split (R, WB, PG, TT and, for the weight gradient, IPB and the row
// count) is computed by the wrappers (ops/dw_conv.py: plan_s2_fwd,
// plan_act_s2_fwd, plan_mm_s2_fwd, plan_s2_dx, plan_act_dx_s2,
// plan_mm_dx_s2, plan_s2 for the plain and act weight gradients,
// plan_mm_wgrad_s2 for the mm one) and checked here; a
// plan the kernels do not take returns cudaErrorInvalidValue.

#include "mm_strip.cuh"

namespace {

using namespace cfn;

constexpr int GSTAGE = 5;  // g frames in the dx kernels' ring
constexpr int XSTAGE = 3;  // x frames in the act dx kernel's ring

// One thread's share of staging a tile of output columns [w0, w0+WB): its
// channel pair c at the de-interleaved staged columns even wl (input column
// 2(w0+wl)-1), odd wl (2(w0+wl)) and, for wl == 0, even WB (2(w0+WB)-1), on
// every x row; and at column wl of every g row.
struct S2Stager {
  int srcE, srcO, srcX, dstE, dstO, dstX, srcG, C;
  bool uE, uO, uX, uG, pairs, second;

  __device__ __forceinline__ S2Stager(const Tile& tl, int wl, int pi, int WB,
                                      int PG2, int W, int Wo, int C_,
                                      bool pairs_)
      : C(C_), pairs(pairs_) {
    const int c = 2 * (tl.p0 + pi);
    const bool in = wl < WB && c < C;
    const int gE = 2 * (tl.w0 + wl) - 1, gX = 2 * (tl.w0 + WB) - 1;
    uE = in && gE >= 0 && gE < W;
    uO = in && gE + 1 < W;
    uX = wl == 0 && c < C && gX < W;
    uG = in && tl.w0 + wl < Wo;
    srcE = gE * C + c;
    srcO = srcE + C;
    srcX = gX * C + c;
    srcG = (tl.w0 + wl) * C + c;
    dstE = wl * PG2 + 2 * pi;
    dstO = (WB + 1) * PG2 + dstE;
    dstX = WB * PG2 + 2 * pi;
    second = c + 1 < C;
  }

  // x rows [hs, hs + nr) of frame f (H, W, C), clipped to the frame, into
  // dst laid out [nr][2][WB + 1][2PG]
  template <typename T>
  __device__ __forceinline__ void x_rows(T* dst, const T* f, int hs, int nr,
                                         int H, int W, int rowlen) const {
    const int lo = max(hs, 0), hi = min(hs + nr, H);
    for (int h = lo; h < hi; ++h) {
      const T* src = f + (size_t)h * W * C;
      T* d = dst + (h - hs) * rowlen;
      if (uE) copy_pair(d + dstE, src + srcE, pairs, second);
      if (uO) copy_pair(d + dstO, src + srcO, pairs, second);
      if (uX) copy_pair(d + dstX, src + srcX, pairs, second);
    }
  }

  // The act weight gradient: activates in place the pairs x_rows(dst, .,
  // hs, NR, H, ., rowlen) copied, column by column (act_column, strip.cuh)
  template <int NR, bool ROLLED, typename T>
  __device__ __forceinline__ void act_x_rows(T* dst, int hs, int H,
                                             int rowlen, float2 sc,
                                             float2 bi) const {
    if (uE) act_column<NR, ROLLED>(dst + dstE, hs, H, rowlen, sc, bi);
    if (uO) act_column<NR, ROLLED>(dst + dstO, hs, H, rowlen, sc, bi);
    if (uX) act_column<NR, ROLLED>(dst + dstX, hs, H, rowlen, sc, bi);
  }

  // g rows [h0, h0 + nr) of frame f (Ho, Wo, C), clipped, into dst laid out
  // [nr][WB][2PG] (the thread's own column and pair)
  template <typename T>
  __device__ __forceinline__ void g_rows(T* dst, const T* f, int h0, int nr,
                                         int Ho, int Wo, int growlen) const {
    if (!uG) return;
    const int hi = min(h0 + nr, Ho);
    for (int h = h0; h < hi; ++h)
      copy_pair(dst + (h - h0) * growlen + dstE,
                f + (size_t)h * Wo * C + srcG, pairs, second);
  }
};

// One thread's share of staging the dx kernel's g tile: its channel pair c
// at g column w0+wl and, for wl == 0, at the halo column w0+WB, on every
// row, into [rows][WB + 1][2PG].
struct GStager {
  int src, srcX, dst, dstX, C;
  bool u, uX, pairs, second;

  __device__ __forceinline__ GStager(const Tile& tl, int wl, int pi, int WB,
                                     int PG2, int Wo, int C_, bool pairs_)
      : C(C_), pairs(pairs_) {
    const int c = 2 * (tl.p0 + pi);
    u = wl < WB && c < C && tl.w0 + wl < Wo;
    uX = wl == 0 && c < C && tl.w0 + WB < Wo;
    src = (tl.w0 + wl) * C + c;
    srcX = (tl.w0 + WB) * C + c;
    dst = wl * PG2 + 2 * pi;
    dstX = WB * PG2 + 2 * pi;
    second = c + 1 < C;
  }

  // g rows [h0, h0 + nr) of frame f (Ho, Wo, C), clipped to the frame
  template <typename T>
  __device__ __forceinline__ void rows(T* out, const T* f, int h0, int nr,
                                       int Ho, int Wo, int rowlen) const {
    const int hi = min(h0 + nr, Ho);
    for (int h = h0; h < hi; ++h) {
      const T* s = f + (size_t)h * Wo * C;
      T* d = out + (h - h0) * rowlen;
      if (u) copy_pair(d + dst, s + src, pairs, second);
      if (uX) copy_pair(d + dstX, s + srcX, pairs, second);
    }
  }
};

// One thread's share of staging the act dx's x: the pairs its own dx quads
// read in the epilogue (dx columns 2j and 2j+1 of the 2R rows 2h0 ..
// 2h0+2R-1), clipped to the frame, into [2R][2][WB][2PG] (row, column
// parity, g column, pair). No other thread reads them.
struct QuadStager {
  int src0, src1, dst, C;
  bool u0, u1, pairs, second;

  __device__ __forceinline__ QuadStager(const Tile& tl, int wl, int pi,
                                        int PG2, int W, int C_, bool pairs_)
      : C(C_), pairs(pairs_) {
    const int c = 2 * (tl.p0 + pi);
    const int q = 2 * (tl.w0 + wl);  // dx column 2j
    u0 = c < C && q < W;
    u1 = c < C && q + 1 < W;
    src0 = q * C + c;
    src1 = src0 + C;
    dst = wl * PG2 + 2 * pi;
    second = c + 1 < C;
  }

  // rows [r0, r0 + nr) of frame f (H, W, C), clipped to the frame; a row
  // of the slot is 2 * WB * PG2 elements, column parity 1 at + WB * PG2
  template <typename T>
  __device__ __forceinline__ void rows(T* slot, const T* f, int r0, int nr,
                                       int H, int W, int half) const {
    const int hi = min(r0 + nr, H);
    for (int h = r0; h < hi; ++h) {
      const T* s = f + (size_t)h * W * C;
      T* d = slot + (h - r0) * 2 * half + dst;
      if (u0) copy_pair(d, s + src0, pairs, second);
      if (u1) copy_pair(d + half, s + src1, pairs, second);
    }
  }
};

// Elements of one staged x frame (2R+1 rows), of one g frame of the weight
// gradient (R rows) and of one g frame of the dx (R+1 rows, WB+1 columns),
// each padded to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int xstage_elems(int R, int WB, int PG) {
  return ((2 * R + 1) * 2 * (WB + 1) * 2 * PG * (int)sizeof(T) + 15) / 16 *
         16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ __forceinline__ int gstage_elems(int R, int WB, int PG) {
  return (R * WB * 2 * PG * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ __forceinline__ int dxstage_elems(int R, int WB, int PG) {
  return ((R + 1) * (WB + 1) * 2 * PG * (int)sizeof(T) + 15) / 16 * 16 /
         (int)sizeof(T);
}
// ... and of one x frame of the act dx (2R rows of 2WB own columns)
template <typename T>
__host__ __device__ __forceinline__ int quadstage_elems(int R, int WB,
                                                        int PG) {
  return (2 * R * 2 * WB * 2 * PG * (int)sizeof(T) + 15) / 16 * 16 /
         (int)sizeof(T);
}

// The stride-2 stencil of one staged x frame at the thread's column and
// channel pair: staged row rr (input row 2h0 - 1 + rr) meets output row r
// through dy = rr - 2r in [0, 2]; its even column wl, odd column wl and even
// column wl + 1 (atE, atO, atE + PG2) are the taps dx = 0, 1, 2. FN(j, r,
// dy, dx, v) does one multiply-add; everything is unrolled, so the loop has
// no branch and the shared-memory reads of a row can run ahead.
template <typename T, int R, typename FN>
__device__ __forceinline__ void s2_frame(const T* slot, int rowlen, int atE,
                                         int atO, int PG2, FN fn) {
#pragma unroll
  for (int rr = 0; rr < 2 * R + 1; ++rr) {
    const T* sr = slot + rr * rowlen;
    const float2 v[3] = {load_pair(sr + atE), load_pair(sr + atO),
                         load_pair(sr + atE + PG2)};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dy = rr - 2 * r;
      if (dy < 0 || dy > 2) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) fn(j, r, dy, dx, v[dx]);
    }
  }
}

// s2_frame under the weight gradient's rule (strip.cuh): the ring slots j of
// bit j of slots, the output rows r < nr, each tap's products in s2_frame's
// order, as stencil_frame_masked (ROWS_ONCE likewise).
template <typename T, int R, bool ROWS_ONCE, typename FN>
__device__ __forceinline__ void s2_frame_masked(const T* slot, int rowlen,
                                                int atE, int atO, int PG2,
                                                FN fn, unsigned slots,
                                                int nr) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (!((slots >> j) & 1u)) continue;
    if constexpr (ROWS_ONCE) {
#pragma unroll
      for (int rr = 0; rr < 2 * R + 1; ++rr) {
        const T* sr = slot + rr * rowlen;
        const float2 v[3] = {load_pair(sr + atE), load_pair(sr + atO),
                             load_pair(sr + atE + PG2)};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int dy = rr - 2 * r;
          if (dy < 0 || dy > 2 || r >= nr) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) fn(j, r, dy, dx, v[dx]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) break;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const T* sr = slot + (2 * r + dy) * rowlen;
          const float2 v[3] = {load_pair(sr + atE), load_pair(sr + atO),
                               load_pair(sr + atE + PG2)};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) fn(j, r, dy, dx, v[dx]);
        }
      }
    }
  }
}

// The taps of the thread's channel pair (zero where it owns no output)
template <typename T>
__device__ __forceinline__ void load_taps(float (&k0)[27], float (&k1)[27],
                                          const T* k, int c, int C,
                                          bool live) {
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    k0[i] = live ? to_f(k[i * C + c]) : 0.f;
    k1[i] = live && c + 1 < C ? to_f(k[i * C + c + 1]) : 0.f;
  }
}

// ---- forward (K4 plain; K4 act) ---------------------------------------------
// Thread (wl, pi) = (tid / PG, tid % PG): output column w0 + wl, channels
// c, c+1 with c = 2*(p0 + pi). Slot i of the ring holds x frame f0 + i
// (staged rows rr = 0..2R: input row 2h0 - 1 + rr). acc[j][r] holds output
// frame ti - 1 + j of row h0 + r while input frame ti is read: frame ti adds
// tap dt = 2 - j to it. After frame ti, acc[0] (output ti - 1) is complete,
// is written, and the ring shifts.
//
// ACT (the act entry's forward, K4 act): the stencil reads a = relu(x*sc +
// bi) rounded to T, activated in place a frame ahead in a ring of
// NSTAGE_ACT frames (act_own, strip.cuh: each thread its even, odd and halo
// columns' pairs, as K10 act); rows and columns outside the frame are never
// copied and stay the zero padding of a. The stencil and its order are K4
// plain's, so y is K4 plain's on the activated x bit for bit.
template <typename T, int R, bool ACT>
__device__ __forceinline__ void s2_fwd_body(const T* __restrict__ x,
                                            const T* __restrict__ k,
                                            const float* __restrict__ sc,
                                            const float* __restrict__ bi,
                                            T* __restrict__ y, int Tn, int H,
                                            int W, int Ho, int Wo, int C,
                                            const Plan& pl) {
  constexpr int NS = ACT ? NSTAGE_ACT : NSTAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = 2 * (WB + 1) * PG2;
  const int stage = xstage_elems<T>(R, WB, PG);

  const int blk = blockIdx.x;
  const int pg = blk % pl.n_pg;
  const Tile tl = pl.tile(blk / pl.n_pg, pg, Tn);
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int w = tl.w0 + wl;
  const int c = 2 * (tl.p0 + pi);
  // threads past the block's columns read nothing (the last warp's tail)
  const bool in = wl < WB;
  const bool live = in && w < Wo && c < C;  // owns outputs
  const bool second = c + 1 < C;
  // the thread's even column wl, odd column wl and even column wl + 1
  const int atE = wl * PG2 + 2 * pi, atO = (WB + 1) * PG2 + atE;

  float k0[27], k1[27];
  load_taps(k0, k1, k, c, C, live);
  float2 scp, bip;  // ACT: bn1's apply of the thread's pair
  if constexpr (ACT) pair_vecs(scp, bip, sc, bi, c, C);

  const size_t frame = (size_t)H * W * C;
  const T* xb = x + (size_t)tl.b * Tn * frame;
  const S2Stager sg(tl, wl, pi, WB, PG2, W, Wo, C, pl.pairs);
  const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;  // input frames
  auto load = [&](int i) {
    const int ti = f0 + i;
    if (i < nf && ti >= 0 && ti < Tn)  // uniform across the block
      sg.x_rows(ring + (i % NS) * stage, xb + (size_t)ti * frame,
                2 * tl.h0 - 1, 2 * R + 1, H, W, rowlen);
    cp_commit();
  };
  auto own = [&](int i) {  // ACT: the thread's copies of frame i, in place
    const int ti = f0 + i;
    if (i < nf && ti >= 0 && ti < Tn)
      // as K10 act: the f32 R = 3 build keeps its groups rolled
      sg.act_x_rows<2 * R + 1, sizeof(T) == 4 && R == 3>(
          ring + (i % NS) * stage, 2 * tl.h0 - 1, H, rowlen, scp, bip);
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
      s2_frame<T, R>(ring + (i % NS) * stage, rowlen, atE, atO, PG2,
                     [&](int j, int r, int dy, int dx, float2 v) {
                       const int tap = ((2 - j) * 3 + dy) * 3 + dx;
                       acc[j][r][0] = fmaf(k0[tap], v.x, acc[j][r][0]);
                       acc[j][r][1] = fmaf(k1[tap], v.y, acc[j][r][1]);
                     });
    const int to = ti - 1;  // complete now
    if (to >= tl.t0 && live) {
      T* yo = y + (((size_t)tl.b * Tn + to) * Ho + tl.h0) * Wo * C +
              (size_t)w * C + c;
      const bool pair = second && !(C & 1);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tl.h0 + r < Ho)
          store_pair(yo + (size_t)r * Wo * C, acc[0][r][0], acc[0][r][1],
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
plain_s2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k,
                    T* __restrict__ y, int Tn, int H, int W, int Ho, int Wo,
                    int C, Plan pl) {
  s2_fwd_body<T, R, false>(x, k, nullptr, nullptr, y, Tn, H, W, Ho, Wo, C,
                           pl);
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
act_s2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k,
                  const float* __restrict__ sc, const float* __restrict__ bi,
                  T* __restrict__ y, int Tn, int H, int W, int Ho, int Wo,
                  int C, Plan pl) {
  s2_fwd_body<T, R, true>(x, k, sc, bi, y, Tn, H, W, Ho, Wo, C, pl);
}

// ---- the mm forward (K4 mm) ---------------------------------------------------
// Shared memory of mm_s2_fwd_kernel (mm_strip.cuh's MmLayout): two
// activated slots in the forward's staged-frame layout (2R+1 rows of
// 2(WB+1) de-interleaved columns, xstage_elems), then mm_front's of the
// (2R+1) x min(2WB+1, W) staged positions.
template <typename T>
__host__ __device__ __forceinline__ MmLayout mm_s2_fwd_layout(int R, int WB,
                                                              int PG, int Cin,
                                                              int W) {
  const int aslot = xstage_elems<T>(R, WB, PG) * (int)sizeof(T);
  MmLayout L = mm_front<T>((2 * R + 1) * min(2 * WB + 1, W), Cin, PG,
                           2 * aslot, 0);
  L.aslot = aslot;
  return L;
}

// K1 mm's front end on K4 plain's back end. A block owns K4 plain's tile
// (R output rows x WB columns x PG channel pairs of one sample over TT
// frames; ops/dw_conv.py: plan_mm_s2_fwd). Per input frame it stages the
// rectangle of x its outputs read, input rows 2h0-1 .. 2h0+2R-1 at columns
// 2w0-1 .. 2w0+2WB-1 (all C_in), by cp.async into a ring of XSTAGE_MM
// frames, computes conv1's product there (mm_activate: bf16 16 x 8 tiles on
// the tensor cores, each relu input within mm_band of 0 summed again in
// order; f32 fmaf over k in order), applies bn1 and the relu, rounds to T
// and writes the activated frame into one of two slots laid out as K4
// plain stages x (each row's even columns, then its odd ones); the stencil
// then walks the slot as K4 plain does (s2_frame, a register ring of the 3
// output frames), so y equals K4 plain's on the activated x bit for bit.
// In one step, between two barriers, the block copies x frame i+2,
// computes the product of frame i and the stencil of frame i-1 (K1 mm's
// schedule). Rows and columns outside the frame are never written and stay
// the zero the slots are cleared to (SAME padding after the activation).
// At most NT_DX threads: the 54 taps and 6R sums stay live through the
// product.
template <typename T, int R>
__global__ void __launch_bounds__(NT_DX, 2)
mm_s2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ k, const float* __restrict__ sc,
                 const float* __restrict__ bi, T* __restrict__ y, int Tn,
                 int H, int W, int Ho, int Wo, int Cin, int C, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = 2 * (WB + 1) * PG2;
  const MmLayout L = mm_s2_fwd_layout<T>(R, WB, PG, Cin, W);
  T* act_s = reinterpret_cast<T*>(smem_raw);  // [2][2R+1][2(WB+1)][2PG]
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs_off);
  T* wt = reinterpret_cast<T*>(smem_raw + L.wt_off);
  float* scs = reinterpret_cast<float*>(smem_raw + L.vec_off);
  float* bis = scs + (L.ng + 3) / 4 * 4;
  float* kbs = bis + (L.ng + 3) / 4 * 4;
  int* tab = reinterpret_cast<int*>(smem_raw + L.tab_off);
  const int aslot = L.aslot / (int)sizeof(T), xslot = L.xslot / (int)sizeof(T);
  const int ld = L.ld;

  const int blk = blockIdx.x;
  const int pg = blk % pl.n_pg;
  const Tile tl = pl.tile(blk / pl.n_pg, pg, Tn);
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int w = tl.w0 + wl;
  const int c0 = 2 * tl.p0, c = c0 + 2 * pi;
  const bool in = wl < WB;
  const bool live = in && w < Wo && c < C;  // owns outputs
  const bool second = c + 1 < C;
  // the thread's even column wl, odd column wl and even column wl + 1
  const int atE = wl * PG2 + 2 * pi, atO = (WB + 1) * PG2 + atE;

  float k0[27], k1[27];
  load_taps(k0, k1, k, c, C, live);

  // the tile's staged rectangle of x (mm_strip.cuh)
  const int r0 = 2 * tl.h0 - 1, e0 = 2 * tl.w0 - 1;
  const MmRect mr(r0, 2 * R + 1, e0, 2 * WB + 1, H, W, Cin, ld,
                  16 / (int)sizeof(T));

  zero_ring(smem_raw, L.wt_off);  // both slots and the x ring
  // W1's columns c0 .. c0 + ng (zero past C_mid and past the group, and in
  // bf16 past C_in), bn1's apply vectors, and each staged position's place
  // in a slot, once per block: input column e0 + e goes to the slot's even
  // column e/2 or odd column (e-1)/2, as S2Stager stages K4 plain's x
  mm_stage_vecs(scs, bis, kbs, sc, bi, C, c0, PG2, L.ng,
                mm_band((ld - 8) / 16, Cin));
  mm_stage_w1<T>(wt, w1, Cin, C, c0, PG2, L.ng, ld);
  mr.table(tab, L.rows, [&](int rr, int col) {
    const int e = col - e0;
    return rr * rowlen + ((e & 1) * (WB + 1) + (e >> 1)) * PG2;
  });

  const size_t frame = (size_t)H * W * Cin;
  // x rows of the tile, from staged row 0 (input row 2h0 - 1) and column
  // cs0, of sample b
  const T* xb = x + (size_t)tl.b * Tn * frame +
                ((long long)r0 * W + mr.cs0) * Cin;
  const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;  // input frames
  // x frame f0 + i (its rows in the frame) into ring slot i % XSTAGE_MM
  auto stage_x = [&](int i) {
    const int ti = f0 + i;
    if (i < nf && ti >= 0 && ti < Tn)  // uniform across the block
      mr.stage(xs + (i % XSTAGE_MM) * xslot, xb + (size_t)ti * frame, W, Cin,
               ld);
    cp_commit();
  };

  float acc[3][R][2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r][0] = acc[j][r][1] = 0.f;

  for (int i = 0; i < XSTAGE_MM - 1; ++i) stage_x(i);
  for (int i = 0; i <= nf; ++i) {
    cp_wait<XSTAGE_MM - 2>();  // this thread's copies of x frame i landed
    __syncthreads();  // and everyone's; slot i-1 is written; slot i, and x
                      // ring slot i-1, are read by no one
    stage_x(i + XSTAGE_MM - 1);
    // conv1's product of x frame f0 + i, bn1, relu rounded to T ->
    // activated slot i % 2
    if (i < nf && f0 + i >= 0 && f0 + i < Tn)
      mm_activate<T>(act_s + (i & 1) * aslot, xs + (i % XSTAGE_MM) * xslot,
                     wt, L, PG, mr.M, Cin, scs, bis, kbs, tab);
    if (i == 0) continue;
    const int ti = f0 + i - 1;  // the frame the stencil reads now
    if (ti >= 0 && ti < Tn && in)  // frames outside the clip add nothing
      s2_frame<T, R>(act_s + ((i - 1) & 1) * aslot, rowlen, atE, atO, PG2,
                     [&](int j, int r, int dy, int dx, float2 v) {
                       const int tap = ((2 - j) * 3 + dy) * 3 + dx;
                       acc[j][r][0] = fmaf(k0[tap], v.x, acc[j][r][0]);
                       acc[j][r][1] = fmaf(k1[tap], v.y, acc[j][r][1]);
                     });
    const int to = ti - 1;  // complete now
    if (to >= tl.t0 && live) {
      T* yo = y + (((size_t)tl.b * Tn + to) * Ho + tl.h0) * Wo * C +
              (size_t)w * C + c;
      const bool pair = second && !(C & 1);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tl.h0 + r < Ho)
          store_pair(yo + (size_t)r * Wo * C, acc[0][r][0], acc[0][r][1],
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

// ---- the masked dx's shared memory (K9) ------------------------------------
// mm_strip.cuh's mm_mask_layout: the ring (phase 1: XSTAGE_MM staged x
// rectangles of 2R x min(2WB, W) positions; phase 2: dx_s2_body's GSTAGE g
// frames), then W1's columns, bn1's vectors, the positions' places and TT
// mask slots [2R][2][WB][2PG] of bytes (dx row 2(h0+r)+py, column parity
// px, g column wl, channel).
template <typename T>
__host__ __device__ __forceinline__ MmMaskLayout mm_s2_dx_layout(
    int R, int WB, int PG, int Cin, int W, int TT) {
  return mm_mask_layout<T>(
      2 * R * min(2 * WB, W), Cin, PG,
      GSTAGE * dxstage_elems<T>(R, WB, PG) * (int)sizeof(T),
      2 * R * 2 * WB * 2 * PG, TT);
}

// ---- dx (K8) and act dx (K5) ------------------------------------------------------
// The tile is over g: thread (wl, pi) owns g column j = w0 + wl and channels
// c, c+1, and writes dx columns 2j and 2j+1 of dx rows 2(h0+r) and
// 2(h0+r)+1, r < R. Slot i % GSTAGE of the ring holds g frame f0 + i (rows
// h0 .. h0+R, columns w0 .. w0+WB). dx frame o reads g frames o-1, o, o+1
// (taps dt = 2, 1, 0) in slots i .. i+2, i = o - t0.
//
// ACT (the act entry's dx, K5): da is the sum above, then dam = da where
// x*sc + bi > 0 (bn_apply), else 0; dx = dam*sc in x's dtype, and the
// thread keeps (sum dam*x, sum dam) of its pair over the block's walk. x
// frame o travels in commit group i + 2 with g frame o + 1 (x slot
// (i + 2) % XSTAGE), each thread staging only the pairs of its own quads
// (QuadStager): it has landed when step i's wait returns, and no barrier
// is needed for it. At the end the block sums its threads' columns in a
// fixed order into row `item` of the (items, 2, C) partial buffer.
template <typename T, int R, bool ACT, bool MM = false>
__device__ __forceinline__ void dx_s2_body(
    const T* __restrict__ g, const T* __restrict__ k,
    const T* __restrict__ x, const float* __restrict__ sc,
    const float* __restrict__ bi, T* __restrict__ dx,
    float* __restrict__ part, int Tn, int H, int W, int Ho, int Wo, int C,
    const Plan& pl, const T* __restrict__ w1 = nullptr, int Cin = 0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = (WB + 1) * PG2;
  const int stage = dxstage_elems<T>(R, WB, PG);
  // ACT: the x ring after the g ring
  const int xstage = ACT ? quadstage_elems<T>(R, WB, PG) : 0;
  T* xring = ring + GSTAGE * stage;

  const int blk = blockIdx.x;
  const int pg = blk % pl.n_pg;
  const int item = blk / pl.n_pg;
  const Tile tl = pl.tile(item, pg, Tn);
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int j = tl.w0 + wl;
  const int c = 2 * (tl.p0 + pi);
  const bool in = wl < WB;
  const bool live = in && j < Wo && c < C;
  const bool second = c + 1 < C;
  const int at = wl * PG2 + 2 * pi;  // g column j; j + 1 is at + PG2

  // MM: phase 1, the segment's relu branches (x is conv1's input, C_in
  // channels), before the stencil's registers are live
  const unsigned char* mask = nullptr;
  int mbytes = 0;
  if constexpr (MM) {
    // as K2's first phase (mm_masks), on the dx positions the block writes:
    // x rows 2h0 .. 2h0+2R-1 and columns 2w0 .. 2w0+2WB-1 (no halo); input
    // column 2w0 + e goes to the mask place of dx column parity e & 1, g
    // column e >> 1
    const MmMaskLayout L = mm_s2_dx_layout<T>(R, WB, PG, Cin, W, pl.TT);
    const MmRect mr(2 * tl.h0, 2 * R, 2 * tl.w0, 2 * WB, H, W, Cin, L.f.ld,
                    16 / (int)sizeof(T));
    const size_t frame = (size_t)H * W * Cin;
    mm_masks<T>(
        smem_raw, L, mr,
        [&](int rr, int col) {
          const int e = col - 2 * tl.w0;
          return ((rr * 2 + (e & 1)) * WB + (e >> 1)) * PG2;
        },
        x + ((size_t)tl.b * Tn + tl.t0) * frame +
            ((size_t)2 * tl.h0 * W + mr.cs0) * Cin,
        frame, tl.t1 - tl.t0, w1, sc, bi, W, Cin, C, 2 * tl.p0, PG);
    mask = smem_raw + L.mask_off;
    mbytes = L.mbytes;
  }

  float k0[27], k1[27];
  load_taps(k0, k1, k, c, C, live);
  // ACT: bn1's apply of the pair, and (sum dam*x, sum dam) per channel
  float sc0 = 0.f, bi0 = 0.f, sc1 = 0.f, bi1 = 0.f;
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if constexpr (ACT) {
    if (live) {
      sc0 = sc[c];
      bi0 = bi[c];
      if (second) {
        sc1 = sc[c + 1];
        bi1 = bi[c + 1];
      }
    }
  }

  const size_t gframe = (size_t)Ho * Wo * C;
  const T* gb = g + (size_t)tl.b * Tn * gframe;
  const GStager sg(tl, wl, pi, WB, PG2, Wo, C, pl.pairs);
  const size_t xframe = (size_t)H * W * C;
  const T* xb = ACT ? x + (size_t)tl.b * Tn * xframe : nullptr;
  const QuadStager sx(tl, wl, pi, PG2, W, C, pl.pairs);
  const int half = WB * PG2;  // an x slot's column-parity stride
  const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;  // g frames
  auto load = [&](int i) {
    const int tg = f0 + i;
    if (i < nf && tg >= 0 && tg < Tn)  // uniform across the block
      sg.rows(ring + (i % GSTAGE) * stage, gb + (size_t)tg * gframe, tl.h0,
              R + 1, Ho, Wo, rowlen);
    if constexpr (ACT) {
      const int tx = tg - 1;  // the dx frame this group's step completes
      if (tx >= tl.t0 && tx < tl.t1 && live)
        sx.rows(xring + (i % XSTAGE) * xstage, xb + (size_t)tx * xframe,
                2 * tl.h0, 2 * R, H, W, half);
    }
    cp_commit();
  };
  // q[px][ch] of one dx row += the terms of g row values a (column j) and
  // b (column j+1) through taps (dt, dy): the even column 2j through dx =
  // 1; the odd column 2j+1 through dx = 2 on a, then dx = 0 on b
  auto add = [&](float (&q)[2][2], int dt, int dy, float2 a, float2 b) {
    const int t0 = (dt * 3 + dy) * 3;
    q[0][0] = fmaf(k0[t0 + 1], a.x, q[0][0]);
    q[0][1] = fmaf(k1[t0 + 1], a.y, q[0][1]);
    q[1][0] = fmaf(k0[t0 + 2], a.x, q[1][0]);
    q[1][1] = fmaf(k1[t0 + 2], a.y, q[1][1]);
    q[1][0] = fmaf(k0[t0], b.x, q[1][0]);
    q[1][1] = fmaf(k1[t0], b.y, q[1][1]);
  };

  zero_ring(smem_raw, (GSTAGE * stage + XSTAGE * xstage) * (int)sizeof(T));
  for (int i = 0; i < GSTAGE - 1; ++i) load(i);
  for (int o = tl.t0; o < tl.t1; ++o) {
    const int i = o - tl.t0;
    cp_wait<GSTAGE - 4>();  // this thread's copies of frame i + 2 landed
    __syncthreads();        // and everyone's; slot i-1 is read by no one
    load(i + GSTAGE - 1);   // into slot i-1
    // acc[r][py][px][ch]: dx row 2(h0+r)+py, column 2j+px
    float acc[R][2][2][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int py = 0; py < 2; ++py)
#pragma unroll
        for (int px = 0; px < 2; ++px)
          acc[r][py][px][0] = acc[r][py][px][1] = 0.f;
    if (in) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {  // g frames ascending: dt = 2 - f
        const int tg = o - 1 + f;
        if (tg < 0 || tg >= Tn) continue;  // outside the clip: adds nothing
        const T* sl = ring + ((i + f) % GSTAGE) * stage + at;
#pragma unroll
        for (int rr = 0; rr <= R; ++rr) {  // g row h0 + rr, ascending
          const float2 a = load_pair(sl + rr * rowlen);
          const float2 b = load_pair(sl + rr * rowlen + PG2);
          // the odd row of quad rr-1 through dy = 0 (its second g row),
          // the even row of quad rr through dy = 1, its odd row through
          // dy = 2 (its first g row)
          if (rr > 0) add(acc[rr - 1][1], 2 - f, 0, a, b);
          if (rr < R) {
            add(acc[rr][0], 2 - f, 1, a, b);
            add(acc[rr][1], 2 - f, 2, a, b);
          }
        }
      }
    }
    if (live) {
      T* d = dx + ((size_t)tl.b * Tn + o) * H * W * C + c;
      const bool pair = second && !(C & 1);
      // ACT: x frame o at the thread's quads
      const T* xq = xring + ((i + 2) % XSTAGE) * xstage + sx.dst;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int py = 0; py < 2; ++py) {
          const int row = 2 * (tl.h0 + r) + py;
          if (row >= H) continue;
#pragma unroll
          for (int px = 0; px < 2; ++px) {
            const int col = 2 * j + px;
            if (col >= W) continue;
            T* dp = d + ((size_t)row * W + col) * C;
            if constexpr (ACT) {
              const float2 xv =
                  load_pair(xq + (2 * r + py) * 2 * half + px * half);
              const float d0 = bn_apply(xv.x, sc0, bi0) > 0.f
                                   ? acc[r][py][px][0] : 0.f;
              const float d1 = bn_apply(xv.y, sc1, bi1) > 0.f
                                   ? acc[r][py][px][1] : 0.f;
              store_pair(dp, d0 * sc0, d1 * sc1, pair, second);
              sum[0][0] = fmaf(d0, xv.x, sum[0][0]);
              sum[1][0] += d0;
              sum[0][1] = fmaf(d1, xv.y, sum[0][1]);
              sum[1][1] += d1;
            } else if constexpr (MM) {
              // the relu branch of x frame o at the quad's position
              const unsigned short kp =
                  *reinterpret_cast<const unsigned short*>(
                      mask + (o - tl.t0) * mbytes +
                      ((2 * r + py) * 2 + px) * WB * PG2 + at);
              store_pair(dp, (kp & 0xff) ? acc[r][py][px][0] : 0.f,
                         (kp >> 8) ? acc[r][py][px][1] : 0.f, pair, second);
            } else {
              store_pair(dp, acc[r][py][px][0], acc[r][py][px][1], pair,
                         second);
            }
          }
        }
    }
  }
  cp_wait<0>();

  if constexpr (ACT) {
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
    for (int e = tid; e < 2 * PG2; e += blockDim.x) {
      const int q = e / PG2, s = e % PG2;
      const int ch = 2 * tl.p0 + s;
      if (ch >= C) continue;
      float v = 0.f;
      for (int u = 0; u < WB; ++u) v += red[(q * WB + u) * PG2 + s];
      part[((size_t)item * 2 + q) * C + ch] = v;
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_s2_dx_kernel(const T* __restrict__ g, const T* __restrict__ k,
                   T* __restrict__ dx, int Tn, int H, int W, int Ho, int Wo,
                   int C, Plan pl) {
  dx_s2_body<T, R, false>(g, k, nullptr, nullptr, nullptr, dx, nullptr, Tn,
                          H, W, Ho, Wo, C, pl);
}

// At most NT_DX threads: the act epilogue's state (bn1's pair, the sums, x
// pairs) beside K8's 54 taps and 8R sums needs more than 128 registers.
template <typename T, int R>
__global__ void __launch_bounds__(NT_DX, 2)
act_s2_dx_kernel(const T* __restrict__ g, const T* __restrict__ k,
                 const T* __restrict__ x, const float* __restrict__ sc,
                 const float* __restrict__ bi, T* __restrict__ dx,
                 float* __restrict__ part, int Tn, int H, int W, int Ho,
                 int Wo, int C, Plan pl) {
  dx_s2_body<T, R, true>(g, k, x, sc, bi, dx, part, Tn, H, W, Ho, Wo, C, pl);
}

// K9: K8's body with K2's mask phase (MM). At most NT_DX threads, as K5:
// phase 1's product and phase 2's stencil are never live together, and
// neither takes more than 168 registers.
template <typename T, int R>
__global__ void __launch_bounds__(NT_DX, 2)
mm_s2_dx_kernel(const T* __restrict__ g, const T* __restrict__ k,
                const T* __restrict__ x, const T* __restrict__ w1,
                const float* __restrict__ sc, const float* __restrict__ bi,
                T* __restrict__ dam, int Tn, int H, int W, int Ho, int Wo,
                int Cin, int C, Plan pl) {
  dx_s2_body<T, R, false, true>(g, k, x, sc, bi, dam, nullptr, Tn, H, W, Ho,
                                Wo, C, pl, w1, Cin);
}

// ---- weight gradient (K10 plain; K10 act) -------------------------------------
// Thread (wl, pi) as in the forward. Slot i of the ring holds x frame f0 + i
// (staged rows rr = 0..2R: input row 2h0 - 1 + rr) and g frame f0 + i + 1
// (rows h0 .. h0+R-1). While x frame ti is read, gr[j][r] holds g frame
// ti - 1 + j of output row h0 + r (zero outside [t0, t1) and the frame):
// x frame ti pairs with it through tap dt = 2 - j, and staged row rr with
// output row r through dy = rr - 2r, where wgrad_slots admits the pair.
//
// ACT (the act entry's weight gradient, K10 act): the stencil reads a =
// relu(x*sc + bi) rounded to T, the x part of each slot activated in place
// a frame ahead in a ring of NSTAGE_ACT frames (act_own, strip.cuh); rows
// and columns outside the frame are never copied and stay the zero padding
// of a. Nothing else changes, so the sums are K10 plain's on the activated
// x, in its order.
template <typename T, int R, bool ACT>
__device__ __forceinline__ void s2_wgrad_body(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ sc, const float* __restrict__ bi,
    float* __restrict__ part, int Tn, int H, int W, int Ho, int Wo, int C,
    const Plan& pl, int n_items, int ipb) {
  constexpr int NS = ACT ? NSTAGE_ACT : NSTAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = 2 * (WB + 1) * PG2, growlen = WB * PG2;
  const int xstage = xstage_elems<T>(R, WB, PG);
  const int stage = xstage + gstage_elems<T>(R, WB, PG);

  const int pg = blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const bool in = wl < WB;
  const size_t xframe = (size_t)H * W * C, gframe = (size_t)Ho * Wo * C;
  const int atE = wl * PG2 + 2 * pi, atO = (WB + 1) * PG2 + atE;

  float acc[27][2];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i][0] = acc[i][1] = 0.f;
  float2 scp, bip;  // ACT: bn1's apply of the thread's pair
  if constexpr (ACT) pair_vecs(scp, bip, sc, bi, 2 * (pg * PG + pi), C);

  const int row = blockIdx.x;
  const int it1 = min((row + 1) * ipb, n_items);
  for (int item = row * ipb; item < it1; ++item) {
    const Tile tl = pl.tile(item, pg, Tn);
    const T* xb = x + (size_t)tl.b * Tn * xframe;
    const T* gb = g + (size_t)tl.b * Tn * gframe;
    const S2Stager sg(tl, wl, pi, WB, PG2, W, Wo, C, pl.pairs);
    const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;
    // output rows of the strip, and whether the thread's column exists
    const int nr = min(R, Ho - tl.h0);
    const bool live = in && tl.w0 + wl < Wo;
    auto load = [&](int i) {
      if (i < nf) {  // uniform across the block
        T* slot = ring + (i % NS) * stage;
        const int ti = f0 + i, tg = ti + 1;
        if (ti >= 0 && ti < Tn)
          sg.x_rows(slot, xb + (size_t)ti * xframe, 2 * tl.h0 - 1, 2 * R + 1,
                    H, W, rowlen);
        if (tg >= tl.t0 && tg < tl.t1)
          sg.g_rows(slot + xstage, gb + (size_t)tg * gframe, tl.h0, R, Ho,
                    Wo, growlen);
      }
      cp_commit();
    };
    auto own = [&](int i) {  // ACT: the thread's x copies of frame i
      const int ti = f0 + i;
      if (i < nf && ti >= 0 && ti < Tn)
        // the f32 builds keep their groups rolled: unrolled, the R = 3 and
        // R = 4 builds spill beside the rule's variant (s2_frame_masked)
        sg.act_x_rows<2 * R + 1, sizeof(T) == 4>(
            ring + (i % NS) * stage, 2 * tl.h0 - 1, H, rowlen, scp, bip);
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
      // this thread's copies of frame i have landed (ACT: and everyone's
      // are activated); after the barrier everyone's, and slot i-1 is read
      // by no one
      if constexpr (!ACT) cp_wait<NS - 2>();
      __syncthreads();
      load(i + NS - 1);  // into slot i-1
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
        const float2 v = gin ? load_pair(slot + xstage + r * growlen + atE)
                             : make_float2(0.f, 0.f);
        gr[2][r][0] = v.x;
        gr[2][r][1] = v.y;
      }
      if (ti >= 0 && ti < Tn && live) {  // frames outside the clip add
        auto fma = [&](int j, int r, int dy, int dx, float2 v) {  // nothing
          const int tap = ((2 - j) * 3 + dy) * 3 + dx;
          acc[tap][0] = fmaf(v.x, gr[j][r][0], acc[tap][0]);
          acc[tap][1] = fmaf(v.y, gr[j][r][1], acc[tap][1]);
        };
        const unsigned slots = wgrad_slots(i, nf);
        if (slots == 7u && nr == R)
          s2_frame<T, R>(slot, rowlen, atE, atO, PG2, fma);
        else
          s2_frame_masked<T, R, !ACT>(slot, rowlen, atE, atO, PG2, fma,
                                      slots, nr);
      }
    }
    cp_wait<0>();
    __syncthreads();  // the next item zeroes and refills every slot
  }

  wgrad_partials(acc, part, smem_raw, WB, PG, C);
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_s2_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ part, int Tn, int H, int W, int Ho,
                      int Wo, int C, Plan pl, int n_items, int ipb) {
  s2_wgrad_body<T, R, false>(x, g, nullptr, nullptr, part, Tn, H, W, Ho, Wo,
                             C, pl, n_items, ipb);
}

template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
act_s2_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ sc,
                    const float* __restrict__ bi, float* __restrict__ part,
                    int Tn, int H, int W, int Ho, int Wo, int C, Plan pl,
                    int n_items, int ipb) {
  s2_wgrad_body<T, R, true>(x, g, sc, bi, part, Tn, H, W, Ho, Wo, C, pl,
                            n_items, ipb);
}

// ---- weight gradient at stride (2,2,2) (dw_conv_wgrad_t2) -------------------
// dk[dt,dy,dx,c] = sum_{o,h,w} x_pad[2o+dt, 2h+dy, 2w+dx, c] * g[o,h,w,c].
// K10 plain's threads, tiles, sums and partial rows, on a walk of its own
// (running K10 plain's body with ST = 2 cost one barrier per x frame, each
// adding 9 or 18 of the 27 taps, a ring slot's g part used only at even
// frames, an item's ring zeroed, filled and drained for its 1-8 g frames, a
// channel group of 8 of a pixel's 54 channels, and a spilling R = 4 f32
// build; chip_rule2.py times it against this body):
//   * It walks g frames. Step o of an item reads x frames 2o-1, 2o and
//     2o+1 (taps dt = 0, 1, 2) and g frame o, and adds all 27 taps: one
//     barrier per g frame. Frame 2o-1 is the step before's 2o+1, so a step
//     stages two new x frames and one g frame, into a ring of T2_XSLOTS = 5
//     x frames (the step's three and the next step's two, which load while
//     this step is summed) and T2_GSLOTS = 2 g frames. A thread holds the g
//     frame's R rows of its pair (2R floats) beside the 54 sums. A ring two
//     steps deep is one of chip_rule2.py's variants.
//   * An item is one clip (the plan has one segment of all To g frames),
//     and a block's items run as one stream of steps: the next item's first
//     frames load during this item's last step, with no zeroing, prologue
//     or drain between items. The ring is zeroed once; after that every
//     place a thread reads is written for every frame (zero outside the
//     frame) or masked.
//   * The split (plan_t2) is over g's rows and columns with the channel
//     pairs first: a pixel of at most 64 pairs in one group (C = 54 and 108
//     on the path), wider ones in groups of at most 32 pairs (runs of 54-62
//     channels), where K10 plain's columns-first split gave a block 8 of a
//     pixel's 54 channels and left the rest of each sector to other blocks.
//   * Where a group is the whole pixel and x's rows are 16-byte aligned (the
//     whole-pixel mode), a staged row is the tile's pixels as they lie in x,
//     copied 16 bytes at a time (t2_stage_whole), and a thread reads its
//     pixels at a stride of C elements, masking those outside the frame.
//     Otherwise each thread copies its own pairs into K10 plain's
//     de-interleaved layout, 4 (bf16) or 8 (f32) bytes a copy (T2Stager).
//     The pair copies and the stencil's shared reads share the load/store
//     pipe; the 16-byte copies take a quarter of the instructions
//     (chip_rule2.py times both modes, and the loads and the sums alone).
//   * The rule: a product is added only for a live column, an output row
//     r < nr and an x frame inside the clip (g frame o always lies in the
//     item), so a NaN of x reaches the taps it reaches in the plain version.
//     Per tap the products are added x frames ascending, then output rows,
//     so dk equals K10 plain's on g put at the even frames of a zero tensor
//     of Tn frames, launched with this plan and one segment, bit for bit
//     (finite x).
constexpr int T2_XSLOTS = 5;  // x frames in dw_conv_wgrad_t2's ring
constexpr int T2_GSLOTS = 2;  // ... and g frames

// One thread's share of staging dw_conv_wgrad_t2's tile: S2Stager's places
// (its channel pair at the de-interleaved even column wl, odd column wl
// and, for wl == 0, even column WB of every x row; column wl of every g
// row), every owned x place written: copied inside the frame, zero outside.
// A copy of S2Stager rather than a flag on it, so the stride-(1,2,2)
// kernels compile as they did.
struct T2Stager {
  int srcE, srcO, srcX, dstE, dstO, dstX, srcG, C, xrow;
  bool oE, oX, uE, uO, uX, uG, pairs, second;

  __device__ __forceinline__ T2Stager(const Tile& tl, int wl, int pi, int WB,
                                      int PG2, int W, int Wo, int C_,
                                      bool pairs_)
      : C(C_), xrow(W * C_), pairs(pairs_) {
    const int c = 2 * (tl.p0 + pi);
    const int gE = 2 * (tl.w0 + wl) - 1, gX = 2 * (tl.w0 + WB) - 1;
    oE = wl < WB && c < C;
    oX = wl == 0 && c < C;
    uE = oE && gE >= 0 && gE < W;
    uO = oE && gE + 1 < W;
    uX = oX && gX < W;
    uG = oE && tl.w0 + wl < Wo;
    srcE = gE * C + c;
    srcO = srcE + C;
    srcX = gX * C + c;
    srcG = (tl.w0 + wl) * C + c;
    dstE = wl * PG2 + 2 * pi;
    dstO = (WB + 1) * PG2 + dstE;
    dstX = WB * PG2 + 2 * pi;
    second = c + 1 < C;
  }

  // x rows [hs, hs + nr) of frame f (H, W, C) into dst laid out
  // [nr][2][WB + 1][2PG]
  template <typename T>
  __device__ __forceinline__ void x_rows(T* dst, const T* f, int hs, int nr,
                                         int H, int rowlen) const {
    for (int r = 0; r < nr; ++r) {
      T* d = dst + r * rowlen;
      if (hs + r >= 0 && hs + r < H) {
        const T* src = f + (size_t)(hs + r) * xrow;
        if (uE) copy_pair(d + dstE, src + srcE, pairs, second);
        else if (oE) store_pair(d + dstE, 0.f, 0.f, true, true);
        if (uO) copy_pair(d + dstO, src + srcO, pairs, second);
        else if (oE) store_pair(d + dstO, 0.f, 0.f, true, true);
        if (uX) copy_pair(d + dstX, src + srcX, pairs, second);
        else if (oX) store_pair(d + dstX, 0.f, 0.f, true, true);
      } else {
        if (oE) store_pair(d + dstE, 0.f, 0.f, true, true);
        if (oE) store_pair(d + dstO, 0.f, 0.f, true, true);
        if (oX) store_pair(d + dstX, 0.f, 0.f, true, true);
      }
    }
  }

  // g rows [h0, h0 + nr) of frame f (Ho, Wo, C), clipped, into dst laid out
  // [nr][WB][2PG]
  template <typename T>
  __device__ __forceinline__ void g_rows(T* dst, const T* f, int h0, int nr,
                                         int Ho, int Wo, int growlen) const {
    if (!uG) return;
    const int hi = min(h0 + nr, Ho);
    for (int h = h0; h < hi; ++h)
      copy_pair(dst + (h - h0) * growlen + dstE,
                f + (size_t)h * Wo * C + srcG, pairs, second);
  }
};

// Bytes of one staged x row in the whole-pixel mode (below): the tile's
// 2WB+1 pixels of 2PG channels from the 16-byte boundary at or below the
// first, one chunk of slack; and the elements of a ring slot of x, which
// holds a frame in either mode.
template <typename T>
__host__ __device__ __forceinline__ int t2_rowb(int WB, int PG) {
  return 16 * ((2 * WB + 1) * 2 * PG * (int)sizeof(T) / 16 + 2);
}
template <typename T>
__host__ __device__ __forceinline__ int t2_xslot(int R, int WB, int PG) {
  const int whole = (2 * R + 1) * t2_rowb<T>(WB, PG) / (int)sizeof(T);
  const int pairs = xstage_elems<T>(R, WB, PG);
  return whole > pairs ? whole : pairs;
}

// The whole-pixel mode's staging of one x frame f (H, W, C): rows [hs, hs +
// nrows) at the pixels [p0, p0 + np) (all C channels: the block's channel
// group is the pixel), each row a run of 16-byte cp.async copies, the
// block's threads taking the chunks in turn. Row rr sits at slot + rr *
// rowb, pixel p0 + q's first byte at d + q * C * sizeof(T), d the first
// pixel's address mod 16 (one value for every row and frame: W * C *
// sizeof(T) and the base are multiples of 16). A chunk is copied where it
// holds a byte of a pixel inside the frame; a row outside the frame is
// zero. Pixels outside [0, W) are not staged: the readers mask them.
template <typename T>
__device__ __forceinline__ void t2_stage_whole(unsigned char* slot,
                                               const T* f, int hs,
                                               int nrows, int H, int W,
                                               int C, int p0, int np,
                                               int rowb) {
  const int pb = C * (int)sizeof(T), nch = rowb / 16;
  // chunk i = rr * nch + k of the frame, i = threadIdx.x + j * blockDim.x
  int rr = threadIdx.x / nch, k = threadIdx.x - rr * nch;
  for (; rr < nrows; k += blockDim.x) {
    while (k >= nch) {
      k -= nch;
      ++rr;
    }
    if (rr >= nrows) break;
    unsigned char* d = slot + rr * rowb + 16 * k;
    const int h = hs + rr;
    if (h < 0 || h >= H) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const char* row = reinterpret_cast<const char*>(f + (size_t)h * W * C);
    const char* c = reinterpret_cast<const char*>(
        reinterpret_cast<uintptr_t>(row + (ptrdiff_t)p0 * pb) &
        ~(uintptr_t)15) + 16 * k;
    if (c + 16 > row + max(p0, 0) * pb && c < row + min(p0 + np, W) * pb)
      cp_async16(d, c);
  }
}

// One x frame's taps dt = DT against the thread's g rows gv: staged row rr
// meets output row r through dy = rr - 2r, and the thread's taps dx = 0,
// 1, 2 are the elements at a[dx] of each row (s2_frame's reads); each
// tap's products over r ascending. FULL: all R rows and the three columns
// exist; else r < nr only, and column dx only where bit dx of ok is set
// (zero elsewhere).
template <typename T, int R, int DT, bool FULL>
__device__ __forceinline__ void t2_frame(float (&acc)[27][2],
                                         const float (&gv)[R][2],
                                         const T* slot, int rowlen,
                                         const int (&a)[3], unsigned ok,
                                         int nr) {
#pragma unroll
  for (int rr = 0; rr < 2 * R + 1; ++rr) {
    const T* sr = slot + rr * rowlen;
    float2 v[3];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      v[dx] = FULL || (ok >> dx & 1u) ? load_pair(sr + a[dx])
                                      : make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dy = rr - 2 * r;
      if (dy < 0 || dy > 2 || (!FULL && r >= nr)) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int tap = (DT * 3 + dy) * 3 + dx;
        acc[tap][0] = fmaf(v[dx].x, gv[r][0], acc[tap][0]);
        acc[tap][1] = fmaf(v[dx].y, gv[r][1], acc[tap][1]);
      }
    }
  }
}

// The step's three x frames (slots A, B, C: x frames 2o-1, 2o, 2o+1), A
// only where o > 0 and C only inside the clip.
template <typename T, int R, bool FULL>
__device__ __forceinline__ void t2_step(float (&acc)[27][2],
                                        const float (&gv)[R][2], const T* xa,
                                        const T* xb, const T* xc, bool a,
                                        bool c, int rowlen,
                                        const int (&at)[3], unsigned ok,
                                        int nr) {
  if (a) t2_frame<T, R, 0, FULL>(acc, gv, xa, rowlen, at, ok, nr);
  t2_frame<T, R, 1, FULL>(acc, gv, xb, rowlen, at, ok, nr);
  if (c) t2_frame<T, R, 2, FULL>(acc, gv, xc, rowlen, at, ok, nr);
}

// Thread (wl, pi) as in K10 plain. Step s of the block is g frame o = s %
// To of item item0 + s / To; its x frames 2o and 2o+1 are in ring slots 2s
// and 2s+1 (mod T2_XSLOTS), frame 2o-1 in slot 2s-1, its g frame in slot
// s (mod T2_GSLOTS). After step s's barrier no one reads step s-1's
// slots, so step s+1's copies go into slots 2s+2 = 2s-3 and 2s+3 = 2s-2
// and g slot s+1 = s-1 while step s is summed.
//
// whole (uniform): the channel group is the whole pixel (2PG == C) and x's
// rows are 16-byte aligned (x and W * C * sizeof(T)), so a staged row is
// the tile's pixels as they lie in x, copied 16 bytes at a time
// (t2_stage_whole), and the threads read their pixels 2wl-1+dx at a byte
// stride of C * sizeof(T), masking those outside the frame; else K10
// plain's de-interleaved pairs (T2Stager), a copy of 4 (bf16) or 8 (f32)
// bytes each, with the padding staged as zeros.
template <typename T, int R>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_t2_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ part, int Tn, int H, int W, int Ho,
                      int Wo, int C, Plan pl, int n_items, int ipb,
                      int whole) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = 2 * (WB + 1) * PG2, growlen = WB * PG2;
  const int rowb = t2_rowb<T>(WB, PG);
  const int xstage = t2_xslot<T>(R, WB, PG);
  const int gstage = gstage_elems<T>(R, WB, PG);
  T* gring = xring + T2_XSLOTS * xstage;
  const int pg = blockIdx.y, tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const size_t xframe = (size_t)H * W * C, gframe = (size_t)Ho * Wo * C;
  const int To = (Tn - 1) / 2 + 1;
  const int item0 = blockIdx.x * ipb;
  const int steps = (min(item0 + ipb, n_items) - item0) * To;

  float acc[27][2];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i][0] = acc[i][1] = 0.f;

  auto load = [&](int s) {
    if (s < steps) {  // uniform across the block
      const int o = s % To;
      const Tile tl = pl.tile(item0 + s / To, pg, To);
      const T2Stager sg(tl, wl, pi, WB, PG2, W, Wo, C, pl.pairs);
      const T* xb = x + (size_t)tl.b * Tn * xframe;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (2 * o + e >= Tn) continue;
        T* slot = xring + (2 * s + e) % T2_XSLOTS * xstage;
        const T* f = xb + (size_t)(2 * o + e) * xframe;
        if (whole)
          t2_stage_whole(reinterpret_cast<unsigned char*>(slot), f,
                         2 * tl.h0 - 1, 2 * R + 1, H, W, C, 2 * tl.w0 - 1,
                         2 * WB + 1, rowb);
        else
          sg.x_rows(slot, f, 2 * tl.h0 - 1, 2 * R + 1, H, rowlen);
      }
      sg.g_rows(gring + s % T2_GSLOTS * gstage,
                g + ((size_t)tl.b * To + o) * gframe, tl.h0, R, Ho, Wo,
                growlen);
    }
    cp_commit();
  };

  zero_ring(smem_raw,
            (T2_XSLOTS * xstage + T2_GSLOTS * gstage) * (int)sizeof(T));
  load(0);
  for (int s = 0; s < steps; ++s) {
    // this thread's copies of step s have landed; after the barrier
    // everyone's, and step s-1's slots are read by no one
    cp_wait<0>();
    __syncthreads();
    load(s + 1);
    const int o = s % To;
    const Tile tl = pl.tile(item0 + s / To, pg, To);
    const int nr = min(R, Ho - tl.h0);
    if (wl < WB && tl.w0 + wl < Wo) {  // the thread's column exists
      const T* gs = gring + s % T2_GSLOTS * gstage + wl * PG2 + 2 * pi;
      float gv[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 v =
            r < nr ? load_pair(gs + r * growlen) : make_float2(0.f, 0.f);
        gv[r][0] = v.x;
        gv[r][1] = v.y;
      }
      // the thread's taps dx = 0, 1, 2 in a staged row, and which exist
      int at[3], rl = rowlen;
      unsigned ok = 7u;
      bool inner = true;  // uniform: the tile has no column outside x
      if (whole) {
        const int p0 = 2 * tl.w0 - 1;
        const int d = ((p0 * C * (int)sizeof(T)) % 16 + 16) % 16;
        at[0] = (d + 2 * wl * C * (int)sizeof(T)) / (int)sizeof(T) + 2 * pi;
        at[1] = at[0] + C;
        at[2] = at[0] + 2 * C;
        rl = rowb / (int)sizeof(T);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int px = p0 + 2 * wl + dx;
          if (px < 0 || px >= W) ok &= ~(1u << dx);
        }
        inner = p0 >= 0 && p0 + 2 * WB < W;
      } else {
        at[0] = wl * PG2 + 2 * pi;
        at[1] = (WB + 1) * PG2 + at[0];
        at[2] = at[0] + PG2;
      }
      const T* xa = xring + (2 * s + T2_XSLOTS - 1) % T2_XSLOTS * xstage;
      const T* xb = xring + 2 * s % T2_XSLOTS * xstage;
      const T* xc = xring + (2 * s + 1) % T2_XSLOTS * xstage;
      const bool a = o > 0, c = 2 * o + 1 < Tn;
      if (nr == R && inner)
        t2_step<T, R, true>(acc, gv, xa, xb, xc, a, c, rl, at, ok, nr);
      else
        t2_step<T, R, false>(acc, gv, xa, xb, xc, a, c, rl, at, ok, nr);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring becomes the column sums
  wgrad_partials(acc, part, smem_raw, WB, PG, C);
}

// ---- forward and dx at stride (2,2,2) (dw_conv_t2, dw_conv_dx_t2) ---------
// Bodies of their own (running K4 plain's and K8's bodies with the temporal
// stride a template argument cost the forward a barrier per input frame,
// half of them for 9 of the 27 taps, a channel group of 8 of a pixel's 54
// channels staged a pair per 4-byte copy, and the dx a 4-byte store per
// channel pair straight to device memory; chip_rule2.py times both kernels
// against those bodies). Both stay exact against what those bodies
// computed.
//
// The forward, y[o] = sum_dt k[dt] * x[2o-1+dt] (dt, dy, dx as above):
//   * The split (plan_t2_fwd) is over y's rows and columns with the channel
//     pairs first: a pixel of at most T2_WHOLE_PG pairs in one group (C = 54
//     and 108 on the path, 94 % of the bound's bytes), wider ones in groups
//     of at most 32 pairs, then columns to fill the block.
//   * One step per output frame: input frames 2o and 2o+1 arrive together
//     (one cp.async commit group, or one mbarrier phase per frame, the
//     second waited for while the first is summed), one barrier per step.
//     A thread keeps two output frames in registers
//     (acc[0]: o, acc[1]: o+1): frame 2o adds tap dt = 1 to o; frame 2o+1
//     adds dt = 2 to o and dt = 0 to o+1, after which o is complete. Every
//     step adds all 27 taps, and each staged frame is read once.
//   * The ring holds 2(T2F_AHEAD + 1) x frames: the step's two and the next
//     T2F_AHEAD steps' (T2F_AHEAD = 1: 68 KB a block at the first entry in
//     bf16, so two blocks an SM keep about two steps in flight). A segment
//     that starts past frame 0 first reads its frame 2t0-1 (slot 0) alone.
//   * Where the group is the whole pixel and x's rows are 16-byte aligned
//     (the whole-pixel mode), a staged row is the tile's 2WB+1 pixels as
//     they lie in x from the 16-byte boundary at or below the first: one TMA
//     bulk copy a row (cp.async.bulk, issued by warp 0, completing on the
//     slot's mbarrier). The copies then leave the load/store pipe to the
//     stencil's shared reads (16-byte cp.async copies by every thread, as
//     the weight gradient's t2_stage_whole, took 37 % longer on an H100 at
//     the path's entries; chip_rule2.py's fwd_cp16). Otherwise each thread copies its
//     own pairs into K10 plain's de-interleaved layout (T2Stager) with the
//     padding written as zeros.
//   * A thread reads the pixels 2w-1+dx of each staged row at a stride of C
//     elements (whole) or its de-interleaved places (pairs), with no mask:
//     in the whole-pixel mode a row or a pixel outside the frame is never
//     staged and keeps the zero the ring is cleared to once per block (the
//     same places in every frame), and the pairs mode stages zeros there.
//     Bytes of the span outside the tile are never summed.
//     Each output's taps are added in K4 plain's order (dt, then dy, then
//     dx, one fmaf each; frames outside the clip add nothing), so y equals
//     dw_conv_s2's output frames 0, 2, 4, ... bit for bit.
//
// The dx, K8's gather on g with dx frame 2o taking tap dt = 1 of g frame o
// and dx frame 2o+1 tap dt = 2 of g frame o, then dt = 0 of g frame o+1:
//   * K8's threads, g ring (GSTAGE_T2 frames, a pair per copy: g is 1/9 of
//     the bytes) and order (g frames ascending, then rows, then columns), so
//     dx equals dw_conv_dx_s2 on g put at the even frames of a zero tensor
//     bit for bit. The split (plan_t2_dx) is K8's with whole-pixel groups up
//     to T2_WHOLE_PG pairs.
//   * Its stores are 8/9 of its bytes. Where the group is the whole pixel
//     and dx's rows are 16-byte aligned (the tile mode), each thread writes
//     its sums of a dx frame into a tile in shared memory laid out as dx is
//     (2R rows of the block's 2WB columns x C, each row from the byte that
//     the run's address has mod 16), and after a barrier the tile goes out
//     as runs: the 16-byte aligned middle of each row by one TMA bulk copy
//     (thread 0), the bytes before and after it element by element (the
//     rest of those chunks is a neighbour's). Two tiles: frame 2o's goes out
//     while 2o+1 is summed. Otherwise (groups of a wider pixel) each thread
//     stores its pairs straight to dx. (16-byte stores of the runs by the
//     block's threads took 34 % longer on an H100 at the path's entries;
//     PERF.md records them.)
//   * A g step has two barriers: after dx frame 2o's tile (its copies of g
//     frame o+1 waited first, so the barrier also shows everyone's and frees
//     the slot the next copy takes) and after dx frame 2o+1's.
constexpr int T2F_AHEAD = 1;  // steps of x frames in flight in dw_conv_t2
constexpr int T2F_SLOTS = 2 * (T2F_AHEAD + 1);  // ... and its ring's frames
constexpr int GSTAGE_T2 = 4;  // g frames in dw_conv_dx_t2's ring

// The shared-memory address of p, and the mbarrier and bulk-copy operations
// of the forward's bulk mode (one mbarrier a ring slot, one arrival a use)
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
// the slot's one arrival, expecting `bytes` of bulk copies (none: complete)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned bytes) {
  if (bytes)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}
// waits until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from shared src to global dst, both 16-byte
// aligned, in the thread's current bulk group; its commit, and the waits
// until the thread's groups have read their shared memory, or completed
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The whole-pixel staging of one x frame f (H, W, C) by bulk copies, called
// by warp 0: staged row rr (input row hs + rr) inside the frame is the span
// of 16-byte chunks of x that holds the pixels [p0, p0 + np) inside [0, W),
// one copy, placed as t2_stage_whole places its chunks (row rr at slot + rr
// * rowb, pixel p0's first byte at d = its address mod 16); rows outside the
// frame are not copied (their reads are masked). The span ends inside the
// row (W * C * sizeof(T) is a multiple of 16), so nothing past x is read.
// Lane 0 makes the slot's one arrival, expecting every row's bytes.
template <typename T>
__device__ __forceinline__ void t2_bulk_whole(unsigned char* slot, const T* f,
                                              int hs, int nrows, int H, int W,
                                              int C, int p0, int np, int rowb,
                                              uint64_t* bar) {
  const long long pb = C * (long long)sizeof(T);
  const long long base = (p0 * pb) & ~15LL;             // pixel p0's chunk
  const long long s = (max(p0, 0) * pb) & ~15LL;        // the span's first
  const long long e = (min(p0 + np, W) * pb + 15) & ~15LL;  // ... and end
  const unsigned bytes = (unsigned)(e - s);
  const int lo = max(hs, 0) - hs, hi = min(hs + nrows, H) - hs;
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar, bytes * max(hi - lo, 0));
  __syncwarp();
  for (int rr = lo + (int)(threadIdx.x & 31); rr < hi; rr += 32)
    bulk_g2s(slot + rr * rowb + (s - base),
             reinterpret_cast<const char*>(f + (size_t)(hs + rr) * W * C) + s,
             bytes, bar);
}

// One staged x frame's taps at the thread's column and pair: staged row rr
// meets output row r through dy = rr - 2r; the pairs at a[dx] of each row
// are the taps dx = 0, 1, 2 (zero outside the frame). Tap dt = DA goes to
// acc[0] and, where DB >= 0, dt = DB to acc[1]; each output's products dy,
// then dx ascending.
template <typename T, int R, int DA, int DB>
__device__ __forceinline__ void t2f_frame(float (&acc)[2][R][2],
                                          const float (&k0)[27],
                                          const float (&k1)[27], const T* sl,
                                          int rl, const int (&a)[3]) {
#pragma unroll
  for (int rr = 0; rr < 2 * R + 1; ++rr) {
    const T* sr = sl + rr * rl;
    const float2 v[3] = {load_pair(sr + a[0]), load_pair(sr + a[1]),
                         load_pair(sr + a[2])};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dy = rr - 2 * r;
      if (dy < 0 || dy > 2) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ta = (DA * 3 + dy) * 3 + dx;
        acc[0][r][0] = fmaf(k0[ta], v[dx].x, acc[0][r][0]);
        acc[0][r][1] = fmaf(k1[ta], v[dx].y, acc[0][r][1]);
        if constexpr (DB >= 0) {
          const int tb = (DB * 3 + dy) * 3 + dx;
          acc[1][r][0] = fmaf(k0[tb], v[dx].x, acc[1][r][0]);
          acc[1][r][1] = fmaf(k1[tb], v[dx].y, acc[1][r][1]);
        }
      }
    }
  }
}

// Thread (wl, pi) = (tid / PG, tid % PG): output column w0 + wl, channels
// c, c+1 with c = 2(p0 + pi). Frame index i of the block is x frame 2t0 - 1
// + i, in ring slot i % T2F_SLOTS; step s (output frame t0 + s) reads i =
// 2s + 1 and 2s + 2 and, after its barrier, stages step s + T2F_AHEAD's two
// frames into the slots step s - 1 read. WHOLE (the wrapper's mode): whole
// pixels by bulk copies on the slots' mbarriers; else each thread's pairs
// by cp.async, a commit group a step.
template <typename T, int R, bool WHOLE>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_t2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k,
                    T* __restrict__ y, int Tn, int H, int W, int Ho, int Wo,
                    int C, Plan pl) {
  constexpr bool BULK = WHOLE;  // mbarriers, not cp.async groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG;
  const int rowb = t2_rowb<T>(WB, PG);
  const int xslot = t2_xslot<T>(R, WB, PG);
  const T* ring = reinterpret_cast<const T*>(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem_raw + T2F_SLOTS * xslot * (int)sizeof(T));
  const int To = (Tn - 1) / 2 + 1;

  const int blk = blockIdx.x;
  const int pg = blk % pl.n_pg;
  const Tile tl = pl.tile(blk / pl.n_pg, pg, To);
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int w = tl.w0 + wl;
  const int c = 2 * (tl.p0 + pi);
  const bool live = wl < WB && w < Wo && c < C;  // owns outputs
  const bool second = c + 1 < C;

  float k0[27], k1[27];
  load_taps(k0, k1, k, c, C, live);

  // staged row rr is input row hs + rr, staged pixel q input column p0 + q
  const int hs = 2 * tl.h0 - 1, p0 = 2 * tl.w0 - 1;
  // the thread's taps dx = 0, 1, 2 in a staged row (input columns 2w-1+dx)
  int at[3], rl;
  if constexpr (WHOLE) {
    const int pb = C * (int)sizeof(T);
    const int d = ((p0 * pb) % 16 + 16) % 16;
    at[0] = (d + 2 * wl * pb) / (int)sizeof(T) + 2 * pi;
    at[1] = at[0] + C;
    at[2] = at[0] + 2 * C;
    rl = rowb / (int)sizeof(T);
  } else {
    at[0] = wl * PG2 + 2 * pi;
    at[1] = (WB + 1) * PG2 + at[0];
    at[2] = at[0] + PG2;
    rl = 2 * (WB + 1) * PG2;
  }

  const size_t frame = (size_t)H * W * C;
  const T* xb = x + (size_t)tl.b * Tn * frame;
  // the thread's outputs in the segment's first frame
  T* yb = y + (((size_t)tl.b * To + tl.t0) * Ho + tl.h0) * Wo * C +
          (size_t)w * C + c;
  const int f0 = 2 * tl.t0 - 1, nf = 2 * (tl.t1 - tl.t0) + 1;  // x frames
  // frame index i into its slot; in the bulk mode every i < nf makes its
  // slot's one arrival (none past the clip's frames), so use u of a slot
  // completes phase u
  auto stage = [&](int i) {
    if (i >= nf) return;  // uniform across the block
    const int ti = f0 + i;
    unsigned char* slot =
        smem_raw + (i % T2F_SLOTS) * xslot * (int)sizeof(T);
    const bool in = ti >= 0 && ti < Tn;
    if constexpr (BULK) {
      if (tid < 32) {
        if (in)
          t2_bulk_whole(slot, xb + (size_t)ti * frame, hs, 2 * R + 1, H, W,
                        C, p0, 2 * WB + 1, rowb, bar + i % T2F_SLOTS);
        else if (tid == 0)
          mbar_arrive(bar + i % T2F_SLOTS, 0);
      }
    } else {
      if (in)
        T2Stager(tl, wl, pi, WB, PG2, W, Wo, C, pl.pairs)
            .x_rows(reinterpret_cast<T*>(slot), xb + (size_t)ti * frame, hs,
                    2 * R + 1, H, 2 * (WB + 1) * PG2);
    }
  };
  // step s's frames (step 0: also frame index 0), one commit group
  auto load = [&](int s) {
    if (s == 0) stage(0);
    stage(2 * s + 1);
    stage(2 * s + 2);
    if constexpr (!BULK) cp_commit();
  };
  // this thread sees frame index i landed (cp.async: its step's group)
  auto wait = [&](int i) {
    if constexpr (BULK) {
      if (i < nf)
        mbar_wait(bar + i % T2F_SLOTS, (unsigned)(i / T2F_SLOTS) & 1u);
    } else {
      cp_wait<T2F_AHEAD - 1>();
    }
  };
  auto slot_at = [&](int i) { return ring + (i % T2F_SLOTS) * xslot; };

  float acc[2][R][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r][0] = acc[j][r][1] = 0.f;

  if constexpr (WHOLE) {
    // the places of pixels and rows outside the frame are never staged: the
    // ring's zero, the same places in every frame of the block (for the bulk
    // copies written by the generic proxy before any copy)
    if constexpr (BULK) {
      if (tid == 0) {
        for (int j = 0; j < T2F_SLOTS; ++j) mbar_init(bar + j);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
    }
    for (int i = tid * 16; i < T2F_SLOTS * xslot * (int)sizeof(T);
         i += blockDim.x * 16)
      *reinterpret_cast<uint4*>(smem_raw + i) = make_uint4(0, 0, 0, 0);
    if constexpr (BULK)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  for (int s = 0; s < T2F_AHEAD; ++s) load(s);
  if (f0 >= 0) {  // frame 2t0 - 1: tap dt = 0 of output t0 (uniform)
    wait(0);
    __syncthreads();
    if (live)
      t2f_frame<T, R, 0, -1>(acc, k0, k1, slot_at(0), rl, at);
  }
  const int steps = tl.t1 - tl.t0;
  for (int s = 0; s < steps; ++s) {
    // this thread's copies of step s (the bulk mode: its first frame)
    // have landed; after the barrier everyone's, and the slots of step s - 1
    // are read by no one
    wait(2 * s + 1);
    __syncthreads();
    load(s + T2F_AHEAD);
    if (live)  // frame 2(t0+s): dt = 1 of output t0 + s
      t2f_frame<T, R, 1, -1>(acc, k0, k1, slot_at(2 * s + 1), rl, at);
    // the bulk mode's second frame, waited for while the first was summed
    // (an mbarrier wait shows the copies to the thread that waits)
    wait(2 * s + 2);
    if (live && f0 + 2 * s + 2 < Tn)  // frame 2(t0+s)+1: dt = 2, then dt =
      t2f_frame<T, R, 2, 0>(acc, k0, k1, slot_at(2 * s + 2), rl,
                            at);  // 0 of output t0 + s + 1
    if (live) {
      T* yo = yb + (size_t)s * Ho * Wo * C;
      const bool pair = second && !(C & 1);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tl.h0 + r < Ho)
          store_pair(yo + (size_t)r * Wo * C, acc[0][r][0], acc[0][r][1],
                     pair, second);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[0][r][0] = acc[1][r][0];
      acc[0][r][1] = acc[1][r][1];
      acc[1][r][0] = acc[1][r][1] = 0.f;
    }
  }
  if constexpr (!BULK) cp_wait<0>();
}

// Bytes of one dx row of dw_conv_dx_t2's tile: 2WB pixels of 2PG channels
// from the byte the run's address has mod 16, one chunk of slack.
template <typename T>
__host__ __device__ __forceinline__ int t2_tileb(int WB, int PG) {
  return 16 * (2 * WB * 2 * PG * (int)sizeof(T) / 16 + 2);
}

// The tile mode's write-out of one dx frame f (H, W, C): tile row rr (dx
// row row0 + rr, rr < nrows) holds the run of dx columns [q0, q0 + nq) (all
// C channels) from byte d of t + rr * tb, d the run's address mod 16 (one
// value for the tile: W * C * sizeof(T) and the base are multiples of 16).
// The 16-byte aligned middle of each run goes by one bulk copy from the
// tile (thread 0, one bulk group a frame), the bytes before and after it (a
// run's first and last chunk, where they hold a neighbour's bytes) element
// by element by the block's threads in turn; no byte outside the runs is
// written. The caller's put made the tile visible to the bulk copies' proxy
// and thread 0 waited for the last frame's copies to have read their tile.
template <typename T>
__device__ __forceinline__ void t2_tile_bulk(T* f, const unsigned char* t,
                                             int tb, int d, int row0,
                                             int nrows, int W, int C, int q0,
                                             int nq) {
  constexpr int E = (int)sizeof(T);
  const int n = nq * C * E;
  const int lo = min((d + 15) / 16 * 16, d + n);  // the middle [lo, hi) of
  const int hi = max((d + n) / 16 * 16, lo);      // each tile row, in bytes
  if (threadIdx.x == 0) {
    if (hi > lo)
      for (int rr = 0; rr < nrows; ++rr)
        bulk_s2g(reinterpret_cast<char*>(f + ((size_t)(row0 + rr) * W + q0) *
                                                 C) - d + lo,
                 t + rr * tb + lo, (unsigned)(hi - lo));
    bulk_commit();
  }
  // (row, element) of the heads [d, lo) and tails [hi, d + n)
  const int nh = (lo - d) / E, ne = nh + (d + n - hi) / E;
  for (int u = threadIdx.x; u < nrows * ne; u += blockDim.x) {
    const int rr = u / ne, q = u - rr * ne;
    const int e = q < nh ? d + q * E : hi + (q - nh) * E;
    *reinterpret_cast<T*>(reinterpret_cast<char*>(
        f + ((size_t)(row0 + rr) * W + q0) * C) - d + e) =
        *reinterpret_cast<const T*>(t + rr * tb + e);
  }
}

// dx frame 2o + E of g frame o (slot s0) and, for E = 1 and next, g frame
// o + 1 (slot s1), at the thread's g column (and column + 1, at + PG2) and
// pair: acc[r][py][px][ch] is dx row 2(h0+r)+py, column 2j+px. K8's order:
// g frames ascending, then g rows, then the columns; one fmaf a term.
template <typename T, int R, int E>
__device__ __forceinline__ void t2dx_frame(float (&acc)[R][2][2][2],
                                           const float (&k0)[27],
                                           const float (&k1)[27],
                                           const T* s0, const T* s1,
                                           bool next, int rowlen, int PG2) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int px = 0; px < 2; ++px)
        acc[r][py][px][0] = acc[r][py][px][1] = 0.f;
  // q[px][ch] of one dx row += the terms of g row values a (column j) and
  // b (column j+1) through taps (dt, dy): the even column 2j through dx =
  // 1; the odd column 2j+1 through dx = 2 on a, then dx = 0 on b
  auto add = [&](float (&q)[2][2], int dt, int dy, float2 a, float2 b) {
    const int t0 = (dt * 3 + dy) * 3;
    q[0][0] = fmaf(k0[t0 + 1], a.x, q[0][0]);
    q[0][1] = fmaf(k1[t0 + 1], a.y, q[0][1]);
    q[1][0] = fmaf(k0[t0 + 2], a.x, q[1][0]);
    q[1][1] = fmaf(k1[t0 + 2], a.y, q[1][1]);
    q[1][0] = fmaf(k0[t0], b.x, q[1][0]);
    q[1][1] = fmaf(k1[t0], b.y, q[1][1]);
  };
#pragma unroll
  for (int f = 0; f < 1 + E; ++f) {  // g frames o, o + 1 ascending
    if (f == 1 && !next) break;      // outside the clip: nothing
    const int dt = E == 0 ? 1 : 2 - 2 * f;
    const T* sl = f ? s1 : s0;
#pragma unroll
    for (int rr = 0; rr <= R; ++rr) {  // g row h0 + rr, as K8
      const float2 a = load_pair(sl + rr * rowlen);
      const float2 b = load_pair(sl + rr * rowlen + PG2);
      if (rr > 0) add(acc[rr - 1][1], dt, 0, a, b);
      if (rr < R) {
        add(acc[rr][0], dt, 1, a, b);
        add(acc[rr][1], dt, 2, a, b);
      }
    }
  }
}

// Thread (wl, pi) as in K8: g column j = w0 + wl, channels c, c+1. Slot i
// % GSTAGE_T2 of the ring holds g frame t0 + i (rows h0 .. h0+R, columns
// w0 .. w0+WB); step i (g frame o = t0 + i) writes dx frames 2o and 2o+1
// (those below Tn). TILE (the wrapper's mode): the tile mode, its runs out
// by bulk copies; else each thread's pairs straight to dx.
template <typename T, int R, bool TILE>
__global__ void __launch_bounds__(NT_MAX, 2)
plain_t2_dx_kernel(const T* __restrict__ g, const T* __restrict__ k,
                   T* __restrict__ dx, int Tn, int H, int W, int Ho, int Wo,
                   int C, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = (WB + 1) * PG2;
  const int stage = dxstage_elems<T>(R, WB, PG);
  const int tb = t2_tileb<T>(WB, PG);
  // the two dx tiles after the g ring
  unsigned char* tiles = smem_raw + GSTAGE_T2 * stage * (int)sizeof(T);
  const int Tg = (Tn - 1) / 2 + 1;  // g frames

  const int blk = blockIdx.x;
  const int pg = blk % pl.n_pg;
  const Tile tl = pl.tile(blk / pl.n_pg, pg, Tg);
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int j = tl.w0 + wl;
  const int c = 2 * (tl.p0 + pi);
  const bool live = wl < WB && j < Wo && c < C;
  const bool second = c + 1 < C;
  const int at = wl * PG2 + 2 * pi;  // g column j; j + 1 is at + PG2

  float k0[27], k1[27];
  load_taps(k0, k1, k, c, C, live);

  const size_t gframe = (size_t)Ho * Wo * C, xframe = (size_t)H * W * C;
  const T* gb = g + (size_t)tl.b * Tg * gframe;
  T* db = dx + (size_t)tl.b * Tn * xframe;
  const int nf = tl.t1 - tl.t0 + 1;  // g frames t0 .. t1
  auto load = [&](int i) {
    const int tg = tl.t0 + i;
    if (i < nf && tg < Tg)  // uniform across the block
      GStager(tl, wl, pi, WB, PG2, Wo, C, pl.pairs)
          .rows(ring + (i % GSTAGE_T2) * stage, gb + (size_t)tg * gframe,
                tl.h0, R + 1, Ho, Wo, rowlen);
    cp_commit();
  };
  // TILE: the run's byte mod 16, and the dx rows and columns of the block
  const int d = 2 * tl.w0 * C * (int)sizeof(T) % 16;
  const int nrows = min(2 * R, H - 2 * tl.h0), nq = min(2 * WB, W - 2 * tl.w0);
  // dx frame ox's sums (dframe: its first element): TILE into tile ox & 1
  // (then made visible to the bulk copies' proxy, and the copies of frame
  // ox - 1, which read the other tile, waited for), else each thread's
  // pairs straight to dx
  auto put = [&](int ox, T* dframe, const float (&acc)[R][2][2][2]) {
    if (live) {
      T* dq;
      if constexpr (TILE)
        dq = reinterpret_cast<T*>(tiles + (ox & 1) * 2 * R * tb + d) +
             2 * wl * C + c;
      else
        dq = dframe + ((size_t)2 * tl.h0 * W + 2 * j) * C + c;
      const bool pair = second && !(C & 1);
      // the row stride (bytes in the tile, elements in dx), opaque to the
      // compiler: it would hoist the 2R row addresses out of the frame loop
      // and spill them
      int rs = TILE ? tb : W * C;
      asm volatile("" : "+r"(rs));
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int py = 0; py < 2; ++py) {
          if (2 * (tl.h0 + r) + py >= H) continue;
          T* dr = TILE ? reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(
                             dq) + (2 * r + py) * rs)
                       : dq + (size_t)(2 * r + py) * rs;
#pragma unroll
          for (int px = 0; px < 2; ++px)
            if (2 * j + px < W)
              store_pair(dr + px * C, acc[r][py][px][0], acc[r][py][px][1],
                         TILE || pair, TILE || second);
        }
    }
    if constexpr (TILE) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (tid == 0) bulk_wait_read();
    }
  };
  // TILE: dx frame ox's tile out, after the barrier that follows its put
  auto out = [&](int ox, T* dframe) {
    if constexpr (TILE)
      t2_tile_bulk(dframe, tiles + (ox & 1) * 2 * R * tb, tb, d, 2 * tl.h0,
                   nrows, W, C, 2 * tl.w0, nq);
  };

  zero_ring(smem_raw, GSTAGE_T2 * stage * (int)sizeof(T));
  for (int i = 0; i < GSTAGE_T2 - 1; ++i) load(i);
  cp_wait<GSTAGE_T2 - 2>();  // g frame t0 has landed
  __syncthreads();
  T* df = db + (size_t)2 * tl.t0 * xframe;  // dx frame 2o
  for (int o = tl.t0; o < tl.t1; ++o, df += 2 * xframe) {
    const int i = o - tl.t0;
    const T* s0 = ring + (i % GSTAGE_T2) * stage + at;
    const T* s1 = ring + ((i + 1) % GSTAGE_T2) * stage + at;
    float acc[R][2][2][2];
    t2dx_frame<T, R, 0>(acc, k0, k1, s0, s1, false, rowlen, PG2);
    put(2 * o, df, acc);
    cp_wait<GSTAGE_T2 - 3>();  // this thread's copies of g frame o+1 landed
    // everyone's, and dx frame 2o's tile; slot i-1 is read by no one
    __syncthreads();
    load(i + GSTAGE_T2 - 1);  // into slot i-1
    out(2 * o, df);
    if (2 * o + 1 < Tn) {  // uniform across the block
      t2dx_frame<T, R, 1>(acc, k0, k1, s0, s1, o + 1 < Tg, rowlen, PG2);
      put(2 * o + 1, df + xframe, acc);
      if constexpr (TILE) {
        __syncthreads();  // dx frame 2o+1's tile
        out(2 * o + 1, df + xframe);
      }
    }
  }
  cp_wait<0>();
  if constexpr (TILE) {
    if (tid == 0) bulk_wait();
  }
}

// ---- the mm weight gradient (K10 mm) -----------------------------------------
// Shared memory of mm_s2_wgrad_kernel: K4 mm's layout (mm_s2_fwd_layout: two
// activated slots, the x ring, W1's columns, bn1's vectors, the table), then
// a ring of XSTAGE_MM g frames (R rows of WB columns, gstage_elems); or the
// column sums if larger.
template <typename T>
__host__ __device__ __forceinline__ int mm_s2_wgrad_smem(int R, int WB,
                                                         int PG, int Cin,
                                                         int W) {
  const int ring = mm_s2_fwd_layout<T>(R, WB, PG, Cin, W).total +
                   XSTAGE_MM * gstage_elems<T>(R, WB, PG) * (int)sizeof(T);
  const int red = (int)sizeof(float) * 27 * WB * 2 * PG;
  return ring > red ? ring : red;
}

// dk of a = relu((x @ W1)*sc + bi), rounded to T and zero-padded after the
// activation: K4 mm's front end (mm_s2_fwd_kernel above) on K10 plain's back
// end (s2_wgrad_body). Per block, once: W1's column group and bn1's
// vectors. Per item (K10 plain's persistent walk of (sample, frame segment,
// row strip, column tile) items): x frame f0 + i's rectangle (input rows
// 2h0-1 .. 2h0+2R-1, columns 2w0-1 .. 2w0+2WB-1, all C_in; MmRect) staged
// by cp.async into ring slot i % XSTAGE_MM, in one commit group with g frame
// f0 + i (rows h0 .. h0+R-1 at the thread's own column, as S2Stager stages
// them for K10 plain). Step i (i = 0 .. nf, between two barriers, K6 mm's
// schedule): stage frame i + 2; conv1's product of x frame f0 + i into
// activated slot i % 2 (mm_activate, at K4 mm's places: even input column e
// at e/2, odd at WB+1+(e-1)/2, as S2Stager stages x for K10 plain; its relu
// branch is every mm kernel's); the register ring takes g frame f0 + i; the
// stencil reads activated frame f0 + i - 1 (slot (i - 1) % 2) with the ring
// under wgrad_slots, so ring slot j holds g frame f0 + i - 2 + j as in
// s2_wgrad_body. Rows and columns outside the frame are never written and
// stay the zero each item clears the activated slots to. The sums, their
// column sum and the partial row are s2_wgrad_body's, so dk equals K10 plain
// launched with this plan on the activation, bit for bit. At most NT_DX
// threads: the product's registers beside the 27 x 2 sums and the ring of g
// need more than 128.
template <typename T, int R>
__global__ void __launch_bounds__(NT_DX, 2)
mm_s2_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ g, const float* __restrict__ sc,
                   const float* __restrict__ bi, float* __restrict__ part,
                   int Tn, int H, int W, int Ho, int Wo, int Cin, int C,
                   Plan pl, int n_items, int ipb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WB = pl.WB, PG = pl.PG;
  const int PG2 = 2 * PG, rowlen = 2 * (WB + 1) * PG2, growlen = WB * PG2;
  const MmLayout L = mm_s2_fwd_layout<T>(R, WB, PG, Cin, W);
  T* act_s = reinterpret_cast<T*>(smem_raw);  // [2][2R+1][2(WB+1)][2PG]
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs_off);
  T* wt = reinterpret_cast<T*>(smem_raw + L.wt_off);
  float* scs = reinterpret_cast<float*>(smem_raw + L.vec_off);
  float* bis = scs + (L.ng + 3) / 4 * 4;
  float* kbs = bis + (L.ng + 3) / 4 * 4;
  int* tab = reinterpret_cast<int*>(smem_raw + L.tab_off);
  T* gring = reinterpret_cast<T*>(smem_raw + L.total);  // after the table
  const int aslot = L.aslot / (int)sizeof(T), xslot = L.xslot / (int)sizeof(T);
  const int gslot = gstage_elems<T>(R, WB, PG);  // g rows [R][WB][2PG]
  const int ld = L.ld;

  const int pg = blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid / PG, pi = tid % PG;
  const int c0 = 2 * pg * PG;
  const bool in = wl < WB;
  // the thread's even column wl, odd column wl and even column wl + 1
  const int atE = wl * PG2 + 2 * pi, atO = (WB + 1) * PG2 + atE;

  zero_ring(smem_raw, L.wt_off);  // both slots and the x ring
  mm_stage_vecs(scs, bis, kbs, sc, bi, C, c0, PG2, L.ng,
                mm_band((ld - 8) / 16, Cin));
  mm_stage_w1<T>(wt, w1, Cin, C, c0, PG2, L.ng, ld);

  float acc[27][2];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i][0] = acc[i][1] = 0.f;

  const size_t xframe = (size_t)H * W * Cin, gframe = (size_t)Ho * Wo * C;
  const int row = blockIdx.x;
  const int it1 = min((row + 1) * ipb, n_items);
  for (int item = row * ipb; item < it1; ++item) {
    const Tile tl = pl.tile(item, pg, Tn);
    const int r0 = 2 * tl.h0 - 1, e0 = 2 * tl.w0 - 1;
    const MmRect mr(r0, 2 * R + 1, e0, 2 * WB + 1, H, W, Cin, ld,
                    16 / (int)sizeof(T));
    const S2Stager sg(tl, wl, pi, WB, PG2, W, Wo, C, pl.pairs);
    // x rows of the tile from staged row 0 (input row 2h0 - 1) and column
    // cs0, of sample b
    const T* xb = x + (size_t)tl.b * Tn * xframe +
                  ((long long)r0 * W + mr.cs0) * Cin;
    const T* gb = g + (size_t)tl.b * Tn * gframe;
    const int f0 = tl.t0 - 1, nf = tl.t1 - tl.t0 + 2;
    // output rows of the strip, and whether the thread's column exists
    const int nr = min(R, Ho - tl.h0);
    const bool live = in && tl.w0 + wl < Wo;
    // x frame f0 + i and g frame f0 + i (where they exist) into ring slot
    // i % XSTAGE_MM, one commit group
    auto stage = [&](int i) {
      if (i < nf) {  // uniform across the block
        const int ti = f0 + i;
        if (ti >= 0 && ti < Tn)
          mr.stage(xs + (i % XSTAGE_MM) * xslot, xb + (size_t)ti * xframe, W,
                   Cin, ld);
        if (ti >= tl.t0 && ti < tl.t1)
          sg.g_rows(gring + (i % XSTAGE_MM) * gslot, gb + (size_t)ti * gframe,
                    tl.h0, R, Ho, Wo, growlen);
      }
      cp_commit();
    };

    // the slots' padding is this tile's (the previous item's readers are
    // done: the barrier closing its walk); each staged position's place
    zero_ring(smem_raw, L.xs_off);
    mr.table(tab, L.rows, [&](int rr, int col) {
      const int e = col - e0;
      return rr * rowlen + ((e & 1) * (WB + 1) + (e >> 1)) * PG2;
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
                       wt, L, PG, mr.M, Cin, scs, bis, kbs, tab);
      // g frame f0 + i (the thread's own copies) into the register ring
      const bool gin = live && i < nf && tx >= tl.t0 && tx < tl.t1;
      const T* gs = gring + (i % XSTAGE_MM) * gslot + atE;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gr[0][r][0] = gr[1][r][0];
        gr[0][r][1] = gr[1][r][1];
        gr[1][r][0] = gr[2][r][0];
        gr[1][r][1] = gr[2][r][1];
        const float2 v =
            gin ? load_pair(gs + r * growlen) : make_float2(0.f, 0.f);
        gr[2][r][0] = v.x;
        gr[2][r][1] = v.y;
      }
      if (i == 0) continue;
      const int ti = tx - 1;  // the activated frame the stencil reads
      if (ti >= 0 && ti < Tn && live) {  // frames outside the clip add
        auto fma = [&](int j, int r, int dy, int dx, float2 v) {  // nothing
          const int tap = ((2 - j) * 3 + dy) * 3 + dx;
          acc[tap][0] = fmaf(v.x, gr[j][r][0], acc[tap][0]);
          acc[tap][1] = fmaf(v.y, gr[j][r][1], acc[tap][1]);
        };
        const T* slot = act_s + ((i - 1) & 1) * aslot;
        const unsigned slots = wgrad_slots(i - 1, nf);
        if (slots == 7u && nr == R)
          s2_frame<T, R>(slot, rowlen, atE, atO, PG2, fma);
        else
          s2_frame_masked<T, R, true>(slot, rowlen, atE, atO, PG2, fma,
                                      slots, nr);
      }
    }
    cp_wait<0>();
    __syncthreads();  // the next item clears the slots and the table
  }
  wgrad_partials(acc, part, smem_raw, WB, PG, C);
}

// ---- launchers -----------------------------------------------------------------

// Dynamic shared memory: the forward's ring of x frames (the act mode's
// NSTAGE_ACT deep); the dx's ring of g
// frames; the weight gradient's ring of x and g frames, or its column sums
// if larger.
template <typename T>
size_t fwd_smem(int R, int WB, int PG, bool act = false) {
  return sizeof(T) * (act ? NSTAGE_ACT : NSTAGE) *
         xstage_elems<T>(R, WB, PG);
}
template <typename T>
size_t dx_smem(int R, int WB, int PG) {
  return sizeof(T) * GSTAGE * dxstage_elems<T>(R, WB, PG);
}
// the act dx: the g ring, then the x ring; reused for the column sums
template <typename T>
size_t act_dx_smem(int R, int WB, int PG) {
  const size_t ring = dx_smem<T>(R, WB, PG) +
                      sizeof(T) * XSTAGE * quadstage_elems<T>(R, WB, PG);
  const size_t red = sizeof(float) * 2 * WB * 2 * PG;
  return ring > red ? ring : red;
}
// (the act mode's ring holds NSTAGE_ACT frames)
template <typename T>
size_t wgrad_smem(int R, int WB, int PG, bool act) {
  const size_t ring = sizeof(T) * (act ? NSTAGE_ACT : NSTAGE) *
                      (xstage_elems<T>(R, WB, PG) + gstage_elems<T>(R, WB, PG));
  const size_t red = sizeof(float) * 27 * WB * 2 * PG;
  return ring > red ? ring : red;
}
// the stride-(2,2,2) forward: T2F_SLOTS x frames (either mode's layout)
// and their mbarriers; the dx: GSTAGE_T2 g frames, two dx tiles and the
// group's taps in f32
template <typename T>
size_t t2_fwd_smem(int R, int WB, int PG) {
  return sizeof(T) * T2F_SLOTS * t2_xslot<T>(R, WB, PG) +
         sizeof(uint64_t) * T2F_SLOTS;
}
template <typename T>
size_t t2_dx_smem(int R, int WB, int PG) {
  return sizeof(T) * GSTAGE_T2 * dxstage_elems<T>(R, WB, PG) +
         2 * 2 * R * t2_tileb<T>(WB, PG);
}
// the stride-(2,2,2) weight gradient: T2_XSLOTS x frames and T2_GSLOTS g
// frames, or its column sums if larger
template <typename T>
size_t t2_wgrad_smem(int R, int WB, int PG) {
  const size_t ring = sizeof(T) * (T2_XSLOTS * t2_xslot<T>(R, WB, PG) +
                                   T2_GSLOTS * gstage_elems<T>(R, WB, PG));
  const size_t red = sizeof(float) * 27 * WB * 2 * PG;
  return ring > red ? ring : red;
}

// The kernel instantiations for R rows (RMIN..RMAX), or null.
template <typename T>
decltype(&plain_s2_fwd_kernel<T, RMAX>) fwd_kernel_of(int R) {
  switch (R) {
    case 2: return plain_s2_fwd_kernel<T, 2>;
    case 3: return plain_s2_fwd_kernel<T, 3>;
    case 4: return plain_s2_fwd_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&act_s2_fwd_kernel<T, RMAX>) act_fwd_kernel_of(int R) {
  switch (R) {
    case 2: return act_s2_fwd_kernel<T, 2>;
    case 3: return act_s2_fwd_kernel<T, 3>;
    case 4: return act_s2_fwd_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&plain_s2_dx_kernel<T, RMAX>) dx_kernel_of(int R) {
  switch (R) {
    case 2: return plain_s2_dx_kernel<T, 2>;
    case 3: return plain_s2_dx_kernel<T, 3>;
    case 4: return plain_s2_dx_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&act_s2_dx_kernel<T, RMAX>) act_dx_kernel_of(int R) {
  switch (R) {
    case 2: return act_s2_dx_kernel<T, 2>;
    case 3: return act_s2_dx_kernel<T, 3>;
    case 4: return act_s2_dx_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&plain_s2_wgrad_kernel<T, RMAX>) wgrad_kernel_of(int R) {
  switch (R) {
    case 2: return plain_s2_wgrad_kernel<T, 2>;
    case 3: return plain_s2_wgrad_kernel<T, 3>;
    case 4: return plain_s2_wgrad_kernel<T, 4>;
  }
  return nullptr;
}
// ... at stride (2,2,2)
template <typename T>
decltype(&plain_t2_fwd_kernel<T, RMAX, true>) t2_fwd_kernel_of(int R,
                                                                bool whole) {
  switch (R) {
    case 2: return whole ? plain_t2_fwd_kernel<T, 2, true>
                         : plain_t2_fwd_kernel<T, 2, false>;
    case 3: return whole ? plain_t2_fwd_kernel<T, 3, true>
                         : plain_t2_fwd_kernel<T, 3, false>;
    case 4: return whole ? plain_t2_fwd_kernel<T, 4, true>
                         : plain_t2_fwd_kernel<T, 4, false>;
  }
  return nullptr;
}
template <typename T>
decltype(&plain_t2_dx_kernel<T, RMAX, true>) t2_dx_kernel_of(int R,
                                                              bool tile) {
  switch (R) {
    case 2: return tile ? plain_t2_dx_kernel<T, 2, true>
                        : plain_t2_dx_kernel<T, 2, false>;
    case 3: return tile ? plain_t2_dx_kernel<T, 3, true>
                        : plain_t2_dx_kernel<T, 3, false>;
    case 4: return tile ? plain_t2_dx_kernel<T, 4, true>
                        : plain_t2_dx_kernel<T, 4, false>;
  }
  return nullptr;
}
template <typename T>
decltype(&plain_t2_wgrad_kernel<T, RMAX>) t2_wgrad_kernel_of(int R) {
  switch (R) {
    case 2: return plain_t2_wgrad_kernel<T, 2>;
    case 3: return plain_t2_wgrad_kernel<T, 3>;
    case 4: return plain_t2_wgrad_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&act_s2_wgrad_kernel<T, RMAX>) act_wgrad_kernel_of(int R) {
  switch (R) {
    case 2: return act_s2_wgrad_kernel<T, 2>;
    case 3: return act_s2_wgrad_kernel<T, 3>;
    case 4: return act_s2_wgrad_kernel<T, 4>;
  }
  return nullptr;
}

template <typename T>
decltype(&mm_s2_fwd_kernel<T, RMAX>) mm_fwd_kernel_of(int R) {
  switch (R) {
    case 2: return mm_s2_fwd_kernel<T, 2>;
    case 3: return mm_s2_fwd_kernel<T, 3>;
    case 4: return mm_s2_fwd_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&mm_s2_dx_kernel<T, RMAX>) mm_dx_kernel_of(int R) {
  switch (R) {
    case 2: return mm_s2_dx_kernel<T, 2>;
    case 3: return mm_s2_dx_kernel<T, 3>;
    case 4: return mm_s2_dx_kernel<T, 4>;
  }
  return nullptr;
}
template <typename T>
decltype(&mm_s2_wgrad_kernel<T, RMAX>) mm_wgrad_kernel_of(int R) {
  switch (R) {
    case 2: return mm_s2_wgrad_kernel<T, 2>;
    case 3: return mm_s2_wgrad_kernel<T, 3>;
    case 4: return mm_s2_wgrad_kernel<T, 4>;
  }
  return nullptr;
}

// The forward (dx: false) over y, or the dx (true) over g, of x (dx: dx)
// (B, T, H, W, C): one block per tile.
template <typename T, bool DX>
int launch_tiles(const void* in, const void* k, void* out, int B, int Tn,
                 int H, int W, int C, int R, int WB, int PG, int TT,
                 cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over the output's (the forward) or g's (the dx) rows, columns
  if (!make_plan<T>(p, (uintptr_t)in, B, Tn, Ho, Wo, C, R, WB, PG, TT))
    return (int)cudaErrorInvalidValue;
  const auto kern = DX ? dx_kernel_of<T>(R) : fwd_kernel_of<T>(R);
  const size_t smem = DX ? dx_smem<T>(R, WB, PG) : fwd_smem<T>(R, WB, PG);
  if (int e = set_smem(kern, smem)) return e;
  const long long blocks =
      (long long)B * p.n_tseg * p.n_strip * p.n_wt * p.n_pg;
  kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
      static_cast<const T*>(in), static_cast<const T*>(k), static_cast<T*>(out),
      Tn, H, W, Ho, Wo, C, p);
  return (int)cudaGetLastError();
}

// Whether a t2 kernel's whole-pixel mode may copy the rows of tensor p (x
// of the forward and weight gradient, dx of the dx) whole: the channel
// group is the pixel and the rows are 16-byte aligned. The wrapper chooses
// the mode (ops/dw_conv.py: t2_whole); a launcher refuses a whole-pixel
// mode where this does not hold.
template <typename T>
bool t2_rows_whole(const void* p, const Plan& pl, int W, int C, int PG) {
  return pl.n_pg == 1 && 2 * PG == C && (uintptr_t)p % 16 == 0 &&
         (long long)W * C * sizeof(T) % 16 == 0;
}

// The forward at stride (2,2,2) over y (B, To, Ho, Wo, C) of x (B, T, H, W,
// C): one block per tile; whole pixels by bulk copies where whole (the
// group is the pixel and x's rows are 16-byte aligned), else pairs.
template <typename T>
int launch_t2_fwd(const void* x, const void* k, void* y, int B, int Tn,
                  int H, int W, int C, int R, int WB, int PG, int TT,
                  int whole, cudaStream_t st) {
  if (H < 1 || W < 1 || Tn < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1, To = (Tn - 1) / 2 + 1;
  Plan p;  // over y's frames, rows and columns
  if (!make_plan<T>(p, (uintptr_t)x, B, To, Ho, Wo, C, R, WB, PG, TT))
    return (int)cudaErrorInvalidValue;
  const size_t smem = t2_fwd_smem<T>(R, WB, PG);
  if (smem > SMEM_MAX || (whole && !t2_rows_whole<T>(x, p, W, C, PG)))
    return (int)cudaErrorInvalidValue;
  const auto kern = t2_fwd_kernel_of<T>(R, whole);
  if (int e = set_smem(kern, smem)) return e;
  const long long blocks =
      (long long)B * p.n_tseg * p.n_strip * p.n_wt * p.n_pg;
  kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(y),
      Tn, H, W, Ho, Wo, C, p);
  return (int)cudaGetLastError();
}

// The dx at stride (2,2,2) over g (B, To, Ho, Wo, C) into dx (B, T, H, W,
// C): one block per tile; the tile mode where whole (the group is the
// pixel and dx's rows are 16-byte aligned), else each thread's pairs
// straight to dx.
template <typename T>
int launch_t2_dx(const void* g, const void* k, void* dx, int B, int Tn,
                 int H, int W, int C, int R, int WB, int PG, int TT,
                 int whole, cudaStream_t st) {
  if (H < 1 || W < 1 || Tn < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1, To = (Tn - 1) / 2 + 1;
  Plan p;  // over g's frames, rows and columns
  if (!make_plan<T>(p, (uintptr_t)g, B, To, Ho, Wo, C, R, WB, PG, TT))
    return (int)cudaErrorInvalidValue;
  const size_t smem = t2_dx_smem<T>(R, WB, PG);
  if (smem > SMEM_MAX || (whole && !t2_rows_whole<T>(dx, p, W, C, PG)))
    return (int)cudaErrorInvalidValue;
  const auto kern = t2_dx_kernel_of<T>(R, whole);
  if (int e = set_smem(kern, smem)) return e;
  const long long blocks =
      (long long)B * p.n_tseg * p.n_strip * p.n_wt * p.n_pg;
  kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(k), static_cast<T*>(dx),
      Tn, H, W, Ho, Wo, C, p);
  return (int)cudaGetLastError();
}

// The act forward over y of x (B, T, H, W, C): relu(x*sc + bi) rounded to
// T, zero-padded, then the forward; one block per tile.
template <typename T>
int launch_act_fwd(const void* x, const void* k, const void* sc,
                   const void* bi, void* y, int B, int Tn, int H, int W, int C,
                   int R, int WB, int PG, int TT, cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over the output's rows and columns
  if (!make_plan<T>(p, (uintptr_t)x, B, Tn, Ho, Wo, C, R, WB, PG, TT))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem<T>(R, WB, PG, true);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kern = act_fwd_kernel_of<T>(R);
  if (int e = set_smem(kern, smem)) return e;
  const long long blocks =
      (long long)B * p.n_tseg * p.n_strip * p.n_wt * p.n_pg;
  kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(k),
      static_cast<const float*>(sc), static_cast<const float*>(bi),
      static_cast<T*>(y), Tn, H, W, Ho, Wo, C, p);
  return (int)cudaGetLastError();
}

// The act dx over g (B, T, Ho, Wo, C) of x (B, T, H, W, C): one block per
// tile, at most NT_DX threads, and one partial row per work item.
template <typename T>
int launch_act_dx(const void* g, const void* x, const void* k,
                  const void* sc, const void* bi, void* dx, void* part, int B,
                  int Tn, int H, int W, int C, int R, int WB, int PG, int TT,
                  int rows, cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over g's rows and columns; g and x are staged a pair at a time
  if (!make_plan<T>(p, (uintptr_t)g | (uintptr_t)x, B, Tn, Ho, Wo, C, R, WB,
                    PG, TT) ||
      WB * PG > NT_DX)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * p.n_tseg * p.n_strip * p.n_wt;
  if (items * p.n_pg > 0x7fffffff || rows != items)
    return (int)cudaErrorInvalidValue;
  const size_t smem = act_dx_smem<T>(R, WB, PG);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kern = act_dx_kernel_of<T>(R);
  if (int e = set_smem(kern, smem)) return e;
  kern<<<(unsigned)(items * p.n_pg), threads_of(p), smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(k),
      static_cast<const T*>(x), static_cast<const float*>(sc),
      static_cast<const float*>(bi), static_cast<T*>(dx),
      static_cast<float*>(part), Tn, H, W, Ho, Wo, C, p);
  return (int)cudaGetLastError();
}

// The mm forward over y of x (B, T, H, W, Cin) with W1 (Cin, C): one block
// per tile, at most NT_DX threads; x is staged 16 bytes at a time.
template <typename T>
int launch_mm_fwd(const void* x, const void* w1, const void* k,
                  const void* sc, const void* bi, void* y, int B, int Tn,
                  int H, int W, int Cin, int C, int R, int WB, int PG, int TT,
                  cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over the output's rows and columns
  if (!make_plan<T>(p, (uintptr_t)y, B, Tn, Ho, Wo, C, R, WB, PG, TT) ||
      WB * PG > NT_DX || Cin < 8 || Cin % 8 || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = mm_s2_fwd_layout<T>(R, WB, PG, Cin, W).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kern = mm_fwd_kernel_of<T>(R);
  if (int e = set_smem(kern, smem)) return e;
  const long long blocks =
      (long long)B * p.n_tseg * p.n_strip * p.n_wt * p.n_pg;
  kern<<<(unsigned)blocks, threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(k), static_cast<const float*>(sc),
      static_cast<const float*>(bi), static_cast<T*>(y), Tn, H, W, Ho, Wo,
      Cin, C, p);
  return (int)cudaGetLastError();
}

// The masked dx over g (B, T, Ho, Wo, C) of x (B, T, H, W, Cin) with W1
// (Cin, C): one block per tile, at most NT_DX threads, a mask slot for each
// of the TT frames of a segment.
template <typename T>
int launch_mm_dx(const void* g, const void* x, const void* w1, const void* k,
                 const void* sc, const void* bi, void* dam, int B, int Tn,
                 int H, int W, int Cin, int C, int R, int WB, int PG, int TT,
                 cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over g's rows and columns; g is staged a pair at a time
  if (!make_plan<T>(p, (uintptr_t)g, B, Tn, Ho, Wo, C, R, WB, PG, TT) ||
      WB * PG > NT_DX || Cin < 8 || Cin % 8 || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * p.n_tseg * p.n_strip * p.n_wt;
  if (items * p.n_pg > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int smem = mm_s2_dx_layout<T>(R, WB, PG, Cin, W, TT).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kern = mm_dx_kernel_of<T>(R);
  if (int e = set_smem(kern, smem)) return e;
  kern<<<(unsigned)(items * p.n_pg), threads_of(p), smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(k),
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(sc), static_cast<const float*>(bi),
      static_cast<T*>(dam), Tn, H, W, Ho, Wo, Cin, C, p);
  return (int)cudaGetLastError();
}

// The weight gradient of x (plain) or of relu(x*sc + bi) (ACT; sc and bi
// unused otherwise).
template <typename T, bool ACT>
int launch_wgrad(const void* x, const void* g, const void* sc,
                 const void* bi, void* part, int B, int Tn, int H, int W,
                 int C, int R, int WB, int PG, int TT, int ipb, int rows,
                 cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over the output's rows and columns
  if (!make_plan<T>(p, (uintptr_t)x | (uintptr_t)g, B, Tn, Ho, Wo, C, R, WB,
                    PG, TT) ||
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
        static_cast<float*>(part), Tn, H, W, Ho, Wo, C, p, (int)items, ipb);
  } else {
    const auto kern = wgrad_kernel_of<T>(R);
    if (int e = set_smem(kern, smem)) return e;
    kern<<<grid, threads_of(p), smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<float*>(part), Tn, H, W, Ho, Wo, C, p, (int)items, ipb);
  }
  return (int)cudaGetLastError();
}

// The weight gradient at stride (2,2,2): the plan over g (B, To, Ho, Wo,
// C) in one segment (TT >= To), a persistent grid of rows blocks per
// channel group; whole pixels by 16-byte copies where whole, else pairs.
template <typename T>
int launch_t2_wgrad(const void* x, const void* g, void* part, int B, int Tn,
                    int H, int W, int C, int R, int WB, int PG, int TT,
                    int ipb, int rows, int whole, cudaStream_t st) {
  if (H < 1 || W < 1 || Tn < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1, To = (Tn - 1) / 2 + 1;
  Plan p;
  if (!make_plan<T>(p, (uintptr_t)x | (uintptr_t)g, B, To, Ho, Wo, C, R, WB,
                    PG, TT) ||
      TT < To || ipb < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * p.n_strip * p.n_wt;
  if (rows < 1 || (long long)rows * ipb < items ||
      (long long)(rows - 1) * ipb >= items)
    return (int)cudaErrorInvalidValue;
  const size_t smem = t2_wgrad_smem<T>(R, WB, PG);
  if (smem > SMEM_MAX || (whole && !t2_rows_whole<T>(x, p, W, C, PG)))
    return (int)cudaErrorInvalidValue;
  const auto kern = t2_wgrad_kernel_of<T>(R);
  if (int e = set_smem(kern, smem)) return e;
  kern<<<dim3(rows, p.n_pg), threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(part), Tn, H, W, Ho, Wo, C, p, (int)items, ipb,
      whole);
  return (int)cudaGetLastError();
}

// The weight gradient of relu((x @ W1)*sc + bi) (K10 mm): x (B, T, H, W,
// C_in) with C_in % 8 == 0 and 16-byte aligned; the split is over g (B, T,
// Ho, Wo, C), a persistent grid of rows blocks per channel group, as K10
// plain's.
template <typename T>
int launch_mm_wgrad(const void* x, const void* w1, const void* g,
                    const void* sc, const void* bi, void* part, int B, int Tn,
                    int H, int W, int Cin, int C, int R, int WB, int PG,
                    int TT, int ipb, int rows, cudaStream_t st) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  Plan p;  // over the output's rows and columns; g is staged a pair at a time
  if (!make_plan<T>(p, (uintptr_t)g, B, Tn, Ho, Wo, C, R, WB, PG, TT) ||
      WB * PG > NT_DX || ipb < 1 || Cin < 8 || Cin % 8 || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * p.n_tseg * p.n_strip * p.n_wt;
  // every block has an item, and the blocks cover them all
  if (rows < 1 || (long long)rows * ipb < items ||
      (long long)(rows - 1) * ipb >= items)
    return (int)cudaErrorInvalidValue;
  const int smem = mm_s2_wgrad_smem<T>(R, WB, PG, Cin, W);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kern = mm_wgrad_kernel_of<T>(R);
  if (int e = set_smem(kern, smem)) return e;
  kern<<<dim3(rows, p.n_pg), threads_of(p), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(g), static_cast<const float*>(sc),
      static_cast<const float*>(bi), static_cast<float*>(part), Tn, H, W, Ho,
      Wo, Cin, C, p, (int)items, ipb);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int kind, int R, int WB, int PG) {
  if (R < RMIN || R > RMAX || WB < 1 || PG < 1 ||
      WB * PG > (kind == 3 ? NT_DX : NT_MAX))
    return -1;
  const int threads = (WB * PG + 31) / 32 * 32;
  switch (kind) {
    case 0:
      return blocks_per_sm(fwd_kernel_of<T>(R), fwd_smem<T>(R, WB, PG),
                           threads);
    case 1:
      return blocks_per_sm(dx_kernel_of<T>(R), dx_smem<T>(R, WB, PG),
                           threads);
    case 2:
      return blocks_per_sm(wgrad_kernel_of<T>(R),
                           wgrad_smem<T>(R, WB, PG, false), threads);
    case 3:
      return blocks_per_sm(act_dx_kernel_of<T>(R), act_dx_smem<T>(R, WB, PG),
                           threads);
    case 4:
      return blocks_per_sm(act_wgrad_kernel_of<T>(R),
                           wgrad_smem<T>(R, WB, PG, true), threads);
    case 5:
      return blocks_per_sm(act_fwd_kernel_of<T>(R),
                           fwd_smem<T>(R, WB, PG, true), threads);
    case 6:
      return blocks_per_sm(t2_fwd_kernel_of<T>(R, true),
                           t2_fwd_smem<T>(R, WB, PG), threads);
    case 7:
      return blocks_per_sm(t2_dx_kernel_of<T>(R, true),
                           t2_dx_smem<T>(R, WB, PG), threads);
    case 8:
      return blocks_per_sm(t2_wgrad_kernel_of<T>(R),
                           t2_wgrad_smem<T>(R, WB, PG), threads);
  }
  return -1;
}

// Blocks per SM the mm forward (KIND 0), the masked dx (1) or the weight
// gradient (2) reaches at a plan (R, WB, PG; TT: the dx's mask slots), C_in
// and x's width W, or -1 where it does not take them.
template <typename T, int KIND>
int mm_occupancy(int R, int WB, int PG, int TT, int Cin, int W) {
  if (R < RMIN || R > RMAX || WB < 1 || PG < 1 || TT < 1 ||
      WB * PG > NT_DX || Cin < 8 || W < 1)
    return -1;
  const int threads = (WB * PG + 31) / 32 * 32;
  if constexpr (KIND == 2) {
    const int smem = mm_s2_wgrad_smem<T>(R, WB, PG, Cin, W);
    return smem > SMEM_MAX ? -1
                           : blocks_per_sm(mm_wgrad_kernel_of<T>(R), smem,
                                           threads);
  }
  if constexpr (KIND == 1) {
    const int smem = mm_s2_dx_layout<T>(R, WB, PG, Cin, W, TT).total;
    return smem > SMEM_MAX ? -1
                           : blocks_per_sm(mm_dx_kernel_of<T>(R), smem,
                                           threads);
  }
  const int smem = mm_s2_fwd_layout<T>(R, WB, PG, Cin, W).total;
  return smem > SMEM_MAX ? -1
                         : blocks_per_sm(mm_fwd_kernel_of<T>(R), smem,
                                         threads);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after the launch: 0 means the kernel was launched. (R, WB, PG, TT) is the
// wrapper's split: R rows, WB columns and PG channel pairs per block or
// item, TT frames per segment, over the output's rows and columns (the
// forward, the weight gradient) or over g's (the dx).

// x is (B,T,H,W,C), y (B,T,(H-1)/2+1,(W-1)/2+1,C).
extern "C" int dw_conv_s2(const void* x, const void* k, void* y, int B, int T,
                          int H, int W, int C, int R, int WB, int PG, int TT,
                          int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tiles<__nv_bfloat16, false>(x, k, y, B, T, H, W, C, R, WB,
                                              PG, TT, st);
  return launch_tiles<float, false>(x, k, y, B, T, H, W, C, R, WB, PG, TT,
                                    st);
}

// The act entry's forward (K4 act): y of a = relu(x*sc + bi) rounded to x's
// dtype, zero-padded; sc and bi are f32 (C,). The split is over y's rows
// and columns, as dw_conv_s2's (ops/dw_conv.py: plan_act_s2_fwd).
extern "C" int dw_act_s2(const void* x, const void* k, const void* sc,
                         const void* bi, void* y, int B, int T, int H, int W,
                         int C, int R, int WB, int PG, int TT, int is_bf16,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_act_fwd<__nv_bfloat16>(x, k, sc, bi, y, B, T, H, W, C, R,
                                         WB, PG, TT, st);
  return launch_act_fwd<float>(x, k, sc, bi, y, B, T, H, W, C, R, WB, PG, TT,
                               st);
}

// g is (B,T,(H-1)/2+1,(W-1)/2+1,C), dx (B,T,H,W,C).
extern "C" int dw_conv_dx_s2(const void* g, const void* k, void* dx, int B,
                             int T, int H, int W, int C, int R, int WB,
                             int PG, int TT, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tiles<__nv_bfloat16, true>(g, k, dx, B, T, H, W, C, R, WB,
                                             PG, TT, st);
  return launch_tiles<float, true>(g, k, dx, B, T, H, W, C, R, WB, PG, TT,
                                   st);
}

// The act entry's dx (K5): g is (B,T,(H-1)/2+1,(W-1)/2+1,C), x and dx
// (B,T,H,W,C), sc and bi f32 (C,); dx = dam*sc with dam = da where
// x*sc + bi > 0, and part (rows, 2, C) f32 the (sum dam*x, sum dam) of each
// work item (rows = the items of a channel group; WB * PG at most 192).
extern "C" int dw_act_dx_s2(const void* g, const void* x, const void* w,
                            const void* sc, const void* bi, void* dx,
                            void* part, int B, int T, int H, int W, int C,
                            int R, int WB, int PG, int TT, int rows,
                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_act_dx<__nv_bfloat16>(g, x, w, sc, bi, dx, part, B, T, H,
                                        W, C, R, WB, PG, TT, rows, st);
  return launch_act_dx<float>(g, x, w, sc, bi, dx, part, B, T, H, W, C, R,
                              WB, PG, TT, rows, st);
}

// x is (B,T,H,W,C), g (B,T,(H-1)/2+1,(W-1)/2+1,C); part is (rows, 27, C)
// f32; block row r walks items [r*IPB, (r+1)*IPB).
extern "C" int dw_conv_wgrad_s2(const void* x, const void* g, void* part,
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

// The act entry's weight gradient (K10 act): dk of a = relu(x*sc + bi)
// rounded to x's dtype, zero-padded; sc and bi are f32 (C,). The split and
// part are dw_conv_wgrad_s2's.
extern "C" int dw_act_wgrad_s2(const void* x, const void* g, const void* sc,
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

// The mm entry's forward (K4 mm): x is conv1's input (B,T,H,W,Cin), w1
// (Cin,C) its weight, y (B,T,(H-1)/2+1,(W-1)/2+1,C) the stride-2 stencil of
// a = relu((x@W1)*sc + bi) rounded to x's dtype, zero-padded; sc and bi are
// f32 (C,). The split is over y's rows and columns (ops/dw_conv.py:
// plan_mm_s2_fwd; WB * PG at most 192).
extern "C" int dw_mm_act_s2(const void* x, const void* w1, const void* wdw,
                            const void* sc, const void* bi, void* y, int B,
                            int T, int H, int W, int Cin, int C, int R,
                            int WB, int PG, int TT, int is_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mm_fwd<__nv_bfloat16>(x, w1, wdw, sc, bi, y, B, T, H, W,
                                        Cin, C, R, WB, PG, TT, st);
  return launch_mm_fwd<float>(x, w1, wdw, sc, bi, y, B, T, H, W, Cin, C, R,
                              WB, PG, TT, st);
}

// The train composite's masked dx (K9): g is (B,T,(H-1)/2+1,(W-1)/2+1,C),
// x conv1's input (B,T,H,W,Cin) and w1 (Cin,C) its weight; dam (B,T,H,W,C)
// = da * relu'((x@W1)*sc + bi) in g's dtype, da as dw_conv_dx_s2's. The
// split is over g's rows and columns (ops/dw_conv.py: plan_mm_dx_s2; WB * PG
// at most 192, TT mask slots).
extern "C" int dw_mm_dx_mask_s2(const void* g, const void* x, const void* w1,
                                const void* w, const void* sc, const void* bi,
                                void* dam, int B, int T, int H, int W, int Cin,
                                int C, int R, int WB, int PG, int TT,
                                int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mm_dx<__nv_bfloat16>(g, x, w1, w, sc, bi, dam, B, T, H, W,
                                       Cin, C, R, WB, PG, TT, st);
  return launch_mm_dx<float>(g, x, w1, w, sc, bi, dam, B, T, H, W, Cin, C, R,
                             WB, PG, TT, st);
}

// The mm entry's weight gradient (K10 mm): dk of a = relu((x @ W1)*sc + bi)
// rounded to x's dtype, zero-padded; x (B,T,H,W,Cin) is conv1's input, w1
// (Cin,C) its weight, g (B,T,(H-1)/2+1,(W-1)/2+1,C); sc and bi are f32
// (C,). The split is over g (ops/dw_conv.py: plan_mm_wgrad_s2; WB * PG at
// most 192); part is (rows, 27, C) f32, block row r walking items
// [r*IPB, (r+1)*IPB) as dw_conv_wgrad_s2's.
extern "C" int dw_mm_wgrad_s2(const void* x, const void* w1, const void* g,
                              const void* sc, const void* bi, void* part,
                              int B, int T, int H, int W, int Cin, int C,
                              int R, int WB, int PG, int TT, int ipb,
                              int rows, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mm_wgrad<__nv_bfloat16>(x, w1, g, sc, bi, part, B, T, H, W,
                                          Cin, C, R, WB, PG, TT, ipb, rows,
                                          st);
  return launch_mm_wgrad<float>(x, w1, g, sc, bi, part, B, T, H, W, Cin, C,
                                R, WB, PG, TT, ipb, rows, st);
}

// The plain kernels at stride (2,2,2) (dw_conv_t2, dw_conv_dx_t2,
// dw_conv_wgrad_t2): x and dx are (B,T,H,W,C), y and g
// (B,(T-1)/2+1,(H-1)/2+1,(W-1)/2+1,C); the split (R, WB, PG, TT) is over
// y's or g's frames, rows and columns (ops/dw_conv.py: plan_t2_fwd,
// plan_t2_dx, plan_t2); part is (rows, 27, C) f32 as dw_conv_wgrad_s2's;
// whole: the whole-pixel mode (ops/dw_conv.py: t2_whole).
extern "C" int dw_conv_t2(const void* x, const void* k, void* y, int B, int T,
                          int H, int W, int C, int R, int WB, int PG, int TT,
                          int whole, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_t2_fwd<__nv_bfloat16>(x, k, y, B, T, H, W, C, R, WB, PG,
                                        TT, whole, st);
  return launch_t2_fwd<float>(x, k, y, B, T, H, W, C, R, WB, PG, TT, whole,
                              st);
}

extern "C" int dw_conv_dx_t2(const void* g, const void* k, void* dx, int B,
                             int T, int H, int W, int C, int R, int WB,
                             int PG, int TT, int whole, int is_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_t2_dx<__nv_bfloat16>(g, k, dx, B, T, H, W, C, R, WB, PG,
                                       TT, whole, st);
  return launch_t2_dx<float>(g, k, dx, B, T, H, W, C, R, WB, PG, TT, whole,
                             st);
}

extern "C" int dw_conv_wgrad_t2(const void* x, const void* g, void* part,
                                int B, int T, int H, int W, int C, int R,
                                int WB, int PG, int TT, int ipb, int rows,
                                int whole, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_t2_wgrad<__nv_bfloat16>(x, g, part, B, T, H, W, C, R, WB,
                                          PG, TT, ipb, rows, whole, st);
  return launch_t2_wgrad<float>(x, g, part, B, T, H, W, C, R, WB, PG, TT,
                                ipb, rows, whole, st);
}

// Blocks per SM mm_s2_fwd_kernel reaches at a plan (R, WB, PG), C_in and
// x's width W, with its threads and shared memory, or -1 where it does not
// take them.
extern "C" int dw_mm_act_s2_occupancy(int R, int WB, int PG, int Cin, int W,
                                      int is_bf16) {
  return is_bf16 ? mm_occupancy<__nv_bfloat16, 0>(R, WB, PG, 1, Cin, W)
                 : mm_occupancy<float, 0>(R, WB, PG, 1, Cin, W);
}

// ... and mm_s2_dx_kernel at a plan (R, WB, PG, TT), C_in and x's width W.
extern "C" int dw_mm_dx_mask_s2_occupancy(int R, int WB, int PG, int TT,
                                          int Cin, int W, int is_bf16) {
  return is_bf16 ? mm_occupancy<__nv_bfloat16, 1>(R, WB, PG, TT, Cin, W)
                 : mm_occupancy<float, 1>(R, WB, PG, TT, Cin, W);
}

// ... and mm_s2_wgrad_kernel at a plan (R, WB, PG), C_in and x's width W.
extern "C" int dw_mm_wgrad_s2_occupancy(int R, int WB, int PG, int Cin, int W,
                                        int is_bf16) {
  return is_bf16 ? mm_occupancy<__nv_bfloat16, 2>(R, WB, PG, 1, Cin, W)
                 : mm_occupancy<float, 2>(R, WB, PG, 1, Cin, W);
}

// Blocks per SM a kernel reaches at a plan (R, WB, PG), with its threads and
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1
// where it does not take the plan; kind 0 is the forward, 1 the dx, 2 the
// weight gradient, 3 the act dx, 4 the act weight gradient, 5 the act
// forward, 6-8 the forward, dx and weight gradient at stride (2,2,2).
extern "C" int dw_plain_s2_occupancy(int kind, int R, int WB, int PG,
                                     int is_bf16) {
  return is_bf16 ? occupancy<__nv_bfloat16>(kind, R, WB, PG)
                 : occupancy<float>(kind, R, WB, PG);
}
