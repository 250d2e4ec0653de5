// Clip frames decoded on the card: a thin nvJPEG wrapper, and the crop and
// bilinear resize of the decoded frames (sm_90a).
//
//   cfn_jpeg_*           nvJPEG (shipped with the CUDA toolkit): a decoder
//                        context (handle + state), each frame's size and
//                        components, and the decode of one clip's frames
//                        into device memory the caller allocates, one
//                        nvjpegDecodeBatched call for RGB frames
//                        (NVJPEG_OUTPUT_RGBI), nvjpegDecode frame by frame
//                        for grey ones (NVJPEG_OUTPUT_Y, one channel);
//   crop_resize_kernel:  uint8 frames (N, h, w, C) with rows `pitch` bytes
//                        apart, C = 3 (RGB) or 1 (grey), and a crop box
//                        (x1, y1, cw, ch) per frame -> uint8 (N, out, out, 3).
//
// Replaces no TPU kernel. Its counterpart is host C++ of the JAX package,
// native/cfn_data.cpp's exact path: crop_resize (:132), which
// center_crop_scale (:262) equals with the box (m, m) at ((w-m+1)/2,
// (h-m+1)/2); the decode there is libjpeg's, here nvJPEG's.
//
// The arithmetic is the C++'s, which g++ -O3 compiles for x86-64 without
// FMA: each operation rounded to f32 on its own. nvcc would contract
// (y + 0.5f) * sy - 0.5f and the four-tap sum into fmaf, so every operation
// is written with its _rn intrinsic (no --fmad=false needed). In order:
//   sy = ch / out;  fy = (y + 0.5) * sy - 0.5, clamped below at 0;
//   y0 = trunc(fy); yb = min(y0 + 1, ch - 1); wy = fy - y0 (x likewise);
//   v = v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx,
//   summed left to right; out = trunc(v + 0.5).
// ops/frame_decode.py's crop_resize_plain is the same sequence in separate
// PyTorch ops, and the two agree bit for bit on the same frames.
//
// What bounds it on this card: bytes. It reads at most the crop's rows
// (cw*C bytes each) and writes out*out*3 bytes a frame; ~20 f32 operations
// an output byte are far below the card's rate. At a clip's 64 frames of
// 480^2 -> 224^2 that is 44 MB read and 9.6 MB written, 16 us at 3.35 TB/s.
//
// Design (a thread per output pixel recomputed its row's and column's
// geometry with two divisions, divided p / out, read its box from device
// memory and issued 12 one-byte loads and 3 one-byte stores):
//   * A block covers `rows` output rows (at most 8) of one frame, the frame
//     from blockIdx.y; the split (rows, and the bytes `span` staged of each
//     source row) is ops/frame_decode.py's crop_plan.
//   * The geometry is computed once a block into shared memory: each output
//     row's two source rows and weights (wy, 1-wy) first, then, while the
//     rows load, each output column's two source byte offsets and weights
//     (wx, 1-wx), by the same intrinsics in the same order, so the values
//     are the same bits.
//   * The two source rows each output row reads (y0 and yb) are staged into
//     shared memory over the crop's columns only, with 16-byte cp.async
//     copies from the 16-byte boundary at or below the crop's first byte
//     (`vec`: the frames' base and pitch are multiples of 16, as nvJPEG's
//     buffers are; otherwise byte by byte, the same layout). An aligned
//     16-byte chunk that holds a byte of the crop never crosses a page, so
//     the bytes it reads past the crop are never a fault; they are never
//     used.
//   * Neighbouring threads compute neighbouring output pixels of a row, so
//     a warp's geometry reads are consecutive words and its tap reads fall
//     within a few words of each other (no bank conflicts: 8 adjacent
//     pixels a thread put its lanes' geometry reads 16 words apart). The pixels go into a shared-memory tile of the block's output
//     rows, which are contiguous in the output, and the block writes the
//     tile with 16-byte stores (where it is 16-byte aligned and a multiple
//     of 16 bytes long, as at out = 224 and 112; else byte by byte).
//   * The boxes reach the kernel by value in its parameters (a
//     __grid_constant__ block of up to CROP_BOXES = 1024 boxes, 16 KB), so
//     a call needs no device allocation and no host-to-device copy; the
//     wrapper splits a call past the cap into several launches.
// Grey frames (C = 1) give three equal channels, as Pillow's
// convert("RGB") does.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <vector>

#include "common.cuh"

namespace {

constexpr int CROP_THREADS = 256;
constexpr int CROP_ROWS = 8;       // output rows a block covers at most
constexpr int CROP_BOXES = 1024;   // boxes one launch carries
constexpr int SMEM_MAX = 232448;   // a block's shared memory on sm_90

struct CropBoxes {
  int v[4 * CROP_BOXES];  // (x1, y1, cw, ch) of frame i at 4i
};

// Shared memory of a block: 2 * rows staged source rows of span bytes, the
// output tile (rows * out * 3 bytes, padded to 16), each output column's
// (off0, off1) and (wx, 1-wx), each output row's two source rows and (wy,
// 1-wy).
__host__ __device__ __forceinline__ int crop_tile(int rows, int out) {
  return (rows * out * 3 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int crop_smem(int rows, int span,
                                                  int out) {
  return 2 * rows * span + crop_tile(rows, out) + 16 * out + 16 * rows;
}

// One axis's sample of output index i: the source index i0 (< size), its
// neighbour ib and the weight of ib, in the C++'s order.
__device__ __forceinline__ void crop_axis(int i, float s, int size, int& i0,
                                          int& ib, float& wgt) {
  float f = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), s),
                      0.5f);
  if (f < 0) f = 0;
  i0 = static_cast<int>(f);
  ib = i0 + 1 < size ? i0 + 1 : size - 1;
  wgt = __fsub_rn(f, static_cast<float>(i0));
}

__global__ void __launch_bounds__(CROP_THREADS)
crop_resize_kernel(const uint8_t* __restrict__ src, int h, int pitch,
                   int channels, int vec, const __grid_constant__ CropBoxes
                   boxes, uint8_t* __restrict__ dst, int out, int rows,
                   int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.y, tid = threadIdx.x;
  const int ya = blockIdx.x * rows;             // the block's first row
  const int nr = min(rows, out - ya);           // and its row count
  const int x1 = boxes.v[4 * n], y1 = boxes.v[4 * n + 1];
  const int cw = boxes.v[4 * n + 2], ch = boxes.v[4 * n + 3];
  const int lo = x1 * channels / 16 * 16;       // the first byte staged
  uint8_t* tile = smem + 2 * rows * span;
  int2* offs = reinterpret_cast<int2*>(tile + crop_tile(rows, out));
  float2* wxs = reinterpret_cast<float2*>(offs + out);
  int2* srow = reinterpret_cast<int2*>(wxs + out);
  float2* wys = reinterpret_cast<float2*>(srow + rows);
  const float fo = static_cast<float>(out);
  const float sx = __fdiv_rn(static_cast<float>(cw), fo);
  const float sy = __fdiv_rn(static_cast<float>(ch), fo);

  if (tid < nr) {  // each row's source rows y1 + y0, y1 + yb and weights
    int y0, yb;
    float wy;
    crop_axis(ya + tid, sy, ch, y0, yb, wy);
    srow[tid] = make_int2(y1 + y0, y1 + yb);
    wys[tid] = make_float2(wy, __fsub_rn(1.f, wy));
  }
  __syncthreads();

  // staged row 2r + e holds source row srow[r] (.x for e = 0, .y for 1):
  // the crop's bytes [x1*C, (x1+cw)*C) at their offsets from lo
  const uint8_t* frame = src + static_cast<size_t>(n) * h * pitch;
  if (vec) {
    const int nv = ((x1 + cw) * channels - lo + 15) / 16;
    for (int i = tid; i < 2 * nr * nv; i += CROP_THREADS) {
      const int s = i / nv, v = i - s * nv;
      const int2 sr = srow[s >> 1];
      const uint8_t* row =
          frame + static_cast<size_t>(s & 1 ? sr.y : sr.x) * pitch;
      const unsigned sa = static_cast<unsigned>(
          __cvta_generic_to_shared(smem + s * span + 16 * v));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(row + lo + 16 * v));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    const int b0 = x1 * channels - lo, nb = cw * channels;
    for (int i = tid; i < 2 * nr * nb; i += CROP_THREADS) {
      const int s = i / nb, j = i - s * nb;
      const int2 sr = srow[s >> 1];
      smem[s * span + b0 + j] = __ldg(
          frame + static_cast<size_t>(s & 1 ? sr.y : sr.x) * pitch + lo +
          b0 + j);
    }
  }
  // each column's source bytes (in a staged row) and weights, while the
  // rows load
  for (int x = tid; x < out; x += CROP_THREADS) {
    int x0, xb;
    float wx;
    crop_axis(x, sx, cw, x0, xb, wx);
    offs[x] = make_int2((x1 + x0) * channels - lo, (x1 + xb) * channels - lo);
    wxs[x] = make_float2(wx, __fsub_rn(1.f, wx));
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // pixel i of the tile: row r = i / out, column x = i % out
  const int k3 = channels == 3 ? 1 : 0;
  int r = tid / out, x = tid - r * out;
  for (int i = tid; i < nr * out; i += CROP_THREADS) {
    const uint8_t* row0 = smem + 2 * r * span;
    const uint8_t* row1 = row0 + span;
    const float2 wy = wys[r];
    const int2 c = offs[x];
    const float2 wx = wxs[x];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int k = q * k3;
      const float v00 = row0[c.x + k], v01 = row0[c.y + k];
      const float v10 = row1[c.x + k], v11 = row1[c.y + k];
      float v = __fmul_rn(__fmul_rn(v00, wy.y), wx.y);
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, wy.y), wx.x));
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy.x), wx.y));
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy.x), wx.x));
      tile[3 * i + q] = static_cast<uint8_t>(
          static_cast<int>(__fadd_rn(v, 0.5f)));
    }
    x += CROP_THREADS;
    while (x >= out) {
      x -= out;
      ++r;
    }
  }
  __syncthreads();

  // the block's rows are bytes [o, o + nb) of the output
  uint8_t* o = dst + (static_cast<size_t>(n) * out + ya) * out * 3;
  const int nb = nr * out * 3;
  if ((reinterpret_cast<uintptr_t>(o) | nb) % 16 == 0) {
    for (int i = tid; i < nb / 16; i += CROP_THREADS)
      reinterpret_cast<uint4*>(o)[i] = reinterpret_cast<const uint4*>(tile)[i];
  } else {
    for (int i = tid; i < nb; i += CROP_THREADS) o[i] = tile[i];
  }
}

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int batch = -1;  // the batch nvjpegDecodeBatchedInitialize was given
};

}  // namespace

// Crops and resizes n <= CROP_BOXES frames: boxes (4n ints, host memory)
// go into the launch's parameters. 0, or cudaErrorInvalidValue for
// arguments the kernel does not take (rows and span: ops/frame_decode.py's
// crop_plan), or the launch's error.
extern "C" int cfn_crop_resize(const void* src, int n, int h, int pitch,
                               int channels, const int* boxes, void* dst,
                               int out, int rows, int span, void* stream) {
  if (n < 1 || n > CROP_BOXES || out < 1 || h < 1 ||
      (channels != 1 && channels != 3) || rows < 1 || rows > CROP_ROWS ||
      span < 16 || span % 16)
    return cudaErrorInvalidValue;
  CropBoxes b;
  for (int i = 0; i < 4 * n; ++i) b.v[i] = boxes[i];
  for (int i = 0; i < n; ++i) {  // each box's staged bytes fit the span
    const int* q = b.v + 4 * i;
    const int lo = q[0] * channels / 16 * 16;
    if (q[0] < 0 || q[1] < 0 || q[2] < 1 || q[3] < 1 || q[1] + q[3] > h ||
        (q[0] + q[2]) * channels > pitch ||
        ((q[0] + q[2]) * channels - lo + 15) / 16 * 16 > span)
      return cudaErrorInvalidValue;
  }
  const int smem = crop_smem(rows, span, out);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (int e = cfn::set_smem(crop_resize_kernel, smem)) return e;
  const int vec = (reinterpret_cast<uintptr_t>(src) | pitch) % 16 == 0;
  const dim3 grid((out + rows - 1) / rows, n);
  crop_resize_kernel<<<grid, CROP_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), h, pitch, channels, vec, b,
      static_cast<uint8_t*>(dst), out, rows, span);
  return static_cast<int>(cudaGetLastError());
}

// A decoder context for one thread at a time: its nvJPEG handle and state,
// kept for the process's life. Returns the nvJPEG status (0: success).
extern "C" int cfn_jpeg_create(void** ctx) {
  Decoder* d = new Decoder;
  int st = nvjpegCreateSimple(&d->handle);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegJpegStateCreate(d->handle, &d->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (d->handle != nullptr) nvjpegDestroy(d->handle);
    delete d;
    return st;
  }
  *ctx = d;
  return 0;
}

// info[0..2] = width, height, components of one JPEG in host memory
extern "C" int cfn_jpeg_info(void* ctx, const void* data, size_t len,
                             int* info) {
  Decoder* d = static_cast<Decoder*>(ctx);
  int comps = 0;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  const int st = nvjpegGetImageInfo(d->handle,
                                    static_cast<const unsigned char*>(data),
                                    len, &comps, &sub, ws, hs);
  info[0] = ws[0];
  info[1] = hs[0];
  info[2] = comps;
  return st;
}

// Decode n JPEGs of one size (host memory, datas[i] of lens[i] bytes) into
// out: frame i at out + i * frame_bytes, rows pitch bytes apart, RGB
// interleaved (channels 3) or grey (channels 1). Asynchronous on stream
// after the host's part of the decode.
extern "C" int cfn_jpeg_decode(void* ctx, const void* const* datas,
                               const size_t* lens, int n, int channels,
                               void* out, int pitch, size_t frame_bytes,
                               void* stream) {
  Decoder* d = static_cast<Decoder*>(ctx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto image = [&](int i) {
    nvjpegImage_t img = {};
    img.channel[0] = static_cast<unsigned char*>(out) + i * frame_bytes;
    img.pitch[0] = static_cast<unsigned int>(pitch);
    return img;
  };
  if (channels == 1) {
    for (int i = 0; i < n; ++i) {
      nvjpegImage_t img = image(i);
      const int st = nvjpegDecode(
          d->handle, d->state, static_cast<const unsigned char*>(datas[i]),
          lens[i], NVJPEG_OUTPUT_Y, &img, s);
      if (st != NVJPEG_STATUS_SUCCESS) return st;
    }
    d->batch = -1;  // the state now holds a single decode's setup
    return 0;
  }
  if (channels != 3) return NVJPEG_STATUS_INVALID_PARAMETER;
  if (d->batch != n) {
    const int st = nvjpegDecodeBatchedInitialize(d->handle, d->state, n, 1,
                                                 NVJPEG_OUTPUT_RGBI);
    if (st != NVJPEG_STATUS_SUCCESS) return st;
    d->batch = n;
  }
  std::vector<nvjpegImage_t> imgs(n);
  for (int i = 0; i < n; ++i) imgs[i] = image(i);
  return nvjpegDecodeBatched(
      d->handle, d->state,
      reinterpret_cast<const unsigned char* const*>(datas), lens, imgs.data(),
      s);
}
