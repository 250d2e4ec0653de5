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
// What bounds it on this card: bytes. Four taps and ~20 f32 operations per
// output value; it reads at most the crop's rows and writes out*out*3 bytes
// per frame. Design: one thread per output pixel (its three channels), a
// block of 256 pixels of one frame, the frame from blockIdx.y; the taps are
// read through the read-only cache. Neighbouring threads read neighbouring
// source pixels, so a warp's taps share cache lines. Grey frames (C = 1)
// give three equal channels, as Pillow's convert("RGB") does.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
crop_resize_kernel(const uint8_t* __restrict__ src, int h, int w, int pitch,
                   int channels, const int* __restrict__ boxes,
                   uint8_t* __restrict__ dst, int out) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= out * out) return;
  const int y = p / out, x = p - y * out;
  const int* box = boxes + 4 * n;
  const int x1 = box[0], y1 = box[1], cw = box[2], ch = box[3];
  const float fo = static_cast<float>(out);
  const float sx = __fdiv_rn(static_cast<float>(cw), fo);
  const float sy = __fdiv_rn(static_cast<float>(ch), fo);

  float fy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), sy),
                       0.5f);
  if (fy < 0) fy = 0;
  const int y0 = static_cast<int>(fy);
  const int yb = y0 + 1 < ch ? y0 + 1 : ch - 1;
  const float wy = __fsub_rn(fy, static_cast<float>(y0));
  float fx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), sx),
                       0.5f);
  if (fx < 0) fx = 0;
  const int x0 = static_cast<int>(fx);
  const int xb = x0 + 1 < cw ? x0 + 1 : cw - 1;
  const float wx = __fsub_rn(fx, static_cast<float>(x0));
  const float oy = __fsub_rn(1.f, wy), ox = __fsub_rn(1.f, wx);

  const uint8_t* frame = src + static_cast<size_t>(n) * h * pitch;
  const uint8_t* row0 = frame + static_cast<size_t>(y1 + y0) * pitch;
  const uint8_t* row1 = frame + static_cast<size_t>(y1 + yb) * pitch;
  const int c0 = (x1 + x0) * channels, c1 = (x1 + xb) * channels;
  uint8_t* o = dst + (static_cast<size_t>(n) * out * out + p) * 3;
  for (int c = 0; c < 3; ++c) {
    const int k = channels == 3 ? c : 0;
    const float v00 = __ldg(row0 + c0 + k), v01 = __ldg(row0 + c1 + k);
    const float v10 = __ldg(row1 + c0 + k), v11 = __ldg(row1 + c1 + k);
    float v = __fmul_rn(__fmul_rn(v00, oy), ox);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, oy), wx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), ox));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
    o[c] = static_cast<uint8_t>(static_cast<int>(__fadd_rn(v, 0.5f)));
  }
}

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int batch = -1;  // the batch nvjpegDecodeBatchedInitialize was given
};

}  // namespace

// 0, or cudaErrorInvalidValue for arguments the kernel does not take, or the
// launch's error
extern "C" int cfn_crop_resize(const void* src, int n, int h, int w,
                               int pitch, int channels, const void* boxes,
                               void* dst, int out, void* stream) {
  if (n < 1 || n > 65535 || out < 1 || (channels != 1 && channels != 3) ||
      pitch < w * channels)
    return cudaErrorInvalidValue;
  const dim3 grid((out * out + kThreads - 1) / kThreads, n);
  crop_resize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), h, w, pitch, channels,
      static_cast<const int*>(boxes), static_cast<uint8_t*>(dst), out);
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
