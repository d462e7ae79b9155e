// Separable zero-padded FIR blur for Hopper (sm_90a), StyleGAN2's post-upsample
// blur: y = correlate(pad(x, p0, p1), outer(taps, taps)) on every plane.
//
// Replaces the Pallas TPU kernel pix2latent_tpu/ops/pallas_fir.py
// (_fir_blur_impl -> _fir_plane_kernel); its custom-VJP backward
// (_fir_blur_bwd) is this same kernel called with the taps reversed and the
// pad (K-1-p0, K-1-p1). Same function and the same rounding points: the
// column taps run first (rows of the output), then the row taps, both
// accumulated in f32, and the result is rounded once to x's type. up = down = 1.
//
// Shapes: x [planes, H, W] (an NCHW tensor viewed as N*C planes), contiguous,
// float32 or bfloat16; y [planes, Ho, Wo] with Ho = H + p0 + p1 - K + 1 (the
// same for W); K <= 8 taps. StyleGAN2-cars-512 at pop 22 blurs seven levels
// r = 8 .. 512: x [22, ch(r), r+1, r+1] -> y [22, ch(r), r, r], K = 4, pad
// (1, 1); the largest is [22, 64, 513, 513].
//
// Bound on an H100 SXM: 2*K MACs per output element against 2 to 4 bytes
// moved for it, far below the ~295 operations a byte at which the card's
// arithmetic would bind, so the kernel is bound by bytes: each input read
// once and each output written once, planes * (H*W + Ho*Wo) * size. At the
// largest level in bf16 that is 1.48 GB, 0.44 ms at 3.35 TB/s; all seven
// levels of one forward move 2.83 GB, 0.85 ms.
//
// Design. In NCHW a plane is already contiguous, so no transposes are needed
// (the TPU kernel transposes NHWC into planes and materialises the padded
// copy with jnp.pad). One block owns a 32-row x 64-column output tile of one
// plane: it stages the (32+K-1) x (64+K-1) input window in shared memory as
// f32, writing zeros where the window leaves the plane (the padding is done
// at load, never materialised), runs the column pass into a second shared
// buffer and the row pass from it, and stores each output once. Rows of 513
// are ragged against the 64-wide tiles: loads and stores past the edge are
// masked. Neighbouring threads touch neighbouring addresses in every pass, so
// global loads and stores coalesce and shared memory has no bank conflicts.
// The halo is re-read by the neighbouring tile (1.14x the input bytes at K=4),
// mostly from L2.
//
// C interface, bound from Python with ctypes: returns the cudaError_t of the
// launch (0 on success) and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;

struct Taps {
  float v[kMaxTaps];
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
fir_blur_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int ho,
                int wo, int p0, int tiles_h, int tiles_w, Taps taps) {
  constexpr int kInH = kTileH + K - 1;
  constexpr int kInW = kTileW + K - 1;
  __shared__ float in_s[kInH][kInW];
  __shared__ float mid_s[kTileH][kInW];

  int b = blockIdx.x;
  const int tw = b % tiles_w;
  b /= tiles_w;
  const int th = b % tiles_h;
  const size_t plane = (size_t)(b / tiles_h);
  const int oy0 = th * kTileH;
  const int ox0 = tw * kTileW;
  const T* xp = x + plane * (size_t)h * w;
  T* yp = y + plane * (size_t)ho * wo;

  // input window, zero outside the plane (the padding)
  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW;
    const int c = i - r * kInW;
    const int iy = oy0 - p0 + r;
    const int ix = ox0 - p0 + c;
    in_s[r][c] = (iy >= 0 && iy < h && ix >= 0 && ix < w)
                     ? to_f<T>(xp[(size_t)iy * w + ix])
                     : 0.f;
  }
  __syncthreads();

  // column taps: mid[r][c] = sum_j taps[j] * in[r + j][c]
  for (int i = threadIdx.x; i < kTileH * kInW; i += kThreads) {
    const int r = i / kInW;
    const int c = i - r * kInW;
    float acc = taps.v[0] * in_s[r][c];
#pragma unroll
    for (int j = 1; j < K; ++j) acc = fmaf(taps.v[j], in_s[r + j][c], acc);
    mid_s[r][c] = acc;
  }
  __syncthreads();

  // row taps: y[r][c] = sum_j taps[j] * mid[r][c + j], rounded once
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW;
    const int c = i - r * kTileW;
    const int oy = oy0 + r;
    const int ox = ox0 + c;
    if (oy >= ho || ox >= wo) continue;
    float acc = taps.v[0] * mid_s[r][c];
#pragma unroll
    for (int j = 1; j < K; ++j) acc = fmaf(taps.v[j], mid_s[r][c + j], acc);
    yp[(size_t)oy * wo + ox] = from_f<T>(acc);
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, void* y, int planes, int h, int w, int ho, int wo,
                   int p0, const Taps& taps, cudaStream_t s) {
  const int tiles_h = (ho + kTileH - 1) / kTileH;
  const int tiles_w = (wo + kTileW - 1) / kTileW;
  const long long blocks = (long long)planes * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fir_blur_kernel<T, K><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)x, (T*)y, h, w, ho, wo, p0, tiles_h, tiles_w, taps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, int planes, int h, int w, int ho, int wo,
                     int p0, int k, const Taps& taps, cudaStream_t s) {
  switch (k) {
    case 1: return launch<T, 1>(x, y, planes, h, w, ho, wo, p0, taps, s);
    case 2: return launch<T, 2>(x, y, planes, h, w, ho, wo, p0, taps, s);
    case 3: return launch<T, 3>(x, y, planes, h, w, ho, wo, p0, taps, s);
    case 4: return launch<T, 4>(x, y, planes, h, w, ho, wo, p0, taps, s);
    case 5: return launch<T, 5>(x, y, planes, h, w, ho, wo, p0, taps, s);
    case 6: return launch<T, 6>(x, y, planes, h, w, ho, wo, p0, taps, s);
    case 7: return launch<T, 7>(x, y, planes, h, w, ho, wo, p0, taps, s);
    default: return launch<T, 8>(x, y, planes, h, w, ho, wo, p0, taps, s);
  }
}

}  // namespace

extern "C" {

// y [planes, ho, wo] in x's type; taps: k f32 values; p0: the leading pad of
// both spatial axes (the trailing pad is implied by ho and wo).
int fir_blur(const void* x, void* y, const float* taps, int k, int planes, int h,
             int w, int ho, int wo, int p0, int is_bf16, void* stream) {
  if (k < 1 || k > kMaxTaps || planes < 1 || h < 1 || w < 1 || ho < 1 || wo < 1)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int j = 0; j < kMaxTaps; ++j) t.v[j] = j < k ? taps[j] : 0.f;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(x, y, planes, h, w, ho, wo, p0, k, t, s);
  return (int)dispatch<float>(x, y, planes, h, w, ho, wo, p0, k, t, s);
}

}  // extern "C"
