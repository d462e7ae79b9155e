// Fused backward of StyleGAN2's style modulation for Hopper (sm_90a).
//
// The modulated conv computes conv(x * s) with a per-(sample, in-channel)
// style scale s. Given the conv's input gradient g, this kernel emits both
//   g_x[n,c,h,w] = g[n,c,h,w] * s[n,c]            in g's type,
//   g_s[n,c]     = sum_{h,w} g[n,c,h,w] * x[n,c,h,w]   returned in f32,
// in one pass over g and x.
//
// Replaces the Pallas TPU kernel pix2latent_tpu/ops/mod_backward.py
// (fused_mod_backward -> _bwd_kernel). Same function; g * s is one product
// rounded to g's type (for bf16 the f32 product of two bf16 values rounded
// once, which is what a bf16 multiply gives). The TPU kernel sums g * x in
// f32. Here every product is exact (a bf16 product in f32, an f32 product in
// f64) and the sum runs in f64, rounded once to f32: an f32 sum over a
// 512 x 512 plane depends on its order by up to ~1e-3 (7e-4 measured on an
// H100 against torch.sum at [22, 64, 512, 512]), beyond the reference
// tolerances (rtol 5e-5, atol 1e-5) for channels whose sum nearly cancels.
// The f64 work is a conversion and an add per element, far below the card's
// rate for them at this kernel's byte rate.
//
// Shapes: g, x [n, c, h, w] (NCHW, contiguous) and s [n, c], all float32 or
// all bfloat16; g_x like g, g_s [n, c] float32. StyleGAN2-cars-512 at pop 22
// runs it on every modulated conv's input, from [22, 512, 4, 4] to
// [22, 64, 512, 512]: 23 launches per backward.
//
// Bound on an H100 SXM: 2 FLOPs per element against 3 * size bytes moved
// (g and x read, g_x written), so the kernel is bound by bytes,
// 3 * n*c*h*w * size plus s and g_s. At [22, 64, 512, 512] in bf16 that is
// 1.11 GB, 0.33 ms at 3.35 TB/s; all 23 modulated convs of one backward
// move about 10.5 GB, 3.1 ms.
//
// Design. The Pallas kernel walks [rows, c] tiles of an NHWC tensor and
// carries g_s across the row blocks of its sequential grid. Blocks on the
// card run in no order, so here one block owns a whole (n, c) plane, which is
// contiguous in NCHW: a block-stride loop over h*w writes g * s and keeps a
// per-thread f64 partial of g * x, then a warp-shuffle and shared-memory
// reduction gives g_s, written once by thread 0. No atomics, so the result
// is deterministic. Where the plane is a whole number of 16-byte vectors and
// the pointers are 16-byte aligned, every load and store moves 16 bytes a
// thread (4 f32 or 8 bf16 values); otherwise one element a thread. Small
// planes get smaller blocks (32 threads at least), so the 4x4 levels do not
// idle 256 threads on 16 values.
//
// C interface, bound from Python with ctypes: returns the cudaError_t of the
// launch (0 on success) and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

constexpr int kMaxThreads = 256;

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

// g * x without rounding: two bf16 values multiply exactly in f32, two f32
// values in f64.
template <typename T> __device__ __forceinline__ double exact_product(float g, float x);
template <> __device__ __forceinline__ double exact_product<__nv_bfloat16>(float g,
                                                                          float x) {
  return (double)(g * x);
}
template <> __device__ __forceinline__ double exact_product<float>(float g, float x) {
  return (double)g * (double)x;
}

// VEC elements of T packed in one 16-byte word (VEC = 1: a single element).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
mod_backward_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const T* __restrict__ s, T* __restrict__ gx,
                    float* __restrict__ gs, int hw) {
  __shared__ double partial[kMaxThreads / 32];
  const size_t plane = blockIdx.x;
  const size_t base = plane * (size_t)hw;
  const float sv = to_f<T>(s[plane]);
  const Pack<T, VEC>* gp = reinterpret_cast<const Pack<T, VEC>*>(g + base);
  const Pack<T, VEC>* xp = reinterpret_cast<const Pack<T, VEC>*>(x + base);
  Pack<T, VEC>* op = reinterpret_cast<Pack<T, VEC>*>(gx + base);

  double acc = 0.0;
  const int packs = hw / VEC;
  for (int i = threadIdx.x; i < packs; i += blockDim.x) {
    const Pack<T, VEC> gv = gp[i];
    const Pack<T, VEC> xv = xp[i];
    Pack<T, VEC> ov;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float gf = to_f<T>(gv.v[e]);
      ov.v[e] = from_f<T>(gf * sv);
      acc += exact_product<T>(gf, to_f<T>(xv.v[e]));
    }
    op[i] = ov;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    acc = lane < warps ? partial[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) gs[plane] = (float)acc;
  }
}

int threads_for(int work) {
  int t = 32;
  while (t < kMaxThreads && t < work) t <<= 1;
  return t;
}

template <typename T>
cudaError_t launch(const void* g, const void* x, const void* s, void* gx, float* gs,
                   int planes, int hw, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)g | (uintptr_t)x | (uintptr_t)gx) % 16 == 0;
  if (aligned && hw % kVec == 0) {
    mod_backward_kernel<T, kVec><<<planes, threads_for(hw / kVec), 0, st>>>(
        (const T*)g, (const T*)x, (const T*)s, (T*)gx, gs, hw);
  } else {
    mod_backward_kernel<T, 1><<<planes, threads_for(hw), 0, st>>>(
        (const T*)g, (const T*)x, (const T*)s, (T*)gx, gs, hw);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, x [planes, hw] and s [planes] in one type (planes = n * c); g_x like g,
// g_s [planes] f32.
int mod_backward(const void* g, const void* x, const void* s, void* gx, void* gs,
                 int planes, int hw, int is_bf16, void* stream) {
  if (planes < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(g, x, s, gx, (float*)gs, planes, hw, st);
  return (int)launch<float>(g, x, s, gx, (float*)gs, planes, hw, st);
}

}  // extern "C"
