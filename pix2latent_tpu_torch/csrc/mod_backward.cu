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
// [22, 64, 512, 512] (23 launches per backward); FFHQ-1024 under its recipe
// on 2-sample chunks, from [2, 512, 4, 4] to [2, 32, 1024, 1024] (26).
//
// Bound on an H100 SXM: 2 FLOPs per element against 3 * size bytes moved
// (g and x read, g_x written), so the kernel is bound by bytes,
// 3 * n*c*h*w * size plus s and g_s. At [22, 64, 512, 512] in bf16 that is
// 1.11 GB, 0.33 ms at 3.35 TB/s; at [2, 32, 1024, 1024] 0.40 GB, 0.12 ms.
//
// Design. The Pallas kernel walks [rows, c] tiles of an NHWC tensor and
// carries g_s across the row blocks of its sequential grid. Blocks on the
// card run in no order, and an (n, c) plane is contiguous in NCHW, so a
// plane is cut into `splits` contiguous ranges, one block each, and the
// blocks of a plane form one thread-block cluster (cudaLaunchKernelEx with
// a cluster dimension of `splits`, at most 8, the portable size). A 2-sample
// chunk of FFHQ has 64 planes at its largest level: one block a plane would
// leave half of the 132 SMs idle, which held the first version of this
// kernel at about a third of its bound there.
//   * Each block streams its range: a thread issues the loads of UNROLL
//     16-byte vectors of g and of x before it uses any (4 KB a warp in
//     flight), writes g * s and keeps an f64 partial of the exact products.
//   * The block reduces its partials: a warp shuffle, then warp 0 over the
//     warps' sums, always in the same order.
//   * After cluster.sync(), rank 0 reads the peers' block sums through
//     distributed shared memory (map_shared_rank) in rank order and writes
//     g_s once; a second cluster.sync() keeps the peers' shared memory alive
//     until it has been read.
// No atomics, no workspace, no second launch: the result does not depend on
// the schedule, and two calls give the same bits.
//
// The plan (splits, threads, vector width) is chosen in Python
// (ops/mod_backward.py: mod_backward_plan) and passed in; this file checks
// it. Where the plane is a whole number of 16-byte vectors and the pointers
// are 16-byte aligned, every load and store moves 16 bytes a thread (4 f32
// or 8 bf16 values) and every range starts on a vector, so on a 16-byte
// boundary; otherwise one element a thread.
//
// C interface, bound from Python with ctypes: returns the cudaError_t of the
// launch (0 on success) and does not synchronise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSplits = 8;   // a portable cluster
constexpr int kUnroll = 4;      // vectors of g and of x a thread has in flight

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

// Vectors [rank * chunk, min(packs, (rank + 1) * chunk)) of plane
// blockIdx.x / splits, rank = blockIdx.x % splits (the block's rank in its
// cluster).
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
mod_backward_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const T* __restrict__ s, T* __restrict__ gx,
                    float* __restrict__ gs, int hw, int splits, int chunk) {
  __shared__ double partial[kMaxThreads / 32];
  __shared__ double block_sum;
  const int rank = (int)(blockIdx.x % (unsigned)splits);
  const size_t plane = blockIdx.x / (unsigned)splits;
  const size_t base = plane * (size_t)hw;
  const float sv = to_f<T>(s[plane]);
  const Pack<T, VEC>* gp = reinterpret_cast<const Pack<T, VEC>*>(g + base);
  const Pack<T, VEC>* xp = reinterpret_cast<const Pack<T, VEC>*>(x + base);
  Pack<T, VEC>* op = reinterpret_cast<Pack<T, VEC>*>(gx + base);

  const int packs = hw / VEC;
  const int begin = rank * chunk;
  const int end = min(packs, begin + chunk);
  const int stride = blockDim.x;
  double acc = 0.0;
  for (int i0 = begin + threadIdx.x; i0 < end; i0 += kUnroll * stride) {
    Pack<T, VEC> gv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * stride;
      if (i < end) {
        gv[u] = gp[i];
        xv[u] = xp[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * stride;
      if (i >= end) continue;
      Pack<T, VEC> ov;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float gf = to_f<T>(gv[u].v[e]);
        ov.v[e] = from_f<T>(gf * sv);
        acc += exact_product<T>(gf, to_f<T>(xv[u].v[e]));
      }
      op[i] = ov;
    }
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
  }
  if (splits == 1) {
    if (threadIdx.x == 0) gs[plane] = (float)acc;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) block_sum = acc;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    double total = 0.0;
    for (int r = 0; r < splits; ++r) total += *cluster.map_shared_rank(&block_sum, r);
    gs[plane] = (float)total;
  }
  cluster.sync();
}

template <typename T, int VEC>
cudaError_t launch(const void* g, const void* x, const void* s, void* gx, float* gs,
                   int planes, int hw, int splits, int threads, cudaStream_t st) {
  const int packs = hw / VEC;
  const int chunk = (packs + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)planes * (unsigned)splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, mod_backward_kernel<T, VEC>, (const T*)g, (const T*)x, (const T*)s, (T*)gx,
      gs, hw, splits, chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
cudaError_t dispatch(const void* g, const void* x, const void* s, void* gx, float* gs,
                     int planes, int hw, int splits, int threads, int vec,
                     cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    if (hw % kVec != 0 || !aligned16(g) || !aligned16(x) || !aligned16(gx))
      return cudaErrorInvalidValue;
    return launch<T, kVec>(g, x, s, gx, gs, planes, hw, splits, threads, st);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return launch<T, 1>(g, x, s, gx, gs, planes, hw, splits, threads, st);
}

}  // namespace

extern "C" {

// g, x [planes, hw] and s [planes] in one type (planes = n * c); g_x like g,
// g_s [planes] f32. The plan: `splits` blocks (one cluster) a plane, 1..8;
// `threads` a block, a multiple of 32 up to 256; `vec` elements a load, 1 or
// 16 bytes' worth (which needs hw a multiple of it and 16-byte pointers).
int mod_backward(const void* g, const void* x, const void* s, void* gx, void* gs,
                 int planes, int hw, int is_bf16, int splits, int threads, int vec,
                 void* stream) {
  if (planes < 1 || hw < 1 || splits < 1 || splits > kMaxSplits || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (long long)planes * splits >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(g, x, s, gx, (float*)gs, planes, hw, splits,
                                        threads, vec, st);
  return (int)dispatch<float>(g, x, s, gx, (float*)gs, planes, hw, splits, threads,
                              vec, st);
}

}  // extern "C"
