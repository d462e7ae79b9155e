// SA-GAN attention for Hopper (sm_90a): o = softmax(theta . phi^T) . g.
//
// Replaces the Pallas TPU kernel pix2latent_tpu/ops/attention.py
// (_fwd_call -> _fwd_kernel and _bwd_call -> _bwd_kernel). Same function
// and the same rounding points:
//   * no 1/sqrt(d) scale; QK^T and the softmax in f32 over the whole key axis;
//   * the probabilities are rounded to g's type before the PV product, which
//     accumulates in f32;
//   * backward: dP = dO . g^T and dS = P * (dP - rowsum(dP * P)) stay f32;
//     dtheta = dS . phi, dphi = dS^T . theta, dG = P_cast^T . dO, all
//     accumulated in f32 and rounded once to the input type.
//
// Shapes: theta [n, q, d], phi [n, k, d], g [n, k, dv], row-major and
// contiguous; float32 or bfloat16; d <= 128, dv <= 512; ragged q and k are
// masked. BigGAN-deep-256 at pop 18: n=18, q=4096, k=1024, d=64, dv=256.
//
// Bound on an H100 SXM at that shape: the forward is 2*n*q*k*(d+dv) = 48.3
// GFLOP, about 49 us at the 989 TFLOP/s bf16 tensor-core rate (0.72 ms at
// the 67 TFLOP/s f32 rate); the backward about 106 GFLOP, 107 us (1.6 ms in
// f32). Memory traffic is about 59 MB forward and 92 MB backward, 18 us and
// 27 us at 3.35 TB/s, so the work is bound by operations.
//
// Design. The TPU kernel keeps all of phi and g resident in VMEM; here g
// alone is 512 KB a sample in bf16, more than the 227 KB of shared memory a
// block has, so every kernel tiles the key axis through shared memory:
//   forward  (grid q-blocks x n): pass 1 over k-tiles finds the row max m and
//            the row sum l of exp(s - m) (online per thread, merged across
//            the row's lanes); pass 2 recomputes s, forms p = exp(s - m) / l,
//            rounds p to g's type and accumulates p . g. (m, l) are written
//            out for the backward. Normalising before the PV product, and not
//            at the end as an online softmax does, keeps the reference's
//            rounding of p.
//   backward (a) (grid q-blocks x n): pass 1 computes delta = rowsum(dP * P)
//            and writes it out; pass 2 forms dS and accumulates dtheta.
//   backward (b) (grid k-blocks x n): loops over all q-blocks, recomputes P
//            from (m, l), and accumulates dphi and dG in registers.
// Blocks run in parallel in no order, so the TPU kernel's accumulation
// across its sequential grid becomes the loop inside (b): no atomics, and
// the result is deterministic.
//
// This first design makes no use of wgmma, TMA or mma.sync: every product is
// a plain f32 FMA out of shared memory (bf16 inputs are widened on load, and
// their products are exact in f32). It is far from the bound; making it fast
// is later work.
//
// C interface, bound from Python with ctypes: each entry returns the
// cudaError_t of its launches (0 on success) and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;                        // query rows per block
constexpr int kBK = 32;                        // key rows per tile
constexpr int kLanes = kThreads / kBQ;         // threads per row: 8
constexpr int kPerLane = kBK / kLanes;         // tile columns per thread: 4

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

// Round an f32 value to T's precision and widen it back.
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return to_f<T>(from_f<T>(v));
}

// Rows [r0, r0 + rows) of a row-major [limit, width] matrix into shared
// memory as f32 with row stride `stride`; rows at or past `limit` read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          int r0, int rows, int limit, int width) {
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    const int gr = r0 + r;
    dst[r * stride + c] = gr < limit ? to_f<T>(src[(size_t)gr * width + c]) : 0.f;
  }
}

// out[j] = sum_c a[c] * b[j * stride + c] for the kPerLane rows of b that
// lie kLanes rows apart, starting at row b0 (one shared read of a per c).
__device__ __forceinline__ void dots(float out[kPerLane], const float* a,
                                     const float* b, int b0, int stride, int width) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) out[j] = 0.f;
  for (int c = 0; c < width; ++c) {
    const float av = a[c];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      out[j] = fmaf(av, b[(b0 + kLanes * j) * stride + c], out[j]);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
           const T* __restrict__ g, T* __restrict__ o, float* __restrict__ m_out,
           float* __restrict__ l_out, int q, int k, int d, int dv) {
  extern __shared__ float smem[];
  const int sd = d + 1;                  // padded strides avoid bank conflicts
  float* th_s = smem;                    // [kBQ][sd]
  float* ph_s = th_s + kBQ * sd;         // [kBK][sd]
  float* g_s = ph_s + kBK * sd;          // [kBK][dv]
  float* p_s = g_s + kBK * dv;           // [kBQ][kBK + 1]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  theta += (size_t)b * q * d;
  phi += (size_t)b * k * d;
  g += (size_t)b * k * dv;
  o += (size_t)b * q * dv;

  load_tile(th_s, sd, theta, q0, kBQ, q, d);

  // pass 1: row max and row sum of exp(s - max)
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();
    load_tile(ph_s, sd, phi, k0, kBK, k, d);
    __syncthreads();
    float s[kPerLane];
    dots(s, th_s + r * sd, ph_s, lane, sd, d);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (k0 + lane + kLanes * j >= k) continue;
      if (s[j] > m) {
        l = l * expf(m - s[j]) + 1.f;
        m = s[j];
      } else {
        l += expf(s[j] - m);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_n = fmaxf(m, m_o);
    l = (m == -INFINITY ? 0.f : l * expf(m - m_n)) +
        (m_o == -INFINITY ? 0.f : l_o * expf(m_o - m_n));
    m = m_n;
  }
  const bool row_ok = q0 + r < q;
  if (row_ok && lane == 0) {
    m_out[(size_t)b * q + q0 + r] = m;
    l_out[(size_t)b * q + q0 + r] = l;
  }

  // pass 2: o = round(p) . g with p = exp(s - m) / l
  float acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();
    load_tile(ph_s, sd, phi, k0, kBK, k, d);
    load_tile(g_s, dv, g, k0, kBK, k, dv);
    __syncthreads();
    float s[kPerLane];
    dots(s, th_s + r * sd, ph_s, lane, sd, d);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int kc = lane + kLanes * j;
      p_s[r * (kBK + 1) + kc] =
          k0 + kc < k ? round_as<T>(expf(s[j] - m) / l) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = p_s[r * (kBK + 1) + kk];
      const float* gr = g_s + kk * dv;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = lane + kLanes * j;
        if (c < dv) acc[j] = fmaf(p, gr[c], acc[j]);
      }
    }
  }
  if (row_ok) {
    T* orow = o + (size_t)(q0 + r) * dv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + kLanes * j;
      if (c < dv) orow[c] = from_f<T>(acc[j]);
    }
  }
}

// Backward (a): delta = rowsum(dP * P), then dtheta = dS . phi.
template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
              const T* __restrict__ g, const T* __restrict__ dout,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              float* __restrict__ delta_out, T* __restrict__ dtheta,
              int q, int k, int d, int dv) {
  extern __shared__ float smem[];
  const int sd = d + 1, sv = dv + 1;
  float* th_s = smem;                    // [kBQ][sd]
  float* do_s = th_s + kBQ * sd;         // [kBQ][sv]
  float* ph_s = do_s + kBQ * sv;         // [kBK][sd]
  float* g_s = ph_s + kBK * sd;          // [kBK][sv]
  float* ds_s = g_s + kBK * sv;          // [kBQ][kBK + 1]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool row_ok = q0 + r < q;
  theta += (size_t)b * q * d;
  dout += (size_t)b * q * dv;
  phi += (size_t)b * k * d;
  g += (size_t)b * k * dv;
  dtheta += (size_t)b * q * d;

  load_tile(th_s, sd, theta, q0, kBQ, q, d);
  load_tile(do_s, sv, dout, q0, kBQ, q, dv);
  const float m = row_ok ? m_in[(size_t)b * q + q0 + r] : 0.f;
  const float l = row_ok ? l_in[(size_t)b * q + q0 + r] : 1.f;

  // pass 1: delta
  float delta = 0.f;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();
    load_tile(ph_s, sd, phi, k0, kBK, k, d);
    load_tile(g_s, sv, g, k0, kBK, k, dv);
    __syncthreads();
    float s[kPerLane], dp[kPerLane];
    dots(s, th_s + r * sd, ph_s, lane, sd, d);
    dots(dp, do_s + r * sv, g_s, lane, sv, dv);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (k0 + lane + kLanes * j < k) delta += (expf(s[j] - m) / l) * dp[j];
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    delta += __shfl_xor_sync(0xffffffffu, delta, off);
  if (row_ok && lane == 0) delta_out[(size_t)b * q + q0 + r] = delta;

  // pass 2: dtheta
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();
    load_tile(ph_s, sd, phi, k0, kBK, k, d);
    load_tile(g_s, sv, g, k0, kBK, k, dv);
    __syncthreads();
    float s[kPerLane], dp[kPerLane];
    dots(s, th_s + r * sd, ph_s, lane, sd, d);
    dots(dp, do_s + r * sv, g_s, lane, sv, dv);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int kc = lane + kLanes * j;
      const float p = expf(s[j] - m) / l;
      ds_s[r * (kBK + 1) + kc] = k0 + kc < k ? p * (dp[j] - delta) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = ds_s[r * (kBK + 1) + kk];
      const float* pr = ph_s + kk * sd;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = lane + kLanes * j;
        if (c < d) acc[j] = fmaf(w, pr[c], acc[j]);
      }
    }
  }
  if (row_ok) {
    T* out = dtheta + (size_t)(q0 + r) * d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = lane + kLanes * j;
      if (c < d) out[c] = from_f<T>(acc[j]);
    }
  }
}

// Backward (b): per key block, dphi = dS^T . theta and dG = P_cast^T . dO
// summed over every query block.
template <typename T, int NV, int ND>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
               const T* __restrict__ g, const T* __restrict__ dout,
               const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ delta_in, T* __restrict__ dphi,
               T* __restrict__ dg, int q, int k, int d, int dv) {
  extern __shared__ float smem[];
  const int sd = d + 1, sv = dv + 1;
  float* ph_s = smem;                    // [kBK][sd]
  float* g_s = ph_s + kBK * sd;          // [kBK][sv]
  float* th_s = g_s + kBK * sv;          // [kBQ][sd]
  float* do_s = th_s + kBQ * sd;         // [kBQ][sv]
  float* pc_s = do_s + kBQ * sv;         // [kBK][kBQ + 1]
  float* ds_s = pc_s + kBK * (kBQ + 1);  // [kBK][kBQ + 1]
  float* m_s = ds_s + kBK * (kBQ + 1);   // [kBQ]
  float* l_s = m_s + kBQ;                // [kBQ]
  float* dl_s = l_s + kBQ;               // [kBQ]

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int kr = threadIdx.x / kLanes;   // key row within the block
  const int lane = threadIdx.x % kLanes;
  const bool key_ok = k0 + kr < k;
  theta += (size_t)b * q * d;
  dout += (size_t)b * q * dv;
  phi += (size_t)b * k * d;
  g += (size_t)b * k * dv;
  m_in += (size_t)b * q;
  l_in += (size_t)b * q;
  delta_in += (size_t)b * q;

  load_tile(ph_s, sd, phi, k0, kBK, k, d);
  load_tile(g_s, sv, g, k0, kBK, k, dv);

  float acc_g[NV], acc_p[ND];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc_g[j] = 0.f;
#pragma unroll
  for (int j = 0; j < ND; ++j) acc_p[j] = 0.f;

  for (int q0 = 0; q0 < q; q0 += kBQ) {
    __syncthreads();
    load_tile(th_s, sd, theta, q0, kBQ, q, d);
    load_tile(do_s, sv, dout, q0, kBQ, q, dv);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      m_s[threadIdx.x] = row < q ? m_in[row] : 0.f;
      l_s[threadIdx.x] = row < q ? l_in[row] : 1.f;
      dl_s[threadIdx.x] = row < q ? delta_in[row] : 0.f;
    }
    __syncthreads();
    // rows of this thread: queries lane + kLanes * j against key kr
    float s[kPerLane], dp[kPerLane];
    {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s[j] = dp[j] = 0.f;
      const float* pa = ph_s + kr * sd;
      for (int c = 0; c < d; ++c) {
        const float av = pa[c];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          s[j] = fmaf(th_s[(lane + kLanes * j) * sd + c], av, s[j]);
      }
      const float* ga = g_s + kr * sv;
      for (int c = 0; c < dv; ++c) {
        const float av = ga[c];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          dp[j] = fmaf(do_s[(lane + kLanes * j) * sv + c], av, dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int qr = lane + kLanes * j;
      float pc = 0.f, ds = 0.f;
      if (key_ok && q0 + qr < q) {
        const float p = expf(s[j] - m_s[qr]) / l_s[qr];
        pc = round_as<T>(p);
        ds = p * (dp[j] - dl_s[qr]);
      }
      pc_s[kr * (kBQ + 1) + qr] = pc;
      ds_s[kr * (kBQ + 1) + qr] = ds;
    }
    __syncthreads();
    for (int qq = 0; qq < kBQ; ++qq) {
      const float a = pc_s[kr * (kBQ + 1) + qq];
      const float w = ds_s[kr * (kBQ + 1) + qq];
      const float* dor = do_s + qq * sv;
      const float* thr = th_s + qq * sd;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = lane + kLanes * j;
        if (c < dv) acc_g[j] = fmaf(a, dor[c], acc_g[j]);
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = lane + kLanes * j;
        if (c < d) acc_p[j] = fmaf(w, thr[c], acc_p[j]);
      }
    }
  }
  if (key_ok) {
    T* gout = dg + ((size_t)b * k + k0 + kr) * dv;
    T* pout = dphi + ((size_t)b * k + k0 + kr) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + kLanes * j;
      if (c < dv) gout[c] = from_f<T>(acc_g[j]);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = lane + kLanes * j;
      if (c < d) pout[c] = from_f<T>(acc_p[j]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int NV>
cudaError_t launch_fwd(const void* theta, const void* phi, const void* g, void* o,
                       float* m, float* l, int n, int q, int k, int d, int dv,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                       (size_t)kBK * dv + (size_t)kBQ * (kBK + 1));
  cudaError_t err = allow_smem(fwd_kernel<T, NV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q + kBQ - 1) / kBQ, n);
  fwd_kernel<T, NV><<<grid, kThreads, smem, stream>>>(
      (const T*)theta, (const T*)phi, (const T*)g, (T*)o, m, l, q, k, d, dv);
  return cudaGetLastError();
}

template <typename T, int NV, int ND>
cudaError_t launch_bwd(const void* theta, const void* phi, const void* g,
                       const void* dout, const float* m, const float* l,
                       float* delta, void* dtheta, void* dphi, void* dg, int n,
                       int q, int k, int d, int dv, cudaStream_t stream) {
  const size_t sd = d + 1, sv = dv + 1;
  const size_t smem_dq =
      sizeof(float) * (kBQ * sd + kBQ * sv + kBK * sd + kBK * sv +
                       (size_t)kBQ * (kBK + 1));
  cudaError_t err = allow_smem(bwd_dq_kernel<T, ND>, smem_dq);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, ND><<<dim3((q + kBQ - 1) / kBQ, n), kThreads, smem_dq, stream>>>(
      (const T*)theta, (const T*)phi, (const T*)g, (const T*)dout, m, l, delta,
      (T*)dtheta, q, k, d, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkv =
      sizeof(float) * (kBK * sd + kBK * sv + kBQ * sd + kBQ * sv +
                       2 * (size_t)kBK * (kBQ + 1) + 3 * (size_t)kBQ);
  err = allow_smem(bwd_dkv_kernel<T, NV, ND>, smem_dkv);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<T, NV, ND><<<dim3((k + kBK - 1) / kBK, n), kThreads, smem_dkv,
                              stream>>>(
      (const T*)theta, (const T*)phi, (const T*)g, (const T*)dout, m, l, delta,
      (T*)dphi, (T*)dg, q, k, d, dv);
  return cudaGetLastError();
}

// Register-array widths: NV covers dv <= 8 * NV, ND covers d <= 8 * ND.
int nv_for(int dv) { return dv <= 128 ? 16 : dv <= 256 ? 32 : dv <= 512 ? 64 : 0; }
int nd_for(int d) { return d <= 32 ? 4 : d <= 64 ? 8 : d <= 128 ? 16 : 0; }

bool bad_shape(int n, int q, int k, int d, int dv) {
  return n < 1 || n > 65535 || q < 1 || k < 1 || nd_for(d) == 0 ||
         nv_for(dv) == 0 || d < 1 || dv < 1;
}

template <typename T>
cudaError_t fwd_dispatch(const void* theta, const void* phi, const void* g, void* o,
                         float* m, float* l, int n, int q, int k, int d, int dv,
                         cudaStream_t s) {
  switch (nv_for(dv)) {
    case 16: return launch_fwd<T, 16>(theta, phi, g, o, m, l, n, q, k, d, dv, s);
    case 32: return launch_fwd<T, 32>(theta, phi, g, o, m, l, n, q, k, d, dv, s);
    default: return launch_fwd<T, 64>(theta, phi, g, o, m, l, n, q, k, d, dv, s);
  }
}

template <typename T, int NV>
cudaError_t bwd_dispatch_d(const void* theta, const void* phi, const void* g,
                           const void* dout, const float* m, const float* l,
                           float* delta, void* dtheta, void* dphi, void* dg,
                           int n, int q, int k, int d, int dv, cudaStream_t s) {
  switch (nd_for(d)) {
    case 4: return launch_bwd<T, NV, 4>(theta, phi, g, dout, m, l, delta, dtheta,
                                        dphi, dg, n, q, k, d, dv, s);
    case 8: return launch_bwd<T, NV, 8>(theta, phi, g, dout, m, l, delta, dtheta,
                                        dphi, dg, n, q, k, d, dv, s);
    default: return launch_bwd<T, NV, 16>(theta, phi, g, dout, m, l, delta, dtheta,
                                          dphi, dg, n, q, k, d, dv, s);
  }
}

template <typename T>
cudaError_t bwd_dispatch(const void* theta, const void* phi, const void* g,
                         const void* dout, const float* m, const float* l,
                         float* delta, void* dtheta, void* dphi, void* dg, int n,
                         int q, int k, int d, int dv, cudaStream_t s) {
  switch (nv_for(dv)) {
    case 16: return bwd_dispatch_d<T, 16>(theta, phi, g, dout, m, l, delta, dtheta,
                                          dphi, dg, n, q, k, d, dv, s);
    case 32: return bwd_dispatch_d<T, 32>(theta, phi, g, dout, m, l, delta, dtheta,
                                          dphi, dg, n, q, k, d, dv, s);
    default: return bwd_dispatch_d<T, 64>(theta, phi, g, dout, m, l, delta, dtheta,
                                          dphi, dg, n, q, k, d, dv, s);
  }
}

}  // namespace

extern "C" {

// o [n, q, dv] in the input type; m, l [n, q] f32 row statistics.
int sagan_attention_fwd(const void* theta, const void* phi, const void* g, void* o,
                        void* m, void* l, int n, int q, int k, int d, int dv,
                        int is_bf16, void* stream) {
  if (bad_shape(n, q, k, d, dv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)fwd_dispatch<__nv_bfloat16>(theta, phi, g, o, (float*)m, (float*)l,
                                            n, q, k, d, dv, s);
  return (int)fwd_dispatch<float>(theta, phi, g, o, (float*)m, (float*)l, n, q, k,
                                  d, dv, s);
}

// dtheta [n, q, d], dphi [n, k, d], dg [n, k, dv] in the input type; delta
// [n, q] f32 scratch; m, l from sagan_attention_fwd.
int sagan_attention_bwd(const void* theta, const void* phi, const void* g,
                        const void* dout, const void* m, const void* l, void* delta,
                        void* dtheta, void* dphi, void* dg, int n, int q, int k,
                        int d, int dv, int is_bf16, void* stream) {
  if (bad_shape(n, q, k, d, dv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)bwd_dispatch<__nv_bfloat16>(theta, phi, g, dout, (const float*)m,
                                            (const float*)l, (float*)delta, dtheta,
                                            dphi, dg, n, q, k, d, dv, s);
  return (int)bwd_dispatch<float>(theta, phi, g, dout, (const float*)m,
                                  (const float*)l, (float*)delta, dtheta, dphi, dg,
                                  n, q, k, d, dv, s);
}

}  // extern "C"
