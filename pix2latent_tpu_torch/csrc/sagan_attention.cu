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
// contiguous; float32 or bfloat16; d <= 128, dv <= 512, n <= 65535; ragged
// q and k are masked. BigGAN-deep-256 at pop 18: n=18, q=4096, k=1024, d=64,
// dv=256 (BigGAN-deep-128: d=32, dv=128).
//
// Two routes, chosen by the input type alone. This is not a fallback: each
// type always takes its route, and every shape above is taken by both.
//   bfloat16 -> the tensor-core kernels fwd_mma_kernel, bwd_dq_mma_kernel and
//               bwd_dkv_mma_kernel: mma.sync m16n8k16, bf16 in, f32 sums;
//   float32  -> the FMA kernels fwd_kernel, bwd_dq_kernel and bwd_dkv_kernel:
//               f32 FMAs out of shared memory. The tensor cores would need
//               TF32 for f32 inputs, which breaks the float32 card-vs-CPU
//               checks.
//
// Bound on an H100 SXM at the BigGAN-deep-256 shape, with U = 2 n q k =
// 1.51e8: the forward needs U (d + dv) = 48.3 GFLOP, 49 us at the 989
// TFLOP/s bf16 tensor-core rate (0.72 ms at the 67 TFLOP/s f32 rate); the
// backward U (3d + 2dv) = 106 GFLOP, 107 us (1.6 ms in f32). Memory traffic
// is about 59 MB forward and 92 MB backward, 18 and 27 us at 3.35 TB/s, so
// the work is bound by operations.
//
// Work the bf16 design does at that shape (d is padded to 16, 32, 64 or 128,
// dv to 64, ..., 512, and q and k to the tiles; at that shape nothing is
// padded):
//   forward  U (2d + dv) = 58.0 GFLOP: S in both passes, P . g once;
//   backward U (7d + 4dv) = 222 GFLOP: dq pass 1 U (d + dv) (S, dP), dq pass
//            2 U (3d + dv) (S, dP, dS . phi as hi + lo), dkv U (3d + 2dv)
//            (S^T, dP^T, P^T . dO, dS^T . theta as hi + lo).
// The FMA design does U (2d + dv) forward and U (5d + 4dv) backward.
// sagan_attention_work returns these counts at any shape, from the tiles the
// launchers use.
//
// Design of the bf16 route. Every product is mma.sync m16n8k16 (bf16 in, f32
// sums) fed by ldmatrix. Tiles stay bf16 in shared memory, each row padded
// by 16 bytes so that ldmatrix reads its 8 rows from 8 distinct bank groups,
// and are staged by 16-byte cp.async.cg into two buffers: the next key (or
// query) tile loads while the tensor cores work on the current one. Widths
// that are not a multiple of 8 elements, or bases not 16-byte aligned, are
// staged element by element. Contraction widths are padded with zeros, which
// is exact. Register pressure decides the warp layouts: a 16-row warp owning
// all of dv = 256 would hold 128 accumulators of one product.
//   forward  (grid 64-row q-blocks x n x dv chunks of <= 256; 8 warps): pass
//            1 over 64-key tiles keeps the row max m and the row sum l of
//            exp(s - m) online per thread, merged over the quad and then over
//            the 4 key warps in a fixed order; pass 2 recomputes s, forms
//            p = exp(s - m) / l, rounds p to bf16 and accumulates p . g in
//            f32. Normalising before the PV product, and not at the end as an
//            online softmax does, keeps the reference's rounding of p. Keys
//            past k take no part in m and l, and get p = 0. S is split 2 x 4
//            and O 2 x 4 between the warps, so p passes through shared memory.
//   backward (a) dq (grid 128-row q-blocks x n; 8 warps of 16 query rows
//            against the whole 64-key tile; at d = 64, dv = 256 their theta
//            and dO rows are held as A fragments in registers): pass 1
//            delta = rowsum(dP * P) from the
//            f32 P and dP, summed per thread in key order and then over the
//            quad, written out; pass 2 dS = P (dP - delta) in f32, split into
//            bf16 hi and bf16 lo = dS - hi, and dtheta += hi . phi + lo . phi.
//            The m16n8 accumulators of S are the A fragments of the next
//            product, so dS never leaves the registers. One bf16 rounding of
//            dS would raise dtheta's error about 1.7x; hi + lo carries dS to
//            16 bits.
//   backward (b) dkv (grid 64-key blocks x n x dv chunks; 8 warps): loops
//            over query tiles of 64 (32 where two blocks would not fit on an
//            SM, as at d = 64, dv = 256); each warp computes S^T = phi .
//            theta^T and dP^T = g . dO^T for 16 keys and half the tile (keys
//            in the M dimension); P_bf16^T and the halves of dS^T pass
//            through shared memory to the 16-key x half-width warp tiles that
//            accumulate dG += P_bf16^T . dO and dphi += dS^T_hi . theta +
//            dS^T_lo . theta in registers. Query rows past q get p = 0 and
//            dS = 0 explicitly: a zero theta row gives a uniform P, not a zero
//            one.
// Every output element is written by one block after a loop in a fixed
// order: no atomics, and the result is deterministic.
//
// Design of the f32 route: the same passes, every product an f32 FMA out of
// f32 shared-memory tiles of 32 query rows and 32 keys.
//
// C interface, bound from Python with ctypes: each entry returns the
// cudaError_t of its launches (0 on success) and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// float32: the FMA kernels
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 32;                        // query rows per block
constexpr int kBK = 32;                        // key rows per tile
constexpr int kLanes = kThreads / kBQ;         // threads per row: 8
constexpr int kPerLane = kBK / kLanes;         // tile columns per thread: 4

// Rows [r0, r0 + rows) of a row-major [limit, width] matrix into shared
// memory with row stride `stride`; rows at or past `limit` read as 0.
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src,
                                          int r0, int rows, int limit, int width) {
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    const int gr = r0 + r;
    dst[r * stride + c] = gr < limit ? src[(size_t)gr * width + c] : 0.f;
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

template <int NV>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
           const float* __restrict__ g, float* __restrict__ o,
           float* __restrict__ m_out, float* __restrict__ l_out, int q, int k,
           int d, int dv) {
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

  // pass 2: o = p . g with p = exp(s - m) / l
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
      p_s[r * (kBK + 1) + kc] = k0 + kc < k ? expf(s[j] - m) / l : 0.f;
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
    float* orow = o + (size_t)(q0 + r) * dv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + kLanes * j;
      if (c < dv) orow[c] = acc[j];
    }
  }
}

// Backward (a): delta = rowsum(dP * P), then dtheta = dS . phi.
template <int ND>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
              const float* __restrict__ g, const float* __restrict__ dout,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              float* __restrict__ delta_out, float* __restrict__ dtheta,
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
    float* out = dtheta + (size_t)(q0 + r) * d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = lane + kLanes * j;
      if (c < d) out[c] = acc[j];
    }
  }
}

// Backward (b): per key block, dphi = dS^T . theta and dG = P^T . dO
// summed over every query block.
template <int NV, int ND>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
               const float* __restrict__ g, const float* __restrict__ dout,
               const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ delta_in, float* __restrict__ dphi,
               float* __restrict__ dg, int q, int k, int d, int dv) {
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
        pc = p;
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
    float* gout = dg + ((size_t)b * k + k0 + kr) * dv;
    float* pout = dphi + ((size_t)b * k + k0 + kr) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + kLanes * j;
      if (c < dv) gout[c] = acc_g[j];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = lane + kLanes * j;
      if (c < d) pout[c] = acc_p[j];
    }
  }
}

template <int NV>
cudaError_t launch_fwd(const float* theta, const float* phi, const float* g,
                       float* o, float* m, float* l, int n, int q, int k, int d,
                       int dv, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                       (size_t)kBK * dv + (size_t)kBQ * (kBK + 1));
  cudaError_t err = allow_smem(fwd_kernel<NV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q + kBQ - 1) / kBQ, n);
  fwd_kernel<NV><<<grid, kThreads, smem, stream>>>(theta, phi, g, o, m, l, q, k,
                                                   d, dv);
  return cudaGetLastError();
}

template <int NV, int ND>
cudaError_t launch_bwd(const float* theta, const float* phi, const float* g,
                       const float* dout, const float* m, const float* l,
                       float* delta, float* dtheta, float* dphi, float* dg, int n,
                       int q, int k, int d, int dv, cudaStream_t stream) {
  const size_t sd = d + 1, sv = dv + 1;
  const size_t smem_dq =
      sizeof(float) * (kBQ * sd + kBQ * sv + kBK * sd + kBK * sv +
                       (size_t)kBQ * (kBK + 1));
  cudaError_t err = allow_smem(bwd_dq_kernel<ND>, smem_dq);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<ND><<<dim3((q + kBQ - 1) / kBQ, n), kThreads, smem_dq, stream>>>(
      theta, phi, g, dout, m, l, delta, dtheta, q, k, d, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkv =
      sizeof(float) * (kBK * sd + kBK * sv + kBQ * sd + kBQ * sv +
                       2 * (size_t)kBK * (kBQ + 1) + 3 * (size_t)kBQ);
  err = allow_smem(bwd_dkv_kernel<NV, ND>, smem_dkv);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<NV, ND><<<dim3((k + kBK - 1) / kBK, n), kThreads, smem_dkv,
                           stream>>>(theta, phi, g, dout, m, l, delta, dphi, dg,
                                     q, k, d, dv);
  return cudaGetLastError();
}

// Register-array widths: NV covers dv <= 8 * NV, ND covers d <= 8 * ND.
int nv_for(int dv) { return dv <= 128 ? 16 : dv <= 256 ? 32 : 64; }
int nd_for(int d) { return d <= 32 ? 4 : d <= 64 ? 8 : 16; }

cudaError_t fma_fwd(const float* theta, const float* phi, const float* g, float* o,
                    float* m, float* l, int n, int q, int k, int d, int dv,
                    cudaStream_t s) {
  switch (nv_for(dv)) {
    case 16: return launch_fwd<16>(theta, phi, g, o, m, l, n, q, k, d, dv, s);
    case 32: return launch_fwd<32>(theta, phi, g, o, m, l, n, q, k, d, dv, s);
    default: return launch_fwd<64>(theta, phi, g, o, m, l, n, q, k, d, dv, s);
  }
}

template <int NV>
cudaError_t fma_bwd_d(const float* theta, const float* phi, const float* g,
                      const float* dout, const float* m, const float* l,
                      float* delta, float* dtheta, float* dphi, float* dg, int n,
                      int q, int k, int d, int dv, cudaStream_t s) {
  switch (nd_for(d)) {
    case 4: return launch_bwd<NV, 4>(theta, phi, g, dout, m, l, delta, dtheta,
                                     dphi, dg, n, q, k, d, dv, s);
    case 8: return launch_bwd<NV, 8>(theta, phi, g, dout, m, l, delta, dtheta,
                                     dphi, dg, n, q, k, d, dv, s);
    default: return launch_bwd<NV, 16>(theta, phi, g, dout, m, l, delta, dtheta,
                                       dphi, dg, n, q, k, d, dv, s);
  }
}

cudaError_t fma_bwd(const float* theta, const float* phi, const float* g,
                    const float* dout, const float* m, const float* l,
                    float* delta, float* dtheta, float* dphi, float* dg, int n,
                    int q, int k, int d, int dv, cudaStream_t s) {
  switch (nv_for(dv)) {
    case 16: return fma_bwd_d<16>(theta, phi, g, dout, m, l, delta, dtheta, dphi,
                                  dg, n, q, k, d, dv, s);
    case 32: return fma_bwd_d<32>(theta, phi, g, dout, m, l, delta, dtheta, dphi,
                                  dg, n, q, k, d, dv, s);
    default: return fma_bwd_d<64>(theta, phi, g, dout, m, l, delta, dtheta, dphi,
                                  dg, n, q, k, d, dv, s);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTC = 256;     // threads of a tensor-core block: 8 warps
constexpr int kRows = 64;    // query rows of a forward block, keys of a dkv block
constexpr int kKeys = 64;    // keys per tile of the forward
constexpr int kPad = 8;      // bf16 elements of padding after each shared row
constexpr size_t kSmemPerSM = 228 * 1024;  // an H100 SM's shared memory for blocks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major matrix
// (`limit` rows, `width` columns, row stride `ld`) into shared memory with
// row stride COLS + kPad; elements past `limit` or `width` read as 0. With
// `vec` (ld, width and c0 multiples of 8, base 16-byte aligned) by 16-byte
// cp.async, zero-filled by the source size; otherwise element by element.
template <int ROWS, int COLS, int THREADS = kTC>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int ld, int r0,
                                      int limit, int c0, int width, bool vec) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* out = dst + r * (COLS + kPad) + c;
    if (vec) {
      const bool ok = gr < limit && gc < width;
      cp_async16(out, ok ? src + (size_t)gr * ld + gc : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = gr < limit && gc + e < width ? src[(size_t)gr * ld + gc + e]
                                              : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of n-tiles j and j + 1 (.x4) or of n-tile j alone (.x2), k-step
// k0, from B stored by its columns ([N][K], row stride ldb) or, with B_ROWS,
// by its rows ([K][N], ldmatrix .trans).
template <bool B_ROWS>
__device__ __forceinline__ void load_b2(uint32_t (&r)[4], const bf16* b, int ldb, int j,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  if (B_ROWS)
    ldsm_x4_trans(r, b + (k0 + (lane & 15)) * ldb + 8 * j + (lane >> 4) * 8);
  else
    ldsm_x4(r, b + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * ldb + k0 +
                   ((lane >> 3) & 1) * 8);
}
template <bool B_ROWS>
__device__ __forceinline__ void load_b1(uint32_t (&r)[2], const bf16* b, int ldb, int j,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  if (B_ROWS)
    ldsm_x2_trans(r, b + (k0 + (lane & 15)) * ldb + 8 * j);
  else
    ldsm_x2(r, b + (8 * j + (lane & 7)) * ldb + k0 + ((lane >> 3) & 1) * 8);
}

// One warp: acc[i][j] += A[16 i + 0..16)[0..K) . B[0..K)[8 j + 0..8) for
// i < MT, j < NT, and with SPLIT also A_lo . B against the same B fragments
// (the lo half of dS). A and A_lo are row-major in shared memory (row stride
// lda); B as in load_b2. Accumulator element acc[i][j][2 h + e] is row
// 16 i + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
template <int MT, int NT, int K, bool B_ROWS, bool SPLIT = false>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const bf16* a,
                                         const bf16* a_lo, int lda, const bf16* b,
                                         int ldb) {
  const int lane = threadIdx.x & 31;
  const int a_off = (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      ldsm_x4(af[i], a + a_off + 16 * i * lda + k0);
      if (SPLIT) ldsm_x4(al[i], a_lo + a_off + 16 * i * lda + k0);
    }
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      uint32_t bf[4];
      load_b2<B_ROWS>(bf, b, ldb, j, k0);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
        if (SPLIT) mma_bf16(acc[i][j], al[i], bf[0], bf[1]);
        mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        if (SPLIT) mma_bf16(acc[i][j + 1], al[i], bf[2], bf[3]);
      }
    }
    if (NT % 2) {
      uint32_t bf[2];
      load_b1<B_ROWS>(bf, b, ldb, NT - 1, k0);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][NT - 1], af[i], bf[0], bf[1]);
        if (SPLIT) mma_bf16(acc[i][NT - 1], al[i], bf[0], bf[1]);
      }
    }
  }
}

// warp_mma for one warp of 16 rows.
template <int NT, int K, bool B_ROWS, bool SPLIT = false>
__device__ __forceinline__ void warp_mma16(float (&acc)[NT][4], const bf16* a,
                                           const bf16* a_lo, int lda, const bf16* b,
                                           int ldb) {
  warp_mma<1, NT, K, B_ROWS, SPLIT>(*reinterpret_cast<float(*)[1][NT][4]>(&acc), a, a_lo,
                                    lda, b, ldb);
}

// The A fragments of a warp's 16 rows and KS k-steps, from a row-major tile
// in shared memory (row stride ld) into registers.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* a_lane = tile + (lane & 15) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(a[kk], a_lane + 16 * kk);
}

// warp_mma16 with the A (and A_lo) fragments of the KS k-steps in registers;
// NT even.
template <int NT, int KS, bool B_ROWS, bool SPLIT>
__device__ __forceinline__ void warp_mma16(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                           const uint32_t (&a_lo)[KS][4], const bf16* b,
                                           int ldb) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      load_b2<B_ROWS>(bf, b, ldb, j, 16 * kk);
      mma_bf16(acc[j], a[kk], bf[0], bf[1]);
      if (SPLIT) mma_bf16(acc[j], a_lo[kk], bf[0], bf[1]);
      mma_bf16(acc[j + 1], a[kk], bf[2], bf[3]);
      if (SPLIT) mma_bf16(acc[j + 1], a_lo[kk], bf[2], bf[3]);
    }
  }
}

// The A fragment slot of accumulator n-tile j, half h: n-tiles 2 kk and
// 2 kk + 1 of a 16-row product are the A fragment of k-step kk of the next.
__device__ __forceinline__ uint32_t& a_slot(uint32_t (*frag)[4], int j, int h) {
  return frag[j >> 1][2 * (j & 1) + h];
}

// f32 (v0, v1) as the bf16 pair hi and the bf16 pair lo = v - hi, packed.
__device__ __forceinline__ void split_pair(uint32_t& hi, uint32_t& lo, float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(v0 - back.x, v1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}
template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The pair (v0, v1) into row[col], row[col + 1] as bf16, columns at or past
// `width` left alone.
__device__ __forceinline__ void store_pair(bf16* row, int col, int width, float v0,
                                           float v1) {
  if ((width & 1) == 0 && col + 1 < width) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < width) row[col] = __float2bfloat16_rn(v0);
    if (col + 1 < width) row[col + 1] = __float2bfloat16_rn(v1);
  }
}

// p = exp(s - m) / l, the softmax in f32.
__device__ __forceinline__ float prob(float s, float m, float l) {
  return expf(s - m) / l;
}

// (m, l) <- the merge of two partial (row max, row sum of exp(s - max)).
__device__ __forceinline__ void merge_ml(float& m, float& l, float m_o, float l_o) {
  const float m_n = fmaxf(m, m_o);
  l = (m == -INFINITY ? 0.f : l * expf(m - m_n)) +
      (m_o == -INFINITY ? 0.f : l_o * expf(m_o - m_n));
  m = m_n;
}

// dS in f32 as the bf16 pair hi + lo, written to hi_row[col], lo_row[col].
__device__ __forceinline__ void store_split(bf16* hi_row, bf16* lo_row, int col,
                                            float v0, float v1) {
  split_pair(*reinterpret_cast<uint32_t*>(hi_row + col),
             *reinterpret_cast<uint32_t*>(lo_row + col), v0, v1);
}

// Forward. Warp w: rows 32 (w / 4) of the block; keys 16 (w % 4) of a tile in
// S; columns (VC / 4) (w % 4) of the chunk in O.
template <int DP, int VC>
__global__ void __launch_bounds__(kTC)
fwd_mma_kernel(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
               const bf16* __restrict__ g, bf16* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out, int q, int k,
               int d, int dv, bool vec_d, bool vec_v) {
  constexpr int LD = DP + kPad, LV = VC + kPad, LP = kKeys + kPad;
  constexpr int NO = VC / 32;
  constexpr int ROWS = kRows, THREADS = kTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* th_s = reinterpret_cast<bf16*>(smem_raw);      // [ROWS][LD]
  bf16* ph_s = th_s + ROWS * LD;                      // 2 x [kKeys][LD]
  bf16* g_s = ph_s + 2 * kKeys * LD;                   // 2 x [kKeys][LV]
  bf16* p_s = g_s + 2 * kKeys * LV;                    // [ROWS][LP]
  float* part_m = reinterpret_cast<float*>(p_s + ROWS * LP);  // [4][ROWS]
  float* part_l = part_m + 4 * ROWS;                  // [4][ROWS]
  float* row_m = part_l + 4 * ROWS;                   // [ROWS]
  float* row_l = row_m + ROWS;                        // [ROWS]

  const int b = blockIdx.y, q0 = blockIdx.x * ROWS, c0 = blockIdx.z * VC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  const int key_w = 16 * wc, col_w = (VC / 4) * wc;
  theta += (size_t)b * q * d;
  phi += (size_t)b * k * d;
  g += (size_t)b * k * dv;
  o += (size_t)b * q * dv;
  const int tiles = (k + kKeys - 1) / kKeys;
  const bf16* th_w = th_s + 32 * wr * LD;

  stage<ROWS, DP, THREADS>(th_s, theta, d, q0, q, 0, d, vec_d);
  stage<kKeys, DP, THREADS>(ph_s, phi, d, 0, k, 0, d, vec_d);
  cp_commit();

  // pass 1: per thread, (m, l) of rows 32 wr + 16 i + lane / 4 + 8 h over its keys
  float mr[2][2], lr[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) mr[i][h] = -INFINITY, lr[i][h] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage<kKeys, DP, THREADS>(ph_s + ((t + 1) & 1) * kKeys * LD, phi, d, (t + 1) * kKeys, k,
                       0, d, vec_d);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[2][2][4];
    zero(s);
    warp_mma<2, 2, DP, false>(s, th_w, nullptr, LD,
                              ph_s + (t & 1) * kKeys * LD + key_w * LD, LD);
    const int key0 = t * kKeys + key_w + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key0 + 8 * j + e < k) mx = fmaxf(mx, s[i][j][2 * h + e]);
        if (mx == -INFINITY) continue;
        const float mn = fmaxf(mr[i][h], mx);
        float sum = lr[i][h] * expf(mr[i][h] - mn);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key0 + 8 * j + e < k) sum += expf(s[i][j][2 * h + e] - mn);
        mr[i][h] = mn;
        lr[i][h] = sum;
      }
    __syncthreads();
  }

  // the first tile of pass 2 loads while the row statistics merge
  stage<kKeys, DP, THREADS>(ph_s, phi, d, 0, k, 0, d, vec_d);
  stage<kKeys, VC, THREADS>(g_s, g, dv, 0, k, c0, dv, vec_v);
  cp_commit();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        merge_ml(mr[i][h], lr[i][h], __shfl_xor_sync(0xffffffffu, mr[i][h], off),
                 __shfl_xor_sync(0xffffffffu, lr[i][h], off));
      if ((lane & 3) == 0) {
        const int row = 32 * wr + 16 * i + (lane >> 2) + 8 * h;
        part_m[wc * ROWS + row] = mr[i][h];
        part_l[wc * ROWS + row] = lr[i][h];
      }
    }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) merge_ml(m, l, part_m[w * ROWS + r], part_l[w * ROWS + r]);
    row_m[r] = m;
    row_l[r] = l;
    if (blockIdx.z == 0 && q0 + r < q) {
      m_out[(size_t)b * q + q0 + r] = m;
      l_out[(size_t)b * q + q0 + r] = l;
    }
  }

  // pass 2: o = p . g with p = exp(s - m) / l rounded to bf16
  float acc[2][NO][4];
  zero(acc);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int nb = (t + 1) & 1;
      stage<kKeys, DP, THREADS>(ph_s + nb * kKeys * LD, phi, d, (t + 1) * kKeys, k, 0, d, vec_d);
      stage<kKeys, VC, THREADS>(g_s + nb * kKeys * LV, g, dv, (t + 1) * kKeys, k, c0, dv, vec_v);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[2][2][4];
    zero(s);
    warp_mma<2, 2, DP, false>(s, th_w, nullptr, LD,
                              ph_s + (t & 1) * kKeys * LD + key_w * LD, LD);
    const int key0 = t * kKeys + key_w + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wr + 16 * i + (lane >> 2) + 8 * h;
        const float m = row_m[row], l = row_l[row];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = key0 + 8 * j;
          const float p0 = key < k ? prob(s[i][j][2 * h], m, l) : 0.f;
          const float p1 = key + 1 < k ? prob(s[i][j][2 * h + 1], m, l) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(p_s + row * LP + key_w + 8 * j +
                                             2 * (lane & 3)) =
              __floats2bfloat162_rn(p0, p1);
        }
      }
    __syncthreads();
    warp_mma<2, NO, kKeys, true>(acc, p_s + 32 * wr * LP, nullptr, LP,
                                 g_s + (t & 1) * kKeys * LV + col_w, LV);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 32 * wr + 16 * i + (lane >> 2) + 8 * h;
      if (row >= q) continue;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        store_pair(o + (size_t)row * dv, c0 + col_w + 8 * j + 2 * (lane & 3), dv,
                   acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// Backward (a): delta = rowsum(dP * P), then dtheta = dS . phi with dS as
// hi + lo. Warp w owns query rows 16 w .. 16 w + 15 of the block against the
// whole key tile, so its rows' sums need no other warp, and dS goes from the
// S accumulators straight into A fragments, never through shared memory.
template <int DP, int VP, int BK, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
bwd_dq_mma_kernel(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
                  const bf16* __restrict__ g, const bf16* __restrict__ dout,
                  const float* __restrict__ m_in, const float* __restrict__ l_in,
                  float* __restrict__ delta_out, bf16* __restrict__ dtheta, int q,
                  int k, int d, int dv, bool vec_d, bool vec_v) {
  constexpr int LD = DP + kPad, LV = VP + kPad;
  constexpr int NS = BK / 8, KS = BK / 16, ND = DP / 8;
  constexpr int ROWS = 16 * WARPS, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* th_s = reinterpret_cast<bf16*>(smem_raw);      // [ROWS][LD]
  bf16* do_s = th_s + ROWS * LD;                      // [ROWS][LV]
  bf16* ph_s = do_s + ROWS * LV;                      // 2 x [BK][LD]
  bf16* g_s = ph_s + 2 * BK * LD;                      // 2 x [BK][LV]

  const int b = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  theta += (size_t)b * q * d;
  dout += (size_t)b * q * dv;
  phi += (size_t)b * k * d;
  g += (size_t)b * k * dv;
  const int tiles = (k + BK - 1) / BK;
  const bf16* th_w = th_s + 16 * warp * LD;
  const bf16* do_w = do_s + 16 * warp * LV;

  stage<ROWS, DP, THREADS>(th_s, theta, d, q0, q, 0, d, vec_d);
  stage<ROWS, VP, THREADS>(do_s, dout, dv, q0, q, 0, dv, vec_v);
  stage<BK, DP, THREADS>(ph_s, phi, d, 0, k, 0, d, vec_d);
  stage<BK, VP, THREADS>(g_s, g, dv, 0, k, 0, dv, vec_v);
  cp_commit();

  // this thread's rows 16 w + lane / 4 + 8 h (m = 0, l = 1 past q)
  int row[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 16 * warp + (lane >> 2) + 8 * h;
    const bool ok = row[h] < q;
    m[h] = ok ? m_in[(size_t)b * q + row[h]] : 0.f;
    l[h] = ok ? l_in[(size_t)b * q + row[h]] : 1.f;
  }

  // at the BigGAN-deep-256 widths, this warp's theta and dO rows are held
  // as A fragments in registers (80 of them); on an H100 that was faster
  // there and slower at d = 32, dv = 128, where they stay in shared memory
  constexpr bool A_REGS = DP == 64 && VP == 256;
  uint32_t th_a[A_REGS ? DP / 16 : 1][4], do_a[A_REGS ? VP / 16 : 1][4];
  if constexpr (A_REGS) {
    cp_wait<0>();
    __syncthreads();
    load_a(th_a, th_w, LD);
    load_a(do_a, do_w, LV);
  }

  // S and dP of tile t for this warp's rows, in f32
  float s[NS][4], dp[NS][4];
  auto logits = [&](int t) {
    if (t + 1 < tiles) {
      const int nb = (t + 1) & 1;
      stage<BK, DP, THREADS>(ph_s + nb * BK * LD, phi, d, (t + 1) * BK, k, 0, d, vec_d);
      stage<BK, VP, THREADS>(g_s + nb * BK * LV, g, dv, (t + 1) * BK, k, 0, dv, vec_v);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    zero(s);
    zero(dp);
    if constexpr (A_REGS) {
      warp_mma16<NS, DP / 16, false, false>(s, th_a, th_a, ph_s + (t & 1) * BK * LD, LD);
      warp_mma16<NS, VP / 16, false, false>(dp, do_a, do_a, g_s + (t & 1) * BK * LV, LV);
    } else {
      warp_mma16<NS, DP, false>(s, th_w, nullptr, LD, ph_s + (t & 1) * BK * LD, LD);
      warp_mma16<NS, VP, false>(dp, do_w, nullptr, LV, g_s + (t & 1) * BK * LV, LV);
    }
  };

  // pass 1: delta, summed per thread in key order, then over the quad
  float dl[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    logits(t);
    const int key0 = t * BK + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key0 + 8 * j + e < k)
            dl[h] += prob(s[j][2 * h + e], m[h], l[h]) * dp[j][2 * h + e];
    __syncthreads();
  }

  // the first tile of pass 2 loads while delta is reduced
  stage<BK, DP, THREADS>(ph_s, phi, d, 0, k, 0, d, vec_d);
  stage<BK, VP, THREADS>(g_s, g, dv, 0, k, 0, dv, vec_v);
  cp_commit();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 1);
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 2);
    if ((lane & 3) == 0 && row[h] < q) delta_out[(size_t)b * q + row[h]] = dl[h];
  }

  // pass 2: dtheta += dS_hi . phi + dS_lo . phi. The accumulators of n-tiles
  // 2 kk and 2 kk + 1 of dS are the A fragment of k-step kk.
  float acc[ND][4];
  zero(acc);
  for (int t = 0; t < tiles; ++t) {
    logits(t);
    const int key0 = t * BK + 2 * (lane & 3);
    uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = key0 + 8 * j + e < k
                     ? prob(s[j][2 * h + e], m[h], l[h]) * (dp[j][2 * h + e] - dl[h])
                     : 0.f;
        split_pair(a_slot(hi, j, h), a_slot(lo, j, h), v[0], v[1]);
      }
    warp_mma16<ND, KS, true, true>(acc, hi, lo, ph_s + (t & 1) * BK * LD, LD);
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= q) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_pair(dtheta + ((size_t)b * q + row[h]) * d, 8 * j + 2 * (lane & 3), d,
                 acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Rows [q0, q0 + BQ) of the NSTAT f32 row statistics (m, l and delta) into
// dst[NSTAT][BQ] by 4-byte cp.async; zero past q, where every query is masked.
template <int BQ, int NSTAT, int THREADS>
__device__ __forceinline__ void stage_stats(float* dst, const float* m, const float* l,
                                            const float* delta, int q0, int q) {
  for (int i = threadIdx.x; i < NSTAT * BQ; i += THREADS) {
    const int a = i / BQ, r = i - a * BQ;
    const float* src = a == 0 ? m : a == 1 ? l : delta;
    const bool ok = q0 + r < q;
    cp_async4(dst + i, ok ? src + q0 + r : src, ok ? 4 : 0);
  }
}

// Backward (b): per block of 64 keys, dG = P_bf16^T . dO (columns of one dv
// chunk) and, in chunk 0, dphi = dS^T . theta with dS as hi + lo, summed over
// every query tile. Warp w: keys 16 (w % 4) and queries (BQ / 2) (w / 4) of
// S^T and dP^T; keys 16 (w / 2) and columns (VC / 2) (w % 2) of dG, (DP / 2)
// (w % 2) of dphi.
template <int DP, int VP, int VC, int BQ>
__global__ void __launch_bounds__(kTC)
bwd_dkv_mma_kernel(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
                   const bf16* __restrict__ g, const bf16* __restrict__ dout,
                   const float* __restrict__ m_in, const float* __restrict__ l_in,
                   const float* __restrict__ delta_in, bf16* __restrict__ dphi,
                   bf16* __restrict__ dg, int q, int k, int d, int dv, bool vec_d,
                   bool vec_v) {
  constexpr int LD = DP + kPad, LV = VP + kPad, LQ = BQ + kPad;
  constexpr int ND = DP / 16, NG = VC / 16, NQ = BQ / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ph_s = reinterpret_cast<bf16*>(smem_raw);      // [kRows][LD]
  bf16* g_s = ph_s + kRows * LD;                       // [kRows][LV]
  bf16* th_s = g_s + kRows * LV;                       // 2 x [BQ][LD]
  bf16* do_s = th_s + 2 * BQ * LD;                     // 2 x [BQ][LV]
  bf16* p_s = do_s + 2 * BQ * LV;                      // [kRows][LQ]
  bf16* dsh_s = p_s + kRows * LQ;                      // [kRows][LQ]
  bf16* dsl_s = dsh_s + kRows * LQ;                    // [kRows][LQ]
  float* st_s = reinterpret_cast<float*>(dsl_s + kRows * LQ);  // 2 x [3][BQ]

  const int b = blockIdx.y, k0 = blockIdx.x * kRows, c0 = blockIdx.z * VC;
  const bool with_dphi = blockIdx.z == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kr = 16 * (warp >> 1), gc = (VC / 2) * (warp & 1), pc = (DP / 2) * (warp & 1);
  theta += (size_t)b * q * d;
  dout += (size_t)b * q * dv;
  phi += (size_t)b * k * d;
  g += (size_t)b * k * dv;
  m_in += (size_t)b * q;
  l_in += (size_t)b * q;
  delta_in += (size_t)b * q;
  const int tiles = (q + BQ - 1) / BQ;

  // query tile t into buffer t % 2: theta, dO and the row statistics
  auto fetch = [&](int t) {
    const int nb = t & 1;
    stage<BQ, DP>(th_s + nb * BQ * LD, theta, d, t * BQ, q, 0, d, vec_d);
    stage<BQ, VP>(do_s + nb * BQ * LV, dout, dv, t * BQ, q, 0, dv, vec_v);
    stage_stats<BQ, 3, kTC>(st_s + nb * 3 * BQ, m_in, l_in, delta_in, t * BQ, q);
  };

  stage<kRows, DP>(ph_s, phi, d, k0, k, 0, d, vec_d);
  stage<kRows, VP>(g_s, g, dv, k0, k, 0, dv, vec_v);
  fetch(0);
  cp_commit();

  const int kg = 16 * (warp & 3), qh = (BQ / 2) * (warp >> 2);
  float acc_g[NG][4], acc_p[ND][4];
  zero(acc_g);
  zero(acc_p);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      fetch(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* th_t = th_s + (t & 1) * BQ * LD;
    const bf16* do_t = do_s + (t & 1) * BQ * LV;
    const float* st = st_s + (t & 1) * 3 * BQ;
    float s[NQ][4], dp[NQ][4];
    zero(s);
    zero(dp);
    warp_mma16<NQ, DP, false>(s, ph_s + kg * LD, nullptr, LD, th_t + qh * LD, LD);
    warp_mma16<NQ, VP, false>(dp, g_s + kg * LV, nullptr, LV, do_t + qh * LV, LV);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kg + (lane >> 2) + 8 * h;
      const bool key_ok = k0 + key < k;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = qh + 8 * j + 2 * (lane & 3);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qq = col + e;
          p[e] = ds[e] = 0.f;
          if (key_ok && t * BQ + qq < q) {
            p[e] = prob(s[j][2 * h + e], st[qq], st[BQ + qq]);
            ds[e] = p[e] * (dp[j][2 * h + e] - st[2 * BQ + qq]);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(p_s + key * LQ + col) =
            __floats2bfloat162_rn(p[0], p[1]);
        store_split(dsh_s + key * LQ, dsl_s + key * LQ, col, ds[0], ds[1]);
      }
    }
    __syncthreads();
    warp_mma16<NG, BQ, true>(acc_g, p_s + kr * LQ, nullptr, LQ, do_t + c0 + gc, LV);
    if (with_dphi)
      warp_mma16<ND, BQ, true, true>(acc_p, dsh_s + kr * LQ, dsl_s + kr * LQ, LQ,
                                     th_t + pc, LD);
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr + (lane >> 2) + 8 * h;
    if (key >= k) continue;
#pragma unroll
    for (int j = 0; j < NG; ++j)
      store_pair(dg + ((size_t)b * k + key) * dv, c0 + gc + 8 * j + 2 * (lane & 3),
                 dv, acc_g[j][2 * h], acc_g[j][2 * h + 1]);
    if (with_dphi) {
#pragma unroll
      for (int j = 0; j < ND; ++j)
        store_pair(dphi + ((size_t)b * k + key) * d, pc + 8 * j + 2 * (lane & 3), d,
                   acc_p[j][2 * h], acc_p[j][2 * h + 1]);
    }
  }
}

// Launch arguments of the bf16 route.
struct MmaArgs {
  const bf16 *theta, *phi, *g, *dout;
  bf16 *o, *dtheta, *dphi, *dg;
  float *m, *l, *delta;
  double* work;  // MmaWork's output: forward and backward FLOPs
  int n, q, k, d, dv;
  bool vec_d, vec_v;
  cudaStream_t stream;
};

constexpr size_t tile_bytes(int rows, int cols) {
  return sizeof(bf16) * (size_t)rows * (cols + kPad);
}

// Padded widths: d to DP in {16, 32, 64, 128}, dv to VP in {64, ..., 512};
// dv chunks of VC = min(VP, 256) columns.
int dp_for(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }
int vp_for(int dv) { return dv <= 64 ? 64 : dv <= 128 ? 128 : dv <= 256 ? 256 : 512; }

// Shared memory of the dkv kernel with BQ-query tiles.
constexpr size_t dkv_smem(int DP, int VP, int BQ) {
  return tile_bytes(kRows, DP) + tile_bytes(kRows, VP) + 2 * tile_bytes(BQ, DP) +
         2 * tile_bytes(BQ, VP) + 3 * tile_bytes(kRows, BQ) + sizeof(float) * 6 * BQ;
}

// Tiles of the bf16 route at padded widths DP, VP: read by the launchers and
// by the work count alike.
template <int DP, int VP>
struct Tiles {
  static constexpr int VC = VP < 256 ? VP : 256;  // dv chunk of a forward or dkv block
  // dq: 8 warps of 16 query rows against 64-key tiles; where dv is 512,
  // 4 warps and 32-key tiles, to stay within shared memory
  static constexpr int BK = VP > 256 ? 32 : 64;
  static constexpr int WARPS = VP > 256 ? 4 : 8, ROWS = 16 * WARPS;
  // dkv: 64-query tiles where two blocks (each with 1 KB reserved) still
  // fit on an SM, else 32
  static constexpr int BQ = dkv_smem(DP, VP, 64) + 1024 <= kSmemPerSM / 2 ? 64 : 32;
};

struct MmaFwd {
  template <int DP, int VP>
  static cudaError_t run(const MmaArgs& a) {
    constexpr int VC = Tiles<DP, VP>::VC;
    const size_t smem = tile_bytes(kRows, DP) + 2 * tile_bytes(kKeys, DP) +
                        2 * tile_bytes(kKeys, VC) + tile_bytes(kRows, kKeys) +
                        sizeof(float) * 10 * kRows;
    cudaError_t err = allow_smem(fwd_mma_kernel<DP, VC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.q + kRows - 1) / kRows, a.n, VP / VC);
    fwd_mma_kernel<DP, VC><<<grid, kTC, smem, a.stream>>>(
        a.theta, a.phi, a.g, a.o, a.m, a.l, a.q, a.k, a.d, a.dv, a.vec_d, a.vec_v);
    return cudaGetLastError();
  }
};

struct MmaBwd {
  template <int DP, int VP>
  static cudaError_t run(const MmaArgs& a) {
    using T = Tiles<DP, VP>;
    constexpr int BK = T::BK, WARPS = T::WARPS, ROWS = T::ROWS, VC = T::VC, BQ = T::BQ;
    const size_t smem_dq = tile_bytes(ROWS, DP) + tile_bytes(ROWS, VP) +
                           2 * tile_bytes(BK, DP) + 2 * tile_bytes(BK, VP);
    cudaError_t err = allow_smem(bwd_dq_mma_kernel<DP, VP, BK, WARPS>, smem_dq);
    if (err != cudaSuccess) return err;
    bwd_dq_mma_kernel<DP, VP, BK, WARPS>
        <<<dim3((a.q + ROWS - 1) / ROWS, a.n), 32 * WARPS, smem_dq, a.stream>>>(
            a.theta, a.phi, a.g, a.dout, a.m, a.l, a.delta, a.dtheta, a.q, a.k,
            a.d, a.dv, a.vec_d, a.vec_v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t smem_dkv = dkv_smem(DP, VP, BQ);
    err = allow_smem(bwd_dkv_mma_kernel<DP, VP, VC, BQ>, smem_dkv);
    if (err != cudaSuccess) return err;
    bwd_dkv_mma_kernel<DP, VP, VC, BQ>
        <<<dim3((a.k + kRows - 1) / kRows, a.n, VP / VC), kTC, smem_dkv, a.stream>>>(
            a.theta, a.phi, a.g, a.dout, a.m, a.l, a.delta, a.dphi, a.dg, a.q, a.k,
            a.d, a.dv, a.vec_d, a.vec_v);
    return cudaGetLastError();
  }
};

// x rounded up to a multiple of the tile t.
double up(int x, int t) { return (double)((x + t - 1) / t) * t; }

// The FLOPs the bf16 kernels do, padding included, reached through the same
// dispatch as MmaFwd and MmaBwd: the forward computes S in both passes per dv
// chunk and P . g once; dq computes S and dP in pass 1, and S, dP and dS . phi
// as hi + lo in pass 2; dkv computes S^T, dP^T and P^T . dO per dv chunk, and
// dS^T . theta as hi + lo in chunk 0.
struct MmaWork {
  template <int DP, int VP>
  static cudaError_t run(const MmaArgs& a) {
    using T = Tiles<DP, VP>;
    constexpr int chunks = VP / T::VC;
    const double n2 = 2.0 * a.n;
    a.work[0] = n2 * up(a.q, kRows) * up(a.k, kKeys) * (2 * DP * chunks + VP);
    a.work[1] = n2 * up(a.q, T::ROWS) * up(a.k, T::BK) * (4 * DP + 2 * VP) +
                n2 * up(a.k, kRows) * up(a.q, T::BQ) * (chunks * (DP + VP + T::VC) + 2 * DP);
    return cudaSuccess;
  }
};

template <class Op, int DP>
cudaError_t mma_by_dv(const MmaArgs& a) {
  switch (vp_for(a.dv)) {
    case 64: return Op::template run<DP, 64>(a);
    case 128: return Op::template run<DP, 128>(a);
    case 256: return Op::template run<DP, 256>(a);
    default: return Op::template run<DP, 512>(a);
  }
}

template <class Op>
cudaError_t mma_launch(const MmaArgs& a) {
  switch (dp_for(a.d)) {
    case 16: return mma_by_dv<Op, 16>(a);
    case 32: return mma_by_dv<Op, 32>(a);
    case 64: return mma_by_dv<Op, 64>(a);
    default: return mma_by_dv<Op, 128>(a);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

MmaArgs mma_args(const void* theta, const void* phi, const void* g, const void* dout,
                 int n, int q, int k, int d, int dv, void* stream) {
  MmaArgs a = {};
  a.theta = (const bf16*)theta;
  a.phi = (const bf16*)phi;
  a.g = (const bf16*)g;
  a.dout = (const bf16*)dout;
  a.n = n, a.q = q, a.k = k, a.d = d, a.dv = dv;
  a.vec_d = d % 8 == 0 && aligned16(theta) && aligned16(phi);
  a.vec_v = dv % 8 == 0 && aligned16(g) && (dout == nullptr || aligned16(dout));
  a.stream = (cudaStream_t)stream;
  return a;
}

bool bad_shape(int n, int q, int k, int d, int dv) {
  return n < 1 || n > 65535 || q < 1 || k < 1 || d < 1 || d > 128 || dv < 1 ||
         dv > 512;
}

}  // namespace

extern "C" {

// o [n, q, dv] in the input type; m, l [n, q] f32 row statistics.
int sagan_attention_fwd(const void* theta, const void* phi, const void* g, void* o,
                        void* m, void* l, int n, int q, int k, int d, int dv,
                        int is_bf16, void* stream) {
  if (bad_shape(n, q, k, d, dv)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    MmaArgs a = mma_args(theta, phi, g, nullptr, n, q, k, d, dv, stream);
    a.o = (bf16*)o;
    a.m = (float*)m;
    a.l = (float*)l;
    return (int)mma_launch<MmaFwd>(a);
  }
  return (int)fma_fwd((const float*)theta, (const float*)phi, (const float*)g,
                      (float*)o, (float*)m, (float*)l, n, q, k, d, dv,
                      (cudaStream_t)stream);
}

// dtheta [n, q, d], dphi [n, k, d], dg [n, k, dv] in the input type; delta
// [n, q] f32 scratch; m, l from sagan_attention_fwd.
int sagan_attention_bwd(const void* theta, const void* phi, const void* g,
                        const void* dout, const void* m, const void* l, void* delta,
                        void* dtheta, void* dphi, void* dg, int n, int q, int k,
                        int d, int dv, int is_bf16, void* stream) {
  if (bad_shape(n, q, k, d, dv)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    MmaArgs a = mma_args(theta, phi, g, dout, n, q, k, d, dv, stream);
    a.m = (float*)m;
    a.l = (float*)l;
    a.delta = (float*)delta;
    a.dtheta = (bf16*)dtheta;
    a.dphi = (bf16*)dphi;
    a.dg = (bf16*)dg;
    return (int)mma_launch<MmaBwd>(a);
  }
  return (int)fma_bwd((const float*)theta, (const float*)phi, (const float*)g,
                      (const float*)dout, (const float*)m, (const float*)l,
                      (float*)delta, (float*)dtheta, (float*)dphi, (float*)dg, n, q,
                      k, d, dv, (cudaStream_t)stream);
}

// work[0], work[1]: the FLOPs that sagan_attention_fwd and sagan_attention_bwd
// do for this type at this shape, tile padding included (MmaWork for bf16).
// The FMA kernels pad q and k to their 32-row tiles and do S twice and P . g
// forward; S and dP in each dq pass and dS . phi, S, dP, P^T . dO and
// dS^T . theta in dkv backward. Launches nothing.
int sagan_attention_work(int n, int q, int k, int d, int dv, int is_bf16, double* work) {
  if (bad_shape(n, q, k, d, dv)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    MmaArgs a = mma_args(nullptr, nullptr, nullptr, nullptr, n, q, k, d, dv, nullptr);
    a.work = work;
    return (int)mma_launch<MmaWork>(a);
  }
  const double u = 2.0 * n * up(q, kBQ) * up(k, kBK);
  work[0] = u * (2 * d + dv);
  work[1] = u * (5 * d + 4 * dv);
  return 0;
}

}  // extern "C"
