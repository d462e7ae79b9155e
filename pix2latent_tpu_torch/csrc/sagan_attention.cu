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
//   bfloat16 -> fwd_mma_kernel, bwd_dq_mma_kernel and bwd_dkv_mma_kernel:
//               mma.sync m16n8k16, bf16 in, f32 sums;
//   float32  -> fwd_tf32_kernel, bwd_dq_tf32_kernel and bwd_dkv_tf32_kernel:
//               3xTF32 on mma.sync m16n8k8 (tf32 in, f32 sums), which keeps
//               f32 accuracy (see the f32 design below).
//
// Bound on an H100 SXM at the BigGAN-deep-256 shape, with U = 2 n q k =
// 1.51e8: the forward needs U (d + dv) = 48.3 GFLOP, 49 us at the 989
// TFLOP/s bf16 tensor-core rate; the backward U (3d + 2dv) = 106 GFLOP,
// 107 us. In f32 the same operations bound the route at the 495 TFLOP/s
// dense TF32 rate, as if each f32 product cost one TF32 product: 98 and
// 215 us. Memory traffic is about 59 MB forward and 92 MB backward in bf16
// (twice that in f32), 18 and 27 us at 3.35 TB/s, so the work is bound by
// operations.
//
// Work the bf16 design does at that shape (d is padded to 16, 32, 64 or 128,
// dv to 64, ..., 512, and q and k to the tiles; at that shape nothing is
// padded):
//   forward  U (2d + dv) = 58.0 GFLOP: S in both passes, P . g once;
//   backward U (7d + 4dv) = 222 GFLOP: dq pass 1 U (d + dv) (S, dP), dq pass
//            2 U (3d + dv) (S, dP, dS . phi as hi + lo), dkv U (3d + 2dv)
//            (S^T, dP^T, P^T . dO, dS^T . theta as hi + lo).
// The f32 design forms each product once, three times over (3xTF32): 3 U
// (d + dv) = 145 GFLOP forward and 3 U (3d + 2dv) = 319 GFLOP backward (dkv
// 3 U (2d + 2dv), dq 3 U d), counted as tensor-core FLOPs. sagan_attention_
// work returns these counts at any shape, from the tiles the launchers use.
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
// Design of the f32 route: the bf16 route's passes, warp tiles, cp.async
// double buffering and reduction orders, with f32 tiles and every product
// in 3xTF32 (the split of CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// f32 memory-efficient attention runs): each f32 operand a is split once,
// as it is read from shared memory, into
// hi = rna_tf32(a) and lo = a - hi (split_tf32), and each product is
// lo . hi + hi . lo + hi . hi on mma.sync m16n8k8, summed in f32.
// The dropped lo . lo term is below f32's rounding, so the route keeps the
// f32 tolerances against the plain version; one tf32 product would not
// (tests/test_torch_attention.py emulates both).
//   * tiles: f32 rows padded by 4 floats (16 bytes), P and dS rows by 8;
//     ldmatrix moves 16-bit pairs, so fragments come from 32-bit shared
//     loads (64-bit for P and dS), conflict-free on those paddings. An
//     operand read along its rows takes k index t + 4 j in fragment slot j,
//     one read down its columns (or a P or dS tile, written from an
//     accumulator's column pairs) 2 t + j, and a product's two operands take
//     the same one.
//   * sizes: f32 tiles take twice the bytes, so the widths decide (Tf32Tiles):
//     at d = 64, dv = 256 the forward keeps one dv chunk of 256 (206 KB of
//     shared memory) and dkv 32-query tiles (189 KB), one block an SM each;
//     dkv splits a key block's query tiles between the two blocks of a
//     cluster, which sum through distributed shared memory (2.2 waves of
//     blocks become 4.4 of half-size ones); dq takes 102 KB, two blocks.
//   * the tensor cores' f32 sums truncate; across the 16 key tiles of the
//     forward's P . g their error reached the f32 tolerance, so each tile's
//     P . g has accumulators of its own, added to O by rounded f32 FMAs.
//   * one pass in the forward: in f32 rounding p to g's type is the identity,
//     so the forward is an online softmax normalised at the end (fwd_tf32_
//     kernel), which changes only the f32 rounding order and saves the U d
//     of a second S.
//   * three backward kernels: the f32 output is not rounded, so delta =
//     rowsum(dP * P) = rowsum(dO * O) comes from dO and O (delta_tf32_
//     kernel; the C entry takes O for this); dkv stores dS key-major to
//     device memory (0.3 GB at the BigGAN-deep-256 shape); dq is dS . phi.
//     No S or dP is formed twice, where the bf16 route's dq forms both in
//     two passes.
//   * dS needs no bf16 hi + lo: the tf32 split of dS takes its place. Query
//     rows past q still get p = 0 and dS = 0 explicitly.
//
// C interface, bound from Python with ctypes: each entry returns the
// cudaError_t of its launches (0 on success) and does not synchronise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kFPad = 4;   // f32 elements of padding after each input-tile row
constexpr int kSPad = 8;   // after each row of a P or dS tile
constexpr int kDkvSplit = 2;  // blocks (one cluster) that share a dkv key block
constexpr size_t kBlockSmem = 232448;  // the most shared memory a block can have

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major f32 matrix
// (`limit` rows, `width` columns, row stride `ld`) into shared memory with
// row stride COLS + kFPad; elements past `limit` or `width` read as 0. With
// `vec` (ld, width and c0 multiples of 4, base 16-byte aligned) by 16-byte
// cp.async, otherwise by 4-byte cp.async; zero-filled by the source size.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int ld, int r0,
                                          int limit, int c0, int width, bool vec) {
  constexpr int kChunks = COLS / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const int gr = r0 + r, gc = c0 + c;
    float* out = dst + r * (COLS + kFPad) + c;
    if (vec) {
      const bool ok = gr < limit && gc < width;
      cp_async16(out, ok ? src + (size_t)gr * ld + gc : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gr < limit && gc + e < width;
        cp_async4(out + e, ok ? src + (size_t)gr * ld + gc + e : src, ok ? 4 : 0);
      }
    }
  }
}

// x as the tf32 pair hi + lo. hi = x rounded to tf32, to nearest with ties
// away from zero: the rounding of cvt.rna.tf32.f32, done by adding half a
// tf32 ulp to the sign-magnitude bits and masking the 13 low bits, which
// gives the same bits in two integer operations (cvt.rna costs more on
// sm_90a). lo = x - hi is exact in f32 and is passed as it is: the tensor
// core reads a tf32 operand's upper 19 bits, so lo enters rounded toward
// zero, and hi + lo carries 21 of x's 24 significant bits. A NaN x whose
// payload carries out of the add (CUDA's 0x7fffffff does) gives hi = -0 or
// +0, and then lo = x - hi is that NaN, so the product stays NaN.
__device__ __forceinline__ void split_tf32(uint32_t& hi, uint32_t& lo, float x) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: lo . hi + hi . lo + hi . hi, the small terms first
// (lo . lo lies below f32's rounding and is left out).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Fragments of m16n8k8 in tf32, lane = 4 g + t. The k index of register
// slot j is t + 4 j ("standard") for an operand read along the rows of a
// tile stored [rows][k], and 2 t + j ("paired") for one read down the
// columns of a tile stored [k][rows] and for A from a P or dS tile, whose
// rows an accumulator wrote in column pairs 2 t, 2 t + 1 (k slots 0 and 1).
// A product uses one convention for both operands (the sum over k does not
// depend on it). Input tiles have rows of width + 4 floats (4 mod 32), so
// the standard reads hit banks 4 g + t and the paired ones 8 t + g; P and
// dS tiles rows of width + 8 (8 mod 32), read 8 bytes at a time at 8 g + 2 t.

// A (16 rows, k0 .. k0 + 8) from a tile stored [rows][k], standard, split.
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* a,
                                       int lda, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = a + (lane >> 2) * lda + k0 + (lane & 3);
  split_tf32(hi[0], lo[0], p[0]);
  split_tf32(hi[1], lo[1], p[8 * lda]);
  split_tf32(hi[2], lo[2], p[4]);
  split_tf32(hi[3], lo[3], p[8 * lda + 4]);
}

// A from a P or dS tile, paired, split.
__device__ __forceinline__ void frag_a_paired(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float* a, int lda, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = a + (lane >> 2) * lda + k0 + 2 * (lane & 3);
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * lda);
  split_tf32(hi[0], lo[0], v0.x);
  split_tf32(hi[2], lo[2], v0.y);
  split_tf32(hi[1], lo[1], v1.x);
  split_tf32(hi[3], lo[3], v1.y);
}

// B (k0 .. k0 + 8 by columns n0 .. n0 + 8), split: with B_ROWS from a tile
// stored [k][n] (row stride ldb), paired; otherwise stored [n][k], standard.
template <bool B_ROWS>
__device__ __forceinline__ void frag_b(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* b,
                                       int ldb, int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (B_ROWS) {
    const float* p = b + (k0 + 2 * t) * ldb + n0 + g;
    split_tf32(hi[0], lo[0], p[0]);
    split_tf32(hi[1], lo[1], p[ldb]);
  } else {
    const float* p = b + (n0 + g) * ldb + k0 + t;
    split_tf32(hi[0], lo[0], p[0]);
    split_tf32(hi[1], lo[1], p[4]);
  }
}

// One warp: acc[i][j] += A[16 i + 0..16)[0..K) . B[0..K)[8 j + 0..8) for
// i < MT, j < NT, in 3xTF32. A lies in shared memory: a P or dS tile (paired)
// where B_ROWS, else a tile stored [rows][k] (standard); B as in frag_b.
// Accumulator element acc[i][j][2 h + e] is row 16 i + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e.
template <int MT, int NT, int K, bool B_ROWS>
__device__ __forceinline__ void warp_mma3(float (&acc)[MT][NT][4], const float* a, int lda,
                                          const float* b, int ldb) {
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (B_ROWS)
        frag_a_paired(ah[i], al[i], a + 16 * i * lda, lda, k0);
      else
        frag_a(ah[i], al[i], a + 16 * i * lda, lda, k0);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      frag_b<B_ROWS>(bh, bl, b, ldb, 8 * j, k0);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl);
    }
  }
}

// warp_mma3 for one warp of 16 rows.
template <int NT, int K, bool B_ROWS>
__device__ __forceinline__ void warp_mma3_16(float (&acc)[NT][4], const float* a, int lda,
                                             const float* b, int ldb) {
  warp_mma3<1, NT, K, B_ROWS>(*reinterpret_cast<float(*)[1][NT][4]>(&acc), a, lda, b, ldb);
}

// The pair (v0, v1) into row[col], row[col + 1], columns at or past `width`
// left alone.
__device__ __forceinline__ void store_pair(float* row, int col, int width, float v0,
                                           float v1) {
  if ((width & 1) == 0 && col + 1 < width) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < width) row[col] = v0;
    if (col + 1 < width) row[col + 1] = v1;
  }
}

// Forward in f32: fwd_mma_kernel's warp tiles with f32 tiles and 3xTF32
// products, in one pass. In f32, rounding p to g's type is the identity, so
// the output may be normalised at the end (an online softmax): per key tile,
// the 4 warps of a row block share their row maxima through shared memory,
// every thread takes the same new maximum m' in the same order, forms
// p = exp(s - m') for the P . g product, rescales its O accumulators and
// its row sums l by exp(m - m') and adds the tile's row sums. S is computed
// once, not in two passes; o = acc / l at the end.
template <int DP, int VC>
__global__ void __launch_bounds__(kTC)
fwd_tf32_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                const float* __restrict__ g, float* __restrict__ o,
                float* __restrict__ m_out, float* __restrict__ l_out, int q, int k, int d,
                int dv, bool vec_d, bool vec_v) {
  constexpr int LD = DP + kFPad, LV = VC + kFPad, LP = kKeys + kSPad;
  constexpr int NO = VC / 32;
  constexpr int ROWS = kRows, THREADS = kTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* th_s = reinterpret_cast<float*>(smem_raw);   // [ROWS][LD]
  float* ph_s = th_s + ROWS * LD;                     // 2 x [kKeys][LD]
  float* g_s = ph_s + 2 * kKeys * LD;                 // 2 x [kKeys][LV]
  float* p_s = g_s + 2 * kKeys * LV;                  // [ROWS][LP]
  float* part_m = p_s + ROWS * LP;                    // [4][ROWS]
  float* part_l = part_m + 4 * ROWS;                  // [4][ROWS]

  const int b = blockIdx.y, q0 = blockIdx.x * ROWS, c0 = blockIdx.z * VC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  const int key_w = 16 * wc, col_w = (VC / 4) * wc;
  theta += (size_t)b * q * d;
  phi += (size_t)b * k * d;
  g += (size_t)b * k * dv;
  o += (size_t)b * q * dv;
  const int tiles = (k + kKeys - 1) / kKeys;
  const float* th_w = th_s + 32 * wr * LD;

  stage_f32<ROWS, DP, THREADS>(th_s, theta, d, q0, q, 0, d, vec_d);
  stage_f32<kKeys, DP, THREADS>(ph_s, phi, d, 0, k, 0, d, vec_d);
  stage_f32<kKeys, VC, THREADS>(g_s, g, dv, 0, k, c0, dv, vec_v);
  cp_commit();

  // this thread's rows 32 wr + 16 i + lane / 4 + 8 h, in S and in O alike:
  // running maximum m, row sum l of exp(s - m), and O
  float mr[2][2], lr[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) mr[i][h] = -INFINITY, lr[i][h] = 0.f;
  float acc[2][NO][4];
  zero(acc);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int nb = (t + 1) & 1;
      stage_f32<kKeys, DP, THREADS>(ph_s + nb * kKeys * LD, phi, d, (t + 1) * kKeys, k, 0,
                                    d, vec_d);
      stage_f32<kKeys, VC, THREADS>(g_s + nb * kKeys * LV, g, dv, (t + 1) * kKeys, k, c0,
                                    dv, vec_v);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[2][2][4];
    zero(s);
    warp_mma3<2, 2, DP, false>(s, th_w, LD, ph_s + (t & 1) * kKeys * LD + key_w * LD, LD);
    const int key0 = t * kKeys + key_w + 2 * (lane & 3);
    // the tile's row maxima over this warp's 16 keys (keys past k left out)
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
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if ((lane & 3) == 0) part_m[wc * ROWS + 32 * wr + 16 * i + (lane >> 2) + 8 * h] = mx;
      }
    __syncthreads();
    // the new maximum over the 4 warps, p = exp(s - m') into P and the
    // tile's row sums over this warp's keys
    float scale[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wr + 16 * i + (lane >> 2) + 8 * h;
        float mn = mr[i][h];
#pragma unroll
        for (int w = 0; w < 4; ++w) mn = fmaxf(mn, part_m[w * ROWS + row]);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = key0 + 8 * j;
          const float p0 = key < k ? expf(s[i][j][2 * h] - mn) : 0.f;
          const float p1 = key + 1 < k ? expf(s[i][j][2 * h + 1] - mn) : 0.f;
          sum += p0 + p1;
          *reinterpret_cast<float2*>(p_s + row * LP + key_w + 8 * j + 2 * (lane & 3)) =
              make_float2(p0, p1);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if ((lane & 3) == 0) part_l[wc * ROWS + row] = sum;
        scale[i][h] = expf(mr[i][h] - mn);   // 0 at the first tile
        mr[i][h] = mn;
      }
    __syncthreads();
    // the tile's P . g in accumulators of its own, added to the rescaled O
    // by rounded f32 FMAs: the tensor cores' f32 sums truncate, and across
    // all the key tiles their error would grow to the f32 tolerance
    float pv[2][NO][4];
    zero(pv);
    warp_mma3<2, NO, kKeys, true>(pv, p_s + 32 * wr * LP, LP,
                                  g_s + (t & 1) * kKeys * LV + col_w, LV);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wr + 16 * i + (lane >> 2) + 8 * h;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) sum += part_l[w * ROWS + row];
        lr[i][h] = lr[i][h] * scale[i][h] + sum;
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[i][j][2 * h + e] = fmaf(acc[i][j][2 * h + e], scale[i][h], pv[i][j][2 * h + e]);
      }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 32 * wr + 16 * i + (lane >> 2) + 8 * h;
      if (row >= q) continue;
      const float l = lr[i][h];
      if (wc == 0 && blockIdx.z == 0 && (lane & 3) == 0) {
        m_out[(size_t)b * q + row] = mr[i][h];
        l_out[(size_t)b * q + row] = l;
      }
#pragma unroll
      for (int j = 0; j < NO; ++j)
        store_pair(o + (size_t)row * dv, c0 + col_w + 8 * j + 2 * (lane & 3), dv,
                   acc[i][j][2 * h] / l, acc[i][j][2 * h + 1] / l);
    }
}

// Backward in f32, three kernels: delta_tf32_kernel, then bwd_dkv_tf32_kernel,
// which also stores dS, then bwd_dq_tf32_kernel, dtheta = dS . phi. The bf16
// route recomputes S and dP in its dq kernel (twice, for delta and for dS);
// here dkv's dS goes through device memory (n k q f32 values, key-major as
// dkv holds it, 0.3 GB at the BigGAN-deep-256 shape, written once and read
// once), so every product is formed once: 3 U (3d + 2dv) tensor-core FLOPs,
// three times the least.

// delta = rowsum(dP * P) = rowsum(dO * (P . g)) = rowsum(dO * O): the f32
// forward's output is not rounded, so delta comes from dO and O. One warp a
// row: f32 products summed per lane in column order, then over the warp in a
// fixed tree.
__global__ void __launch_bounds__(256)
delta_tf32_kernel(const float* __restrict__ dout, const float* __restrict__ o,
                  float* __restrict__ delta, int rows, int dv) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  float sum = 0.f;
  for (int c = lane; c < dv; c += 32) sum += dout[(size_t)row * dv + c] * o[(size_t)row * dv + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// dtheta = dS . phi for 128 query rows a block (8 warps of 16 rows), over
// 64-key tiles of dS^T ([key][query], read down its columns, paired) and
// phi (read by its rows, paired), staged by cp.async into two buffers.
template <int DP>
__global__ void __launch_bounds__(kTC)
bwd_dq_tf32_kernel(const float* __restrict__ ds_t, const float* __restrict__ phi,
                   float* __restrict__ dtheta, int q, int k, int d, bool vec_d,
                   bool vec_q) {
  constexpr int ROWS = 128, BK = 64, LQ = ROWS + kFPad, LD = DP + kFPad, ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ds_s = reinterpret_cast<float*>(smem_raw);   // 2 x [BK][LQ]
  float* ph_s = ds_s + 2 * BK * LQ;                   // 2 x [BK][LD]

  const int b = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ds_t += (size_t)b * k * q;
  phi += (size_t)b * k * d;
  const int tiles = (k + BK - 1) / BK;

  auto fetch = [&](int t) {
    const int nb = t & 1;
    stage_f32<BK, ROWS, kTC>(ds_s + nb * BK * LQ, ds_t, q, t * BK, k, q0, q, vec_q);
    stage_f32<BK, DP, kTC>(ph_s + nb * BK * LD, phi, d, t * BK, k, 0, d, vec_d);
  };
  fetch(0);
  cp_commit();

  float acc[ND][4];
  zero(acc);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      fetch(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // A: this warp's 16 query rows of dS, k-step k0 of the keys, read down
    // the columns of dS^T (paired: keys 2 t and 2 t + 1; banks 8 t + g)
    const float* a = ds_s + (t & 1) * BK * LQ + 16 * warp + (lane >> 2);
#pragma unroll 4
    for (int k0 = 0; k0 < BK; k0 += 8) {
      const float* p = a + (k0 + 2 * (lane & 3)) * LQ;
      uint32_t ah[4], al[4];
      split_tf32(ah[0], al[0], p[0]);
      split_tf32(ah[1], al[1], p[8]);
      split_tf32(ah[2], al[2], p[LQ]);
      split_tf32(ah[3], al[3], p[LQ + 8]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t bh[2], bl[2];
        frag_b<true>(bh, bl, ph_s + (t & 1) * BK * LD, LD, 8 * j, k0);
        mma3(acc[j], ah, al, bh, bl);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= q) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_pair(dtheta + ((size_t)b * q + row) * d, 8 * j + 2 * (lane & 3), d,
                 acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Backward (b) in f32: bwd_dkv_mma_kernel's loop with f32 tiles and 3xTF32
// products; P^T and dS^T pass through shared memory in f32 (no hi + lo: the
// tf32 split of every operand takes its place). With NBUF = 1 (the widest
// heads) the query tiles are staged into one buffer.
// The query tiles of a key block are shared by the kDkvSplit blocks of a
// cluster, in rank order: one block of 64 keys a (key block, sample) pair
// would give 288 blocks at the BigGAN-deep-256 shape, 2.2 waves of one block
// an SM. After the loop the other ranks leave their dG and dphi sums in
// their shared memory, and rank 0 adds them to its own through distributed
// shared memory, in rank order, and writes the result.
template <int DP, int VP, int VC, int BQ, int NBUF>
__global__ void __launch_bounds__(kTC)
bwd_dkv_tf32_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                    const float* __restrict__ g, const float* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    const float* __restrict__ delta_in, float* __restrict__ dphi,
                    float* __restrict__ dg, float* __restrict__ ds_out, int q, int k,
                    int d, int dv, bool vec_d, bool vec_v) {
  constexpr int LD = DP + kFPad, LV = VP + kFPad, LQ = BQ + kSPad;
  constexpr int ND = DP / 16, NG = VC / 16, NQ = BQ / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ph_s = reinterpret_cast<float*>(smem_raw);   // [kRows][LD]
  float* g_s = ph_s + kRows * LD;                     // [kRows][LV]
  float* th_s = g_s + kRows * LV;                     // NBUF x [BQ][LD]
  float* do_s = th_s + NBUF * BQ * LD;                // NBUF x [BQ][LV]
  float* p_s = do_s + NBUF * BQ * LV;                 // [kRows][LQ]
  float* ds_s = p_s + kRows * LQ;                     // [kRows][LQ]
  float* st_s = ds_s + kRows * LQ;                    // NBUF x [3][BQ]
  float* sums = ph_s;  // after the loop: [NG + ND][4][kTC], a rank's sums

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y, k0 = (blockIdx.x / kDkvSplit) * kRows, c0 = blockIdx.z * VC;
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
  ds_out += (size_t)b * k * q;
  const int all_tiles = (q + BQ - 1) / BQ;
  const int share = (all_tiles + kDkvSplit - 1) / kDkvSplit;
  const int t0 = min(all_tiles, rank * share), t1 = min(all_tiles, t0 + share);

  // query tile t into buffer (t - t0) % NBUF: theta, dO and the row statistics
  auto fetch = [&](int t) {
    const int nb = (t - t0) % NBUF;
    stage_f32<BQ, DP, kTC>(th_s + nb * BQ * LD, theta, d, t * BQ, q, 0, d, vec_d);
    stage_f32<BQ, VP, kTC>(do_s + nb * BQ * LV, dout, dv, t * BQ, q, 0, dv, vec_v);
    stage_stats<BQ, 3, kTC>(st_s + nb * 3 * BQ, m_in, l_in, delta_in, t * BQ, q);
  };

  stage_f32<kRows, DP, kTC>(ph_s, phi, d, k0, k, 0, d, vec_d);
  stage_f32<kRows, VP, kTC>(g_s, g, dv, k0, k, 0, dv, vec_v);
  if (t0 < t1) fetch(t0);
  cp_commit();

  const int kg = 16 * (warp & 3), qh = (BQ / 2) * (warp >> 2);
  float acc_g[NG][4], acc_p[ND][4];
  zero(acc_g);
  zero(acc_p);
  for (int t = t0; t < t1; ++t) {
    if (NBUF == 2 && t + 1 < t1) {
      fetch(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      if (NBUF == 1 && t > t0) {
        fetch(t);
        cp_commit();
      }
      cp_wait<0>();
    }
    __syncthreads();
    const int nb = (t - t0) % NBUF;
    const float* th_t = th_s + nb * BQ * LD;
    const float* do_t = do_s + nb * BQ * LV;
    const float* st = st_s + nb * 3 * BQ;
    float s[NQ][4], dp[NQ][4];
    zero(s);
    zero(dp);
    warp_mma3_16<NQ, DP, false>(s, ph_s + kg * LD, LD, th_t + qh * LD, LD);
    warp_mma3_16<NQ, VP, false>(dp, g_s + kg * LV, LV, do_t + qh * LV, LV);
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
        *reinterpret_cast<float2*>(p_s + key * LQ + col) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(ds_s + key * LQ + col) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();
    // dS of this tile to device memory for dq, key-major as it lies here
    // ([key][query]: BQ queries of a key row a pass; chunk 0 only, every
    // chunk forms it)
    if (with_dphi) {
      for (int i = threadIdx.x; i < kRows * BQ; i += kTC) {
        const int key = i / BQ, qq = i - key * BQ;
        if (k0 + key < k && t * BQ + qq < q)
          ds_out[(size_t)(k0 + key) * q + t * BQ + qq] = ds_s[key * LQ + qq];
      }
    }
    warp_mma3_16<NG, BQ, true>(acc_g, p_s + kr * LQ, LQ, do_t + c0 + gc, LV);
    if (with_dphi) warp_mma3_16<ND, BQ, true>(acc_p, ds_s + kr * LQ, LQ, th_t + pc, LD);
    __syncthreads();
  }

  // the other ranks' sums to their shared memory (phi's and g's tiles are
  // done with: 64 (DP + VP + 8) floats hold (NG + ND) 4 kTC), rank 0 adds them
  cp_wait<0>();
  __syncthreads();
  if (rank > 0) {
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[(j * 4 + e) * kTC + threadIdx.x] = acc_g[j][e];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[((NG + j) * 4 + e) * kTC + threadIdx.x] = acc_p[j][e];
  }
  cluster.sync();
  if (rank == 0) {
    for (int r = 1; r < kDkvSplit; ++r) {
      const float* other = cluster.map_shared_rank(sums, r);
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_g[j][e] += other[(j * 4 + e) * kTC + threadIdx.x];
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_p[j][e] += other[((NG + j) * 4 + e) * kTC + threadIdx.x];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + kr + (lane >> 2) + 8 * h;
      if (key >= k) continue;
#pragma unroll
      for (int j = 0; j < NG; ++j)
        store_pair(dg + ((size_t)b * k + key) * dv, c0 + gc + 8 * j + 2 * (lane & 3), dv,
                   acc_g[j][2 * h], acc_g[j][2 * h + 1]);
      if (with_dphi) {
#pragma unroll
        for (int j = 0; j < ND; ++j)
          store_pair(dphi + ((size_t)b * k + key) * d, pc + 8 * j + 2 * (lane & 3), d,
                     acc_p[j][2 * h], acc_p[j][2 * h + 1]);
      }
    }
  }
  cluster.sync();   // the other ranks' shared memory stays until rank 0 has read it
}

// Launch arguments of either route (T: bf16 or float).
template <typename T>
struct Args {
  const T *theta, *phi, *g, *dout;
  T *o, *dtheta, *dphi, *dg;
  float *m, *l, *delta;
  float* ds;     // f32 backward: dS^T [n, k, q] from dkv to dq
  double* work;  // the Work ops' output: forward and backward FLOPs
  int n, q, k, d, dv;
  bool vec_d, vec_v;
  cudaStream_t stream;
};
using MmaArgs = Args<bf16>;
using Tf32Args = Args<float>;

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

// Shared memory of the f32 kernels: input tiles of width + kFPad floats a
// row, P and dS tiles of width + kSPad.
constexpr size_t tf32_fwd_smem(int DP, int VC) {
  return 4 * ((size_t)3 * kRows * (DP + kFPad) + 2 * (size_t)kKeys * (VC + kFPad) +
              (size_t)kRows * (kKeys + kSPad) + 8 * (size_t)kRows);
}
constexpr size_t tf32_dq_smem(int DP) {
  return 4 * ((size_t)2 * 64 * (128 + kFPad) + 2 * (size_t)64 * (DP + kFPad));
}
constexpr size_t tf32_dkv_smem(int DP, int VP, int bq, int nbuf) {
  return 4 * ((size_t)(kRows + nbuf * bq) * (DP + VP + 2 * kFPad) +
              2 * (size_t)kRows * (bq + kSPad) + 3 * (size_t)nbuf * bq);
}

// Tiles of the f32 route at padded widths DP, VP, chosen to fit a block's
// shared memory (f32 tiles take twice the bytes of bf16 ones): read by the
// launchers and by the work count alike.
template <int DP, int VP>
struct Tf32Tiles {
  // forward: dv chunks of 256 columns (128 at DP = 128), so that theta, two
  // phi and two g buffers and P fit
  static constexpr int VC = VP < (DP > 64 ? 128 : 256) ? VP : (DP > 64 ? 128 : 256);
  static constexpr size_t FWD_SMEM = tf32_fwd_smem(DP, VC);
  static constexpr size_t DQ_SMEM = tf32_dq_smem(DP);
  // dkv: dv chunks of at most 256, 32-query tiles (16 for dv = 512) in two
  // buffers (one where two do not fit)
  static constexpr int DVC = VP < 256 ? VP : 256;
  static constexpr int BQ = tf32_dkv_smem(DP, VP, 32, 2) <= kBlockSmem ? 32 : 16;
  static constexpr int NBUF = tf32_dkv_smem(DP, VP, BQ, 2) <= kBlockSmem ? 2 : 1;
  static constexpr size_t DKV_SMEM = tf32_dkv_smem(DP, VP, BQ, NBUF);
  static_assert(FWD_SMEM <= kBlockSmem && DQ_SMEM <= kBlockSmem && DKV_SMEM <= kBlockSmem,
                "f32 tiles exceed a block's shared memory");
  // dkv's rank 1 leaves its dG and dphi sums where phi's and g's tiles were
  static_assert((DVC / 16 + DP / 16) * 4 * kTC <= kRows * (DP + VP + 2 * kFPad),
                "dkv's sums do not fit in its key tiles");
};

struct Tf32Fwd {
  template <int DP, int VP>
  static cudaError_t run(const Tf32Args& a) {
    using T = Tf32Tiles<DP, VP>;
    cudaError_t err = allow_smem(fwd_tf32_kernel<DP, T::VC>, T::FWD_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.q + kRows - 1) / kRows, a.n, VP / T::VC);
    fwd_tf32_kernel<DP, T::VC><<<grid, kTC, T::FWD_SMEM, a.stream>>>(
        a.theta, a.phi, a.g, a.o, a.m, a.l, a.q, a.k, a.d, a.dv, a.vec_d, a.vec_v);
    return cudaGetLastError();
  }
};

struct Tf32Bwd {
  template <int DP, int VP>
  static cudaError_t run(const Tf32Args& a) {
    using T = Tf32Tiles<DP, VP>;
    const int rows = a.n * a.q;
    delta_tf32_kernel<<<(rows + 7) / 8, 256, 0, a.stream>>>(a.dout, a.o, a.delta, rows,
                                                             a.dv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    // kDkvSplit blocks (one cluster) a key block, each with a share of the
    // query tiles
    constexpr size_t smem_dkv = T::DKV_SMEM;
    auto dkv = bwd_dkv_tf32_kernel<DP, VP, T::DVC, T::BQ, T::NBUF>;
    err = allow_smem(dkv, smem_dkv);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kDkvSplit * ((a.k + kRows - 1) / kRows), a.n, VP / T::DVC);
    cfg.blockDim = dim3(kTC);
    cfg.dynamicSmemBytes = smem_dkv;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kDkvSplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dkv, a.theta, a.phi, a.g, a.dout, (const float*)a.m,
                             (const float*)a.l, (const float*)a.delta, a.dphi, a.dg,
                             a.ds, a.q, a.k, a.d, a.dv, a.vec_d, a.vec_v);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    err = allow_smem(bwd_dq_tf32_kernel<DP>, T::DQ_SMEM);
    if (err != cudaSuccess) return err;
    bwd_dq_tf32_kernel<DP><<<dim3((a.q + 127) / 128, a.n), kTC, T::DQ_SMEM, a.stream>>>(
        a.ds, a.phi, a.dtheta, a.q, a.k, a.d, a.vec_d, a.q % 4 == 0);
    return cudaGetLastError();
  }
};

// The tensor-core FLOPs the f32 kernels do, padding included, each product
// counted three times (3xTF32): the forward computes S and P . g once per dv
// chunk; dkv computes S^T, dP^T and P^T . dO per dv chunk, and dS^T . theta
// in chunk 0; dq computes dS . phi.
struct Tf32Work {
  template <int DP, int VP>
  static cudaError_t run(const Tf32Args& a) {
    using T = Tf32Tiles<DP, VP>;
    constexpr int chunks = VP / T::VC, dkv_chunks = VP / T::DVC;
    const double n6 = 3 * 2.0 * a.n;
    a.work[0] = n6 * up(a.q, kRows) * up(a.k, kKeys) * (DP * chunks + VP);
    a.work[1] = n6 * up(a.q, 128) * up(a.k, 64) * DP +
                n6 * up(a.k, kRows) * up(a.q, T::BQ) * (dkv_chunks * (DP + VP + T::DVC) + DP);
    return cudaSuccess;
  }
};

template <class Op, int DP, class A>
cudaError_t mma_by_dv(const A& a) {
  switch (vp_for(a.dv)) {
    case 64: return Op::template run<DP, 64>(a);
    case 128: return Op::template run<DP, 128>(a);
    case 256: return Op::template run<DP, 256>(a);
    default: return Op::template run<DP, 512>(a);
  }
}

template <class Op, class A>
cudaError_t mma_launch(const A& a) {
  switch (dp_for(a.d)) {
    case 16: return mma_by_dv<Op, 16, A>(a);
    case 32: return mma_by_dv<Op, 32, A>(a);
    case 64: return mma_by_dv<Op, 64, A>(a);
    default: return mma_by_dv<Op, 128, A>(a);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Arguments of the route for T; the 16-byte staging needs rows of whole
// 16-byte chunks and 16-byte aligned bases.
template <typename T>
Args<T> make_args(const void* theta, const void* phi, const void* g, const void* dout,
                  int n, int q, int k, int d, int dv, void* stream) {
  constexpr int per16 = 16 / sizeof(T);
  Args<T> a = {};
  a.theta = (const T*)theta;
  a.phi = (const T*)phi;
  a.g = (const T*)g;
  a.dout = (const T*)dout;
  a.n = n, a.q = q, a.k = k, a.d = d, a.dv = dv;
  a.vec_d = d % per16 == 0 && aligned16(theta) && aligned16(phi);
  a.vec_v = dv % per16 == 0 && aligned16(g) && (dout == nullptr || aligned16(dout));
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
    MmaArgs a = make_args<bf16>(theta, phi, g, nullptr, n, q, k, d, dv, stream);
    a.o = (bf16*)o;
    a.m = (float*)m;
    a.l = (float*)l;
    return (int)mma_launch<MmaFwd>(a);
  }
  Tf32Args a = make_args<float>(theta, phi, g, nullptr, n, q, k, d, dv, stream);
  a.o = (float*)o;
  a.m = (float*)m;
  a.l = (float*)l;
  return (int)mma_launch<Tf32Fwd>(a);
}

// dtheta [n, q, d], dphi [n, k, d], dg [n, k, dv] in the input type; delta
// [n, q] f32 scratch, and for f32 ds [n, k, q] f32 scratch (null for bf16);
// o, m, l from sagan_attention_fwd (o is read by the f32 route only).
int sagan_attention_bwd(const void* theta, const void* phi, const void* g,
                        const void* dout, const void* o, const void* m, const void* l,
                        void* delta, void* ds, void* dtheta, void* dphi, void* dg, int n,
                        int q, int k, int d, int dv, int is_bf16, void* stream) {
  if (bad_shape(n, q, k, d, dv)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    MmaArgs a = make_args<bf16>(theta, phi, g, dout, n, q, k, d, dv, stream);
    a.m = (float*)m;
    a.l = (float*)l;
    a.delta = (float*)delta;
    a.dtheta = (bf16*)dtheta;
    a.dphi = (bf16*)dphi;
    a.dg = (bf16*)dg;
    return (int)mma_launch<MmaBwd>(a);
  }
  if (ds == nullptr) return (int)cudaErrorInvalidValue;
  Tf32Args a = make_args<float>(theta, phi, g, dout, n, q, k, d, dv, stream);
  a.o = (float*)o;
  a.m = (float*)m;
  a.l = (float*)l;
  a.delta = (float*)delta;
  a.ds = (float*)ds;
  a.dtheta = (float*)dtheta;
  a.dphi = (float*)dphi;
  a.dg = (float*)dg;
  return (int)mma_launch<Tf32Bwd>(a);
}

// work[0], work[1]: the FLOPs that sagan_attention_fwd and sagan_attention_bwd
// do for this type at this shape, tile padding included (MmaWork for bf16,
// Tf32Work, three tensor-core products each, for f32). Launches nothing.
int sagan_attention_work(int n, int q, int k, int d, int dv, int is_bf16, double* work) {
  if (bad_shape(n, q, k, d, dv)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    MmaArgs a = make_args<bf16>(nullptr, nullptr, nullptr, nullptr, n, q, k, d, dv, nullptr);
    a.work = work;
    return (int)mma_launch<MmaWork>(a);
  }
  Tf32Args a = make_args<float>(nullptr, nullptr, nullptr, nullptr, n, q, k, d, dv, nullptr);
  a.work = work;
  return (int)mma_launch<Tf32Work>(a);
}

}  // extern "C"
