// BigGAN-deep's block convolutions for Hopper (sm_90a): a float32-accurate
// implicit GEMM over NCHW activations, on the tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA.
// On the card, cuDNN's heuristics give BigGAN's strict-float32 3x3
// convolutions (TF32 off) FFT algorithms whose complex GEMMs run on the FMA
// units, about 9-10 TFLOP/s; this kernel runs the same products as 3xTF32
// on the tensor cores instead. It computes, for a 1x1 convolution (pad 0)
// or a 3x3 one (pad 1), stride 1,
//   y[n, co, p] = bias[co] + sum_{tap, ci} A[co, tap, ci] . x[n, ci, p + tap]
// where the packed weight A is the layer's weight for the forward, and the
// layer's weight flipped with its in and out axes swapped (1x1: transposed)
// for the input gradient, which is then this same convolution of dy.
//
// Shapes: x [n, cin, h, w] contiguous f32; A [2][cout][taps][cin_pad]
// (tf32 hi, then lo = a - hi rounded to tf32, split once in Python since
// the weights are frozen; cin_pad = cin rounded up to kBK with zeros); bias
// [cout] or null; y [n, cout, h, w]. BigGAN-deep-256 runs it from
// [18, 2048, 4, 4] (K = 2048 or 4608, N = 288) to [18, 64, 256, 256] (K =
// 576, N = 1.18 M).
//
// GEMM: M = cout, N = n h w (the spatial index is contiguous in NCHW, so a
// row of the B tile is a run of x), K = taps x cin, ordered tap-major so a
// K tile of kBK channels has one tap: its B rows are x shifted by one
// offset, masked by one validity bit per column.
//
// Bound on an H100 SXM: 2 M N K operations against x, A and y read or
// written once. At the 3x3 of block 11 (M 64, K 576, N 1.18 M) that is
// 87 GFLOP, 0.176 ms at the 495 TFLOP/s TF32 rate counted once per
// product, against 0.60 GB, 0.180 ms at 3.35 TB/s: the two bounds meet
// there, and the 3x3s of blocks 3 to 10 are bound by operations (block
// 7's: 87 GFLOP against 0.15 GB). 3xTF32 issues three tensor-core products
// per product, so the kernel's own ceiling is a third of that rate.
//
// Design.
//   * Products: mma.sync m16n8k8 tf32, three per product (lo . hi + hi . lo
//     + hi . hi, f32 sums), the split of CUTLASS's OpMultiplyAddFastF32 as
//     in csrc/sagan_attention.cu. A (the weight) arrives split; B (the
//     activations) is split as each fragment is read from shared memory.
//     Each K tile sums into fresh accumulators, added to the running sums
//     once a tile: the tensor core's own f32 adds round toward zero, which
//     over K = 4608 left errors of 1e-5 of the output's scale.
//   * Tiles: a block computes 64 x 128 outputs, four warps of 64 x 32; K
//     tiles of kBK = 32 go through a ring of three shared-memory buffers
//     filled by cp.async while the tensor cores work on the oldest. A's hi
//     and lo rows are read by ldmatrix (an 8 x 4 f32 block is an 8 x 8 b16
//     matrix, and its rows land as the m16n8k8 tf32 A fragment); B's rows
//     are padded to BN + 8 floats so each fragment read hits 32 banks.
//   * Split-K: where the tiles are too few to fill the card (the 4x4 to
//     32x32 blocks), grid.z splits the K tiles; each split writes its
//     partial sums to a workspace and a second kernel adds them in split
//     order, then the bias. No atomics: two calls give the same bits.
//   * B staging: a 1x1 convolution whose plane is a whole number of 16-byte
//     vectors copies 16 bytes a thread; otherwise (every 3x3) 4 bytes a
//     thread, a warp covering 32 neighbouring columns, each column's image,
//     offset and 9 tap-validity bits computed once per block; invalid taps,
//     channels past cin and columns past N are zero-filled by cp.async.
//   * The split of K is chosen here from (cout, K tiles, N) alone
//     (plan_splits); Python asks for it (block_conv_splits) only to size
//     the workspace.
//
// C interface, bound from Python with ctypes: each entry returns the
// cudaError_t of its launch (0 on success) and launches on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;            // K tile: 32 channels of one tap
constexpr int kLDA = kBK + 4;      // floats a shared A row: 144 bytes
constexpr int kBPad = 8;           // floats after each shared B row
constexpr int kMaxSplits = 16;
constexpr int kSMs = 132;           // an H100 SXM's streaming multiprocessors
constexpr int kMinSplitKTiles = 8;  // K tiles a split keeps at least
constexpr int kMaxBlocksPerSM = 9;  // blocks of a split GEMM an SM takes at most

struct Params {
  const float* x;
  const float* w;        // [2][cout][ktiles * kBK]
  const float* bias;     // null: no bias (and always null in a split)
  float* y;              // output, or the workspace [splits][n, cout, h, w]
  int cin, h, wd, hw, cout, ksize, ncols;
  int ktiles, kchunks;   // K tiles, and K tiles a tap (cin_pad / kBK)
  int kt_per_split;
  long long y_split;     // elements between the splits' outputs
};

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// x as the tf32 pair hi + lo: hi rounded to nearest (ties away), lo = x - hi
// passed as it is (the tensor core reads its upper 19 bits); see
// csrc/sagan_attention.cu: split_tf32.
__device__ __forceinline__ void split_tf32(uint32_t& hi, uint32_t& lo, float x) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// Not volatile: a product depends only on its operands, so the compiler may
// interleave independent ones.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
struct Tile {
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kWM = BM / WARPS_M, kWN = BN / WARPS_N;
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;
  static constexpr int kLDB = BN + kBPad;
  static constexpr int kAStage = 2 * BM * kLDA;   // floats: the hi tile, then lo
  static constexpr int kBStage = kBK * kLDB;
  static constexpr size_t kSmem = (size_t)STAGES * (kAStage + kBStage) * sizeof(float);
  static_assert(kWM % 16 == 0 && kWN % 8 == 0, "warp tile");
  static_assert((2 * BM * (kBK / 4)) % kThreads == 0, "A staging");
  static_assert(BN % 32 == 0 && kBK % (kThreads / 32) == 0, "B staging (4-byte)");
  static_assert(kThreads % (BN / 4) == 0 && kBK % (kThreads / (BN / 4)) == 0,
                "B staging (16-byte)");
};

// One block: outputs [m0, m0 + BM) x [n0, n0 + BN) over its split's K tiles.
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool VEC>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
conv_kernel(Params p) {
  using T = Tile<BM, BN, WARPS_M, WARPS_N, STAGES>;
  constexpr int THREADS = T::kThreads, MT = T::kMT, NT = T::kNT, LDB = T::kLDB;
  constexpr int NWARPS = THREADS / 32;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + STAGES * T::kAStage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * p.kt_per_split;
  const int nkt = min(p.ktiles, kt0 + p.kt_per_split) - kt0;
  const size_t krow = (size_t)p.ktiles * kBK;
  const float* w_hi = p.w;
  const float* w_lo = p.w + (size_t)p.cout * krow;
  const int pad = p.ksize >> 1;

  // Per-thread column state of the B staging.
  constexpr int CPT = VEC ? 1 : BN / 32;   // columns (16-byte runs with VEC) a thread
  int base[CPT];
  unsigned mask[CPT];
  if (VEC) {
    const int col = n0 + 4 * (tid % (BN / 4));
    const int img = col / p.hw;
    base[0] = col < p.ncols ? img * p.cin * p.hw + (col - img * p.hw) : 0;
    mask[0] = col < p.ncols ? 1u : 0u;
  } else {
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int col = n0 + lane + 32 * e;
      const int img = col / p.hw, pix = col - img * p.hw;
      const int hh = pix / p.wd, ww = pix - hh * p.wd;
      base[e] = col < p.ncols ? img * p.cin * p.hw + pix : 0;
      unsigned m = 0;
      if (col < p.ncols) {
        for (int r = 0; r < p.ksize; ++r)
          for (int s = 0; s < p.ksize; ++s) {
            const bool ok = (unsigned)(hh + r - pad) < (unsigned)p.h &&
                            (unsigned)(ww + s - pad) < (unsigned)p.wd;
            m |= (ok ? 1u : 0u) << (r * p.ksize + s);
          }
      }
      mask[e] = m;
    }
  }

  auto load_tile = [&](int stage, int kt) {
    // A: hi and lo rows of BM output channels, kBK floats each.
    float* a_dst = as + stage * T::kAStage;
    constexpr int A_CHUNKS = 2 * BM * (kBK / 4);
#pragma unroll
    for (int i = tid; i < A_CHUNKS; i += THREADS) {
      const int part = i / (BM * (kBK / 4));
      const int rem = i - part * (BM * (kBK / 4));
      const int r = rem / (kBK / 4), c = (rem % (kBK / 4)) * 4;
      const bool ok = m0 + r < p.cout;
      const float* src = (part ? w_lo : w_hi) + (size_t)(ok ? m0 + r : 0) * krow +
                         (size_t)kt * kBK + c;
      cp_async16(a_dst + part * BM * kLDA + r * kLDA + c, src, ok ? 16 : 0);
    }
    // B: kBK channels of one tap by BN columns.
    float* b_dst = bs + stage * T::kBStage;
    const int tap = kt / p.kchunks;
    const int ci0 = (kt - tap * p.kchunks) * kBK;
    if (VEC) {
      constexpr int CPR = BN / 4, RSTEP = THREADS / CPR;
      const int c = 4 * (tid % CPR), r0 = tid / CPR;
#pragma unroll
      for (int r = r0; r < kBK; r += RSTEP) {
        const int ci = ci0 + r;
        const bool ok = mask[0] && ci < p.cin;
        cp_async16(b_dst + r * LDB + c, ok ? p.x + base[0] + ci * p.hw : p.x, ok ? 16 : 0);
      }
    } else {
      const int rr = tap / p.ksize, ss = tap - rr * p.ksize;
      const int off = (rr - pad) * p.wd + (ss - pad);
#pragma unroll
      for (int r = warp; r < kBK; r += NWARPS) {
        const int ci = ci0 + r;
        const bool ci_ok = ci < p.cin;
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const bool ok = ci_ok && ((mask[e] >> tap) & 1u);
          cp_async4(b_dst + r * LDB + lane + 32 * e,
                    ok ? p.x + base[e] + ci * p.hw + off : p.x, ok ? 4 : 0);
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load_tile(s, kt0 + s);
    cp_commit();
  }

  // ldmatrix row addresses: lanes 8 q .. 8 q + 7 give matrix q's rows
  // (rows 0-7 or 8-15, columns 0-3 or 4-7 of the 16 x 8 A block).
  const int a_row = wm * T::kWM + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;
  const int b_col = wn * T::kWN + g;

  for (int it = 0; it < nkt; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int next = it + STAGES - 1;
    if (next < nkt) load_tile(next % STAGES, kt0 + next);
    cp_commit();

    const int stage = it % STAGES;
    const float* a_hi = as + stage * T::kAStage + a_row * kLDA + a_col;
    const float* a_lo = a_hi + BM * kLDA;
    const float* b = bs + stage * T::kBStage + t * LDB + b_col;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2], ah[MT][4], al[MT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32(bh[j][0], bl[j][0], b[kk * LDB + 8 * j]);
        split_tf32(bh[j][1], bl[j][1], b[(kk + 4) * LDB + 8 * j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldsm_x4(ah[i], a_hi + 16 * i * kLDA + kk);
        ldsm_x4(al[i], a_lo + 16 * i * kLDA + kk);
      }
      // The three products of 3xTF32, the small terms first, each over all
      // MT x NT accumulators before the next: no product waits on the one
      // just before it in the same accumulator.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
    }
    // The tensor cores' f32 sums do not round to nearest; a K tile's sum
    // starts from zero and joins the running sum by a rounded add, so the
    // long sums over K (up to 144 tiles) round once a tile.
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_wait<0>();

  // Epilogue: acc[i][j][2 h + e] is row 16 i + g + 8 h, column 8 j + 2 t + e
  // of the warp tile; a pair of columns of one image is one 8-byte store.
  float* y = p.y + (size_t)blockIdx.z * p.y_split;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * T::kWN + 8 * j + 2 * t;
    if (col >= p.ncols) continue;
    const int img = col / p.hw, pix = col - img * p.hw;
    float* y0 = y + (size_t)img * p.cout * p.hw + pix;
    const bool has1 = col + 1 < p.ncols;
    const bool pair = has1 && pix + 1 < p.hw && ((pix & 1) == 0) && ((p.hw & 1) == 0);
    float* y1 = y0 + 1;
    if (has1 && pix + 1 == p.hw) y1 = y + (size_t)(img + 1) * p.cout * p.hw;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * T::kWM + 16 * i + g + 8 * h;
        if (m >= p.cout) continue;
        const float bv = p.bias ? p.bias[m] : 0.f;
        const float v0 = acc[i][j][2 * h] + bv, v1 = acc[i][j][2 * h + 1] + bv;
        const size_t mo = (size_t)m * p.hw;
        if (pair) {
          *reinterpret_cast<float2*>(y0 + mo) = make_float2(v0, v1);
        } else {
          y0[mo] = v0;
          if (has1) y1[mo] = v1;
        }
      }
  }
}

// y = bias + the splits' partial sums, added in split order.
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias, float* __restrict__ y,
                                     long long total, int splits, int hw, int cout) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float s = bias ? bias[(i / hw) % cout] : 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * total + i];
    y[i] = s;
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool VEC>
cudaError_t launch_one(const Params& p, int splits, int dev, cudaStream_t st) {
  using T = Tile<BM, BN, WARPS_M, WARPS_N, STAGES>;
  auto kern = conv_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, VEC>;
  static unsigned long long ready = 0;     // a bit a device
  if (dev >= 64 || !((ready >> dev) & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) ready |= 1ull << dev;
  }
  const dim3 grid((p.ncols + BN - 1) / BN, (p.cout + BM - 1) / BM, splits);
  kern<<<grid, T::kThreads, T::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
cudaError_t launch(const Params& p, int splits, bool vec, int dev, cudaStream_t st) {
  return vec ? launch_one<BM, BN, WARPS_M, WARPS_N, STAGES, true>(p, splits, dev, st)
             : launch_one<BM, BN, WARPS_M, WARPS_N, STAGES, false>(p, splits, dev, st);
}

// The tile: 64 output channels by 128 columns, four warps of 64 x 32, three
// stages (107.5 KB of shared memory, two blocks an SM). A sweep of four
// tiles (128 x 128 of eight warps, 64 x 128, 64 x 64, 64 x 256 of eight)
// and splits over the 96 GEMMs of a BigGAN-deep-256 step (forward and input
// gradient at 18 rows) put this one within 0.5 % of the best tile for each
// shape in sum (PERF.md section 6), so it is the only one built.
constexpr int kTileM = 64, kTileN = 128, kWarpsM = 1, kWarpsN = 4, kStages = 3;

cudaError_t dispatch(const Params& p, int splits, bool vec, int dev, cudaStream_t st) {
  return launch<kTileM, kTileN, kWarpsM, kWarpsN, kStages>(p, splits, vec, dev, st);
}

// The split of K for a GEMM of `cout` rows, `ktiles` K tiles and `ncols`
// columns: K is halved as long as the blocks (the tiles times the splits)
// stay within kMaxBlocksPerSM an SM and each split keeps kMinSplitKTiles K
// tiles; then made even, so that no split is empty. At biggan-deep-256's
// shapes (18 rows) this splits the GEMMs of the 4x4 to 32x32 blocks in 2 to
// 16 and leaves those at 64x64 and above whole.
int plan_splits(int cout, int ktiles, int ncols) {
  const long long tiles = (long long)((cout + kTileM - 1) / kTileM) *
                          ((ncols + kTileN - 1) / kTileN);
  int splits = 1;
  while (2 * splits <= kMaxSplits && 2 * splits * tiles <= (long long)kMaxBlocksPerSM * kSMs &&
         ktiles / (2 * splits) >= kMinSplitKTiles)
    splits *= 2;
  const int per = (ktiles + splits - 1) / splits;
  return (ktiles + per - 1) / per;
}

// Launches on `stream` with `device` current, and restores the caller's.
cudaError_t run(Params& p, const float* bias, float* y, float* ws, int splits, bool vec,
                int device, cudaStream_t st) {
  const long long total = (long long)p.ncols * p.cout;
  if (splits == 1) {
    p.bias = bias;
    p.y = y;
    p.y_split = 0;
    return dispatch(p, 1, vec, device, st);
  }
  p.bias = nullptr;
  p.y = ws;
  p.y_split = total;
  const cudaError_t e = dispatch(p, splits, vec, device, st);
  if (e != cudaSuccess) return e;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  splitk_reduce_kernel<<<blocks, threads, 0, st>>>(ws, bias, y, total, splits, p.hw, p.cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of splits of K block_conv runs at this shape (1: none), so
// that the caller can size its workspace; 0 for a shape it refuses.
int block_conv_splits(int n, int cin_pad, int h, int wd, int cout, int ksize) {
  if (n < 1 || cin_pad < kBK || cin_pad % kBK != 0 || h < 1 || wd < 1 || cout < 1 ||
      (ksize != 1 && ksize != 3) || (long long)n * h * wd >= (1LL << 31))
    return 0;
  return plan_splits(cout, ksize * ksize * (cin_pad / kBK), n * h * wd);
}

// y = conv(x, A) + bias as set out above. x [n, cin, h, w] f32; w the packed
// A [2][cout][taps][cin_pad]; bias [cout] or null; y [n, cout, h, w]. Where
// block_conv_splits gives more than 1, ws is a workspace of that many times
// n * cout * h * w floats (else unused). Launches on `stream` of card
// `device`, which is made current for the launch and then restored.
int block_conv(const void* x, const void* w, const void* bias, void* y, void* ws, int n,
               int cin, int cin_pad, int h, int wd, int cout, int ksize, int device,
               void* stream) {
  const int splits = block_conv_splits(n, cin_pad, h, wd, cout, ksize);
  if (splits < 1 || cin < 1 || cin_pad < cin || cin_pad - cin >= kBK ||
      (splits > 1 && ws == nullptr) || device < 0)
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)h * wd;
  if ((long long)n * cin * hw >= (1LL << 31) || (long long)n * cout * hw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const float*)x;
  p.w = (const float*)w;
  p.cin = cin;
  p.h = h;
  p.wd = wd;
  p.hw = (int)hw;
  p.cout = cout;
  p.ksize = ksize;
  p.ncols = (int)(n * hw);
  p.kchunks = cin_pad / kBK;
  p.ktiles = ksize * ksize * p.kchunks;
  p.kt_per_split = (p.ktiles + splits - 1) / splits;
  const bool vec = ksize == 1 && hw % 4 == 0 && ((uintptr_t)x % 16) == 0;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = run(p, (const float*)bias, (float*)y, (float*)ws, splits, vec, device,
          (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t r = cudaSetDevice(prev);
    if (e == cudaSuccess) e = r;
  }
  return (int)e;
}

}  // extern "C"
