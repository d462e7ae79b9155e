// The port's float32 3x3 and 1x1 convolutions for Hopper (sm_90a): a
// float32-accurate implicit GEMM over NCHW activations, on the tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA.
// On the card, cuDNN's heuristics give strict-float32 convolutions (TF32
// off) FFT algorithms whose complex GEMMs run on the FMA units, or implicit
// GEMMs at 30-34 TFLOP/s; this kernel runs the same products as 3xTF32 on
// the tensor cores instead. It serves BigGAN-deep's GenBlock convolutions
// (1x1 and 3x3, stride 1) and StyleGAN2's modulated 3x3 convolutions: the
// stride-1 ones and the stride-2 transposed up-convolutions, forward and
// input gradient each. Three routes share one GEMM core:
//
//   * same: y[n, co, p] = bias[co] + sum_{tap, ci} A[co, tap, ci] . x[n, ci,
//     p + tap], a 1x1 (pad 0) or 3x3 (pad 1) convolution of stride 1. A is
//     the layer's weight for the forward, and the weight flipped with its in
//     and out axes swapped (1x1: transposed) for the input gradient, which
//     is then this same convolution of dy.
//   * up: the transposed convolution of stride 2 of the unflipped 3x3
//     weight, y[o, 2 iy + ky, 2 ix + kx] += x[i, iy, ix] w[o, i, ky, kx],
//     an h x w plane to 2h+1 x 2w+1. Output pixel (2m + a, 2q + b) takes
//     only the taps with ky = a and kx = b (mod 2), so the route is four
//     stride-1 GEMMs over x, one per output phase (a, b): 2x2 taps on an
//     (h+1) x (w+1) grid, 2x1 on (h+1) x w, 1x2 on h x (w+1), 1x1 on h x w,
//     each tap at x[m - u, q - v] for ky = a + 2u, kx = b + 2v. Their K
//     sums to 9 cin, so no product falls on an inserted zero. Each phase
//     stores its outputs interleaved into y; the four run in one launch,
//     the phase the low bits of the block index, so the blocks that fill one
//     region of y run side by side and their half-sector stores meet in L2.
//     A is the weight's taps in phase order, [cout][9][cin_pad].
//   * up_grad: that convolution's input gradient, dx[i, iy, ix] = sum_{o,
//     ky, kx} g[o, 2 iy + ky, 2 ix + kx] w[o, i, ky, kx], a gather of 9 taps
//     at stride 2 with no padding (every tap inside g). A is the weight
//     with its in and out axes swapped, not flipped.
//
// The route is the caller's argument, never inferred: BigGAN calls `same`
// only, and its tiles, plan and launches are what they were.
//
// Shapes: x [n, cin, h, w] contiguous f32; A [2][cout][taps][cin_pad] (tf32
// hi, then lo = a - hi rounded to tf32, split once in Python since the
// weights are frozen; cin_pad = cin rounded up to kBK with zeros); bias
// [cout] or null (route same only); y contiguous. BigGAN-deep-256 runs
// `same` from [18, 2048, 4, 4] (K = 2048 or 4608, N = 288) to [18, 64, 256,
// 256] (K = 576, N = 1.18 M). StyleGAN2 config-f runs its 3x3s from [22,
// 512, 4, 4] to [22, 32, 1024, 1024] (cars at 512 px: to [22, 64, 512,
// 512]), K = 288 to 4608, and its up-convolutions from [22, 512, 4, 4] to
// [22, 64, 512, 512] in (output [22, 32, 1025, 1025] before the blur).
//
// GEMM: M = cout, N = the output grid's pixels over n (the spatial index is
// contiguous in NCHW, so a row of the B tile is a run of x, or every other
// element at stride 2), K = taps x cin, ordered tap-major so a K tile of kBK
// channels has one tap: its B rows are x shifted by one offset, masked by
// one validity bit per column.
//
// Bound on an H100 SXM: 2 M N K operations against x, A and y read or
// written once, at the 495 TFLOP/s TF32 rate counted once per product and
// 3.35 TB/s. At the 3x3 of BigGAN's block 11 (M 64, K 576, N 1.18 M) that is
// 87 GFLOP, 0.176 ms, against 0.60 GB, 0.180 ms: the two bounds meet there,
// and the 3x3s of blocks 3 to 10 are bound by operations (block 7's: 87
// GFLOP against 0.15 GB). StyleGAN2's 3x3s and up-convolutions from 4 to
// 256 px are bound by operations (cars' 64 px 3x3: 425 GFLOP against 0.19
// GB); the 512 px 3x3 (M 64, K 576) by both (425 GFLOP, 0.86 ms, against
// 3.0 GB, 0.88 ms); FFHQ's 1024 px 3x3 (M 32, K 288) by bytes: 424 GFLOP,
// 0.86 ms, against 5.9 GB, 1.76 ms; and its up-convolution to 1025 px (M
// 32) too: 425 GFLOP against 4.4 GB, 1.32 ms. 3xTF32 issues three
// tensor-core products per product, so the kernel's own ceiling is a third
// of the TF32 rate.
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
//     are padded to BN + 8 floats so each fragment read hits 32 banks. A
//     GEMM of at most 32 rows (FFHQ's 1024 px level: cout 32) takes a
//     32-row tile instead, where 64 rows would leave half the products on
//     zero rows, and the up_grad route's GEMMs of 128 rows or more a 128-row
//     tile of eight warps, which reads its stride-2 B rows for twice the
//     rows (kThin*, kTall* below).
//   * Split-K: where the tiles are too few to fill the card (the 4x4 to
//     32x32 planes), grid.z splits the K tiles; each split writes its
//     partial sums to a workspace and a second kernel adds them in split
//     order, then the bias. No atomics: two calls give the same bits. The
//     up route splits each phase's K in as many parts (a phase with fewer
//     K tiles than splits writes zeros in the rest).
//   * B staging: a 1x1 convolution whose plane is a whole number of 16-byte
//     vectors copies 16 bytes a thread; otherwise (every 3x3) 4 bytes a
//     thread, a warp covering 32 neighbouring columns, each column's image,
//     input offset and tap-validity bits computed once per block; invalid
//     taps, channels past cin and columns past N are zero-filled by cp.async.
//   * The split of K and the tile are chosen here from the route and (cout,
//     K tiles, N) alone (plan_splits, tile_of); Python asks for the split
//     (block_conv_splits) only to size the workspace.
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
constexpr int kPhases = 4;          // the up route's output phases

// The routes, as the callers name them.
enum Route { kSame = 0, kUp = 1, kUpGrad = 2 };

struct Params {
  const float* x;        // B's planes [n, cin, in_h, in_w]
  const float* w;        // A [2][cout][lda]: the hi rows, then the lo rows
  const float* bias;     // null: no bias (and always null in a split)
  float* y;              // output [n, cout, y plane], or the workspace [splits][...]
  int route;
  int n, cin, in_h, in_w, in_hw;
  int cout, kchunks, lda;   // M; K tiles a tap (cin_pad / kBK); floats an A row
  int out_h, out_w;         // the column grid of an unphased route
  int ksize, pad, stride;   // its taps: x[stride * out + tap - pad]
  int y_w, y_hw;            // the output plane
  int splits;
  long long y_split;        // elements between the splits' outputs
};

// One GEMM of a launch: the whole of an unphased route, or one phase (a, b)
// of the up route, phase = 2 a + b.
struct Geom {
  int out_w, out_hw, ncols;   // its column grid: out_h x out_w a row of n
  int kh, kw, pad_h, pad_w;   // its taps: tap t at (t / kw - pad_h, t % kw - pad_w)
  int ktiles;
  int a_off;                  // floats from an A row's start to its first tap
  int y_off;                  // a phase's column (r, c) lands at y_off + 2 (r y_w + c)
};

template <bool PHASED>
__device__ __forceinline__ Geom geometry(const Params& p, int phase) {
  Geom g;
  int out_h;
  if (PHASED) {
    const int a = phase >> 1, b = phase & 1;
    out_h = p.in_h + 1 - a;
    g.out_w = p.in_w + 1 - b;
    g.kh = 2 - a;
    g.kw = 2 - b;
    g.pad_h = g.kh - 1;
    g.pad_w = g.kw - 1;
    g.a_off = (phase == 0 ? 0 : phase == 1 ? 4 : phase == 2 ? 6 : 8) * p.kchunks * kBK;
    g.y_off = a * p.y_w + b;
  } else {
    out_h = p.out_h;
    g.out_w = p.out_w;
    g.kh = g.kw = p.ksize;
    g.pad_h = g.pad_w = p.pad;
    g.a_off = 0;
    g.y_off = 0;
  }
  g.out_hw = out_h * g.out_w;
  g.ncols = p.n * g.out_hw;
  g.ktiles = g.kh * g.kw * p.kchunks;
  return g;
}

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

// One block: outputs [m0, m0 + BM) x [n0, n0 + BN) of one GEMM (the up
// route: of the phase blockIdx.x % 4) over its split's K tiles.
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool VEC, bool PHASED>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
conv_kernel(Params p) {
  using T = Tile<BM, BN, WARPS_M, WARPS_N, STAGES>;
  constexpr int THREADS = T::kThreads, MT = T::kMT, NT = T::kNT, LDB = T::kLDB;
  constexpr int NWARPS = THREADS / 32;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + STAGES * T::kAStage;

  const Geom G = geometry<PHASED>(p, PHASED ? blockIdx.x % kPhases : 0);
  const int n0 = (PHASED ? blockIdx.x / kPhases : blockIdx.x) * BN, m0 = blockIdx.y * BM;
  if (n0 >= G.ncols) return;      // a phase with fewer tiles than the largest
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int kt_per_split = (G.ktiles + p.splits - 1) / p.splits;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = max(0, min(G.ktiles, kt0 + kt_per_split) - kt0);
  const size_t krow = p.lda;
  const float* w_hi = p.w + G.a_off;
  const float* w_lo = w_hi + (size_t)p.cout * krow;

  // Per-thread column state of the B staging.
  constexpr int CPT = VEC ? 1 : BN / 32;   // columns (16-byte runs with VEC) a thread
  int base[CPT];
  unsigned mask[CPT];
  if (VEC) {
    const int col = n0 + 4 * (tid % (BN / 4));
    const int img = col / G.out_hw;
    base[0] = col < G.ncols ? img * p.cin * p.in_hw + (col - img * G.out_hw) : 0;
    mask[0] = col < G.ncols ? 1u : 0u;
  } else {
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int col = n0 + lane + 32 * e;
      const int img = col / G.out_hw, pix = col - img * G.out_hw;
      const int hh = pix / G.out_w, ww = pix - hh * G.out_w;
      const int ih = hh * p.stride, iw = ww * p.stride;
      base[e] = col < G.ncols ? img * p.cin * p.in_hw + ih * p.in_w + iw : 0;
      unsigned m = 0;
      if (col < G.ncols) {
        for (int r = 0; r < G.kh; ++r)
          for (int s = 0; s < G.kw; ++s) {
            const bool ok = (unsigned)(ih + r - G.pad_h) < (unsigned)p.in_h &&
                            (unsigned)(iw + s - G.pad_w) < (unsigned)p.in_w;
            m |= (ok ? 1u : 0u) << (r * G.kw + s);
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
        cp_async16(b_dst + r * LDB + c, ok ? p.x + base[0] + ci * p.in_hw : p.x, ok ? 16 : 0);
      }
    } else {
      const int rr = tap / G.kw, ss = tap - rr * G.kw;
      const int off = (rr - G.pad_h) * p.in_w + (ss - G.pad_w);
#pragma unroll
      for (int r = warp; r < kBK; r += NWARPS) {
        const int ci = ci0 + r;
        const bool ci_ok = ci < p.cin;
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const bool ok = ci_ok && ((mask[e] >> tap) & 1u);
          cp_async4(b_dst + r * LDB + lane + 32 * e,
                    ok ? p.x + base[e] + ci * p.in_hw + off : p.x, ok ? 4 : 0);
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
  // of the warp tile. Unphased, a pair of columns of one image is one 8-byte
  // store; a phase's columns land two apart in y, one 4-byte store each.
  float* y = p.y + (size_t)blockIdx.z * p.y_split;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * T::kWN + 8 * j + 2 * t;
    if (col >= G.ncols) continue;
    const bool has1 = col + 1 < G.ncols;
    float *y0, *y1;
    bool pair = false;
    if (PHASED) {
      auto at = [&](int c) {
        const int img = c / G.out_hw, pix = c - img * G.out_hw;
        const int r = pix / G.out_w, q = pix - r * G.out_w;
        return y + (size_t)img * p.cout * p.y_hw + G.y_off + 2 * (r * p.y_w + q);
      };
      y0 = at(col);
      y1 = has1 ? at(col + 1) : y0;
    } else {
      const int img = col / G.out_hw, pix = col - img * G.out_hw;
      y0 = y + (size_t)img * p.cout * G.out_hw + pix;
      pair = has1 && pix + 1 < G.out_hw && ((pix & 1) == 0) && ((G.out_hw & 1) == 0);
      y1 = y0 + 1;
      if (has1 && pix + 1 == G.out_hw) y1 = y + (size_t)(img + 1) * p.cout * G.out_hw;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * T::kWM + 16 * i + g + 8 * h;
        if (m >= p.cout) continue;
        const float bv = p.bias ? p.bias[m] : 0.f;
        const float v0 = acc[i][j][2 * h] + bv, v1 = acc[i][j][2 * h + 1] + bv;
        const size_t mo = (size_t)m * p.y_hw;
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

// The tile: 64 output channels by 128 columns, four warps of 64 x 32, three
// stages (107.5 KB of shared memory, two blocks an SM). A sweep of four
// tiles (128 x 128 of eight warps, 64 x 128, 64 x 64, 64 x 256 of eight)
// and splits over the 96 GEMMs of a BigGAN-deep-256 step (forward and input
// gradient at 18 rows) put this one within 0.5 % of the best tile for each
// shape in sum (PERF.md section 6).
constexpr int kTileM = 64, kTileN = 128, kWarpsM = 1, kWarpsN = 4, kStages = 3;
// The thin tile, for GEMMs of at most 32 rows: 32 x 128, four warps of
// 32 x 32, two stages (53 KB of shared memory). At FFHQ's 1024 px 3x3 (M
// 32, K 288, bound by bytes; 11 rows on an H100 80GB HBM3) it took 6.0 ms
// where 64 x 128 took 9.9; 32 x 256 (four or eight warps, two or three
// stages), 32 x 512 of eight warps, 32 x 128 of two warps or three stages
// and 32 x 64 of two warps read 6 to 56 % slower (PERF.md section 6).
constexpr int kThinM = 32, kThinN = 128, kThinWarpsN = 4, kThinStages = 2;
// The tall tile, for the up_grad route's GEMMs of 128 rows or more: 128 x
// 128, eight warps of 64 x 32, two stages (108.5 KB). Its B rows are read
// at stride 2, so each K tile moves twice the sectors of a stride-1 one,
// and a taller tile reads each of them for twice the rows: at cars'
// up-convolutions' input gradients (M 128 to 512, 22 rows, H100 80GB HBM3)
// it took 2.47 to 4.77 ms where 64 x 128 took 2.77 to 5.51 (PERF.md
// section 6).
constexpr int kTallM = 128, kTallN = 128, kTallWarpsM = 2, kTallWarpsN = 4, kTallStages = 2;

enum TileKind { kDefaultTile, kThinTile, kTallTile };

// The tile of a launch, from its route and M alone.
TileKind tile_of(const Params& p) {
  if (p.cout <= kThinM) return kThinTile;
  if (p.route == kUpGrad && p.cout >= kTallM) return kTallTile;
  return kDefaultTile;
}

// Columns of the GEMM `phase` of a launch (the up route's phase 0, 2x2 taps
// on (h+1) x (w+1), is its largest).
long long columns(const Params& p, int phase, bool phased) {
  if (!phased) return (long long)p.n * p.out_h * p.out_w;
  return (long long)p.n * (p.in_h + 1 - (phase >> 1)) * (p.in_w + 1 - (phase & 1));
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool VEC, bool PHASED>
cudaError_t launch_one(const Params& p, int dev, cudaStream_t st) {
  using T = Tile<BM, BN, WARPS_M, WARPS_N, STAGES>;
  auto kern = conv_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, VEC, PHASED>;
  static unsigned long long ready = 0;     // a bit a device
  if (dev >= 64 || !((ready >> dev) & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) ready |= 1ull << dev;
  }
  const long long tiles_n = (columns(p, 0, PHASED) + BN - 1) / BN;
  const dim3 grid((unsigned)((PHASED ? kPhases : 1) * tiles_n), (p.cout + BM - 1) / BM,
                  p.splits);
  kern<<<grid, T::kThreads, T::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
cudaError_t launch(const Params& p, bool vec, bool phased, int dev, cudaStream_t st) {
  if (vec) return launch_one<BM, BN, WARPS_M, WARPS_N, STAGES, true, false>(p, dev, st);
  return phased ? launch_one<BM, BN, WARPS_M, WARPS_N, STAGES, false, true>(p, dev, st)
                : launch_one<BM, BN, WARPS_M, WARPS_N, STAGES, false, false>(p, dev, st);
}

cudaError_t dispatch(const Params& p, bool vec, int dev, cudaStream_t st) {
  const bool phased = p.route == kUp;
  switch (tile_of(p)) {
    case kThinTile:
      return launch<kThinM, kThinN, 1, kThinWarpsN, kThinStages>(p, vec, phased, dev, st);
    case kTallTile:     // the up_grad route: neither 16-byte rows nor phases
      return launch_one<kTallM, kTallN, kTallWarpsM, kTallWarpsN, kTallStages, false, false>(
          p, dev, st);
    default:
      return launch<kTileM, kTileN, kWarpsM, kWarpsN, kStages>(p, vec, phased, dev, st);
  }
}

// The split of K for `tiles` output tiles (over every GEMM of the launch)
// whose largest GEMM has `ktiles` K tiles: K is halved as long as the blocks
// (the tiles times the splits) stay within kMaxBlocksPerSM an SM and each
// split keeps kMinSplitKTiles K tiles; then made even, so that no split of
// the largest GEMM is empty. At biggan-deep-256's shapes (18 rows) this
// splits the GEMMs of the 4x4 to 32x32 blocks in 2 to 16 and leaves those at
// 64x64 and above whole; StyleGAN2's at 22 rows alike.
int plan_splits(long long tiles, int ktiles) {
  int splits = 1;
  while (2 * splits <= kMaxSplits && 2 * splits * tiles <= (long long)kMaxBlocksPerSM * kSMs &&
         ktiles / (2 * splits) >= kMinSplitKTiles)
    splits *= 2;
  const int per = (ktiles + splits - 1) / splits;
  return (ktiles + per - 1) / per;
}

int plan(const Params& p) {
  const TileKind kind = tile_of(p);
  const bool phased = p.route == kUp;
  const int bm = kind == kThinTile ? kThinM : kind == kTallTile ? kTallM : kTileM;
  const int bn = kind == kThinTile ? kThinN : kind == kTallTile ? kTallN : kTileN;
  long long tiles_n = 0;
  for (int f = 0; f < (phased ? kPhases : 1); ++f) tiles_n += (columns(p, f, phased) + bn - 1) / bn;
  const int ktiles = (phased ? 4 : p.ksize * p.ksize) * p.kchunks;
  return plan_splits(tiles_n * ((p.cout + bm - 1) / bm), ktiles);
}

// Fills `p` for `route` and plans its split; false for a shape the route
// refuses. h x wd is x's plane for `same` and `up`, and dx's (the small
// plane) for `up_grad`, whose x is the (2h+1) x (2wd+1) gradient.
bool make_params(Params& p, int route, int n, int cin, int cin_pad, int h, int wd, int cout,
                 int ksize) {
  if (n < 1 || cin < 1 || cin_pad < kBK || cin_pad % kBK != 0 || cin_pad < cin ||
      cin_pad - cin >= kBK || h < 1 || wd < 1 || cout < 1)
    return false;
  if (route == kSame ? (ksize != 1 && ksize != 3)
                     : (route != kUp && route != kUpGrad) || ksize != 3)
    return false;
  const long long big = (long long)(2 * h + 1) * (2 * wd + 1), small = (long long)h * wd;
  const long long in_hw = route == kUpGrad ? big : small, y_hw = route == kUp ? big : small;
  if (n * in_hw >= (1LL << 31) || n * y_hw >= (1LL << 31)) return false;
  p.route = route;
  p.n = n;
  p.cin = cin;
  p.in_h = route == kUpGrad ? 2 * h + 1 : h;
  p.in_w = route == kUpGrad ? 2 * wd + 1 : wd;
  p.in_hw = (int)in_hw;
  p.cout = cout;
  p.kchunks = cin_pad / kBK;
  p.lda = ksize * ksize * cin_pad;
  p.out_h = h;
  p.out_w = wd;
  p.ksize = ksize;
  p.pad = route == kSame ? ksize / 2 : 0;
  p.stride = route == kUpGrad ? 2 : 1;
  p.y_w = route == kUp ? 2 * wd + 1 : wd;
  p.y_hw = (int)y_hw;
  p.splits = plan(p);
  return true;
}

// Launches on `stream` with `device` current.
cudaError_t run(Params& p, const float* bias, float* y, float* ws, bool vec, int device,
                cudaStream_t st) {
  const long long total = (long long)p.n * p.cout * p.y_hw;
  if (p.splits == 1) {
    p.bias = bias;
    p.y = y;
    p.y_split = 0;
    return dispatch(p, vec, device, st);
  }
  p.bias = nullptr;
  p.y = ws;
  p.y_split = total;
  const cudaError_t e = dispatch(p, vec, device, st);
  if (e != cudaSuccess) return e;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  splitk_reduce_kernel<<<blocks, threads, 0, st>>>(ws, bias, y, total, p.splits, p.y_hw,
                                                   p.cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of splits of K block_conv runs at this shape and route (1:
// none), so that the caller can size its workspace; 0 for a shape it
// refuses. Arguments as block_conv's.
int block_conv_splits(int n, int cin_pad, int h, int wd, int cout, int ksize, int route) {
  Params p;
  return make_params(p, route, n, cin_pad, cin_pad, h, wd, cout, ksize) ? p.splits : 0;
}

// The convolution of x by A as set out above, on `route` (0 same, 1 up, 2
// up_grad). x [n, cin, h, w] (up_grad: [n, cin, 2h+1, 2w+1]) f32; w the
// packed A [2][cout][taps][cin_pad]; bias [cout] or null (same only); y [n,
// cout, h, w] (up: [n, cout, 2h+1, 2w+1]). Where block_conv_splits gives
// more than 1, ws is a workspace of that many times y's elements (else
// unused). Launches on `stream` of card `device`, which is made current for
// the launch and then restored.
int block_conv(const void* x, const void* w, const void* bias, void* y, void* ws, int n,
               int cin, int cin_pad, int h, int wd, int cout, int ksize, int route,
               int device, void* stream) {
  Params p;
  if (!make_params(p, route, n, cin, cin_pad, h, wd, cout, ksize) ||
      (p.splits > 1 && ws == nullptr) || (route != kSame && bias != nullptr) || device < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)n * cin * p.in_hw >= (1LL << 31) ||
      (long long)n * cout * p.y_hw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  p.x = (const float*)x;
  p.w = (const float*)w;
  const bool vec = route == kSame && ksize == 1 && p.in_hw % 4 == 0 &&
                   ((uintptr_t)x % 16) == 0;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = run(p, (const float*)bias, (float*)y, (float*)ws, vec, device, (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t r = cudaSetDevice(prev);
    if (e == cudaSuccess) e = r;
  }
  return (int)e;
}

}  // extern "C"
