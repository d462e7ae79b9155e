// Separable zero-padded FIR blur for Hopper (sm_90a), StyleGAN2's post-upsample
// blur: y = correlate(pad(x, p0, p1), outer(taps, taps)) on every plane.
//
// Replaces the Pallas TPU kernel pix2latent_tpu/ops/pallas_fir.py
// (_fir_blur_impl -> _fir_plane_kernel); its custom-VJP backward
// (_fir_blur_bwd) is this same kernel called with the taps reversed and the
// pad (K-1-p0, K-1-p1). Same function and the same rounding points: the
// column taps run first (along H), then the row taps (along W), both
// accumulated in f32 with fmaf in tap order, and the result is rounded once to
// x's type. up = down = 1.
//
// Shapes: x [planes, H, W] (an NCHW tensor viewed as N*C planes), contiguous,
// float32 or bfloat16, its data pointer only element-aligned; y [planes, Ho,
// Wo] with Ho = H + p0 + p1 - K + 1 (the same for W); 1 to 8 taps; any pad
// that leaves Ho, Wo >= 1. StyleGAN2-cars-512 at pop 22 blurs seven levels
// r = 8 .. 512: x [22, ch(r), r+1, r+1] -> y [22, ch(r), r, r], K = 4, pad
// (1, 1), and the backward the same shapes the other way; the largest is
// [22, 64, 513, 513].
//
// Bound on an H100 SXM: 2*K MACs per output element against 2 to 4 bytes
// moved for it, far below the ~295 operations a byte at which the card's
// arithmetic would bind, so the kernel is bound by bytes: each input read
// once and each output written once, planes * (H*W + Ho*Wo) * size. At the
// largest level in bf16 that is 1.48 GB, 0.44 ms at 3.35 TB/s; all seven
// levels of one direction move 2.84 GB, 0.85 ms.
//
// What held the first design back (one block per 32x64 output tile, 2.9x and
// 3.4x the bound at the largest level): scalar 2-byte global accesses with a
// divide and four bounds tests per element; the window staged in shared memory
// as f32 and a second f32 buffer between the passes, about ten shared
// accesses per output; 64-wide tiles ragged against 513-wide planes and mostly
// idle on planes of 32 or less; no copy in flight while a block computed.
//
// Design.
// - Strips and tiles. A plane's Ho output rows are cut into strips of about
//   kStripRows rows, their heights spread evenly. A thread owns a run of V
//   consecutive output columns (16 bytes: 8 in bf16, 4 in f32) of one strip
//   and walks down it; a strip's row takes ceil(Wo / V) threads. A tile is T
//   consecutive strips (several whole small planes, or a few strips of one
//   large one), so that a block of about 256 threads is busy at every level,
//   and there are at least two tiles for each block the card holds.
// - Whole rows, contiguous ranges. A tile's input rows, the K-1 halo rows
//   between its strips included, are one contiguous range of x. 513-wide
//   rows start at any 2- or 4-byte offset, so no 2-D copy describes them, but
//   a 1-D range does: it is staged in 16-byte cp.async.cg copies of the
//   aligned 16-byte chunks that cover it, placed in shared memory at the same
//   offset modulo 16 as in x. The two end chunks may reach past the range
//   (never past the 16-byte chunk, so never into another page); what they
//   bring is not used. Only the K-1 halo rows of a tile are read again, by
//   the next tile, mostly from L2.
// - Both passes from registers. The input stays in shared memory in its own
//   type. For each input row a thread reads the V+K-1 values its columns need
//   in 8-byte words (realigned by a select and, in bf16, a funnel shift),
//   adds them into the column sums of the K output rows that row feeds (a
//   ring of K x (V+K-1) f32 registers, its slots fixed at compile time by
//   unrolling the row loop K times), and when an output row's column sums
//   are complete runs the row taps on them in registers. Each staged element
//   is read (V+K-1)/V times. Rows outside the plane are read from a row of
//   zeros in shared memory, so the walk has no branch on them; columns
//   outside it are masked per thread, and the first and last run of each
//   strip row sit together in the block's last threads, so that the masking
//   diverges in few warps.
// - Stores. Each thread stores its V results of a row straight to y: one
//   16-byte store where the run starts on a 16-byte boundary (every row of
//   the forward, whose rows are 512 wide), else the fewest aligned 8-, 4- and
//   2-byte stores (the backward's 513-wide rows). Staging the output in shared
//   memory to write whole 16-byte chunks was slower on the card (PERF.md).
// - Overlap. The grid is persistent (blocks an SM by occupancy, times the
//   SMs; 96 registers and about 74 KB of shared memory in bf16 leave two);
//   each block walks its tiles with kStages input stages, so the next tile's
//   copies are in flight while this one computes and stores.
// - Rows too wide for one tile (more than kRunsPerRow runs, or a tile over
//   the shared-memory budget) are cut into column segments of kRunsPerRow
//   runs, one strip a tile, each input row of the segment staged as its own
//   range.
// Each output is written by one thread in a fixed order, so repeated calls
// give bitwise-equal results.
//
// C interface, bound from Python with ctypes: fir_blur returns the
// cudaError_t of the launch (0 on success) and does not synchronise;
// fir_blur_work returns the bytes this design moves for a shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kStripRows = 8;        // output rows a thread walks, about
constexpr int kRunsPerRow = 256;     // most threads across one tile row
constexpr int kThreadsTarget = 256;  // threads a block, about
constexpr int kMaxThreads = 288;    // two blocks an SM: at most 113 registers a thread
constexpr int kStages = 2;           // input stages in the ring
constexpr int kGuard = 32;           // elements of slack around each input stage
constexpr int kSmemBudget = 113 * 1024;  // two blocks an SM (228 KB, 1 KB each reserved)
constexpr int kSmemMax = 232448;

struct Taps {
  float v[kMaxTaps];
};

// `count` ranges of `len` elements, range j starting at element e0 + j*stride
// of the tensor and staged in the slot at j*pitch of a shared buffer.
struct Span {
  long long e0, stride;
  int len, count, pitch;
};

// The tiling. The launcher and fir_blur_work both read it.
struct Plan {
  int size, V;            // element bytes; elements in 16 bytes
  int k, h, w, ho, wo, p0;
  long long planes;
  int seg;                // 1: rows cut into column segments, one strip a tile
  int seg_w, segs;        // output columns a segment, segments a row
  int runs;               // threads across one strip row
  int strips;             // strips a plane: sq rows each, one more in the first srem
  int sq, srem;
  int per_tile;           // strips a tile
  int threads;
  long long tiles;
  int big;                // 1: strip and tile indices need 64-bit division
  int in_pitch;           // slot width in segment mode
  int in_elems;           // one input stage, guards included
  int zero_elems;           // a row of zeros, read for rows outside the plane
  int smem_bytes;
};

struct Tile {
  Span in;
  int in_lo, in_hi;       // staged input columns
  int cx0, cx1;           // output columns
  int iy0, oy0, oy1;      // first staged input row, output rows (segment mode)
};

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
__host__ __device__ inline long long roundup(long long a, long long b) { return cdiv(a, b) * b; }
__host__ __device__ inline long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a / b for a strip or tile index a: 32-bit unless the plan says otherwise
__host__ __device__ inline long long qdiv(const Plan& p, long long a, int b) {
  return p.big ? a / b : (long long)((unsigned)a / (unsigned)b);
}

// output rows [a, b) of strip s of a plane
__host__ __device__ inline void strip_rows(const Plan& p, int s, int* a, int* b) {
  *a = s * p.sq + (s < p.srem ? s : p.srem);
  *b = *a + p.sq + (s < p.srem ? 1 : 0);
}

__host__ __device__ inline Tile tile_at(const Plan& p, long long t) {
  Tile r;
  if (!p.seg) {
    const long long n = p.planes * p.strips;
    const long long g0 = t * p.per_tile;
    const long long g1 = (g0 + p.per_tile < n ? g0 + p.per_tile : n) - 1;
    const long long pa = qdiv(p, g0, p.strips), pb = qdiv(p, g1, p.strips);
    int a0, a1, b0, b1;
    strip_rows(p, (int)(g0 - pa * p.strips), &a0, &a1);
    strip_rows(p, (int)(g1 - pb * p.strips), &b0, &b1);
    const long long fr0 = pa * p.h + clampll((long long)a0 - p.p0, 0, p.h);
    const long long fr1 = pb * p.h + clampll((long long)b1 - 1 - p.p0 + p.k, 0, p.h);
    r.in = {fr0 * p.w, 0, (int)((fr1 - fr0) * p.w), 1, 0};
    r.in_lo = 0;
    r.in_hi = p.w;
    r.cx0 = 0;
    r.cx1 = p.wo;
    r.iy0 = r.oy0 = r.oy1 = 0;
  } else {
    const long long rest = qdiv(p, t, p.segs);
    const long long s = t - rest * p.segs;
    const long long plane = qdiv(p, rest, p.strips);
    int oy0, oy1;
    strip_rows(p, (int)(rest - plane * p.strips), &oy0, &oy1);
    r.cx0 = (int)(s * p.seg_w);
    r.cx1 = (int)clampll((long long)r.cx0 + p.seg_w, 0, p.wo);
    r.in_lo = (int)clampll((long long)r.cx0 - p.p0, 0, p.w);
    r.in_hi = (int)clampll((long long)r.cx1 - 1 - p.p0 + p.k, 0, p.w);
    r.iy0 = (int)clampll((long long)oy0 - p.p0, 0, p.h);
    const int iy1 = (int)clampll((long long)oy1 - 1 - p.p0 + p.k, 0, p.h);
    r.oy0 = oy0;
    r.oy1 = oy1;
    r.in = {(plane * p.h + r.iy0) * p.w + r.in_lo, p.w, r.in_hi - r.in_lo, iy1 - r.iy0,
            p.in_pitch};
  }
  return r;
}

inline int smem_bytes(const Plan& p) {
  return (int)(((long long)kStages * p.in_elems + p.zero_elems) * p.size);
}

// Full-row tiles of t strips: the shared memory they need, or a value over
// kSmemMax where it does not fit an int.
inline long long full_smem(Plan& p, long long t, int smax) {
  const long long maxp = (t - 1 + p.strips - 1) / p.strips + 1;
  long long rows = t * smax + (p.k - 1) + (maxp - 1) * (p.h > p.ho ? p.h - p.ho : 0);
  if (rows > maxp * p.h) rows = maxp * p.h;
  const long long in = 2LL * kGuard + roundup(rows * p.w + p.V - 1, p.V);
  if (in > (1LL << 28)) return 1LL << 40;
  p.in_elems = (int)in;
  p.zero_elems = (int)roundup(p.w + 2 * (p.V + p.k) + 16, p.V);
  return smem_bytes(p);
}

Plan make_plan(int size, int k, long long planes, int h, int w, int ho, int wo, int p0,
               int sms) {
  Plan p = {};
  p.size = size;
  p.V = 16 / size;
  p.k = k;
  p.h = h;
  p.w = w;
  p.ho = ho;
  p.wo = wo;
  p.p0 = p0;
  p.planes = planes;
  p.strips = (int)cdiv(ho, kStripRows);
  p.sq = ho / p.strips;
  p.srem = ho % p.strips;
  const int smax = (int)cdiv(ho, p.strips);
  const long long nstrips = planes * p.strips;
  const int runs = (int)cdiv(wo, p.V);
  if (runs <= kRunsPerRow) {
    p.seg = 0;
    p.seg_w = wo;
    p.segs = 1;
    p.runs = runs;
    long long t = (kThreadsTarget + runs / 2) / runs;
    if (t * runs > kMaxThreads) t = kMaxThreads / runs;
    if (t < 1) t = 1;
    const long long fill = cdiv(nstrips, 2LL * sms);  // tiles for two blocks an SM
    if (fill < t) {
      t = fill;
      if (32 % runs == 0) t = roundup(t, 32 / runs);
    }
    if (t > nstrips) t = nstrips;
    while (t > 1 && full_smem(p, t, smax) > kSmemBudget) t = (t + 1) / 2;
    if (full_smem(p, t, smax) <= kSmemBudget) {
      p.per_tile = (int)t;
      p.tiles = cdiv(nstrips, t);
      p.threads = (int)roundup(t * runs, 32);
      p.big = nstrips >= (1LL << 32);
      p.smem_bytes = smem_bytes(p);
      return p;
    }
  }
  p.seg = 1;
  p.seg_w = wo < kRunsPerRow * p.V ? wo : kRunsPerRow * p.V;
  p.segs = (int)cdiv(wo, p.seg_w);
  p.runs = (int)cdiv(p.seg_w, p.V);
  p.per_tile = 1;
  p.tiles = nstrips * p.segs;
  p.threads = (int)roundup(p.runs, 32);
  p.big = p.tiles >= (1LL << 32);
  const int in_len = w < p.seg_w + k - 1 ? w : p.seg_w + k - 1;
  p.in_pitch = (int)roundup(in_len + p.V - 1, p.V);
  p.in_elems = 2 * kGuard + (smax + k - 1) * p.in_pitch;
  p.zero_elems = (int)roundup(in_len + 2 * (p.V + k) + 16, p.V);
  p.smem_bytes = smem_bytes(p);
  return p;
}

// ------------------------------------------------------------------ device

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for all but the kStages - 1 newest groups
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Copy the 16-byte chunks covering every range of `sp` into `dst` (slot j at
// j*pitch), each at its offset modulo 16 in the tensor. `base` is the tensor's
// pointer rounded down to 16 bytes and `mis` its offset from there in elements.
template <typename T>
__device__ void stage(const T* base, int mis, const Span& sp, T* dst) {
  constexpr int V = 16 / sizeof(T);
  if (sp.len <= 0) return;
  for (int j = 0; j < sp.count; ++j) {
    const long long a0 = sp.e0 + j * sp.stride + mis;
    const T* src = base + (a0 & ~(long long)(V - 1));
    const int n = ((int)(a0 & (V - 1)) + sp.len + V - 1) / V;
    T* d = dst + j * sp.pitch;
    for (int q = threadIdx.x; q < n; q += blockDim.x) cp_async_16(d + q * V, src + q * V);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// The NE values of one staged row from element `pos` of `s`, as f32. The
// row is read in 8-byte words from the even 4-byte word at or before it (two
// 4-byte words a bank access where 4-byte reads 16 bytes apart would take one)
// and shifted into place.
template <int NE>
__device__ __forceinline__ void load_row(const float* s, int pos, float* v) {
  constexpr int NL = (NE + 2) / 2;
  const float2* p2 = reinterpret_cast<const float2*>(s + (pos & ~1));
  float f[2 * NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    const float2 t = p2[q];
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
  const bool odd = pos & 1;
#pragma unroll
  for (int c = 0; c < NE; ++c) v[c] = odd ? f[c + 1] : f[c];
}

template <int NE>
__device__ __forceinline__ void load_row(const __nv_bfloat16* s, int pos, float* v) {
  constexpr int NP = (NE + 1) / 2;       // element pairs
  constexpr int NL = (NP + 3) / 2;       // 8-byte reads: NP + 1 words from an odd word
  const int w0 = pos >> 1;
  const uint2* p2 = reinterpret_cast<const uint2*>(s) + (w0 >> 1);
  uint32_t f[2 * NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    const uint2 t = p2[q];
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
  const bool odd = w0 & 1;
  uint32_t raw[NP + 1];
#pragma unroll
  for (int q = 0; q <= NP; ++q) raw[q] = odd ? f[q + 1] : f[q];
  const int sh = (pos & 1) << 4;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const uint32_t u = __funnelshift_r(raw[q], raw[q + 1], sh);
    v[2 * q] = __uint_as_float(u << 16);
    if (2 * q + 1 < NE) v[2 * q + 1] = __uint_as_float(u & 0xffff0000u);
  }
}

// Round the V results of one output row, o[0..n), to T and store them at
// element `pos` (< V) past the 16-byte aligned `out`: one 16-byte store where
// the run is aligned, else the fewest aligned 8-, 4- and 2-byte stores.
__device__ __forceinline__ void put_row(float* out, int pos, const float* o, int n) {
  if (n == 4) {
    if ((pos & 3) == 0) {
      *reinterpret_cast<float4*>(out + pos) = make_float4(o[0], o[1], o[2], o[3]);
    } else if ((pos & 1) == 0) {
      reinterpret_cast<float2*>(out + pos)[0] = make_float2(o[0], o[1]);
      reinterpret_cast<float2*>(out + pos)[1] = make_float2(o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[pos + c] = o[c];
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) out[pos + c] = o[c];
  }
}

__device__ __forceinline__ void put_row(__nv_bfloat16* out, int pos, const float* o, int n) {
  uint32_t pw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) pw[q] = pack_bf16(o[2 * q], o[2 * q + 1]);
  unsigned short* o16 = reinterpret_cast<unsigned short*>(out);
  if (n == 8) {
    if ((pos & 7) == 0) {
      *reinterpret_cast<uint4*>(out + pos) = make_uint4(pw[0], pw[1], pw[2], pw[3]);
    } else if ((pos & 3) == 0) {
      uint2* d = reinterpret_cast<uint2*>(out + pos);
      d[0] = make_uint2(pw[0], pw[1]);
      d[1] = make_uint2(pw[2], pw[3]);
    } else if ((pos & 1) == 0) {
      uint32_t* d = reinterpret_cast<uint32_t*>(out + pos);
      d[0] = pw[0];
      *reinterpret_cast<uint2*>(d + 1) = make_uint2(pw[1], pw[2]);
      d[3] = pw[3];
    } else {
      o16[pos] = (unsigned short)(pw[0] & 0xffffu);
      uint32_t w[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) w[q] = __funnelshift_r(pw[q], pw[q + 1], 16);
      uint32_t* d = reinterpret_cast<uint32_t*>(out + pos + 1);
      if (((pos + 1) & 3) == 0) {
        *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
        d[2] = w[2];
      } else {
        d[0] = w[0];
        *reinterpret_cast<uint2*>(d + 1) = make_uint2(w[1], w[2]);
      }
      o16[pos + 7] = (unsigned short)(pw[3] >> 16);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < n) o16[pos + c] = (unsigned short)(pw[c >> 1] >> ((c & 1) << 4));
  }
}

// One thread's strip of tile `tile`: walk its input rows, keep the column
// sums of the last K output rows in registers, finish one output row per
// input row once K rows are in, and store it to y (`yb`: y rounded down to 16
// bytes, `mis_y` elements before it). Rows outside the plane are read from
// the zero row at `zoff` elements from `in_s`.
template <typename T, int K>
__device__ __forceinline__ void blur_strip(const Plan& p, const Tile& tl, long long tile,
                                           const T* in_s, int zoff, T* yb, int mis_x,
                                           int mis_y, const Taps& taps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NE = V + K - 1;
  constexpr uint32_t kAll = (1u << NE) - 1;
  // threads to (strip of the tile, run); the first and last run of every
  // strip row come last, so that the column masking diverges in few warps
  const int c_in = p.runs - 2, inner = p.per_tile * c_in;
  int sl, run;
  if (p.runs <= 2) {
    sl = threadIdx.x / p.runs;
    run = threadIdx.x - sl * p.runs;
  } else if ((int)threadIdx.x < inner) {
    sl = threadIdx.x / c_in;
    run = 1 + threadIdx.x - sl * c_in;
  } else {
    const int e = threadIdx.x - inner;
    sl = e >> 1;
    run = (e & 1) ? p.runs - 1 : 0;
  }
  if (sl >= p.per_tile) return;
  long long plane;
  int oy0, oy1;
  if (!p.seg) {
    const long long g = tile * p.per_tile + sl;
    if (g >= p.planes * p.strips) return;
    plane = qdiv(p, g, p.strips);
    strip_rows(p, (int)(g - plane * p.strips), &oy0, &oy1);
  } else {
    plane = qdiv(p, qdiv(p, tile, p.segs), p.strips);
    oy0 = tl.oy0;
    oy1 = tl.oy1;
  }
  const int ox = tl.cx0 + run * V;
  if (ox >= tl.cx1) return;
  const int n_out = tl.cx1 - ox < V ? tl.cx1 - ox : V;

  // input columns ix0 .. ix0+NE-1; bit c of `mask` says column ix0+c lies in
  // the plane; reads start at `cb`, which keeps them inside the stage and its
  // guards (a window clamped there is wholly outside the plane)
  const long long ix0 = (long long)ox - p.p0;
  uint32_t mask = 0;
#pragma unroll
  for (int c = 0; c < NE; ++c)
    if (ix0 + c >= 0 && ix0 + c < p.w) mask |= 1u << c;
  const bool edge = mask != kAll;
  const int cb = (int)clampll(ix0, (long long)tl.in_lo - (V + K), tl.in_hi);

  // positions of the walk's first input row (oy0 - p0) in the stage and of
  // output row oy0 in the output buffer; full-row tiles step them by one row,
  // segment slots start each row at its own offset modulo 16 bytes
  const int in_lead = (int)((tl.in.e0 + mis_x) & (V - 1));
  long long iy = (long long)oy0 - p.p0;
  long long rp = kGuard + in_lead + (plane * p.h + iy) * p.w - tl.in.e0 + cb;
  long long gi = (plane * p.ho + oy0) * p.wo + ox + mis_y;   // from yb
  const int zpos = zoff + cb - tl.in_lo + (V + K);

  float part[K][NE];
  const int n_in = (oy1 - oy0) + K - 1;
  for (int i0 = 0; i0 < n_in; i0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int i = i0 + u;
      if (i < n_in) {
        float v[NE];
        int pos = (int)rp;
        if (p.seg) {
          const int j = (int)(iy - tl.iy0);
          pos = kGuard + j * tl.in.pitch + ((in_lead + j * (p.w & (V - 1))) & (V - 1)) + cb -
                tl.in_lo;
        }
        load_row<NE>(in_s, iy >= 0 && iy < p.h ? pos : zpos, v);
        if (edge) {
#pragma unroll
          for (int c = 0; c < NE; ++c) v[c] = (mask >> c) & 1u ? v[c] : 0.f;
        }
        // input row i feeds the column sums of output rows i-j, j < K, in
        // slot (i-j) mod K: tap 0 starts a row's sum, tap K-1 completes it
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int slot = (u - j + K) % K;
#pragma unroll
          for (int c = 0; c < NE; ++c)
            part[slot][c] = j == 0 ? taps.v[0] * v[c] : fmaf(taps.v[j], v[c], part[slot][c]);
        }
        if (i >= K - 1) {
          const float* m = part[(u + 1) % K];
          float o[V];
#pragma unroll
          for (int c = 0; c < V; ++c) {
            float a = taps.v[0] * m[c];
#pragma unroll
            for (int j = 1; j < K; ++j) a = fmaf(taps.v[j], m[c + j], a);
            o[c] = a;
          }
          put_row(yb + (gi & ~(long long)(V - 1)), (int)(gi & (V - 1)), o, n_out);
          gi += p.wo;
        }
        ++iy;
        rp += p.w;
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, 2)
fir_blur_kernel(const T* __restrict__ x, T* __restrict__ y, Plan p, Taps taps) {
  extern __shared__ __align__(16) unsigned char fir_smem[];
  constexpr int V = 16 / sizeof(T);
  T* stages = reinterpret_cast<T*>(fir_smem);
  T* zero_s = stages + kStages * p.in_elems;
  const int mis_x = (int)(((uintptr_t)x & 15) / sizeof(T));
  const int mis_y = (int)(((uintptr_t)y & 15) / sizeof(T));
  const T* xb = x - mis_x;
  T* yb = y - mis_y;
  for (int e = threadIdx.x * V; e < p.zero_elems; e += blockDim.x * V)
    *reinterpret_cast<uint4*>(zero_s + e) = make_uint4(0, 0, 0, 0);

  // the ring: tile it + s of this block goes to stage (it + s) % kStages
  for (int s = 0; s < kStages - 1; ++s) {
    const long long t = blockIdx.x + (long long)s * gridDim.x;
    if (t < p.tiles) stage(xb, mis_x, tile_at(p, t).in, stages + s * p.in_elems + kGuard);
    cp_async_commit();
  }
  long long tile = blockIdx.x;
  for (int it = 0; tile < p.tiles; ++it, tile += gridDim.x) {
    const long long next = tile + (long long)(kStages - 1) * gridDim.x;
    if (next < p.tiles)
      stage(xb, mis_x, tile_at(p, next).in,
            stages + ((it + kStages - 1) % kStages) * p.in_elems + kGuard);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const Tile tl = tile_at(p, tile);
    const T* in_s = stages + (it % kStages) * p.in_elems;
    blur_strip<T, K>(p, tl, tile, in_s, (int)(zero_s - in_s), yb, mis_x, mis_y, taps);
    __syncthreads();
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

template <typename T, int K>
cudaError_t launch(const void* x, void* y, const Plan& p, const Taps& taps, cudaStream_t s) {
  auto kernel = fir_blur_kernel<T, K>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  if (p.smem_bytes > kSmemMax || p.threads > kMaxThreads) return cudaErrorInvalidConfiguration;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads,
                                                                p.smem_bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * sm_count();
  if (grid > p.tiles) grid = p.tiles;
  kernel<<<(unsigned)grid, p.threads, p.smem_bytes, s>>>((const T*)x, (T*)y, p, taps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, const Plan& p, const Taps& t, cudaStream_t s) {
  switch (p.k) {
    case 1: return launch<T, 1>(x, y, p, t, s);
    case 2: return launch<T, 2>(x, y, p, t, s);
    case 3: return launch<T, 3>(x, y, p, t, s);
    case 4: return launch<T, 4>(x, y, p, t, s);
    case 5: return launch<T, 5>(x, y, p, t, s);
    case 6: return launch<T, 6>(x, y, p, t, s);
    case 7: return launch<T, 7>(x, y, p, t, s);
    default: return launch<T, 8>(x, y, p, t, s);
  }
}

bool valid(int k, int planes, int h, int w, int ho, int wo) {
  return k >= 1 && k <= kMaxTaps && planes >= 1 && h >= 1 && w >= 1 && ho >= 1 && wo >= 1;
}

}  // namespace

extern "C" {

// y [planes, ho, wo] in x's type; taps: k f32 values; p0: the leading pad of
// both spatial axes (the trailing pad is implied by ho and wo).
int fir_blur(const void* x, void* y, const float* taps, int k, int planes, int h, int w,
             int ho, int wo, int p0, int is_bf16, void* stream) {
  if (!valid(k, planes, h, w, ho, wo)) return (int)cudaErrorInvalidValue;
  Taps t;
  for (int j = 0; j < kMaxTaps; ++j) t.v[j] = j < k ? taps[j] : 0.f;
  const Plan p = make_plan(is_bf16 ? 2 : 4, k, planes, h, w, ho, wo, p0, sm_count());
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return (int)dispatch<__nv_bfloat16>(x, y, p, t, s);
  return (int)dispatch<float>(x, y, p, t, s);
}

// *bytes: the bytes fir_blur moves between the SMs and memory for this shape
// (x 16-byte aligned): every 16-byte chunk it copies in, the halo rows read
// again by the next tile and the chunks reaching past a range included, and
// every element it writes. Launches nothing.
int fir_blur_work(int k, int planes, int h, int w, int ho, int wo, int p0, int is_bf16,
                  double* bytes) {
  if (!valid(k, planes, h, w, ho, wo)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(is_bf16 ? 2 : 4, k, planes, h, w, ho, wo, p0, sm_count());
  double moved = 0.0;
  for (long long t = 0; t < p.tiles; ++t) {
    const Tile tl = tile_at(p, t);
    if (tl.in.len > 0)
      for (int j = 0; j < tl.in.count; ++j) {
        const long long a0 = tl.in.e0 + j * tl.in.stride;
        moved += 16.0 * ((a0 + tl.in.len - 1) / p.V - a0 / p.V + 1);
      }
  }
  *bytes = moved + (double)p.size * planes * ho * wo;
  return 0;
}

}  // extern "C"
