// Fused per-row shift + fractional lerp + per-image NT tap matmul: one pass
// of the two-pass affine warp.
//
// Replaces the Pallas TPU kernel `_matmul_kernel` of
// peclr_tpu/ops/pallas/barrel_shift.py (body :392-406, pallas_call :470),
// reached through fused_shift_lerp_matmul.  For G planes of B images of R
// rows of W source elements, a window of U taps per row and M outputs per
// image:
//
//   win[g,b,r,u] = cast_Wt( x[g,b,r,u+k] * (1 - f) + x[g,b,r,u+k+1] * f )
//   out[g,b,m,r] = sum_u win[g,b,r,u] * w_t[b,m,u]        (f32 sum, cast)
//
// with k = k[b*R + r] clamped to [-(U + 2), W], taps outside [0, W) reading
// 0 (a clamped row comes out zero), the lerp in f32 (__fmul_rn/__fadd_rn, as
// the plain version in peclr_tpu_torch/ops/shift_lerp_matmul.py) and the
// window cast to the taps' type before the product, as the TPU kernel does.
// The output comes out transposed (m before r), ready for the next pass.
//
// Bound (pretrain recipe, 2B = 256 canvases), as chip_smoke.py:matmul_bound
// reckons it: the bytes the function must move over 3.35 TB/s.  That is the
// taps, k, f and the output once, and of each row's source only what its
// image's nonzero taps need: with taps in [lo, hi) over all M, source k + lo
// through k + hi.  bf16 taps: pass 1, (3, 256, 224, 224) uint8 in, w_t (256,
// 128, 384) bf16 at slopes 1.0-2.5, (3, 256, 128, 224) bf16 out: about 25 us
// (27 us if all the source that the U-tap window reaches were counted); pass
// 2, (3, 256, 128, 224) bf16 in, w_t (256, 128, 256) bf16 at slopes
// 1.0-1.75, (3, 256, 128, 128) f32 out: about 24 us.  The multiply-adds of
// the nonzero taps (2-4 of a row's U) take under 1 us of the bf16 tensor
// cores, and even the dense product (8.46 G multiply-adds at pass 1) 17 us:
// the function is bound by bytes.  f32 taps (precision="f32"): the taps and
// the window twice the bytes, the output f32; pass 1 (uint8 in, f32 out)
// about 53 us, pass 2 (f32 in and out) about 33 us; the nonzero taps'
// multiply-adds at 67 TFLOP/s of f32 take a few us: bound by bytes too.
//
// Design, bf16 taps (the warp's "matmul" route).  Each call is two launches
// on the caller's stream:
//  1. tap_band: for each (b, tile of kBandM = 32 outputs m) the first u with
//     a nonzero tap and one past the last, int32 (B, ceil(M / 32), 2), (0, 0)
//     for a tile whose taps are all zero.  It reads the taps once, with
//     16-byte loads where U % 8 == 0 and the base is 16-byte aligned.
//  2. shift_lerp_matmul_band: one block of 4 warps per (b, m tile, tile of
//     kBandR = 32 rows r), so the recipe's 224 rows need no padded rows.  It
//     rounds its tile's band out to the MMA depth of 16 and walks only that
//     range, in chunks of 64 taps: it stages the band's taps once (cp.async,
//     16 bytes, where alignment allows; in segments of at most 128 taps) and
//     builds and multiplies the G planes together, kPlanes = 3 at a time (the
//     TPU grid's inner g axis), so a plane group shares each tap fragment.
//     The lerped window of a chunk is cut into tasks of 8 consecutive taps of
//     one row, spread over all threads so that no lane idles on a narrow
//     chunk; a task reads its 9 source elements once, with k and f read and
//     clamped once per row.  The product runs on the tensor cores (ldmatrix
//     and mma.sync m16n8k16 bf16, f32 accumulators, each warp 16 m x 16 r per
//     plane), and the transposed tile goes out along r through shared memory.
//  Why 32 outputs a tile: an area-tap row of slope s spans about s taps, so
//  a tile of 32 reads at most 32 s + 3 of them: 83 at pass 1 (s <= 2.5) and
//  59 at pass 2 (s <= 1.75), 96 and 64 after rounding, against 384 and 256
//  dense.  A tile of 64 would double the taps staged and multiplied per
//  output for about the same window lerps (the tiles' bands together cover
//  the used range either way); one of 16 would round its bands up to 48-64
//  taps and lerp more.
//  Taps outside the band are exact zeros, so skipping them leaves every f32
//  sum unchanged while the window is finite (a skipped term is w * 0 = +-0).
//  A non-finite source value can propagate differently from the dense
//  product: Inf * 0 = NaN there, nothing here.  Any G, B, R, W, U and M are
//  taken; with more than kPlanes planes a multi-segment band is staged again
//  for each group; dense taps (band = U) are the worst case.
//  Where the time goes (chip_smoke.py's kernel phase, PERF.md): building the
//  window, latency-bound on its source loads, then the product and the
//  stores, one after another between the block's barriers.
//
// Design, f32 taps (precision="f32", the warp's "matmul" route in f32).
// Each call is two launches on the caller's stream, as with bf16 taps:
//  1. tap_band, the same pass over f32 taps, with tiles of kF32TileM = 8
//     outputs m: int32 (B, ceil(M / 8), 2).  A block reads the taps of 32
//     outputs (4 tiles, as one bf16 tile), with 16-byte loads where U % 4
//     == 0 and the base is 16-byte aligned, kBandLoads = 4 of them in flight.
//  2. shift_lerp_matmul_f32: one block of 4 warps per (b, group of 32
//     outputs m, tile of 32 rows r); warp w owns the group's tile w of 8
//     outputs and lane l row r0 + l, and sums for the 8 outputs of its tile,
//     for each of kPlanes = 3 planes, only its tile's band (rounded out to 4
//     taps).  The block walks the union of its 4 tiles' bands in segments of
//     at most kF32Seg = 80 taps: one segment for a group at slope s <= 2.25
//     (32 s + 8 <= 80 taps), so all of pass 2 and most of pass 1.  For each
//     segment all threads build the lerped windows of the G planes, kPlanes
//     at a time, in tasks of kF32Task = 16 consecutive taps of one row: each
//     task has the loads of its 17 source elements in flight together (the
//     window build is bound by their latency) and reads each once; k and f
//     of the block's rows are read and clamped once.  Meanwhile each warp
//     stages its own tile's taps of the segment (cp.async, 16 bytes, where
//     alignment allows), in chunks of at most kF32TapSeg = 32 (one chunk at
//     the recipe's slopes).  Taps are shared by the planes of a group,
//     windows by the 4 tiles.  The product is register-tiled f32 FMAs on the
//     CUDA cores: per 4 taps a lane loads its row's 4 window taps of each
//     plane (16-byte loads; row strides of an odd number of 16-byte words
//     keep them free of bank conflicts), then for each of its tile's 8
//     outputs 4 taps (a 16-byte broadcast load) and makes 12 FMAs; each lane
//     stores its 24 sums directly, a warp's 32 rows of one output being one
//     128-byte line.  37 KB of shared memory and at most 80 registers a
//     thread let kF32Blocks = 6 blocks share an SM, to hide the latency of
//     the loads.  In a sweep on the card, tasks of 4 or 8 taps with several
//     in flight, 5 or 7 blocks an SM and segments of 64 or 88 taps were all
//     slower, most where the registers spilled.
//  Why this design: an area-tap row of slope s has about s + 1 nonzero taps,
//  so a tile's band is about 8 s + 2 taps at 8 outputs (10-22 at the
//  recipe's slopes, 12-24 after rounding) against 32 s + 2 (34-82, rounded
//  to 48-96) at the bf16 path's 32.  The f32 product has no MMA depth to
//  round to, so the narrow tile cuts the multiply-adds about 3x: the
//  recipe's pass 1 then makes about 0.4 G FMAs (13 us at 67 TFLOP/s of
//  f32), below its bytes (about 53 us), so the CUDA cores are fast enough
//  and keep f32 exactly.  A 3 x TF32 split on the tensor cores (hi * hi + hi *
//  lo + lo * hi, mma.sync m16n8k8) would buy little: TF32 mma.sync runs
//  about 4x the f32 FMA rate, the split triples the products, and the MMA
//  depth of 8 would round the bands out again.  One-pass TF32 would lose the
//  kernel's 1e-2 bound on the 0-255 scale.
//  Skipped taps are exact zeros, so the sums are those of the dense product
//  while the window is finite; an Inf or NaN source element under a zero
//  tap is NaN in the dense product and skipped here, as on the bf16 path.
//  Any G, B, R, W, U and M are taken: dense taps walk every segment of U
//  (the worst case), rows past R and outputs past M are computed as zeros
//  and not stored.
//
// The designs these replaced: for bf16 taps the dense product (128 x 64
// output tiles of one (g, b) over all U taps, every tap and window element
// staged by a scalar load and the taps re-read for every plane), 0.6828 ms
// at pass 1 and 0.2877 ms at pass 2; for f32 taps the same dense design on
// the CUDA cores (32 outputs a thread, chunks of 32 taps), 0.4207 ms at pass
// 2 when it was written and 0.4310 ms later, against a bound of 0.0334 ms;
// all on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

constexpr int kThreads = 256;  // threads of a band-pass block
constexpr int kBandLoads = 4;  // 16-byte loads a band-pass thread has in flight
constexpr int kPadC = 4;       // accumulator staging row padding

// bf16 taps, band-limited
constexpr int kBandM = 32;                 // outputs m per tile and per band
constexpr int kBandR = 32;                 // rows r per block
constexpr int kBandKC = 64;                // taps per window chunk
constexpr int kDepth = 16;                 // MMA depth
constexpr int kSegMax = 128;               // most taps staged at once
static_assert(kSegMax % kBandKC == 0, "segments hold whole chunks");
constexpr int kPadH = 8;                   // bf16 row padding (keeps 16-byte rows)
constexpr int kLdw = kBandKC + kPadH;      // window chunk row stride
constexpr int kLdc = kBandR + kPadC;       // accumulator staging row stride
constexpr int kBandThreads = 128;          // threads of a product block
constexpr int kBandWarps = kBandThreads / 32;
static_assert(kBandWarps == 2 * (kBandR / 16), "warps tile the output 2 (m) x kBandR / 16 (r)");
constexpr int kPlanes = 3;                 // planes built and multiplied together
constexpr int kTaskTaps = 8;               // window taps a thread builds at once

// f32 taps, band-limited
constexpr int kF32TileM = 8;                            // outputs m per warp tile and per band
constexpr int kF32Warps = 4;                            // tiles of a block
constexpr int kF32GroupM = kF32TileM * kF32Warps;       // outputs m per block
constexpr int kF32Rows = 32;                            // rows r per block, one per lane
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Seg = 80;                             // most window taps built at once
constexpr int kF32Ld = kF32Seg + 4;                     // window row stride
constexpr int kF32TapSeg = 32;                          // most taps of a tile staged at once
constexpr int kF32TapLd = kF32TapSeg + 4;               // tap row stride
static_assert(kF32Seg % 4 == 0 && kF32Ld / 4 % 2 == 1 && kF32TapSeg % 4 == 0 &&
                  kF32TapLd / 4 % 2 == 1,
              "16-byte rows, an odd number of 16-byte words apart");
constexpr int kF32Task = 16;                            // window taps a task builds
static_assert(kF32Task % 4 == 0 && kF32Seg % kF32Task == 0,
              "a task stores whole 16-byte words within the segment's row");
constexpr int kF32Blocks = 6;                           // blocks that share an SM
constexpr size_t kF32Smem =
    sizeof(float) * (kPlanes * kF32Rows * kF32Ld + kF32GroupM * kF32TapLd) +
    (sizeof(int) + sizeof(float)) * kF32Rows;
static_assert(kF32Smem <= 48 * 1024, "no opt-in to more shared memory");

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lerp_rn(float a, float c, float fr) {
  return __fadd_rn(__fmul_rn(a, 1.0f - fr), __fmul_rn(c, fr));
}

// Source element t of a row of w, 0 outside [0, w).
template <typename In>
__device__ __forceinline__ float tap(const In* __restrict__ src, int t, int w) {
  return static_cast<unsigned>(t) < static_cast<unsigned>(w) ? to_f32(src[t]) : 0.0f;
}

// ---------------------------------------------------------------------------
// The band pass

// A tap's bits without the sign: -0 counts as zero, NaN as nonzero, as
// `w_t != 0` does.
__device__ __forceinline__ uint32_t magnitude_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v) & 0x7fffu;
}
__device__ __forceinline__ uint32_t magnitude_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Widen [lo, hi) by the nonzero taps among the 16 / sizeof(T) taps in q,
// whose first tap is u0.
template <typename T>
__device__ __forceinline__ void band_of_vector(uint4 q, int u0, int& lo, int& hi) {
  constexpr int kPer = 16 / sizeof(T), kBits = 8 * sizeof(T);
  constexpr uint32_t kMask = sizeof(T) == 2 ? 0x7fffu : 0x7fffffffu;
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((words[j * kBits / 32] >> (j * kBits % 32)) & kMask) {
      lo = min(lo, u0 + j);
      hi = max(hi, u0 + j + 1);
    }
  }
}

// One block per (b, span of kTiles tiles of kTile outputs), 32 outputs for
// either tap type: the span's taps w_t[b, m0:m1, :] are one contiguous run
// of (m1 - m0) * U elements, tile t's from t * kTile * U on.
template <typename T, int kTile, int kTiles>
__global__ void __launch_bounds__(kThreads)
tap_band(const T* __restrict__ wt, int32_t* __restrict__ band, int m_count, int u_count,
         bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  const int m_tiles = (m_count + kTile - 1) / kTile;
  const int spans = (m_tiles + kTiles - 1) / kTiles;
  const int b = blockIdx.x / spans, sp = blockIdx.x % spans;
  const int m0 = sp * kTiles * kTile, m1 = min(m0 + kTiles * kTile, m_count);
  const long long n = static_cast<long long>(m1 - m0) * u_count;
  const long long tile_elems = static_cast<long long>(kTile) * u_count;
  const T* base = wt + (static_cast<long long>(b) * m_count + m0) * u_count;
  int lo[kTiles], hi[kTiles];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    lo[t] = INT_MAX;
    hi[t] = 0;
  }
  // widen the band of the tile that holds span element e by [l, h)
  auto widen = [&](long long e, int l, int h) {
    const int te = kTiles == 1 ? 0 : static_cast<int>(e / tile_elems);
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (t == te) {
        lo[t] = min(lo[t], l);
        hi[t] = max(hi[t], h);
      }
    }
  };
  if (vec) {  // U % kPer == 0: a 16-byte vector never crosses a row
    const uint4* v = reinterpret_cast<const uint4*>(base);
    const long long nv = n / kPer;
    for (long long i0 = threadIdx.x; i0 < nv; i0 += kBandLoads * kThreads) {
      uint4 q[kBandLoads];  // loaded together, then scanned
#pragma unroll
      for (int j = 0; j < kBandLoads; ++j) {
        const long long i = i0 + j * kThreads;
        q[j] = i < nv ? v[i] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kBandLoads; ++j) {
        if ((q[j].x | q[j].y | q[j].z | q[j].w) == 0) continue;
        const long long i = i0 + j * kThreads;
        int l = INT_MAX, h = 0;
        band_of_vector<T>(q[j], static_cast<int>(i * kPer % u_count), l, h);
        widen(i * kPer, l, h);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      if (magnitude_bits(base[i])) {
        const int u = static_cast<int>(i % u_count);
        widen(i, u, u + 1);
      }
    }
  }
  __shared__ int s_lo[kTiles], s_hi[kTiles];
  if (threadIdx.x < kTiles) {
    s_lo[threadIdx.x] = INT_MAX;
    s_hi[threadIdx.x] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int l = __reduce_min_sync(0xffffffffu, lo[t]);
    const int h = __reduce_max_sync(0xffffffffu, hi[t]);
    if (threadIdx.x % 32 == 0) {
      atomicMin(&s_lo[t], l);
      atomicMax(&s_hi[t], h);
    }
  }
  __syncthreads();
  const int tile = sp * kTiles + threadIdx.x;
  if (threadIdx.x < kTiles && tile < m_tiles) {
    const bool any = s_hi[threadIdx.x] > 0;
    const long long at = 2LL * (static_cast<long long>(b) * m_tiles + tile);
    band[at] = any ? s_lo[threadIdx.x] : 0;
    band[at + 1] = any ? s_hi[threadIdx.x] : 0;
  }
}

// ---------------------------------------------------------------------------
// bf16 taps: the band-limited product

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives its share of each in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Taps w_t[b, m0 + i, s0 + j] (i < kBandM, j < width, width a multiple of
// 16) into sa[i * lds + j]; rows past M and taps past U are zero.  `vec`:
// U % 8 == 0 and w_t 16-byte aligned, so each 8 taps are one cp.async.
__device__ __forceinline__ void stage_taps(__nv_bfloat16* sa, int lds,
                                           const __nv_bfloat16* __restrict__ wt,
                                           int b, int m0, int m_count, int u_count,
                                           int s0, int width, bool vec) {
  const __nv_bfloat16* base = wt + static_cast<long long>(b) * m_count * u_count;
  if (vec) {
    const int per_row = width / 8;
    for (int idx = threadIdx.x; idx < kBandM * per_row; idx += kBandThreads) {
      const int i = idx / per_row, j = (idx % per_row) * 8;
      const int m = m0 + i, u = s0 + j;
      __nv_bfloat16* dst = sa + i * lds + j;
      if (m < m_count && u < u_count)
        cp_async16(dst, base + static_cast<long long>(m) * u_count + u);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBandM * width; idx += kBandThreads) {
      const int i = idx / width, j = idx % width;
      const int m = m0 + i, u = s0 + j;
      sa[i * lds + j] = (m < m_count && u < u_count)
                            ? base[static_cast<long long>(m) * u_count + u]
                            : __float2bfloat16_rn(0.0f);
    }
  }
}

// The lerped windows win[g0 + p, r0 + i, c0 + j] (p < np planes, i < kBandR,
// j < width, width a multiple of 16 and at most kBandKC) into
// sw[(p * kBandR + i) * kLdw + j], in bf16.  The work is cut into tasks of
// kTaskTaps consecutive taps of one row (no lane idles on a narrow chunk);
// thread t takes tasks t, t + kBandThreads, ..., so neighbouring threads read
// neighbouring source elements, and reads the kTaskTaps + 1 source elements a
// task needs once.  Rows past R and taps past U are zero.  xg points at row 0
// of plane (g0, b); planes are plane_elems apart.
template <typename In>
__device__ __forceinline__ void build_window(__nv_bfloat16* sw, const In* __restrict__ xg,
                                             long long plane_elems, int np, const int* sk,
                                             const float* sf, int r0, int r_count, int w,
                                             int u_count, int c0, int width) {
  const int per_row = width / kTaskTaps;  // tasks of a row
  const int tasks = np * kBandR * per_row;
  const float inv_per_row = 1.0f / static_cast<float>(per_row);
  const bool tail = c0 + width > u_count;  // some taps past U
#pragma unroll 2
  for (int task = threadIdx.x; task < tasks; task += kBandThreads) {
    // task / per_row in floats: exact, the quotient is far below 2^24 / kBandKC
    const int pi = __float2int_rz((static_cast<float>(task) + 0.5f) * inv_per_row);
    const int col = task - pi * per_row, i = pi % kBandR, p = pi / kBandR;
    const int j = kTaskTaps * col, t0 = c0 + j + sk[i];
    const In* src = xg + p * plane_elems + static_cast<long long>(r0 + i) * w;
    const bool row_in = r0 + i < r_count;
    float s[kTaskTaps + 1];
#pragma unroll
    for (int e = 0; e <= kTaskTaps; ++e) s[e] = row_in ? tap(src, t0 + e, w) : 0.0f;
    const float fr = sf[i];
    uint32_t packed[kTaskTaps / 2];
#pragma unroll
    for (int e = 0; e < kTaskTaps; e += 2) {
      float v0 = lerp_rn(s[e], s[e + 1], fr), v1 = lerp_rn(s[e + 1], s[e + 2], fr);
      if (tail) {
        v0 = c0 + j + e < u_count ? v0 : 0.0f;
        v1 = c0 + j + e + 1 < u_count ? v1 : 0.0f;
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      packed[e / 2] = *reinterpret_cast<const uint32_t*>(&h);
    }
    static_assert(kTaskTaps == 8, "a task stores 16 bytes");
    *reinterpret_cast<uint4*>(sw + (p * kBandR + i) * kLdw + j) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// Shared memory of one block: the tap slab of `seg` taps, the windows of
// kPlanes planes (whose space then stages the sums), k and f of the rows.
__host__ __device__ constexpr size_t band_smem_bytes(int seg) {
  return sizeof(__nv_bfloat16) * (kBandM * (seg + kPadH) + kPlanes * kBandR * kLdw) +
         (sizeof(int) + sizeof(float)) * kBandR;
}
static_assert(sizeof(float) * kPlanes * kBandM * kLdc <=
                  sizeof(__nv_bfloat16) * kPlanes * kBandR * kLdw,
              "the sums are staged where the windows were");
static_assert(band_smem_bytes(kSegMax) <= 48 * 1024, "no opt-in to more shared memory");

// One block per (b, m tile, r tile), launch order b, m tile, r tile, so the
// blocks of one image are adjacent.  Its steps are the band's chunks of
// kBandKC taps for each group of kPlanes planes.
template <typename In, typename Out>
__global__ void __launch_bounds__(kBandThreads, 8)
shift_lerp_matmul_band(const In* __restrict__ x, const int32_t* __restrict__ k,
                       const float* __restrict__ f, const __nv_bfloat16* __restrict__ wt,
                       const int32_t* __restrict__ band, Out* __restrict__ y,
                       int g_count, int b_count, int r_count, int w, int u_count,
                       int m_count, int m_tiles, int r_tiles, int seg, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = seg + kPadH;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);  // kBandM x lds taps
  __nv_bfloat16* sw = sa + kBandM * lds;              // kPlanes x kBandR x kLdw windows
  float* sc = reinterpret_cast<float*>(sw);           // kPlanes x kBandM x kLdc sums
  int* sk = reinterpret_cast<int*>(sw + kPlanes * kBandR * kLdw);  // kBandR shifts
  float* sf = reinterpret_cast<float*>(sk + kBandR);               // kBandR fractions

  long long block = blockIdx.x;
  const int r0 = static_cast<int>(block % r_tiles) * kBandR;
  block /= r_tiles;
  const int mt = static_cast<int>(block % m_tiles);
  const int b = static_cast<int>(block / m_tiles);
  const int m0 = mt * kBandM;

  // k and f of the block's rows, read and clamped once for all planes
  for (int i = threadIdx.x; i < kBandR; i += kBandThreads) {
    const long long row = static_cast<long long>(b) * r_count + r0 + i;
    sk[i] = r0 + i < r_count ? min(max(k[row], -(u_count + 2)), w) : 0;
    sf[i] = r0 + i < r_count ? f[row] : 0.0f;
  }

  // the tile's band, rounded out to the MMA depth, within U rounded up
  const long long bi = 2LL * (static_cast<long long>(b) * m_tiles + mt);
  const int lo = band[bi], hi = band[bi + 1];
  const int band_lo = lo / kDepth * kDepth;
  const int u_end = (u_count + kDepth - 1) / kDepth * kDepth;
  const int band_hi = hi > lo ? min((hi + kDepth - 1) / kDepth * kDepth, u_end) : band_lo;
  const int n_seg = (band_hi - band_lo + seg - 1) / seg;
  const int n_chunks = (band_hi - band_lo + kBandKC - 1) / kBandKC;
  __syncthreads();

  const long long plane_elems = static_cast<long long>(b_count) * r_count * w;
  const long long out_planes = static_cast<long long>(b_count) * m_count * r_count;
  Out* yb = y + (static_cast<long long>(b) * m_count + m0) * r_count + r0;
  if (n_chunks == 0) {  // all taps of the tile are zero
    for (int idx = threadIdx.x; idx < g_count * kBandM * kBandR; idx += kBandThreads) {
      const int g = idx / (kBandM * kBandR), i = idx / kBandR % kBandM, j = idx % kBandR;
      if (m0 + i < m_count && r0 + j < r_count)
        yb[g * out_planes + static_cast<long long>(i) * r_count + j] = from_f32<Out>(0.0f);
    }
    return;
  }

  // warp (wm, wr) owns outputs m in wm * 16 + [0, 16) and r in wr * 16 + [0, 16)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (kBandR / 16), wr = warp % (kBandR / 16);
  // the rows this lane addresses for ldmatrix: taps (m, u) and window (r, u)
  const int a_row = wm * 16 + lane % 8 + 8 * (lane / 8 % 2), a_col = 8 * (lane / 16);
  const int b_row = wr * 16 + lane % 8 + 8 * (lane / 16), b_col = 8 * (lane / 8 % 2);
  const int steps = (g_count + kPlanes - 1) / kPlanes * n_chunks;
  const In* xb = x + static_cast<long long>(b) * r_count * w;
  float acc[kPlanes][2][4];  // plane, 8-wide half of r, mma.sync accumulator
  for (int st = 0; st < steps; ++st) {
    const int g0 = st / n_chunks * kPlanes, c = st % n_chunks;
    const int np = min(kPlanes, g_count - g0);
    const int c0 = band_lo + c * kBandKC, width = min(kBandKC, band_hi - c0);
    // the chunk's segment (with more than one, seg is a multiple of kBandKC)
    const int s0 = band_lo + (c0 - band_lo) / seg * seg;
    if (c == 0) {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][h][e] = 0.0f;
    }
    const bool stage = c0 == s0 && (n_seg > 1 || g0 == 0);  // one segment stays
    if (stage) stage_taps(sa, lds, wt, b, m0, m_count, u_count, s0, min(s0 + seg, band_hi) - s0,
                          vec);
    build_window(sw, xb + g0 * plane_elems, plane_elems, np, sk, sf, r0, r_count, w, u_count,
                 c0, width);
    if (stage) cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < width; kk += kDepth) {
      uint32_t a[4];
      ldmatrix_x4(a, sa + a_row * lds + (c0 - s0) + kk + a_col);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        if (p >= np) break;
        // B[u, r] = win[r, u]: the window rows give the column-major operand
        uint32_t bq[4];
        ldmatrix_x4(bq, sw + (p * kBandR + b_row) * kLdw + kk + b_col);
        mma_bf16(acc[p][0], a, bq[0], bq[1]);
        mma_bf16(acc[p][1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();
    if (c == n_chunks - 1) {  // the group's sums, transposed, along r
      const int gid = lane / 4, tig = lane % 4;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        if (p >= np) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = sc + (p * kBandM + wm * 16 + gid) * kLdc + wr * 16 + h * 8 + 2 * tig;
          *reinterpret_cast<float2*>(dst) = make_float2(acc[p][h][0], acc[p][h][1]);
          *reinterpret_cast<float2*>(dst + 8 * kLdc) = make_float2(acc[p][h][2], acc[p][h][3]);
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < np * kBandM * kBandR; idx += kBandThreads) {
        const int p = idx / (kBandM * kBandR), i = idx / kBandR % kBandM, j = idx % kBandR;
        if (m0 + i < m_count && r0 + j < r_count)
          yb[(g0 + p) * out_planes + static_cast<long long>(i) * r_count + j] =
              from_f32<Out>(sc[(p * kBandM + i) * kLdc + j]);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// f32 taps: the band-limited product on the CUDA cores

// Taps w_t[b, m0 + i, u] (i < kF32TileM, u in [lo, hi), lo and hi multiples
// of 4, hi - lo at most kF32TapSeg) into sa[i * kF32TapLd + u - lo], by the
// 32 lanes of one warp; rows past M and taps past U are zero.  `vec`: U % 4
// == 0 and w_t 16-byte aligned, so each 4 taps are one cp.async.
__device__ __forceinline__ void stage_tile_taps(float* sa, const float* __restrict__ wt, int b,
                                                int m0, int m_count, int u_count, int lo, int hi,
                                                bool vec, int lane) {
  const float* base = wt + static_cast<long long>(b) * m_count * u_count;
  const int per_row = (hi - lo) / 4;
  for (int idx = lane; idx < kF32TileM * per_row; idx += 32) {
    const int i = idx / per_row, u = lo + 4 * (idx % per_row);
    const int m = m0 + i;
    float* dst = sa + i * kF32TapLd + (u - lo);
    const float* src = base + static_cast<long long>(m) * u_count + u;
    if (vec && m < m_count && u < u_count) {
      cp_async16(dst, src);
    } else {
      float4 v;
      v.x = m < m_count && u < u_count ? src[0] : 0.0f;
      v.y = m < m_count && u + 1 < u_count ? src[1] : 0.0f;
      v.z = m < m_count && u + 2 < u_count ? src[2] : 0.0f;
      v.w = m < m_count && u + 3 < u_count ? src[3] : 0.0f;
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

// The lerped windows win[g0 + p, r0 + i, s0 + j] (p < np planes, i <
// kF32Rows, j < width, width a multiple of 4 and at most kF32Seg) into
// sw[(p * kF32Rows + i) * kF32Ld + j], in tasks of kF32Task consecutive taps
// of one row: a task issues the loads of its kF32Task + 1 source elements
// together, then lerps and stores (the last task of a row may run past the
// segment, within the row's stride).  Rows past R and taps past U are zero.
// xg points at row 0 of plane (g0, b); planes are plane_elems apart.
template <typename In>
__device__ __forceinline__ void build_window_f32(float* sw, const In* __restrict__ xg,
                                                 long long plane_elems, int np, const int* sk,
                                                 const float* sf, int r0, int r_count, int w,
                                                 int u_count, int s0, int width) {
  const int per_row = (width + kF32Task - 1) / kF32Task;
  const int tasks = np * kF32Rows * per_row;
  for (int task = threadIdx.x; task < tasks; task += kF32Threads) {
    const int pi = task / per_row;
    const int i = pi % kF32Rows, p = pi / kF32Rows;
    const int j = kF32Task * (task - pi * per_row);
    float s[kF32Task + 1];
#pragma unroll
    for (int e = 0; e <= kF32Task; ++e) s[e] = 0.0f;
    if (r0 + i < r_count) {
      const In* src = xg + p * plane_elems + static_cast<long long>(r0 + i) * w;
      const int t0 = s0 + j + sk[i];
#pragma unroll
      for (int e = 0; e <= kF32Task; ++e) s[e] = tap(src, t0 + e, w);
    }
    const float fr = sf[i];
    float* dst = sw + (p * kF32Rows + i) * kF32Ld + j;
#pragma unroll
    for (int h = 0; h < kF32Task; h += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = s0 + j + h + e < u_count ? lerp_rn(s[h + e], s[h + e + 1], fr) : 0.0f;
      *reinterpret_cast<float4*>(dst + h) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One block per (b, group of kF32GroupM outputs, tile of kF32Rows rows),
// launch order b, group, row tile, so the blocks of one image are adjacent.
template <typename In, typename Out>
__global__ void __launch_bounds__(kF32Threads, kF32Blocks)
shift_lerp_matmul_f32(const In* __restrict__ x, const int32_t* __restrict__ k,
                      const float* __restrict__ f, const float* __restrict__ wt,
                      const int32_t* __restrict__ band, Out* __restrict__ y, int g_count,
                      int b_count, int r_count, int w, int u_count, int m_count, int m_tiles,
                      int m_groups, int r_tiles, bool vec) {
  __shared__ __align__(16) float smem[kF32Smem / sizeof(float)];
  float* sw = smem;                                  // kPlanes x kF32Rows x kF32Ld windows
  float* sa = sw + kPlanes * kF32Rows * kF32Ld;      // kF32Warps x kF32TileM x kF32TapLd taps
  int* sk = reinterpret_cast<int*>(sa + kF32GroupM * kF32TapLd);  // row shifts
  float* sf = reinterpret_cast<float*>(sk + kF32Rows);            // row fractions

  long long block = blockIdx.x;
  const int r0 = static_cast<int>(block % r_tiles) * kF32Rows;
  block /= r_tiles;
  const int group = static_cast<int>(block % m_groups);
  const int b = static_cast<int>(block / m_groups);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // k and f of the block's rows, read and clamped once for all planes
  for (int i = threadIdx.x; i < kF32Rows; i += kF32Threads) {
    const long long row = static_cast<long long>(b) * r_count + r0 + i;
    sk[i] = r0 + i < r_count ? min(max(k[row], -(u_count + 2)), w) : 0;
    sf[i] = r0 + i < r_count ? f[row] : 0.0f;
  }

  // this warp's tile band and the union of the group's, rounded out to 4
  // taps, hi at most U rounded up
  const int u_end = (u_count + 3) / 4 * 4;
  int t_lo = 0, t_hi = 0, g_lo = u_end, g_hi = 0;
#pragma unroll
  for (int t = 0; t < kF32Warps; ++t) {
    const int tile = group * kF32Warps + t;
    if (tile >= m_tiles) break;
    const long long bi = 2LL * (static_cast<long long>(b) * m_tiles + tile);
    const int lo = band[bi], hi = band[bi + 1];
    if (hi <= lo) continue;  // all taps of the tile are zero
    const int lo4 = lo / 4 * 4, hi4 = min((hi + 3) / 4 * 4, u_end);
    if (t == warp) {
      t_lo = lo4;
      t_hi = hi4;
    }
    g_lo = min(g_lo, lo4);
    g_hi = max(g_hi, hi4);
  }
  __syncthreads();

  const long long plane_elems = static_cast<long long>(b_count) * r_count * w;
  const long long out_planes = static_cast<long long>(b_count) * m_count * r_count;
  const In* xb = x + static_cast<long long>(b) * r_count * w;
  const int mw = group * kF32GroupM + warp * kF32TileM;  // the warp's first output
  float* sa_w = sa + warp * kF32TileM * kF32TapLd;
  const int r = r0 + lane;
  for (int g0 = 0; g0 < g_count; g0 += kPlanes) {
    const int np = min(kPlanes, g_count - g0);
    float acc[kPlanes][kF32TileM];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
#pragma unroll
      for (int i = 0; i < kF32TileM; ++i) acc[p][i] = 0.0f;
    for (int s0 = g_lo; s0 < g_hi; s0 += kF32Seg) {
      const int width = min(kF32Seg, g_hi - s0);
      // this warp's taps of the segment, in chunks of at most kF32TapSeg;
      // the first chunk flies while the windows are built
      const int lo = max(t_lo, s0), hi = min(t_hi, s0 + width);
      if (hi > lo)
        stage_tile_taps(sa_w, wt, b, mw, m_count, u_count, lo, min(hi, lo + kF32TapSeg), vec,
                        lane);
      build_window_f32(sw, xb + g0 * plane_elems, plane_elems, np, sk, sf, r0, r_count, w,
                       u_count, s0, width);
      cp_async_wait_all();
      __syncthreads();
      for (int c0 = lo; c0 < hi; c0 += kF32TapSeg) {
        const int c1 = min(hi, c0 + kF32TapSeg);
        if (c0 > lo) {  // the next chunk of taps, once every lane is done with this one
          __syncwarp();
          stage_tile_taps(sa_w, wt, b, mw, m_count, u_count, c0, c1, vec, lane);
          cp_async_wait_all();
          __syncwarp();
        }
        for (int u = c0; u < c1; u += 4) {
          float4 v[kPlanes];  // this lane's row, 4 taps of each plane
#pragma unroll
          for (int p = 0; p < kPlanes; ++p)
            v[p] = p < np ? *reinterpret_cast<const float4*>(
                                sw + (p * kF32Rows + lane) * kF32Ld + (u - s0))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int i = 0; i < kF32TileM; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(sa_w + i * kF32TapLd + (u - c0));
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) {
              acc[p][i] = fmaf(a.x, v[p].x, acc[p][i]);
              acc[p][i] = fmaf(a.y, v[p].y, acc[p][i]);
              acc[p][i] = fmaf(a.z, v[p].z, acc[p][i]);
              acc[p][i] = fmaf(a.w, v[p].w, acc[p][i]);
            }
          }
        }
      }
      __syncthreads();
    }
    if (r < r_count) {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        if (p >= np) break;
#pragma unroll
        for (int i = 0; i < kF32TileM; ++i)
          if (mw + i < m_count)
            y[(g0 + p) * out_planes + (static_cast<long long>(b) * m_count + mw + i) * r_count +
              r] = from_f32<Out>(acc[p][i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int kTile>
int launch_tap_band(const void* wt, int32_t* band, int b, int m, int u, cudaStream_t stream) {
  constexpr int kTiles = 32 / kTile;  // a block reads the taps of 32 outputs
  const int m_tiles = (m + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(b) * ((m_tiles + kTiles - 1) / kTiles);
  if (blocks > 0x7fffffffLL) return -2;
  if (blocks == 0) return 0;
  const bool vec = u % (16 / sizeof(T)) == 0 && aligned16(wt);
  tap_band<T, kTile, kTiles><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(wt), band, m, u, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_tap_band_of(const void* wt, int wt_dtype, int32_t* band, int b, int m, int u,
                       cudaStream_t stream) {
  if (wt_dtype == kBF16) return launch_tap_band<__nv_bfloat16, kBandM>(wt, band, b, m, u, stream);
  if (wt_dtype == kF32) return launch_tap_band<float, kF32TileM>(wt, band, b, m, u, stream);
  return -1;
}

template <typename In, typename Out>
int launch_band(const void* x, const int32_t* k, const float* f, const void* wt,
                int32_t* band, void* y, int g, int b, int r, int w, int u, int m,
                cudaStream_t stream) {
  const int m_tiles = (m + kBandM - 1) / kBandM;
  const int r_tiles = (r + kBandR - 1) / kBandR;
  const long long blocks = static_cast<long long>(b) * m_tiles * r_tiles;
  if (blocks > 0x7fffffffLL) return -2;
  int rc = launch_tap_band<__nv_bfloat16, kBandM>(wt, band, b, m, u, stream);
  if (rc != 0) return rc;
  const int seg = max(kDepth, min((u + kDepth - 1) / kDepth * kDepth, kSegMax));
  const size_t smem = band_smem_bytes(seg);
  const bool vec = u % 8 == 0 && aligned16(wt);
  shift_lerp_matmul_band<In, Out><<<static_cast<unsigned>(blocks), kBandThreads, smem,
                                    stream>>>(
      static_cast<const In*>(x), k, f, static_cast<const __nv_bfloat16*>(wt), band,
      static_cast<Out*>(y), g, b, r, w, u, m, m_tiles, r_tiles, seg, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out>
int launch_f32(const void* x, const int32_t* k, const float* f, const void* wt,
               int32_t* band, void* y, int g, int b, int r, int w, int u, int m,
               cudaStream_t stream) {
  const int m_tiles = (m + kF32TileM - 1) / kF32TileM;
  const int m_groups = (m + kF32GroupM - 1) / kF32GroupM;
  const int r_tiles = (r + kF32Rows - 1) / kF32Rows;
  const long long blocks = static_cast<long long>(b) * m_groups * r_tiles;
  if (blocks > 0x7fffffffLL) return -2;
  int rc = launch_tap_band<float, kF32TileM>(wt, band, b, m, u, stream);
  if (rc != 0) return rc;
  const bool vec = u % 4 == 0 && aligned16(wt);
  shift_lerp_matmul_f32<In, Out><<<static_cast<unsigned>(blocks), kF32Threads, 0, stream>>>(
      static_cast<const In*>(x), k, f, static_cast<const float*>(wt), band,
      static_cast<Out*>(y), g, b, r, w, u, m, m_tiles, m_groups, r_tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dispatch_wt(const void* x, const int32_t* k, const float* f, const void* wt,
                int wt_dtype, int32_t* band, void* y, int out_dtype, int g, int b, int r,
                int w, int u, int m, cudaStream_t s) {
  if (band == nullptr) return -1;
  if (wt_dtype == kBF16 && out_dtype == kBF16)
    return launch_band<In, __nv_bfloat16>(x, k, f, wt, band, y, g, b, r, w, u, m, s);
  if (wt_dtype == kBF16 && out_dtype == kF32)
    return launch_band<In, float>(x, k, f, wt, band, y, g, b, r, w, u, m, s);
  if (wt_dtype == kF32 && out_dtype == kBF16)
    return launch_f32<In, __nv_bfloat16>(x, k, f, wt, band, y, g, b, r, w, u, m, s);
  if (wt_dtype == kF32 && out_dtype == kF32)
    return launch_f32<In, float>(x, k, f, wt, band, y, g, b, r, w, u, m, s);
  return -1;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, -1 for a
// type combination the kernel does not take (or no band scratch), -2 for a
// grid too large.  Pointers are device pointers of contiguous (G, B, R, W)
// input, (B*R,) k and f, (B, M, U) taps, (G, B, M, R) output and (B,
// ceil(M / T), 2) int32 scratch for the band pass, which runs first on the
// same stream, with T = peclr_tap_band_m() for bf16 taps and
// peclr_tap_band_m_f32() for f32 taps.
int peclr_shift_lerp_matmul(const void* x, int in_dtype, const int32_t* k,
                            const float* f, const void* wt, int wt_dtype, int32_t* band,
                            void* y, int out_dtype, int g, int b, int r, int w, int u,
                            int m, void* stream) {
  if (static_cast<long long>(g) * b * r * m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kU8)
    return dispatch_wt<uint8_t>(x, k, f, wt, wt_dtype, band, y, out_dtype, g, b, r, w, u,
                                m, s);
  if (in_dtype == kBF16)
    return dispatch_wt<__nv_bfloat16>(x, k, f, wt, wt_dtype, band, y, out_dtype, g, b, r,
                                      w, u, m, s);
  if (in_dtype == kF32)
    return dispatch_wt<float>(x, k, f, wt, wt_dtype, band, y, out_dtype, g, b, r, w, u, m,
                              s);
  return -1;
}

// The band pass alone: (B, ceil(M / T), 2) int32 of (B, M, U) bf16 or f32
// taps into `band`, T as above; -1 for another tap type.
int peclr_tap_band(const void* wt, int wt_dtype, int32_t* band, int b, int m, int u,
                   void* stream) {
  return launch_tap_band_of(wt, wt_dtype, band, b, m, u, static_cast<cudaStream_t>(stream));
}

int peclr_tap_band_m() { return kBandM; }

int peclr_tap_band_m_f32() { return kF32TileM; }

const char* peclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
