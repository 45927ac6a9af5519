// Train-mode BatchNorm with the residual add and the ReLU that follow it in
// the ResNet trunk, forward and backward, in four passes:
//
//   batch_norm_act_stats_kernel            per-channel mean and 1/sqrt(var +
//                                          eps) of x, and the running
//                                          statistics' update (or, for
//                                          statistics across processes,
//                                          the sums of x and x^2)      1 read
//   batch_norm_act_apply_kernel            y = relu(bn(x) [+ r])   1-2 reads,
//                                                                     1 write
//   batch_norm_act_backward_reduce_kernel  per-channel sums of dy' and of
//                                          dy'(x - mean), where dy' is dy
//                                          under the ReLU's mask    2-3 reads
//   batch_norm_act_backward_elemt_kernel   dx, and dr = dy' for the
//                                          residual            2-3 reads,
//                                                               1-2 writes
//
// Replaces no TPU kernel: XLA fuses the BatchNorm, the add and the ReLU into
// the convolutions' neighbours for the JAX package.  On the card the port ran
// them as torch's BatchNorm kernels (a Welford statistics pass at about a
// fifth of its bytes bound on the RN50 trunk's channels-last bf16 tensors)
// and elementwise kernels around them (two fills, a multiply, two lerps and
// an add for the running statistics, the add, the ReLU and its backward):
// about 210 ms of a 370 ms RN50 pretrain step at 2,048 canvases on an H100.
//
// Layout.  x, r, y, dy, dx and dr are (rows, C) with C contiguous: the
// NHWC memory of a channels-last (N, C, H, W) tensor, rows = N*H*W.  x and
// its companions are bf16 or f32; the per-channel vectors (weight, bias,
// running statistics, the outputs below) f32.  Every base is 16-byte
// aligned and C a multiple of the 8 bf16 or 4 f32 elements in 16 bytes (the
// entry points refuse anything else; every ResNet width is a multiple of
// 64): a thread moves 16-byte vectors of one row, and the per-channel
// vectors as float4.
//
// Arithmetic.  The apply follows torch's channels-last transform
// (batch_norm_transform_input_channels_last_kernel): w*(x - mean)*invstd + b
// in f32, the last multiply and add one FMA, rounded to x's type; then, as
// the unfused chain does, the residual added in f32 and rounded once, then
// the ReLU (v <= 0 gives 0, NaN stays NaN).  Given the same statistics it
// equals torch.batch_norm_elemt -> add -> relu bit for bit.  The statistics
// are sums in f64 of x - K and of its square, K a sample of the channel (x's
// first row), so that a mean far from 0 costs no precision;
// var = E[(x-K)^2] - E[x-K]^2, clamped at 0, as flax's biased variance, and
// the mean and 1/sqrt(var + eps) computed in f64 and rounded once to f32:
// the float64 statistics of the plain version, bit for bit in all but the
// rare channel whose value lies within f64's error of an f32 rounding
// boundary.  (f32 sums in another order than torch's Welford pass move each
// channel's statistics by an ulp or so, and the trunk's bf16 roundings carry
// that far: on the RN50 recipe's first step such one-ulp moves alone spread
// the loss by ~3e-3.  The f64 sums pin the statistics to their exact value;
// a bf16 element costs one f32 -> f64 conversion and three f64 operations,
// under half of those units' rate at HBM's pace.)
// The backward's elementwise pass computes dx = ((dy' - mean(dy')) -
// (x - mean) * f1) * f2 with f1 = invstd^2 * mean(dy'(x - mean)), f2 =
// weight * invstd, each operation rounded once (no FMA), so that the plain
// version in ops/batch_norm_act.py repeats it bit for bit from the same sums.
// The ReLU's mask is the output's: read from y where a residual was added,
// else recomputed from x by the apply's own arithmetic (the same bits), so
// that the bn1 and bn2 of a block read no output.
//
// The reductions.  A grid of tiles x row blocks: a tile is up to 32 lanes of
// one 16-byte vector of channels, a block
// 256 threads = lanes x row lanes, each thread walking its rows four at a
// time (loads in flight) and summing in registers (f64 for the statistics,
// f32 for the backward).  A block adds its row lanes in shared memory in a
// fixed order and writes one partial row; the last block of a tile to
// finish (an atomic counter a tile, which it sets back to 0 for the next
// launch) adds the tile's partial rows, 16-byte columns over row slices, in
// a fixed order, then finishes its channels: the
// statistics and the running statistics (momentum, as torch's lerp_), or the
// backward's per-channel factors and the weight gradient.  No atomics on
// the sums: a launch on a card of the same SM count gives the same bits.
// Two blocks an SM (the wrapper's grid) keep ~4 MB of loads in flight,
// more than the H100's HBM needs; at most 16 rows a thread short of that.
//
// Bound.  Bytes over the H100 SXM's 3.35 TB/s: stats one read of x; apply x
// (and r) read, y written; reduce dy and x (and y) read; elemt dy and x (and
// y) read, dx (and dr) written.  A few f32 operations an element are far
// below 67 TFLOP/s.  At the RN50 trunk's 53 BatchNorms of a 1,024-view
// microbatch of 128^2 views (3.63 M elements a view) one bf16 pass over
// every BatchNorm input is 7.4 GB, 2.2 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kBF16 = 1, kF32 = 2 };
// where the ReLU's mask comes from in the backward
enum Mask { kNoRelu = 0, kReluFromX = 1, kReluFromY = 2 };

constexpr int kThreads = 256;   // every kernel's block
constexpr int kMaxLanes = 32;   // channel vectors a reduction tile
constexpr int kMaxVec = 8;      // elements in 16 bytes of bf16
constexpr int kRowsInFlight = 4;
constexpr int kFinalLoads = 8;  // partial rows in flight in a tile's last block
constexpr int kBlocksPerSm = 2;
constexpr int kMinRowsPerThread = 16;

struct BF16 {
  using Bits = uint16_t;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float load(Bits h) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
  static __device__ __forceinline__ Bits store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct F32 {
  using Bits = float;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float load(Bits v) { return v; }
  static __device__ __forceinline__ Bits store(float v) { return v; }
};

template <typename Tr>
union Pack {
  uint4 u;
  typename Tr::Bits e[Tr::kVec];
};

// A 16-byte vector of x's type from p, as f32.
template <typename Tr>
__device__ __forceinline__ void load_v(const typename Tr::Bits* p, float (&o)[Tr::kVec]) {
  Pack<Tr> a;
  a.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int j = 0; j < Tr::kVec; ++j) o[j] = Tr::load(a.e[j]);
}

template <typename Tr>
__device__ __forceinline__ void store_v(typename Tr::Bits* p,
                                        const typename Tr::Bits (&v)[Tr::kVec]) {
  Pack<Tr> a;
#pragma unroll
  for (int j = 0; j < Tr::kVec; ++j) a.e[j] = v[j];
  *reinterpret_cast<uint4*>(p) = a.u;
}

// V per-channel f32 values from c0, as float4 loads.
template <int V>
__device__ __forceinline__ void load_ch(const float* __restrict__ p, int c0, float (&o)[V]) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + c0 + j));
    o[j] = t.x, o[j + 1] = t.y, o[j + 2] = t.z, o[j + 3] = t.w;
  }
}

// The BatchNorm of one element as torch's channels-last transform computes
// it: w * (x - mean) * invstd + b, the last multiply and add one FMA.
__device__ __forceinline__ float normalize(float x, float mean, float invstd, float w,
                                           float b) {
  return __fmaf_rn(__fmul_rn(w, __fsub_rn(x, mean)), invstd, b);
}

// The BatchNorm [+ residual] [-> ReLU] of one element, in x's type.
template <typename Tr, bool kRes, bool kRelu>
__device__ __forceinline__ typename Tr::Bits bn_act(float x, float r, float mean, float invstd,
                                                    float w, float b) {
  typename Tr::Bits y = Tr::store(normalize(x, mean, invstd, w, b));
  if constexpr (kRes) y = Tr::store(__fadd_rn(Tr::load(y), r));
  if constexpr (kRelu) {
    if (Tr::load(y) <= 0.0f) y = Tr::store(0.0f);  // NaN stays NaN
  }
  return y;
}

// ---------------------------------------------------------------------------
// the reductions' shared part

struct Tile {
  int lanes, rlanes;  // channel vectors and row lanes of a block
  int pitch;          // sums of a partial row: 2 * lanes * V, rounded up to 4
  void* partial;      // [tiles][row blocks][pitch] of the sums' type
  unsigned* counters; // [tiles], 0 between launches
};

// 16 bytes of partial sums: four f32 or two f64
template <typename Acc>
union Chunk {
  float4 raw;
  Acc v[16 / sizeof(Acc)];
};

// Adds every thread's V pairs of sums (s, q) over the block's row lanes and
// writes the block's partial row (the lanes' s, then their q); in the last
// block of the tile to finish, adds the tile's partial rows into fin[0 :
// 2 * lanes * V] and returns true.  Every thread of the block calls it.
template <typename Acc, int V>
__device__ bool tile_sums(const Acc (&s)[V], const Acc (&q)[V], const Tile& t, Acc* fin) {
  constexpr int L = 16 / sizeof(Acc);
  __shared__ Acc buf[kThreads * 2 * kMaxVec];
  __shared__ Chunk<Acc> red[kThreads];
  __shared__ bool last;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    buf[tid * 2 * V + j] = s[j];
    buf[tid * 2 * V + V + j] = q[j];
  }
  __syncthreads();
  const int tile_c = t.lanes * V;
  const long long row_blocks = gridDim.x;
  Acc* const partial = static_cast<Acc*>(t.partial);
  Acc* row = partial + (blockIdx.y * row_blocks + blockIdx.x) * t.pitch;
  for (int col = tid; col < t.pitch; col += kThreads) {
    Acc v = 0;
    if (col < 2 * tile_c) {
      const int half = col >= tile_c ? 1 : 0;
      const int cc = col - half * tile_c;
      const int lane = cc / V, j = cc - lane * V;
      for (int r = 0; r < t.rlanes; ++r) v += buf[(r * t.lanes + lane) * 2 * V + half * V + j];
    }
    row[col] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(t.counters + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const int nc = t.pitch / L;  // 16-byte columns of a partial row
  const int slices = kThreads / nc;
  const float4* base =
      reinterpret_cast<const float4*>(partial + blockIdx.y * row_blocks * t.pitch);
  Chunk<Acc> acc;
#pragma unroll
  for (int l = 0; l < L; ++l) acc.v[l] = 0;
  if (tid < nc * slices) {
    // kFinalLoads partial rows in flight a thread: with f64 sums a thread
    // walks every row block of its column alone (one slice)
    const int col = tid % nc;
    Chunk<Acc> a[kFinalLoads];
#pragma unroll
    for (int k = 0; k < kFinalLoads; ++k) {
#pragma unroll
      for (int l = 0; l < L; ++l) a[k].v[l] = 0;
    }
    long long b = tid / nc;
    for (; b + (kFinalLoads - 1) * slices < row_blocks; b += kFinalLoads * slices) {
#pragma unroll
      for (int k = 0; k < kFinalLoads; ++k) {
        Chunk<Acc> v;
        v.raw = __ldcg(base + (b + k * slices) * nc + col);
#pragma unroll
        for (int l = 0; l < L; ++l) a[k].v[l] += v.v[l];
      }
    }
    for (; b < row_blocks; b += slices) {
      Chunk<Acc> v;
      v.raw = __ldcg(base + b * nc + col);
#pragma unroll
      for (int l = 0; l < L; ++l) a[0].v[l] += v.v[l];
    }
#pragma unroll
    for (int w = kFinalLoads / 2; w > 0; w /= 2) {
#pragma unroll
      for (int k = 0; k < w; ++k) {
#pragma unroll
        for (int l = 0; l < L; ++l) a[k].v[l] += a[k + w].v[l];
      }
    }
    acc = a[0];
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < nc) {
    Chunk<Acc> tot = red[tid];
    for (int sl = 1; sl < slices; ++sl) {
#pragma unroll
      for (int l = 0; l < L; ++l) tot.v[l] += red[sl * nc + tid].v[l];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) fin[L * tid + l] = tot.v[l];
  }
  if (tid == 0) t.counters[blockIdx.y] = 0;
  __syncthreads();
  return true;
}

// ---------------------------------------------------------------------------
// stats

struct StatsArgs {
  const void* x;
  long long rows;
  int c;
  Tile t;
  float* stats;  // [2][c]: mean, invstd
  float* running_mean;
  float* running_var;
  long long* num_batches;  // or null
  double eps;
  float momentum;
  double* moments;  // [2][c]: sum x, sum x^2 (K = 0) in place of the above, or null
};

template <typename Tr>
__global__ void __launch_bounds__(kThreads) batch_norm_act_stats_kernel(const StatsArgs a) {
  using Bits = typename Tr::Bits;
  constexpr int V = Tr::kVec;
  __shared__ double fin[2 * kMaxLanes * kMaxVec];
  const int lane = threadIdx.x % a.t.lanes, rlane = threadIdx.x / a.t.lanes;
  const int g = blockIdx.y * a.t.lanes + lane;  // the thread's channel vector
  const bool active = rlane < a.t.rlanes && g < a.c / V;
  double s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.0;
  if (active) {
    const Bits* x = static_cast<const Bits*>(a.x) + g * V;
    float kf[V];
    load_v<Tr>(x, kf);
    double k[V];
#pragma unroll
    for (int j = 0; j < V; ++j) k[j] = a.moments != nullptr ? 0.0 : kf[j];
    // in f64, x - K is exact where x and K lie within a factor 2^29 (bf16:
    // 2^45) of each other
    auto add = [&](const float (&v)[V]) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double d = static_cast<double>(v[j]) - k[j];
        s[j] += d;
        q[j] = fma(d, d, q[j]);
      }
    };
    const long long step = static_cast<long long>(gridDim.x) * a.t.rlanes;
    long long row = static_cast<long long>(blockIdx.x) * a.t.rlanes + rlane;
    for (; row + (kRowsInFlight - 1) * step < a.rows; row += kRowsInFlight * step) {
      float v[kRowsInFlight][V];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) load_v<Tr>(x + (row + u * step) * a.c, v[u]);
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) add(v[u]);
    }
    for (; row < a.rows; row += step) {
      float v[V];
      load_v<Tr>(x + row * a.c, v);
      add(v);
    }
  }
  if (!tile_sums<double, V>(s, q, a.t, fin)) return;
  const int tile_c = a.t.lanes * V;
  const int t = threadIdx.x;
  const int c = blockIdx.y * tile_c + t;
  if (a.moments != nullptr) {
    if (t < tile_c && c < a.c) {
      a.moments[c] = fin[t];
      a.moments[a.c + c] = fin[tile_c + t];
    }
    return;
  }
  if (t < tile_c && c < a.c) {
    const double n = static_cast<double>(a.rows);
    const double k = Tr::load(static_cast<const Bits*>(a.x)[c]);
    const double m1 = fin[t] / n;
    double var = fin[tile_c + t] / n - m1 * m1;
    var = var < 0.0 ? 0.0 : var;  // NaN stays NaN
    const float mean = static_cast<float>(k + m1);
    const float varf = static_cast<float>(var);
    a.stats[c] = mean;
    a.stats[a.c + c] = static_cast<float>(1.0 / sqrt(var + a.eps));
    // torch's lerp_ at a weight under 0.5: self + weight * (end - self)
    const float rm = a.running_mean[c], rv = a.running_var[c];
    a.running_mean[c] = __fmaf_rn(a.momentum, __fsub_rn(mean, rm), rm);
    a.running_var[c] = __fmaf_rn(a.momentum, __fsub_rn(varf, rv), rv);
  }
  if (t == 0 && blockIdx.y == 0 && a.num_batches != nullptr) *a.num_batches += 1;
}

// ---------------------------------------------------------------------------
// apply

struct ApplyArgs {
  const void* x;
  const void* r;  // or null
  const float* stats;
  const float* w;
  const float* b;
  void* y;
  long long nvec;  // 16-byte vectors
  int c;
};

template <typename Tr, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads) batch_norm_act_apply_kernel(const ApplyArgs a) {
  using Bits = typename Tr::Bits;
  constexpr int V = Tr::kVec;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.nvec) return;
  const int c0 = static_cast<int>((i * V) % a.c);
  float x[V], r[V], m[V], inv[V], w[V], b[V];
  load_v<Tr>(static_cast<const Bits*>(a.x) + i * V, x);
  if constexpr (kRes) load_v<Tr>(static_cast<const Bits*>(a.r) + i * V, r);
  load_ch<V>(a.stats, c0, m);
  load_ch<V>(a.stats + a.c, c0, inv);
  load_ch<V>(a.w, c0, w);
  load_ch<V>(a.b, c0, b);
  Bits y[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    y[j] = bn_act<Tr, kRes, kRelu>(x[j], kRes ? r[j] : 0.0f, m[j], inv[j], w[j], b[j]);
  store_v<Tr>(static_cast<Bits*>(a.y) + i * V, y);
}

// ---------------------------------------------------------------------------
// backward

struct BackwardArgs {
  const void* dy;
  const void* x;
  const void* y;  // the forward's output (kReluFromY), else null
  const float* stats;
  const float* w;
  const float* b;
  float* sums;  // [6][c]: sum dy', sum dy'(x - mean), dweight, mean dy', f1, f2
  void* dx;
  void* dr;  // the residual's gradient, or null
  long long rows, nvec;
  int c;
  Tile t;
};

// dy under the ReLU's mask: 0 where the forward's output is <= 0.
template <typename Tr, int kMask>
__device__ __forceinline__ float masked(float dy, float x, float y, float mean, float invstd,
                                        float w, float b) {
  if constexpr (kMask == kReluFromY) {
    return y <= 0.0f ? 0.0f : dy;
  } else if constexpr (kMask == kReluFromX) {
    return Tr::load(Tr::store(normalize(x, mean, invstd, w, b))) <= 0.0f ? 0.0f : dy;
  } else {
    return dy;
  }
}

template <typename Tr, int kMask>
__global__ void __launch_bounds__(kThreads)
    batch_norm_act_backward_reduce_kernel(const BackwardArgs a) {
  using Bits = typename Tr::Bits;
  constexpr int V = Tr::kVec;
  __shared__ float fin[2 * kMaxLanes * kMaxVec];
  const int lane = threadIdx.x % a.t.lanes, rlane = threadIdx.x / a.t.lanes;
  const int g = blockIdx.y * a.t.lanes + lane;
  const bool active = rlane < a.t.rlanes && g < a.c / V;
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.0f;
  if (active) {
    const long long off = static_cast<long long>(g) * V;
    const Bits* dyp = static_cast<const Bits*>(a.dy) + off;
    const Bits* xp = static_cast<const Bits*>(a.x) + off;
    const Bits* yp = static_cast<const Bits*>(a.y) + off;
    float m[V], inv[V], w[V], b[V];
    load_ch<V>(a.stats, g * V, m);
    if constexpr (kMask == kReluFromX) {
      load_ch<V>(a.stats + a.c, g * V, inv);
      load_ch<V>(a.w, g * V, w);
      load_ch<V>(a.b, g * V, b);
    }
    const long long step = static_cast<long long>(gridDim.x) * a.t.rlanes;
    long long row = static_cast<long long>(blockIdx.x) * a.t.rlanes + rlane;
    auto add = [&](const float (&dy)[V], const float (&x)[V], const float (&y)[V]) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = masked<Tr, kMask>(dy[j], x[j], y[j], m[j], inv[j], w[j], b[j]);
        s[j] += d;
        q[j] = fmaf(d, x[j] - m[j], q[j]);
      }
    };
    for (; row + (kRowsInFlight - 1) * step < a.rows; row += kRowsInFlight * step) {
      float dy[kRowsInFlight][V], x[kRowsInFlight][V], y[kRowsInFlight][V];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const long long e = (row + u * step) * a.c;
        load_v<Tr>(dyp + e, dy[u]);
        load_v<Tr>(xp + e, x[u]);
        if constexpr (kMask == kReluFromY) load_v<Tr>(yp + e, y[u]);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) add(dy[u], x[u], y[u]);
    }
    for (; row < a.rows; row += step) {
      float dy[V], x[V], y[V];
      const long long e = row * a.c;
      load_v<Tr>(dyp + e, dy);
      load_v<Tr>(xp + e, x);
      if constexpr (kMask == kReluFromY) load_v<Tr>(yp + e, y);
      add(dy, x, y);
    }
  }
  if (!tile_sums<float, V>(s, q, a.t, fin)) return;
  const int tile_c = a.t.lanes * V;
  const int t = threadIdx.x;
  const int c = blockIdx.y * tile_c + t;
  if (t < tile_c && c < a.c) {
    const float norm = __fdiv_rn(1.0f, static_cast<float>(a.rows));
    const float sum_dy = fin[t], sum_dy_xmu = fin[tile_c + t];
    const float invstd = a.stats[a.c + c];
    a.sums[c] = sum_dy;
    a.sums[a.c + c] = sum_dy_xmu;
    a.sums[2 * a.c + c] = __fmul_rn(sum_dy_xmu, invstd);
    a.sums[3 * a.c + c] = __fmul_rn(sum_dy, norm);
    a.sums[4 * a.c + c] = __fmul_rn(__fmul_rn(__fmul_rn(invstd, invstd), sum_dy_xmu), norm);
    a.sums[5 * a.c + c] = __fmul_rn(a.w[c], invstd);
  }
}

template <typename Tr, int kMask, bool kRes>
__global__ void __launch_bounds__(kThreads)
    batch_norm_act_backward_elemt_kernel(const BackwardArgs a) {
  using Bits = typename Tr::Bits;
  constexpr int V = Tr::kVec;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.nvec) return;
  const int c0 = static_cast<int>((i * V) % a.c);
  float dy[V], x[V], y[V], m[V], inv[V], w[V], b[V], mdy[V], f1[V], f2[V];
  load_v<Tr>(static_cast<const Bits*>(a.dy) + i * V, dy);
  load_v<Tr>(static_cast<const Bits*>(a.x) + i * V, x);
  if constexpr (kMask == kReluFromY) load_v<Tr>(static_cast<const Bits*>(a.y) + i * V, y);
  load_ch<V>(a.stats, c0, m);
  if constexpr (kMask == kReluFromX) {
    load_ch<V>(a.stats + a.c, c0, inv);
    load_ch<V>(a.w, c0, w);
    load_ch<V>(a.b, c0, b);
  }
  load_ch<V>(a.sums + 3 * a.c, c0, mdy);
  load_ch<V>(a.sums + 4 * a.c, c0, f1);
  load_ch<V>(a.sums + 5 * a.c, c0, f2);
  Bits dx[V], dr[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = masked<Tr, kMask>(dy[j], x[j], y[j], m[j], inv[j], w[j], b[j]);
    dx[j] = Tr::store(
        __fmul_rn(__fsub_rn(__fsub_rn(d, mdy[j]), __fmul_rn(__fsub_rn(x[j], m[j]), f1[j])), f2[j]));
    dr[j] = Tr::store(d);
  }
  store_v<Tr>(static_cast<Bits*>(a.dx) + i * V, dx);
  if constexpr (kRes) store_v<Tr>(static_cast<Bits*>(a.dr) + i * V, dr);
}

// ---------------------------------------------------------------------------
// launchers

int sm_count(int* sms) {
  static int cached_dev = -1, cached_sms = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev != cached_dev) {
    rc = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    cached_dev = dev;
  }
  *sms = cached_sms;
  return 0;
}

int elementwise_blocks(long long nvec, unsigned* blocks) {
  const long long b = (nvec + kThreads - 1) / kThreads;
  if (b <= 0 || b > 0x7fffffffLL) return -1;
  *blocks = static_cast<unsigned>(b);
  return 0;
}

bool tile_ok(const Tile& t, long long rows, int c, int v, int tiles, int row_blocks) {
  const int groups = c / v;
  return t.lanes >= 1 && t.lanes <= kMaxLanes && t.lanes * t.rlanes <= kThreads &&
         t.rlanes == kThreads / t.lanes && tiles == (groups + t.lanes - 1) / t.lanes &&
         t.pitch == (2 * t.lanes * v + 3) / 4 * 4 && row_blocks >= 1 && tiles <= 65535 &&
         t.partial != nullptr && t.counters != nullptr && rows >= 1;
}

template <typename Tr>
int launch_stats(StatsArgs a, int tiles, int row_blocks, cudaStream_t s) {
  batch_norm_act_stats_kernel<Tr><<<dim3(row_blocks, tiles), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr>
int launch_apply(const ApplyArgs& a, int relu, cudaStream_t s) {
  unsigned blocks = 0;
  if (elementwise_blocks(a.nvec, &blocks) != 0) return -1;
  const bool res = a.r != nullptr;
  if (res && relu) batch_norm_act_apply_kernel<Tr, true, true><<<blocks, kThreads, 0, s>>>(a);
  else if (res) batch_norm_act_apply_kernel<Tr, true, false><<<blocks, kThreads, 0, s>>>(a);
  else if (relu) batch_norm_act_apply_kernel<Tr, false, true><<<blocks, kThreads, 0, s>>>(a);
  else batch_norm_act_apply_kernel<Tr, false, false><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr>
int launch_reduce(const BackwardArgs& a, int mask, int tiles, int row_blocks, cudaStream_t s) {
  const dim3 grid(row_blocks, tiles);
  if (mask == kNoRelu) batch_norm_act_backward_reduce_kernel<Tr, kNoRelu><<<grid, kThreads, 0, s>>>(a);
  else if (mask == kReluFromX) batch_norm_act_backward_reduce_kernel<Tr, kReluFromX><<<grid, kThreads, 0, s>>>(a);
  else batch_norm_act_backward_reduce_kernel<Tr, kReluFromY><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr, int kMask>
void elemt_mask(const BackwardArgs& a, unsigned blocks, cudaStream_t s) {
  if (a.dr != nullptr) batch_norm_act_backward_elemt_kernel<Tr, kMask, true><<<blocks, kThreads, 0, s>>>(a);
  else batch_norm_act_backward_elemt_kernel<Tr, kMask, false><<<blocks, kThreads, 0, s>>>(a);
}

template <typename Tr>
int launch_elemt(const BackwardArgs& a, int mask, cudaStream_t s) {
  unsigned blocks = 0;
  if (elementwise_blocks(a.nvec, &blocks) != 0) return -1;
  if (mask == kNoRelu) elemt_mask<Tr, kNoRelu>(a, blocks, s);
  else if (mask == kReluFromX) elemt_mask<Tr, kReluFromX>(a, blocks, s);
  else elemt_mask<Tr, kReluFromY>(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn<Tr>() for the dtype code, or returns -1.
#define DISPATCH(dtype, fn, ...)                                \
  do {                                                          \
    if ((dtype) == kBF16) return fn<BF16>(__VA_ARGS__);         \
    if ((dtype) == kF32) return fn<F32>(__VA_ARGS__);           \
    return -1;                                                  \
  } while (0)

// elements in 16 bytes of the dtype (0: not a dtype of the kernels)
int vec_of(int dtype) { return dtype == kBF16 ? BF16::kVec : dtype == kF32 ? F32::kVec : 0; }

// every base (null or) 16-byte aligned
template <typename... P>
bool aligned(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

}  // namespace

extern "C" {

// The reduction grid for x of rows x c of dtype (c a multiple of the
// dtype's 16-byte vector): out[0] lanes, out[1] tiles, out[2] row blocks,
// out[3] pitch (sums of a partial row).  The caller gives the reductions a
// [tiles * row blocks * pitch] scratch, f64 for the statistics and f32 for
// the backward, and a counter a tile, zeroed once.  Returns 0, a
// cudaError_t code, or -1 for arguments the kernels do not take.
int peclr_bn_act_grid(int dtype, long long rows, int c, int* out) {
  const int v = vec_of(dtype);
  if (v == 0 || rows < 1 || c < 1 || c % v != 0) return -1;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int groups = c / v;
  const int lanes = groups < kMaxLanes ? groups : kMaxLanes;
  const int rlanes = kThreads / lanes;
  const int tiles = (groups + lanes - 1) / lanes;
  const long long target = static_cast<long long>(sms) * kBlocksPerSm;
  long long per_tile = (target + tiles - 1) / tiles;
  const long long by_rows =
      (rows + static_cast<long long>(rlanes) * kMinRowsPerThread - 1) /
      (static_cast<long long>(rlanes) * kMinRowsPerThread);
  long long row_blocks = by_rows < per_tile ? by_rows : per_tile;
  if (row_blocks < 1) row_blocks = 1;
  if (tiles > 65535) return -1;
  out[0] = lanes;
  out[1] = tiles;
  out[2] = static_cast<int>(row_blocks);
  out[3] = (2 * lanes * v + 3) / 4 * 4;
  return 0;
}

// Statistics of x (rows x c): stats[0:c] the mean, stats[c:2c] 1/sqrt(var +
// eps) with var the biased variance; running_mean and running_var (c f32)
// moved toward the batch's mean and variance by momentum; *num_batches
// (int64, or null) one more.  lanes, tiles, row_blocks, pitch as
// peclr_bn_act_grid gave them.  Same return codes; every base 16-byte
// aligned, as in every entry point.
int peclr_bn_act_stats(int dtype, const void* x, long long rows, int c, int lanes, int tiles,
                       int row_blocks, int pitch, double* partial, unsigned* counters,
                       float* stats, float* running_mean, float* running_var,
                       long long* num_batches, double eps, float momentum, void* stream) {
  const int v = vec_of(dtype);
  const Tile t{lanes, lanes > 0 ? kThreads / lanes : 0, pitch, partial, counters};
  if (v == 0 || c < 1 || c % v != 0 || !tile_ok(t, rows, c, v, tiles, row_blocks) || !x ||
      !stats || !running_mean || !running_var ||
      !aligned(x, partial, stats))
    return -1;
  const StatsArgs a{x,           rows,        c,   t,        stats, running_mean,
                    running_var, num_batches, eps, momentum, nullptr};
  DISPATCH(dtype, launch_stats, a, tiles, row_blocks, static_cast<cudaStream_t>(stream));
}

// The statistics pass's sums alone, unshifted, for a BatchNorm whose
// statistics span several processes (their sums are added before the
// statistics are taken): moments[0:c] sum x, moments[c:2c] sum x^2, f64.
// Same grid and return codes as peclr_bn_act_stats.
int peclr_bn_act_moments(int dtype, const void* x, long long rows, int c, int lanes, int tiles,
                         int row_blocks, int pitch, double* partial, unsigned* counters,
                         double* moments, void* stream) {
  const int v = vec_of(dtype);
  const Tile t{lanes, lanes > 0 ? kThreads / lanes : 0, pitch, partial, counters};
  if (v == 0 || c < 1 || c % v != 0 || !tile_ok(t, rows, c, v, tiles, row_blocks) || !x ||
      !moments || !aligned(x, partial, moments))
    return -1;
  const StatsArgs a{x, rows, c, t, nullptr, nullptr, nullptr, nullptr, 0.0, 0.0f, moments};
  DISPATCH(dtype, launch_stats, a, tiles, row_blocks, static_cast<cudaStream_t>(stream));
}

// y = relu(bn(x) [+ r]) (relu 0: no ReLU; r null: no residual) with the
// statistics stats ([2][c]) and the weight w and bias b (c f32).  Same
// return codes.
int peclr_bn_act_apply(int dtype, const void* x, const void* r, const float* stats,
                       const float* w, const float* b, void* y, long long rows, int c, int relu,
                       void* stream) {
  const int v = vec_of(dtype);
  if (v == 0 || c < 1 || c % v != 0 || rows < 1 || !x || !stats || !w || !b || !y ||
      !aligned(x, r, stats, w, b, y))
    return -1;
  const ApplyArgs a{x, r, stats, w, b, y, rows * c / v, c};
  DISPATCH(dtype, launch_apply, a, relu, static_cast<cudaStream_t>(stream));
}

// The backward's sums: sums[0:c] sum dy', [c:2c] sum dy'(x - mean), [2c:3c]
// the weight's gradient, [3c:4c] mean dy', [4c:5c] invstd^2 mean dy'(x -
// mean), [5c:6c] w invstd; dy' is dy masked as `mask` says (0 no ReLU, 1
// the ReLU's mask recomputed from x, 2 read from y, the forward's output).
// Same return codes.
int peclr_bn_act_backward_reduce(int dtype, const void* dy, const void* x, const void* y,
                                 int mask, const float* stats, const float* w, const float* b,
                                 long long rows, int c, int lanes, int tiles, int row_blocks,
                                 int pitch, float* partial, unsigned* counters, float* sums,
                                 void* stream) {
  const int v = vec_of(dtype);
  const Tile t{lanes, lanes > 0 ? kThreads / lanes : 0, pitch, partial, counters};
  if (v == 0 || c < 1 || c % v != 0 || !tile_ok(t, rows, c, v, tiles, row_blocks) || !dy ||
      !x || !stats || !w || !b || !sums || mask < kNoRelu || mask > kReluFromY ||
      (mask == kReluFromY && !y) || !aligned(dy, x, y, stats, w, b, partial, sums))
    return -1;
  const BackwardArgs a{dy, x, y, stats, w, b, sums, nullptr, nullptr, rows, rows * c / v, c, t};
  DISPATCH(dtype, launch_reduce, a, mask, tiles, row_blocks, static_cast<cudaStream_t>(stream));
}

// dx from dy, x (and y for mask 2) and the reduce's sums; dr (or null) the
// residual's gradient dy'.  Same return codes.
int peclr_bn_act_backward_elemt(int dtype, const void* dy, const void* x, const void* y, int mask,
                                const float* stats, const float* w, const float* b,
                                const float* sums, void* dx, void* dr, long long rows, int c,
                                void* stream) {
  const int v = vec_of(dtype);
  if (v == 0 || c < 1 || c % v != 0 || rows < 1 || !dy || !x || !stats || !w || !b || !sums ||
      !dx || mask < kNoRelu || mask > kReluFromY || (mask == kReluFromY && !y) ||
      !aligned(dy, x, y, stats, w, b, sums, dx, dr))
    return -1;
  const BackwardArgs a{dy, x, y, stats, w, b, const_cast<float*>(sums), dx, dr, rows,
                       rows * c / v, c, Tile{}};
  DISPATCH(dtype, launch_elemt, a, mask, static_cast<cudaStream_t>(stream));
}

const char* peclr_bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
