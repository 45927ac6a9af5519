// HBM stream passes: the yardstick of scripts/bench_streams.py.
//
// Replaces no TPU kernel.  The reference repository's scripts/bench_streams.py
// (`f_copy`, `f_add`, `f_bn_res_relu`, `f_stats`, :102-137) times XLA
// fusions of four access patterns on the recipe's layer-1 BatchNorm fusion
// shape, [256, 32, 32, 256] channels last, to ask how far a BatchNorm and
// residual pass sits from one pass over HBM.  On the card that question
// needs a pass that is one pass by construction, so each pattern is one
// hand-written kernel here, and the script sets it beside the same math
// composed from torch ops (the port's step) and beside the port's BatchNorm:
//
//   copy         y = x + 1                                  1 read, 1 write
//   add          y = x + r                                  2 reads, 1 write
//   bn_res_relu  y = relu(x * g[c] + b[c] + r) in f32, cast  2 reads, 1 write
//   stats        s[c] = sum x, q[c] = sum x^2 in f32         1 read
//
// over x, r, y of n elements in bf16 or f32, c = e % C for element e (C
// channels last), g and b f32 per channel.  The elementwise arithmetic is
// __fmul_rn / __fadd_rn in the plain versions' order (no FMA contraction),
// so y equals peclr_tpu_torch/ops/streams.py's plain versions bit for bit.
//
// Bound.  Bytes: each input read once and each output written once over the
// H100 SXM's 3.35 TB/s; at [256, 32, 32, 256] bf16 (134 MB a tensor) copy
// moves 268 MB (80 us), add and bn_res_relu 403 MB (120 us), stats 134 MB
// (40 us); f32 twice that.  A few f32 operations an element are far below
// the card's 67 TFLOP/s.
//
// Design of the elementwise passes.  The 16-byte path (every operand's base
// 16-byte aligned, and for bn_res_relu C a multiple of the elements in 16
// bytes; the wrapper chooses it): one 16-byte vector a thread, 128 threads
// a block, a grid that covers the tensor, so that each block streams 2 KB of
// each operand once; bn_res_relu reads the vector's g and b as 16-byte
// loads too.  The last n % (16 / size) elements go one a thread.  A
// one-wave grid walked grid-stride, threads interleaved or whole chunks a
// block, 1-8 vectors in flight a thread, with streaming or L2-prefetch
// load hints, all measured 3-7% slower than this on the H100 (PERF.md);
// this layout runs at the rate of torch's own elementwise kernels.
// The scalar path (any other operands: an unaligned view, C not a multiple
// of the vector) is one element a thread.
//
// stats: a grid of one wave (the SMs times the blocks an SM holds, from the
// occupancy API, cached per instantiation), each block a tile of up to 256
// column lanes (a lane is one 16-byte vector of channels, or one channel on
// the scalar path) and 256 / lanes rows at a time, walking the rows
// grid-stride with four rows in flight a thread, summing its lanes in
// registers (f32, FMA for the squares), then the block's row lanes in
// shared memory in a fixed order, and writing one partial row of 2C sums.
// A second launch adds the partial rows up, 32 columns a block, eight row
// lanes with four accumulators each, then the lanes in a fixed order (the
// first version, one thread a column walking every partial row, took as
// long as the pass).  No atomics: the result is the same on every run on a
// card of the same SM count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kBF16 = 1, kF32 = 2 };
enum Op { kCopy = 0, kAdd = 1, kBnResRelu = 2 };

// Threads a block: the elementwise passes' and stats'.
constexpr int kEwThreads = 128;
constexpr int kThreads = 256;
// Rows in flight a stats thread.
constexpr int kStatsRows = 4;

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

template <int kOp>
__device__ __forceinline__ float apply(float x, float r, float g, float b) {
  if constexpr (kOp == kCopy) {
    return __fadd_rn(x, 1.0f);
  } else if constexpr (kOp == kAdd) {
    return __fadd_rn(x, r);
  } else {
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(x, g), b), r);
    return v < 0.0f ? 0.0f : v;  // NaN stays NaN, as torch.relu
  }
}

template <typename Tr, int kOp>
__device__ __forceinline__ void one(const typename Tr::Bits* x, const typename Tr::Bits* r,
                                    const float* g, const float* b, typename Tr::Bits* y,
                                    long long e, int c) {
  float rv = 0.0f, gv = 0.0f, bv = 0.0f;
  if constexpr (kOp != kCopy) rv = Tr::load(r[e]);
  if constexpr (kOp == kBnResRelu) {
    const int ch = static_cast<int>(e % c);
    gv = g[ch];
    bv = b[ch];
  }
  y[e] = Tr::store(apply<kOp>(Tr::load(x[e]), rv, gv, bv));
}

template <typename Tr, int kOp, bool kVec>
__global__ void __launch_bounds__(kEwThreads)
    elementwise_kernel(const typename Tr::Bits* __restrict__ x,
                       const typename Tr::Bits* __restrict__ r, const float* __restrict__ g,
                       const float* __restrict__ b, typename Tr::Bits* __restrict__ y,
                       long long n, int c) {
  const long long i = static_cast<long long>(blockIdx.x) * kEwThreads + threadIdx.x;
  if constexpr (!kVec) {
    if (i < n) one<Tr, kOp>(x, r, g, b, y, i, c);
  } else {
    constexpr int V = Tr::kVec;
    const long long nv = n / V;
    if (i >= nv) {  // the ragged tail, fewer than V elements
      const long long e = nv * V + (i - nv);
      if (e < n) one<Tr, kOp>(x, r, g, b, y, e, c);
      return;
    }
    Pack<Tr> xa, ra, out;
    xa.u = reinterpret_cast<const uint4*>(x)[i];
    if constexpr (kOp != kCopy) ra.u = reinterpret_cast<const uint4*>(r)[i];
    // C is a multiple of V: the vector's channels are consecutive
    float gv[V], bv[V];
    if constexpr (kOp == kBnResRelu) {
      const int ch = static_cast<int>((i * V) % c);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + ch + j));
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(b + ch + j));
        gv[j] = g4.x, gv[j + 1] = g4.y, gv[j + 2] = g4.z, gv[j + 3] = g4.w;
        bv[j] = b4.x, bv[j + 1] = b4.y, bv[j + 2] = b4.z, bv[j + 3] = b4.w;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float rj = 0.0f, gj = 0.0f, bj = 0.0f;
      if constexpr (kOp != kCopy) rj = Tr::load(ra.e[j]);
      if constexpr (kOp == kBnResRelu) gj = gv[j], bj = bv[j];
      out.e[j] = Tr::store(apply<kOp>(Tr::load(xa.e[j]), rj, gj, bj));
    }
    reinterpret_cast<uint4*>(y)[i] = out.u;
  }
}

template <typename Tr, int kOp, bool kVec>
int launch_elementwise(const void* x, const void* r, const float* g, const float* b, void* y,
                       long long n, int c, cudaStream_t stream) {
  using Bits = typename Tr::Bits;
  // a thread a vector (and one a tail element), or a thread an element
  const long long threads = kVec ? n / Tr::kVec + n % Tr::kVec : n;
  const long long blocks = (threads + kEwThreads - 1) / kEwThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  elementwise_kernel<Tr, kOp, kVec><<<static_cast<unsigned>(blocks), kEwThreads, 0, stream>>>(
      static_cast<const Bits*>(x), static_cast<const Bits*>(r), g, b, static_cast<Bits*>(y), n,
      c);
  return static_cast<int>(cudaGetLastError());
}

// One wave of `kernel` at `smem` bytes of shared memory a block of kThreads,
// cached for the last device of each instantiation.
template <typename Kernel>
int one_wave(Kernel kernel, size_t smem, long long* wave, int* cached_dev) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess && dev != *cached_dev) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (rc == cudaSuccess) {
      *cached_dev = dev;
      *wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    }
  }
  return static_cast<int>(rc);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Tr, int kOp>
int elementwise(const void* x, const void* r, const float* g, const float* b, void* y,
                long long n, int c, int vec16, cudaStream_t stream) {
  if (vec16) {
    const bool ok = aligned16(x) && aligned16(r) && aligned16(y) && aligned16(g) &&
                    aligned16(b) && (kOp != kBnResRelu || c % Tr::kVec == 0);
    if (!ok) return -2;
    return launch_elementwise<Tr, kOp, true>(x, r, g, b, y, n, c, stream);
  }
  return launch_elementwise<Tr, kOp, false>(x, r, g, b, y, n, c, stream);
}

// ---------------------------------------------------------------------------
// stats

// Lanes a block holds: the row's vectors, at most kThreads; rows at a time.
struct StatsTile {
  int lanes, tiles, rows_at_once;
};

StatsTile stats_tile(int c, int v) {
  const int groups = c / v;
  StatsTile t;
  t.lanes = groups < kThreads ? groups : kThreads;
  t.tiles = (groups + t.lanes - 1) / t.lanes;
  t.rows_at_once = kThreads / t.lanes;
  return t;
}

template <typename Tr, bool kVec>
__global__ void __launch_bounds__(kThreads)
    stats_partial_kernel(const typename Tr::Bits* __restrict__ x, float* __restrict__ partial,
                         long long rows, int c) {
  constexpr int V = kVec ? Tr::kVec : 1;
  extern __shared__ float shared[];  // [kThreads][2V]
  const int groups = c / V;
  const int lanes = groups < kThreads ? groups : kThreads;
  const int rows_at_once = kThreads / lanes;
  const int lane = threadIdx.x % lanes, rlane = threadIdx.x / lanes;
  const int group = blockIdx.y * lanes + lane;
  const bool active = rlane < rows_at_once && group < groups;
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.0f;
  if (active) {
    const long long step = static_cast<long long>(gridDim.x) * rows_at_once;
    long long row = static_cast<long long>(blockIdx.x) * rows_at_once + rlane;
    const long long row_elems = c;
    if constexpr (kVec) {
      const uint4* xv = reinterpret_cast<const uint4*>(x);
      const long long row_vecs = row_elems / V;
      for (; row + (kStatsRows - 1) * step < rows; row += kStatsRows * step) {
        Pack<Tr> a[kStatsRows];
#pragma unroll
        for (int k = 0; k < kStatsRows; ++k) a[k].u = __ldg(xv + (row + k * step) * row_vecs + group);
#pragma unroll
        for (int k = 0; k < kStatsRows; ++k) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float va = Tr::load(a[k].e[j]);
            s[j] += va;
            q[j] = fmaf(va, va, q[j]);
          }
        }
      }
      for (; row < rows; row += step) {
        Pack<Tr> a;
        a.u = __ldg(xv + row * row_vecs + group);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float va = Tr::load(a.e[j]);
          s[j] += va;
          q[j] = fmaf(va, va, q[j]);
        }
      }
    } else {
      for (; row < rows; row += step) {
        const float va = Tr::load(x[row * row_elems + group]);
        s[0] += va;
        q[0] = fmaf(va, va, q[0]);
      }
    }
  }
  float* mine = shared + threadIdx.x * 2 * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mine[j] = s[j];
    mine[V + j] = q[j];
  }
  __syncthreads();
  if (active && rlane == 0) {
    for (int rr = 1; rr < rows_at_once; ++rr) {
      const float* other = shared + (rr * lanes + lane) * 2 * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += other[j];
        q[j] += other[V + j];
      }
    }
    float* out = partial + static_cast<long long>(blockIdx.x) * 2 * c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[group * V + j] = s[j];
      out[c + group * V + j] = q[j];
    }
  }
}

// The partial rows' column sums: 32 columns a block, 8 row lanes each
// walking every 8th partial row with four accumulators, then the row lanes
// and accumulators added in a fixed order.
constexpr int kReduceCols = 32, kReduceLanes = kThreads / kReduceCols;

__global__ void __launch_bounds__(kThreads)
    stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int blocks,
                        int width) {
  __shared__ float lanes[kReduceLanes][kReduceCols];
  const int col = blockIdx.x * kReduceCols + threadIdx.x % kReduceCols;
  const int lane = threadIdx.x / kReduceCols;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (col < width) {
    int k = lane;
    for (; k + 3 * kReduceLanes < blocks; k += 4 * kReduceLanes) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        acc[a] += partial[static_cast<long long>(k + a * kReduceLanes) * width + col];
    }
    for (; k < blocks; k += kReduceLanes) acc[0] += partial[static_cast<long long>(k) * width + col];
  }
  lanes[lane][threadIdx.x % kReduceCols] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (lane == 0 && col < width) {
    float sum = lanes[0][threadIdx.x];
#pragma unroll
    for (int l = 1; l < kReduceLanes; ++l) sum += lanes[l][threadIdx.x];
    out[col] = sum;
  }
}

template <typename Tr, bool kVec>
int stats_grid(long long rows, int c, int* blocks) {
  constexpr int V = kVec ? Tr::kVec : 1;
  auto kernel = stats_partial_kernel<Tr, kVec>;
  const size_t smem = static_cast<size_t>(kThreads) * 2 * V * sizeof(float);
  static int cached_dev = -1;
  static long long wave = 0;
  const int rc = one_wave(kernel, smem, &wave, &cached_dev);
  if (rc != 0) return rc;
  const StatsTile t = stats_tile(c, V);
  long long per_tile = wave / t.tiles;
  if (per_tile < 1) per_tile = 1;
  const long long need = (rows + t.rows_at_once - 1) / t.rows_at_once;
  *blocks = static_cast<int>(need < per_tile ? (need > 0 ? need : 1) : per_tile);
  return 0;
}

template <typename Tr, bool kVec>
int launch_stats(const void* x, float* partial, float* out, long long rows, int c, int blocks,
                 cudaStream_t stream) {
  constexpr int V = kVec ? Tr::kVec : 1;
  const size_t smem = static_cast<size_t>(kThreads) * 2 * V * sizeof(float);
  const StatsTile t = stats_tile(c, V);
  stats_partial_kernel<Tr, kVec><<<dim3(blocks, t.tiles), kThreads, smem, stream>>>(
      static_cast<const typename Tr::Bits*>(x), partial, rows, c);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  stats_reduce_kernel<<<(2 * c + kReduceCols - 1) / kReduceCols, kThreads, 0, stream>>>(
      partial, out, blocks, 2 * c);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr>
bool stats_takes_vec16(const void* x, int c) {
  return aligned16(x) && c % Tr::kVec == 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, -1 for a
// dtype or op the kernels do not take, or -2 when vec16 is asked for operands
// that do not meet the 16-byte path's conditions.  Pointers are device
// pointers of contiguous tensors: x, r (op add, bn_res_relu; else null) and y
// of n elements, g and b (bn_res_relu; else null) of c floats.  y may be x.
int peclr_stream_elementwise(int op, int dtype, const void* x, const void* r, const float* g,
                             const float* b, void* y, long long n, int c, int vec16,
                             void* stream) {
  if (n == 0) return 0;
  if (op == kBnResRelu && c <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (op == kCopy) return elementwise<BF16, kCopy>(x, r, g, b, y, n, c, vec16, s);
    if (op == kAdd) return elementwise<BF16, kAdd>(x, r, g, b, y, n, c, vec16, s);
    if (op == kBnResRelu) return elementwise<BF16, kBnResRelu>(x, r, g, b, y, n, c, vec16, s);
  } else if (dtype == kF32) {
    if (op == kCopy) return elementwise<F32, kCopy>(x, r, g, b, y, n, c, vec16, s);
    if (op == kAdd) return elementwise<F32, kAdd>(x, r, g, b, y, n, c, vec16, s);
    if (op == kBnResRelu) return elementwise<F32, kBnResRelu>(x, r, g, b, y, n, c, vec16, s);
  }
  return -1;
}

// The number of partial rows (blocks) peclr_stream_stats writes for x of
// rows x c elements, into *blocks; the caller gives it a [blocks, 2c] f32
// scratch.  Same return codes.
int peclr_stream_stats_blocks(int dtype, long long rows, int c, int vec16, int* blocks) {
  if (c <= 0) return -1;
  if (dtype == kBF16)
    return vec16 ? stats_grid<BF16, true>(rows, c, blocks) : stats_grid<BF16, false>(rows, c, blocks);
  if (dtype == kF32)
    return vec16 ? stats_grid<F32, true>(rows, c, blocks) : stats_grid<F32, false>(rows, c, blocks);
  return -1;
}

// Per-channel sums of x (rows x c, channels last) into out[0:c] and of its
// squares into out[c:2c], in f32, through `partial` ([blocks, 2c] f32, blocks
// from peclr_stream_stats_blocks with the same arguments).  Same return codes.
int peclr_stream_stats(int dtype, const void* x, float* partial, float* out, long long rows,
                       int c, int blocks, int vec16, void* stream) {
  if (c <= 0 || blocks <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (!vec16) return launch_stats<BF16, false>(x, partial, out, rows, c, blocks, s);
    if (!stats_takes_vec16<BF16>(x, c)) return -2;
    return launch_stats<BF16, true>(x, partial, out, rows, c, blocks, s);
  }
  if (dtype == kF32) {
    if (!vec16) return launch_stats<F32, false>(x, partial, out, rows, c, blocks, s);
    if (!stats_takes_vec16<F32>(x, c)) return -2;
    return launch_stats<F32, true>(x, partial, out, rows, c, blocks, s);
  }
  return -1;
}

const char* peclr_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
