// Per-row shift + fractional lerp for the two-pass affine warp.
//
// Replaces the Pallas TPU kernels of peclr_tpu/ops/pallas/barrel_shift.py
// reached through fused_shift_lerp_grouped, `_kernel(grouped=True)` (lerp)
// and `_kernel_raw` (integer shift only), and through fused_shift_lerp,
// `_kernel(grouped=False)` (NHWC rows with the channels folded in).  Row r of
// a (rows, W) element matrix shifts by k[n] + f[n], n = r % N, with a channel
// stride C between taps:
//
//   lerp: out[r,e] = x[r,e+k*C] * (1 - f) + x[r,e+(k+1)*C] * f   (f32, cast)
//   raw:  out[r,e] = x[r,e+k*C]                                   (input type)
//
// with taps outside [0, W) reading 0 and k clamped to [-(out_w/C + 2), W/C],
// so a clamped row comes out all zero.  The grouped entry point is C = 1 with
// G planes of N rows sharing one shift per row; the flat entry point is one
// plane of N rows of W = width*C elements.  The TPU kernel is a log2-stage
// barrel shifter over a right-aligned padded row because the TPU has no
// gather; here each output reads its taps directly.  The lerp uses
// __fmul_rn/__fadd_rn so it is not contracted into an FMA and matches the
// plain PyTorch versions (peclr_tpu_torch/ops/shift_lerp.py) bit for bit.
//
// Bound.  Memory: each source element some tap reaches is read once, each
// output written once, 3 f32 operations an output.  A grouped pass-1 launch
// of the pretrain recipe, (3, 57,344, 224) uint8 -> 384 bf16, moves about
// 154 MB, 46 us at the H100 SXM's 3.35 TB/s; the leaderboard's pass 1 (B =
// 120, out 768) about 137 MB, 41 us; the flat pass 1 (57,344 rows of 672
// uint8 -> 1,152 bf16) about 154 MB, 46 us.
//
// Why one row a block missed it.  The first port gave each row a block of
// 256 threads: a chain of two dependent global round trips (k and f, then
// one- or two-byte source loads) ending in 2-byte stores, for a few hundred
// outputs.  With 8 resident blocks on each of the 132 SMs the launches took
// rows / 1,056 waves of about 1.2-2.7 us each (163 waves, 0.22 ms, at the
// pretrain pass 1): paced by latency, at about a quarter of the HBM rate.
//
// Design.  One warp a row, 8 warps a block, and a grid of about one wave
// (SMs x resident blocks) whose warps walk the rows in a grid-stride loop.
// The 16-byte path (the source's base and row bytes and the output's
// 16-byte aligned, the row at most kMaxRowBytes; the wrapper chooses it):
//  - each warp stages the source its row reaches, [max(kk, 0), min(kk +
//    taps, W)) widened to 16-byte chunks, into shared memory with 16-byte
//    cp.async, between a zero chunk in front and one behind, so that a tap
//    outside the row reads zero after one clamp of its index to [-1, W],
//    and a clamped row reads no source at all;
//  - the next kStages - 1 rows are staged into the warp's other buffers,
//    and the k and f of the row after them are loaded, before this row is
//    computed, so the dependent round trips of several rows overlap (one
//    row ahead measured as fast as two or three);
//  - each lane computes a run of 16 bytes of contiguous outputs (8 bf16, 4
//    f32, 16 uint8 in the raw mode) from the shared taps and writes it with
//    one 16-byte store; a run whose taps all lie inside the row skips the
//    clamps.
// The scalar path (any other operands: an unaligned view, odd row bytes,
// a very wide row) keeps the warp-per-row grid-stride loop and reads each
// tap from global memory with a bounds check.  c == 1 is a compile-time
// case (kUnit): the clamp then has no integer division.
//
// Where it stands (H100, 700 W; PERF.md): 1.35-1.9x the bound.  The bytes
// move at 2.6-3.0 TB/s, and each row costs about 32 SM cycles on top, which
// the narrow rows of the pretrain passes feel most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Rows in flight a warp: the one it computes and kStages - 1 staged ahead.
constexpr int kStages = 2;
// Each warp holds kStages staging buffers of (row + 32) bytes; 8 warps of
// them stay within the 48 KB a block takes without opting in to more.
constexpr int kMaxRowBytes = 48 * 1024 / (kStages * kWarps) - 32;

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ uint8_t zero_of<uint8_t>() { return 0; }
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ uint32_t bits_of(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest kPending groups of this thread's copies have landed.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename Out, bool kLerp, typename Tap>
__device__ __forceinline__ Out output(Tap a, Tap b, float keep, float fr) {
  if constexpr (kLerp)
    return from_f32<Out>(__fadd_rn(__fmul_rn(to_f32(a), keep), __fmul_rn(to_f32(b), fr)));
  else
    return a;
}

// A run of 16 bytes of outputs whose first tap is source element t0, packed
// for one store.  Source element t sits in taps[t + off]; the slots of t =
// -1 and t = w hold zero, and kEdge clamps each tap's index to them (a run
// whose taps all lie inside the row needs no clamp).
template <typename In, typename Out, bool kLerp, bool kEdge>
__device__ __forceinline__ uint4 run16(const In* taps, int t0, int off, int w, int c,
                                       float keep, float fr) {
  constexpr int kRun = 16 / static_cast<int>(sizeof(Out));
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    int a = t0 + i, b = kLerp ? a + c : a;
    if constexpr (kEdge) {
      a = min(max(a, -1), w);
      b = min(max(b, -1), w);
    }
    const Out v = output<Out, kLerp>(taps[a + off], taps[b + off], keep, fr);
    const int byte = i * static_cast<int>(sizeof(Out));
    words[byte / 4] |= bits_of(v) << (8 * (byte % 4));
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

template <typename In, typename Out, bool kLerp, bool kUnit, bool kVec>
__global__ void __launch_bounds__(kThreads)
    shift_lerp_kernel(const In* __restrict__ x, const int32_t* __restrict__ k,
                      const float* __restrict__ f, Out* __restrict__ y, long long rows, int n,
                      int w, int out_w, int c_arg) {
  const int c = kUnit ? 1 : c_arg;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int k_lo = -(out_w / c + 2), k_hi = w / c;
  // m = r % n, the row of k and f, follows r without a division
  const int n_step = static_cast<int>(stride % n);
  auto advance = [&](int m) { return m >= n - n_step ? m - (n - n_step) : m + n_step; };
  // clamp in pixels, then step in elements
  auto shift_of = [&](int m) { return min(max(__ldg(k + m), k_lo), k_hi) * c; };
  auto frac_of = [&](int m) { return kLerp ? __ldg(f + m) : 0.0f; };

  if constexpr (!kVec) {
    for (int m = static_cast<int>(r % n); r < rows; r += stride, m = advance(m)) {
      const int kk = shift_of(m);
      const float fr = frac_of(m), keep = 1.0f - fr;
      const In* src = x + r * static_cast<long long>(w);
      Out* dst = y + r * static_cast<long long>(out_w);
      for (int u = lane; u < out_w; u += 32) {
        const int t0 = u + kk;
        const In a = (t0 >= 0 && t0 < w) ? src[t0] : zero_of<In>();
        In b = a;
        if constexpr (kLerp) {
          const int t1 = t0 + c;
          b = (t1 >= 0 && t1 < w) ? src[t1] : zero_of<In>();
        }
        dst[u] = output<Out, kLerp>(a, b, keep, fr);
      }
    }
    return;
  } else {
    constexpr int kChunk = 16 / static_cast<int>(sizeof(In));  // source elements a copy
    constexpr int kRun = 16 / static_cast<int>(sizeof(Out));   // outputs a store
    extern __shared__ __align__(16) unsigned char smem[];
    // [zero chunk | staged source, at most w | zero chunk], kStages a warp
    const int buf_elems = w + 2 * kChunk;
    In* const bufs = reinterpret_cast<In*>(smem) + (threadIdx.x >> 5) * kStages * buf_elems;
    if (lane < kStages)
      *reinterpret_cast<int4*>(bufs + lane * buf_elems) = make_int4(0, 0, 0, 0);
    const int span = kLerp ? out_w + c : out_w;  // taps a row reads from kk on

    // Stages row `row` (shift kk) into buffer `slot`; returns the first
    // element staged.
    auto stage = [&](long long row, int kk, int slot) {
      const int lo = min(max(kk, 0), w);
      const int hi = min(max(kk + span, lo), w);
      const int base = lo / kChunk * kChunk;
      const int end = (hi + kChunk - 1) / kChunk * kChunk;  // <= w: w % kChunk == 0
      const In* src = x + row * static_cast<long long>(w);
      In* buf = bufs + slot * buf_elems + kChunk;  // buf[i - base] = src[i]
      for (int i = base + lane * kChunk; i < end; i += 32 * kChunk)
        cp_async16(buf + (i - base), src + i);
      if (lane == 0) *reinterpret_cast<int4*>(buf + (end - base)) = make_int4(0, 0, 0, 0);
      return base;
    };

    if (r >= rows) return;
    // Row r + s * stride has shift kk[s], fraction fr[s] and, once staged,
    // its first staged element base[s]: rows s < kStages - 1 are staged,
    // row kStages - 1 has its k and f loaded.
    int kk[kStages], base[kStages];
    float fr[kStages];
    int m = static_cast<int>(r % n);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const long long row = r + s * stride;
      kk[s] = base[s] = 0;
      fr[s] = 0.0f;
      if (row < rows) {
        kk[s] = shift_of(m);
        fr[s] = frac_of(m);
        if (s < kStages - 1) base[s] = stage(row, kk[s], s);
      }
      if (s < kStages - 1) cp_async_commit();
      m = advance(m);  // ends as the row of r + kStages * stride
    }
    for (int slot = 0; r < rows; r += stride, slot = slot + 1 == kStages ? 0 : slot + 1) {
      // stage the row kStages - 1 ahead into the buffer the last row freed,
      // and load the k and f of the row after it
      const long long ahead = r + (kStages - 1) * stride;
      if (ahead < rows)
        base[kStages - 1] = stage(ahead, kk[kStages - 1], slot == 0 ? kStages - 1 : slot - 1);
      cp_async_commit();
      int kk_far = 0;
      float fr_far = 0.0f;
      if (ahead + stride < rows) {
        kk_far = shift_of(m);
        fr_far = frac_of(m);
      }
      m = advance(m);
      cp_async_wait<kStages - 1>();
      __syncwarp();

      const In* taps = bufs + slot * buf_elems;
      const int off = kChunk - base[0];
      const float keep = 1.0f - fr[0];
      Out* dst = y + r * static_cast<long long>(out_w);
      for (int e = lane * kRun; e < out_w; e += 32 * kRun) {
        const int t0 = e + kk[0];
        *reinterpret_cast<uint4*>(dst + e) =
            (t0 >= 0 && t0 + kRun + (kLerp ? c : 0) <= w)
                ? run16<In, Out, kLerp, false>(taps, t0, off, w, c, keep, fr[0])
                : run16<In, Out, kLerp, true>(taps, t0, off, w, c, keep, fr[0]);
      }
      __syncwarp();  // every lane is done with this buffer before it is restaged
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        kk[s] = kk[s + 1];
        fr[s] = fr[s + 1];
        base[s] = base[s + 1];
      }
      kk[kStages - 1] = kk_far;
      fr[kStages - 1] = fr_far;
    }
  }
}

// A grid of about one wave (the SMs times the blocks an SM holds), cached
// for the last device and shared-memory size of each instantiation.
template <typename In, typename Out, bool kLerp, bool kUnit, bool kVec>
int launch_path(const void* x, const int32_t* k, const float* f, void* y, long long rows, int n,
                int w, int out_w, int c, cudaStream_t stream) {
  auto kernel = shift_lerp_kernel<In, Out, kLerp, kUnit, kVec>;
  const size_t smem = kVec ? kStages * kWarps * (w * sizeof(In) + 32) : 0;
  static int cached_dev = -1;
  static size_t cached_smem = 0;
  static long long wave = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess && (dev != cached_dev || smem != cached_smem)) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (rc == cudaSuccess) {
      cached_dev = dev;
      cached_smem = smem;
      wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    }
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long need = (rows + kWarps - 1) / kWarps;
  const unsigned blocks = static_cast<unsigned>(need < wave ? need : wave);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const In*>(x), k, f,
                                             static_cast<Out*>(y), rows, n, w, out_w, c);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte path's conditions; the wrapper's `shift_path` mirrors them.
bool takes_vec16(const void* x, const void* y, long long w, long long out_w, size_t in_size,
                 size_t out_size) {
  const long long row_bytes = w * static_cast<long long>(in_size);
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
         row_bytes % 16 == 0 && row_bytes <= kMaxRowBytes &&
         (out_w * static_cast<long long>(out_size)) % 16 == 0;
}

template <typename In, typename Out, bool kLerp>
int launch(const void* x, const int32_t* k, const float* f, void* y, long long rows, int n,
           int w, int out_w, int c, int vec16, cudaStream_t stream) {
  if (vec16 && !takes_vec16(x, y, w, out_w, sizeof(In), sizeof(Out))) return -2;
  if (vec16) {
    if (c == 1) return launch_path<In, Out, kLerp, true, true>(x, k, f, y, rows, n, w, out_w, 1, stream);
    return launch_path<In, Out, kLerp, false, true>(x, k, f, y, rows, n, w, out_w, c, stream);
  }
  if (c == 1) return launch_path<In, Out, kLerp, true, false>(x, k, f, y, rows, n, w, out_w, 1, stream);
  return launch_path<In, Out, kLerp, false, false>(x, k, f, y, rows, n, w, out_w, c, stream);
}

int dispatch(const void* x, int in_dtype, const int32_t* k, const float* f, void* y,
             int out_dtype, int lerp, long long rows, long long n, long long w, long long out_w,
             int c, int vec16, void* stream) {
  if (rows == 0 || out_w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), wi = static_cast<int>(w), oi = static_cast<int>(out_w);
  if (lerp) {
    if (in_dtype == kU8 && out_dtype == kBF16)
      return launch<uint8_t, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
    if (in_dtype == kU8 && out_dtype == kF32)
      return launch<uint8_t, float, true>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
    if (in_dtype == kBF16 && out_dtype == kBF16)
      return launch<__nv_bfloat16, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
    if (in_dtype == kBF16 && out_dtype == kF32)
      return launch<__nv_bfloat16, float, true>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
    if (in_dtype == kF32 && out_dtype == kBF16)
      return launch<float, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
    if (in_dtype == kF32 && out_dtype == kF32)
      return launch<float, float, true>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
    return -1;
  }
  if (in_dtype != out_dtype) return -1;
  if (in_dtype == kU8)
    return launch<uint8_t, uint8_t, false>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
  if (in_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
  if (in_dtype == kF32)
    return launch<float, float, false>(x, k, f, y, rows, ni, wi, oi, c, vec16, s);
  return -1;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, -1 for a
// type combination the kernel does not take, or -2 when vec16 is asked for
// operands that do not meet the 16-byte path's conditions.  Pointers are
// device pointers of contiguous (G, N, W) input, (N,) k and f, and (G, N,
// out_w) output; vec16 picks the 16-byte path over the scalar one.
int peclr_shift_lerp_grouped(const void* x, int in_dtype, const int32_t* k, const float* f,
                             void* y, int out_dtype, int lerp, long long g, long long n,
                             long long w, long long out_w, int vec16, void* stream) {
  return dispatch(x, in_dtype, k, f, y, out_dtype, lerp, g * n, n, w, out_w, 1, vec16, stream);
}

// The flat (NHWC) kernel: (N, W) input of W = width*C elements, (N,) k and f,
// (N, out_w) output of out_w elements; taps step by C elements.  Same return
// codes.
int peclr_shift_lerp_flat(const void* x, int in_dtype, const int32_t* k, const float* f,
                          void* y, int out_dtype, long long n, long long w, long long out_w,
                          int c, int vec16, void* stream) {
  return dispatch(x, in_dtype, k, f, y, out_dtype, 1, n, n, w, out_w, c, vec16, stream);
}

// The widest source row, in bytes, that the 16-byte path stages.
int peclr_shift_max_row_bytes() { return kMaxRowBytes; }

const char* peclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
