// Grouped per-row shift + fractional lerp for the two-pass affine warp.
//
// Replaces the Pallas TPU kernels of peclr_tpu/ops/pallas/barrel_shift.py
// reached through fused_shift_lerp_grouped: `_kernel(grouped=True)` (lerp)
// and `_kernel_raw` (integer shift only).  For G planes of N rows each,
// sharing one shift k[n] + f[n] per row:
//
//   lerp: out[g,n,u] = x[g,n,u+k] * (1 - f) + x[g,n,u+k+1] * f   (f32, cast)
//   raw:  out[g,n,u] = x[g,n,u+k]                                 (input type)
//
// with taps outside [0, W) reading 0 and k clamped to [-(out_w + 2), W], so a
// clamped row comes out all zero.
//
// Design.  The TPU kernel is a log2-stage barrel shifter over a right-aligned
// padded row because the TPU has no gather.  Hopper loads each tap straight
// from the source row: one block walks rows (a grid-stride loop over G*N on
// gridDim.x, so any batch fits), its threads walk u, and neighbouring threads
// write neighbouring outputs.  Any N, W and out_w are taken; no row-block or
// 128-column padding is needed because out-of-source taps already read 0.
// The lerp uses __fmul_rn/__fadd_rn so it is not contracted into an FMA and
// matches the plain PyTorch version (peclr_tpu_torch/ops/shift_lerp.py)
// bit for bit.
//
// Bound.  Memory: each source row is read once (it stays in L1/L2 across the
// out_w/W re-reads) and each output written once, a few flops per output.
// At the leaderboard shape (B = 120) a pass-1 launch reads 3*26,880*224 B of
// uint8 and writes 3*26,880*768*2 B of bf16, about 142 MB, i.e. 42 us at the
// H100 SXM's 3.35 TB/s; a pass-2 launch (bf16 in) moves about 160 MB, 48 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

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

template <typename In, typename Out, bool kLerp>
__global__ void shift_lerp_kernel(const In* __restrict__ x,
                                  const int32_t* __restrict__ k,
                                  const float* __restrict__ f,
                                  Out* __restrict__ y, long long rows, int n,
                                  int w, int out_w) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int row = static_cast<int>(r % n);
    const int kk = min(max(k[row], -(out_w + 2)), w);
    const In* src = x + r * static_cast<long long>(w);
    Out* dst = y + r * static_cast<long long>(out_w);
    if constexpr (kLerp) {
      const float fr = f[row];
      const float keep = 1.0f - fr;
      for (int u = threadIdx.x; u < out_w; u += blockDim.x) {
        const int t0 = u + kk;
        const int t1 = t0 + 1;
        const float a = (t0 >= 0 && t0 < w) ? to_f32(src[t0]) : 0.0f;
        const float b = (t1 >= 0 && t1 < w) ? to_f32(src[t1]) : 0.0f;
        dst[u] = from_f32<Out>(__fadd_rn(__fmul_rn(a, keep), __fmul_rn(b, fr)));
      }
    } else {
      for (int u = threadIdx.x; u < out_w; u += blockDim.x) {
        const int t0 = u + kk;
        dst[u] = (t0 >= 0 && t0 < w) ? src[t0] : zero_of<Out>();
      }
    }
  }
}

template <typename In, typename Out, bool kLerp>
int launch(const void* x, const int32_t* k, const float* f, void* y,
           long long rows, int n, int w, int out_w, cudaStream_t stream) {
  const int threads = 256;
  const long long max_blocks = 1LL << 20;
  const unsigned blocks = static_cast<unsigned>(rows < max_blocks ? rows : max_blocks);
  shift_lerp_kernel<In, Out, kLerp><<<blocks, threads, 0, stream>>>(
      static_cast<const In*>(x), k, f, static_cast<Out*>(y), rows, n, w, out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for a
// type combination the kernel does not take.  Pointers are device pointers of
// contiguous (G, N, W) input, (N,) k and f, and (G, N, out_w) output.
int peclr_shift_lerp_grouped(const void* x, int in_dtype, const int32_t* k,
                             const float* f, void* y, int out_dtype, int lerp,
                             long long g, long long n, long long w,
                             long long out_w, void* stream) {
  const long long rows = g * n;
  if (rows == 0 || out_w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), wi = static_cast<int>(w),
            oi = static_cast<int>(out_w);
  if (lerp) {
    if (in_dtype == kU8 && out_dtype == kBF16)
      return launch<uint8_t, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, s);
    if (in_dtype == kU8 && out_dtype == kF32)
      return launch<uint8_t, float, true>(x, k, f, y, rows, ni, wi, oi, s);
    if (in_dtype == kBF16 && out_dtype == kBF16)
      return launch<__nv_bfloat16, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, s);
    if (in_dtype == kBF16 && out_dtype == kF32)
      return launch<__nv_bfloat16, float, true>(x, k, f, y, rows, ni, wi, oi, s);
    if (in_dtype == kF32 && out_dtype == kBF16)
      return launch<float, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, s);
    if (in_dtype == kF32 && out_dtype == kF32)
      return launch<float, float, true>(x, k, f, y, rows, ni, wi, oi, s);
    return -1;
  }
  if (in_dtype != out_dtype) return -1;
  if (in_dtype == kU8)
    return launch<uint8_t, uint8_t, false>(x, k, f, y, rows, ni, wi, oi, s);
  if (in_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(x, k, f, y, rows, ni, wi, oi, s);
  if (in_dtype == kF32)
    return launch<float, float, false>(x, k, f, y, rows, ni, wi, oi, s);
  return -1;
}

const char* peclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
