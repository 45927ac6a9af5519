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
// plane of N rows of W = width*C elements.
//
// Design.  The TPU kernel is a log2-stage barrel shifter over a right-aligned
// padded row because the TPU has no gather.  Hopper loads each tap straight
// from the source row: one block walks rows (a grid-stride loop over G*N on
// gridDim.x, so any batch fits), its threads walk the output elements, and
// neighbouring threads write neighbouring outputs.  Any N, W and out_w are
// taken; no row-block or 128-column padding is needed because out-of-source
// taps already read 0.  The lerp uses __fmul_rn/__fadd_rn so it is not
// contracted into an FMA and matches the plain PyTorch versions
// (peclr_tpu_torch/ops/shift_lerp.py) bit for bit.
//
// Bound.  Memory: each source row is read once (it stays in L1/L2 across the
// out_w/W re-reads) and each output written once, a few flops per output.
// At the leaderboard shape (B = 120) a grouped pass-1 launch reads
// 3*26,880*224 B of uint8 and writes 3*26,880*768*2 B of bf16, about 142 MB,
// i.e. 42 us at the H100 SXM's 3.35 TB/s; a pass-2 launch (bf16 in) moves
// about 160 MB, 48 us.  The flat (NHWC) launch of the pretrain recipe
// (microbatch 128, 2B = 256 canvases) reads 57,344 rows of 672 uint8 and
// writes 57,344 x 1,152 bf16, about 171 MB, 51 us; its pass 2 reads 32,768 x
// 672 bf16 and writes 32,768 x 768 bf16, about 94 MB, 28 us.

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

// kUnit: c == 1 known at compile time (the grouped kernel), so the per-row
// clamp has no integer division; each thread writes only a few outputs of
// a row, so the row's set-up is a large share of its work.
template <typename In, typename Out, bool kLerp, bool kUnit>
__global__ void shift_lerp_kernel(const In* __restrict__ x,
                                  const int32_t* __restrict__ k,
                                  const float* __restrict__ f,
                                  Out* __restrict__ y, long long rows, int n,
                                  int w, int out_w, int c_arg) {
  const int c = kUnit ? 1 : c_arg;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int row = static_cast<int>(r % n);
    // clamp in pixels, then step in elements (c = 1: the grouped kernel)
    const int kk = min(max(k[row], -(out_w / c + 2)), w / c) * c;
    const In* src = x + r * static_cast<long long>(w);
    Out* dst = y + r * static_cast<long long>(out_w);
    if constexpr (kLerp) {
      const float fr = f[row];
      const float keep = 1.0f - fr;
      for (int u = threadIdx.x; u < out_w; u += blockDim.x) {
        const int t0 = u + kk;
        const int t1 = t0 + c;
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
           long long rows, int n, int w, int out_w, int c, cudaStream_t stream) {
  const int threads = 256;
  const long long max_blocks = 1LL << 20;
  const unsigned blocks = static_cast<unsigned>(rows < max_blocks ? rows : max_blocks);
  const In* xi = static_cast<const In*>(x);
  Out* yo = static_cast<Out*>(y);
  if (c == 1)
    shift_lerp_kernel<In, Out, kLerp, true><<<blocks, threads, 0, stream>>>(
        xi, k, f, yo, rows, n, w, out_w, 1);
  else
    shift_lerp_kernel<In, Out, kLerp, false><<<blocks, threads, 0, stream>>>(
        xi, k, f, yo, rows, n, w, out_w, c);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, int in_dtype, const int32_t* k, const float* f,
             void* y, int out_dtype, int lerp, long long rows, long long n,
             long long w, long long out_w, int c, void* stream) {
  if (rows == 0 || out_w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), wi = static_cast<int>(w),
            oi = static_cast<int>(out_w);
  if (lerp) {
    if (in_dtype == kU8 && out_dtype == kBF16)
      return launch<uint8_t, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, c, s);
    if (in_dtype == kU8 && out_dtype == kF32)
      return launch<uint8_t, float, true>(x, k, f, y, rows, ni, wi, oi, c, s);
    if (in_dtype == kBF16 && out_dtype == kBF16)
      return launch<__nv_bfloat16, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, c, s);
    if (in_dtype == kBF16 && out_dtype == kF32)
      return launch<__nv_bfloat16, float, true>(x, k, f, y, rows, ni, wi, oi, c, s);
    if (in_dtype == kF32 && out_dtype == kBF16)
      return launch<float, __nv_bfloat16, true>(x, k, f, y, rows, ni, wi, oi, c, s);
    if (in_dtype == kF32 && out_dtype == kF32)
      return launch<float, float, true>(x, k, f, y, rows, ni, wi, oi, c, s);
    return -1;
  }
  if (in_dtype != out_dtype) return -1;
  if (in_dtype == kU8)
    return launch<uint8_t, uint8_t, false>(x, k, f, y, rows, ni, wi, oi, c, s);
  if (in_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(x, k, f, y, rows, ni, wi, oi, c, s);
  if (in_dtype == kF32)
    return launch<float, float, false>(x, k, f, y, rows, ni, wi, oi, c, s);
  return -1;
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
  return dispatch(x, in_dtype, k, f, y, out_dtype, lerp, g * n, n, w, out_w,
                  1, stream);
}

// The flat (NHWC) kernel: (N, W) input of W = width*C elements, (N,) k and f,
// (N, out_w) output of out_w elements; taps step by C elements.  Same return
// codes.
int peclr_shift_lerp_flat(const void* x, int in_dtype, const int32_t* k,
                          const float* f, void* y, int out_dtype, long long n,
                          long long w, long long out_w, int c, void* stream) {
  return dispatch(x, in_dtype, k, f, y, out_dtype, 1, n, n, w, out_w, c,
                  stream);
}

const char* peclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
