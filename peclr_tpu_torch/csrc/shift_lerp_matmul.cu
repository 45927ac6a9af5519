// Fused per-row shift + fractional lerp + per-image NT tap matmul: one pass
// of the two-pass affine warp in one launch.
//
// Replaces the Pallas TPU kernel `_matmul_kernel` of
// peclr_tpu/ops/pallas/barrel_shift.py, reached through
// fused_shift_lerp_matmul.  For G planes of B images of R rows of W source
// elements, a window of U taps per row and M outputs per image:
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
// Design.  The TPU block is one whole (plane, image) window in VMEM (224 x
// 384 at pass 1, 172 KB in bf16 before the taps); that does not fit a
// Hopper block next to its tap tile.  Here one block computes a 128 (m) x 64
// (r) output tile of one (g, b): it walks U in chunks of 64, builds the
// lerped 64 x 64 window chunk in shared memory straight from the source
// rows, stages the 128 x 64 chunk of w_t[b] beside it, and multiplies the
// two (bf16 taps: WMMA 16x16x16 on the tensor cores, f32 accumulators in
// registers, 8 warps of 16 m x 64 r each; f32 taps: chunks of 32 taps and
// CUDA-core FMAs, 32 outputs a thread).  The accumulators go through shared
// memory so the transposed output is written along r, coalesced.  Blocks of
// one image are adjacent in the launch order, so w_t[b] is re-read from L2.
// Any G, B, R, W, U and M are taken; ragged tiles are zero-filled.  Not yet
// used: the band structure of w_t (most taps of a row of w_t are zero),
// wgmma, TMA.
//
// Bound (pretrain recipe, 2B = 256 canvases, bf16 taps).  Pass 1: (3, 256,
// 224, 224) uint8 in, w_t (256, 128, 384) bf16, (3, 256, 128, 224) bf16 out:
// 8.46 G multiply-adds, 17 us at 989 TFLOP/s of bf16 tensor cores but 252 us
// at 67 TFLOP/s of f32 FMA; about 108 MB moved, 32 us at 3.35 TB/s.  So on
// the tensor cores it is bound by memory.  Pass 2: (3, 256, 128, 224) bf16
// in, w_t (256, 128, 256) bf16, (3, 256, 128, 128) f32 out: 3.2 G
// multiply-adds, about 111 MB, 33 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

constexpr int kBM = 128;       // outputs m per block
constexpr int kBR = 64;        // rows r per block
constexpr int kKC = 64;        // taps u per chunk (bf16 taps)
constexpr int kKCF = 32;       // taps u per chunk (f32 taps)
constexpr int kThreads = 256;  // 8 warps
constexpr int kPadH = 8;       // bf16 row padding (keeps 32-byte alignment)
constexpr int kPadF = 1;       // f32 row padding (bank spread)
constexpr int kPadC = 4;       // accumulator staging row padding

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Tile {
  int g, b, m0, r0;
};

__device__ __forceinline__ Tile tile_of(long long block, int g_count, int m_tiles,
                                        int r_tiles) {
  // launch order b, g, m tile, r tile: the blocks of one image are adjacent
  Tile t;
  t.r0 = static_cast<int>(block % r_tiles) * kBR;
  block /= r_tiles;
  t.m0 = static_cast<int>(block % m_tiles) * kBM;
  block /= m_tiles;
  t.g = static_cast<int>(block % g_count);
  t.b = static_cast<int>(block / g_count);
  return t;
}

// The lerped window chunk win[r0 + i, u0 + j] (i < kBR, j < KC) into
// sw[i * ld + j], cast to Wt; rows past R and taps past U are zero.
template <int KC, typename In, typename Wt>
__device__ __forceinline__ void load_window(Wt* sw, int ld, const In* __restrict__ x,
                                            const int32_t* __restrict__ k,
                                            const float* __restrict__ f,
                                            const Tile& t, int b_count, int r_count,
                                            int w, int u_count, int u0) {
  const long long plane = static_cast<long long>(t.g) * b_count + t.b;
  for (int idx = threadIdx.x; idx < kBR * KC; idx += kThreads) {
    const int i = idx / KC, j = idx % KC;
    const int r = t.r0 + i, u = u0 + j;
    float v = 0.0f;
    if (r < r_count && u < u_count) {
      const long long row = static_cast<long long>(t.b) * r_count + r;
      const int kk = min(max(k[row], -(u_count + 2)), w);
      const float fr = f[row];
      const In* src = x + (plane * r_count + r) * static_cast<long long>(w);
      const int t0 = u + kk, t1 = t0 + 1;
      const float a = (t0 >= 0 && t0 < w) ? to_f32(src[t0]) : 0.0f;
      const float c = (t1 >= 0 && t1 < w) ? to_f32(src[t1]) : 0.0f;
      v = __fadd_rn(__fmul_rn(a, 1.0f - fr), __fmul_rn(c, fr));
    }
    sw[i * ld + j] = from_f32<Wt>(v);
  }
}

// The tap chunk w_t[b, m0 + i, u0 + j] (i < kBM, j < KC) into sa[i * ld + j].
template <int KC, typename Wt>
__device__ __forceinline__ void load_taps(Wt* sa, int ld, const Wt* __restrict__ wt,
                                          const Tile& t, int m_count, int u_count,
                                          int u0) {
  const Wt* base = wt + static_cast<long long>(t.b) * m_count * u_count;
  for (int idx = threadIdx.x; idx < kBM * KC; idx += kThreads) {
    const int i = idx / KC, j = idx % KC;
    const int m = t.m0 + i, u = u0 + j;
    sa[i * ld + j] = (m < m_count && u < u_count)
                         ? base[static_cast<long long>(m) * u_count + u]
                         : from_f32<Wt>(0.0f);
  }
}

template <typename Out>
__device__ __forceinline__ void store_tile(const float* sc, int ld, Out* __restrict__ y,
                                           const Tile& t, int b_count, int m_count,
                                           int r_count) {
  const long long plane = static_cast<long long>(t.g) * b_count + t.b;
  for (int idx = threadIdx.x; idx < kBM * kBR; idx += kThreads) {
    const int i = idx / kBR, j = idx % kBR;
    const int m = t.m0 + i, r = t.r0 + j;
    if (m < m_count && r < r_count)
      y[(plane * m_count + m) * r_count + r] = from_f32<Out>(sc[i * ld + j]);
  }
}

// bf16 taps: WMMA on the tensor cores.
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
shift_lerp_matmul_bf16(const In* __restrict__ x, const int32_t* __restrict__ k,
                       const float* __restrict__ f, const __nv_bfloat16* __restrict__ wt,
                       Out* __restrict__ y, int g_count, int b_count, int r_count, int w,
                       int u_count, int m_count, int m_tiles, int r_tiles) {
  using namespace nvcuda;
  constexpr int lda = kKC + kPadH;
  constexpr int ldc = kBR + kPadC;
  constexpr int a_bytes = kBM * lda * 2;
  constexpr int w_bytes = kBR * lda * 2;
  constexpr int c_bytes = kBM * ldc * 4;
  constexpr int smem_bytes = (a_bytes + w_bytes > c_bytes) ? a_bytes + w_bytes : c_bytes;
  __shared__ __align__(128) unsigned char smem[smem_bytes];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + a_bytes);
  float* sc = reinterpret_cast<float*>(smem);  // reused after the last chunk

  const Tile t = tile_of(blockIdx.x, g_count, m_tiles, r_tiles);
  const int warp = threadIdx.x / 32;  // owns m rows [16 warp, 16 warp + 16)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBR / 16];
#pragma unroll
  for (int j = 0; j < kBR / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int u0 = 0; u0 < u_count; u0 += kKC) {
    load_taps<kKC>(sa, lda, wt, t, m_count, u_count, u0);
    load_window<kKC>(sw, lda, x, k, f, t, b_count, r_count, w, u_count, u0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sa + warp * 16 * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < kBR / 16; ++j) {
        // B[u, r] = win[r, u]: the window chunk read column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, sw + j * 16 * lda + kk, lda);
        wmma::mma_sync(acc[j], a, bw, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kBR / 16; ++j)
    wmma::store_matrix_sync(sc + warp * 16 * ldc + j * 16, acc[j], ldc,
                            wmma::mem_row_major);
  __syncthreads();
  store_tile(sc, ldc, y, t, b_count, m_count, r_count);
}

// f32 taps: CUDA-core FMAs, each thread 8 m x 4 r outputs.
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
shift_lerp_matmul_f32(const In* __restrict__ x, const int32_t* __restrict__ k,
                      const float* __restrict__ f, const float* __restrict__ wt,
                      Out* __restrict__ y, int g_count, int b_count, int r_count, int w,
                      int u_count, int m_count, int m_tiles, int r_tiles) {
  constexpr int ld = kKCF + kPadF;
  constexpr int ldc = kBR + kPadC;
  constexpr int a_floats = kBM * ld;
  constexpr int w_floats = kBR * ld;
  constexpr int c_floats = kBM * ldc;
  constexpr int smem_floats =
      (a_floats + w_floats > c_floats) ? a_floats + w_floats : c_floats;
  __shared__ float smem[smem_floats];
  float* sa = smem;
  float* sw = smem + a_floats;
  float* sc = smem;

  const Tile t = tile_of(blockIdx.x, g_count, m_tiles, r_tiles);
  const int tm = threadIdx.x / 16;  // m = tm + 16 i
  const int tr = threadIdx.x % 16;  // r = tr + 16 j
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int u0 = 0; u0 < u_count; u0 += kKCF) {
    load_taps<kKCF>(sa, ld, wt, t, m_count, u_count, u0);
    load_window<kKCF>(sw, ld, x, k, f, t, b_count, r_count, w, u_count, u0);
    __syncthreads();
    for (int u = 0; u < kKCF; ++u) {
      float a[8], c[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sa[(tm + 16 * i) * ld + u];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sw[(tr + 16 * j) * ld + u];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[(tm + 16 * i) * ldc + tr + 16 * j] = acc[i][j];
  __syncthreads();
  store_tile(sc, ldc, y, t, b_count, m_count, r_count);
}

template <typename In, typename Wt, typename Out>
int launch(const void* x, const int32_t* k, const float* f, const void* wt, void* y,
           int g, int b, int r, int w, int u, int m, cudaStream_t stream) {
  const int m_tiles = (m + kBM - 1) / kBM;
  const int r_tiles = (r + kBR - 1) / kBR;
  const long long blocks = static_cast<long long>(g) * b * m_tiles * r_tiles;
  if (blocks > 0x7fffffffLL) return -2;
  const dim3 grid(static_cast<unsigned>(blocks));
  if constexpr (sizeof(Wt) == 2) {
    shift_lerp_matmul_bf16<In, Out><<<grid, kThreads, 0, stream>>>(
        static_cast<const In*>(x), k, f, static_cast<const __nv_bfloat16*>(wt),
        static_cast<Out*>(y), g, b, r, w, u, m, m_tiles, r_tiles);
  } else {
    shift_lerp_matmul_f32<In, Out><<<grid, kThreads, 0, stream>>>(
        static_cast<const In*>(x), k, f, static_cast<const float*>(wt),
        static_cast<Out*>(y), g, b, r, w, u, m, m_tiles, r_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dispatch_wt(const void* x, const int32_t* k, const float* f, const void* wt,
                int wt_dtype, void* y, int out_dtype, int g, int b, int r, int w,
                int u, int m, cudaStream_t s) {
  if (wt_dtype == kBF16 && out_dtype == kBF16)
    return launch<In, __nv_bfloat16, __nv_bfloat16>(x, k, f, wt, y, g, b, r, w, u, m, s);
  if (wt_dtype == kBF16 && out_dtype == kF32)
    return launch<In, __nv_bfloat16, float>(x, k, f, wt, y, g, b, r, w, u, m, s);
  if (wt_dtype == kF32 && out_dtype == kBF16)
    return launch<In, float, __nv_bfloat16>(x, k, f, wt, y, g, b, r, w, u, m, s);
  if (wt_dtype == kF32 && out_dtype == kF32)
    return launch<In, float, float>(x, k, f, wt, y, g, b, r, w, u, m, s);
  return -1;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, -1 for a
// type combination the kernel does not take, -2 for a grid too large.
// Pointers are device pointers of contiguous (G, B, R, W) input, (B*R,) k
// and f, (B, M, U) taps and (G, B, M, R) output.
int peclr_shift_lerp_matmul(const void* x, int in_dtype, const int32_t* k,
                            const float* f, const void* wt, int wt_dtype, void* y,
                            int out_dtype, int g, int b, int r, int w, int u, int m,
                            void* stream) {
  if (static_cast<long long>(g) * b * r * m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kU8)
    return dispatch_wt<uint8_t>(x, k, f, wt, wt_dtype, y, out_dtype, g, b, r, w, u, m, s);
  if (in_dtype == kBF16)
    return dispatch_wt<__nv_bfloat16>(x, k, f, wt, wt_dtype, y, out_dtype, g, b, r, w, u,
                                      m, s);
  if (in_dtype == kF32)
    return dispatch_wt<float>(x, k, f, wt, wt_dtype, y, out_dtype, g, b, r, w, u, m, s);
  return -1;
}

const char* peclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
