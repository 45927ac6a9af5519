// The augmentation's photometric tail in one pass: colour jitter ->
// [Gaussian noise] -> [colour drop] -> /255 -> [ImageNet normalisation].
//
// Replaces no TPU kernel.  The reference leaves this chain to XLA, which
// fuses it on the TPU; the port ran it as torch ops, 97 kernels a call on
// the card (ops/image.py: the HSV round trip's selects, compares, clamps
// and floors, then the division and the normalisation), each over a
// (B, 128, 128) plane of f32, most of them on stride-3 channel slices:
// 6.4 ms a call at the RN50 mb512 pretrain step's 1,024 views on an H100,
// 25 ms of its 385 ms of kernel time (4 calls a step).  This kernel reads
// each pixel once and writes it once.
//
// Arithmetic.  Every operation follows ops/photometric.py's plain chain in
// its order, in f32, one rounding each (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn: nvcc contracts none of them into an FMA), with the plain
// chain's operations as torch runs them on the card: a division by a
// Python number is a multiplication by its f32 reciprocal there (x / 255,
// s / 255, h / 60 and h / 2), a division by a tensor an IEEE division;
// clamp_min, clamp and maximum are fmaxf / fminf with NaN passed through;
// remainder is fmod with torch's sign fix (here in exact steps, below); the
// int32 conversion of h / 60
// truncates; the uint8 round trip is floorf.  So the output equals the
// plain chain on the card bit for bit, except the colour drop's gray value:
// the plain chain takes it with an einsum (cuBLAS's sum order), the kernel
// as (0.114 x0 + 0.587 x1) + 0.299 x2, a few ulp apart.
//
// Layouts.  x is (B, H, W, 3) f32 with any strides.  On the card the warp
// hands over (torch's TensorIterator lays out the warp's border `where`
// after its operands):
//   grouped, matmul  (C, B, H, W) planes, strides (H*W, W, 1, B*H*W)
//   nhwc, gather     contiguous, strides (3*H*W, 3*W, 3, 1)
// y is laid out as the plain chain lays out its result for the jitter
// (its last op stacks the channels: NHWC contiguous) and for /255 and the
// normalisation alone (x's layout, torch.empty_like); the wrapper says
// which.  The kernel reads x and writes y by their strides, one pixel a
// thread a step, consecutive pixels on consecutive lanes: a warp's load
// of one channel covers 128 contiguous bytes of a plane, or, NHWC, its
// three channel loads cover the same 384 contiguous bytes, which L1 and
// L2 merge; the stores likewise.  An earlier design kept four load and
// store modes (16-byte loads of planes and of NHWC pixels, NHWC stores
// staged through shared memory) beside this one; at the RN50 recipe's
// microbatch they saved too little of the step to keep (PERF.md).
//
// Grid.  One block of 256 threads covers whole rows of one sample (about
// 1,024 pixels: 8 rows at W = 128), loads that sample's factors and coins
// once into shared memory, and walks its pixels one a thread a step (2, 4
// or 8 a thread, loaded before any is computed, were 5-30% slower at the
// recipe's microbatch on an H100: fewer registers, more blocks resident,
// a shorter last wave).  Index math is 32-bit within a block's rows (its
// pixel count fits an int: the launcher refuses W >= 2^29); only the
// sample's and the row's offsets are 64-bit.
// The noise tensor ((B, H, W, 3), contiguous) is read only in blocks whose
// sample's noise coin is 1: the plain chain selects on the coin, so the
// result is the same.
//
// Bound.  Bytes: the f32 input read once and the f32 output written once
// (noise, where on, read once too) over the H100 SXM's 3.35 TB/s: at the
// RN50 recipe's microbatch (1,024 x 128 x 128 x 3, 50.3 M floats) 201 MB
// read and 201 MB written, 0.120 ms.  The f32 work (~110 operations a
// pixel, ~1.8 G a call, 0.03 ms at 67 TFLOP/s) stays under it, but its 5
// IEEE divisions a pixel are instruction sequences of their own (PERF.md
// has the measured share of the bound).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// pixels a block covers, about: whole rows of one sample (8 at W = 128)
constexpr int kBlockPixels = 1024;

struct Args {
  const float* x;
  long long sb, sh, sw, sc;  // x's strides, in elements
  float* y;
  long long ysb, ysh, ysw, ysc;  // y's strides, in elements
  int b, h, w, rows;
  const float* hf;  // hue, saturation, value-scale, value-shift factors (B,)
  const float* sf;
  const float* af;
  const float* bf;
  const float* noise;       // (B, H, W, 3) contiguous, or null
  const float* noise_flag;  // (B,) 0/1 coins, or null
  const float* drop_flag;   // (B,) 0/1 coins, or null
  float noise_std;
  int jitter, normalize;
};

// torch's reciprocals of the Python numbers it divides by on the card
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kInv60 = 1.0f / 60.0f;

__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum_t(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float minimum_t(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// ops/image.py:color_jitter on one pixel (storage order c0, c1, c2; the
// cv2 quirk reads c0 as blue), in place.
__device__ __forceinline__ void jitter_pixel(float& c0, float& c1, float& c2, float hf,
                                             float sf, float af, float bf) {
  const float eps = static_cast<float>(1e-6);
  const float b = c0, g = c1, r = c2;
  // rgb_to_hsv_cv2
  const float maxc = maximum_t(maximum_t(r, g), b);
  const float minc = minimum_t(minimum_t(r, g), b);
  const float delta = __fsub_rn(maxc, minc);
  const float s = maxc > 0.0f ? __fmul_rn(__fdiv_rn(delta, clamp_min_t(maxc, eps)), 255.0f)
                              : 0.0f;
  const float sd = clamp_min_t(delta, eps);
  float h;
  if (maxc == r) {
    h = __fdiv_rn(__fmul_rn(__fsub_rn(g, b), 60.0f), sd);
  } else if (maxc == g) {
    h = __fadd_rn(__fdiv_rn(__fmul_rn(__fsub_rn(b, r), 60.0f), sd), 120.0f);
  } else {
    h = __fadd_rn(__fdiv_rn(__fmul_rn(__fsub_rn(r, g), 60.0f), sd), 240.0f);
  }
  if (delta == 0.0f) h = 0.0f;
  h = __fmul_rn(h < 0.0f ? __fadd_rn(h, 360.0f) : h, 0.5f);
  // the jitter and the uint8 round trip
  const float hq = floorf(clamp_t(__fmul_rn(h, hf), 0.0f, 255.0f));
  const float sq = floorf(clamp_t(__fmul_rn(s, sf), 0.0f, 255.0f));
  const float vq = floorf(clamp_t(__fadd_rn(__fmul_rn(maxc, af), bf), 0.0f, 255.0f));
  // hsv_to_rgb_cv2.  torch.remainder is fmod with the divisor's sign, and
  // fmod is exact: of hq * 2 (a whole number in [0, 510], or NaN) by 360
  // it is hq * 2 less 360 where that is 360 or more; of q (in [0, 6), or
  // NaN) by 2 it is q less twice the whole part of q / 2, each step exact
  const float h2 = __fmul_rn(hq, 2.0f);
  const float hd = h2 >= 360.0f ? __fsub_rn(h2, 360.0f) : h2;
  const float c = __fmul_rn(vq, __fmul_rn(sq, kInv255));
  const float q = __fmul_rn(hd, kInv60);
  const float q2 = __fsub_rn(q, __fmul_rn(2.0f, floorf(__fmul_rn(q, 0.5f))));
  const float x = __fmul_rn(c, __fsub_rn(1.0f, fabsf(__fsub_rn(q2, 1.0f))));
  const float m = __fsub_rn(vq, c);
  int sector = static_cast<int>(q) % 6;
  if (sector < 0) sector += 6;
  float rr, gg, bb;
  switch (sector) {
    case 0: rr = c; gg = x; bb = 0.0f; break;
    case 1: rr = x; gg = c; bb = 0.0f; break;
    case 2: rr = 0.0f; gg = c; bb = x; break;
    case 3: rr = 0.0f; gg = x; bb = c; break;
    case 4: rr = x; gg = 0.0f; bb = c; break;
    default: rr = c; gg = 0.0f; bb = x; break;
  }
  c0 = clamp_t(__fadd_rn(bb, m), 0.0f, 255.0f);
  c1 = clamp_t(__fadd_rn(gg, m), 0.0f, 255.0f);
  c2 = clamp_t(__fadd_rn(rr, m), 0.0f, 255.0f);
}

// The sample's factors and coins, read once a block.
struct Sample {
  float hf, sf, af, bf;
  bool noise, drop;
};

// The tail on one pixel: jitter, noise (n: the pixel's 3 noise values),
// drop, /255, normalisation.
__device__ __forceinline__ void tail_pixel(float& c0, float& c1, float& c2, const Sample& s,
                                           const float* n, const Args& a) {
  if (a.jitter) jitter_pixel(c0, c1, c2, s.hf, s.sf, s.af, s.bf);
  if (s.noise) {
    c0 = clamp_t(__fadd_rn(c0, __fmul_rn(n[0], a.noise_std)), 0.0f, 255.0f);
    c1 = clamp_t(__fadd_rn(c1, __fmul_rn(n[1], a.noise_std)), 0.0f, 255.0f);
    c2 = clamp_t(__fadd_rn(c2, __fmul_rn(n[2], a.noise_std)), 0.0f, 255.0f);
  }
  if (s.drop) {
    const float gray = __fadd_rn(__fadd_rn(__fmul_rn(c0, static_cast<float>(0.114)),
                                           __fmul_rn(c1, static_cast<float>(0.587))),
                                 __fmul_rn(c2, static_cast<float>(0.299)));
    c0 = c1 = c2 = gray;
  }
  c0 = __fmul_rn(c0, kInv255);
  c1 = __fmul_rn(c1, kInv255);
  c2 = __fmul_rn(c2, kInv255);
  if (a.normalize) {
    c0 = __fdiv_rn(__fsub_rn(c0, static_cast<float>(0.485)), static_cast<float>(0.229));
    c1 = __fdiv_rn(__fsub_rn(c1, static_cast<float>(0.456)), static_cast<float>(0.224));
    c2 = __fdiv_rn(__fsub_rn(c2, static_cast<float>(0.406)), static_cast<float>(0.225));
  }
}

__global__ void __launch_bounds__(kThreads) photometric_elementwise_kernel(const Args a) {
  __shared__ Sample sample;
  const int per_sample = (a.h + a.rows - 1) / a.rows;
  const int bi = blockIdx.x / per_sample;
  const int r0 = (blockIdx.x % per_sample) * a.rows;
  const int nrows = min(a.rows, a.h - r0);
  if (threadIdx.x == 0) {
    Sample s;
    s.hf = a.jitter ? a.hf[bi] : 0.0f;
    s.sf = a.jitter ? a.sf[bi] : 0.0f;
    s.af = a.jitter ? a.af[bi] : 0.0f;
    s.bf = a.jitter ? a.bf[bi] : 0.0f;
    s.noise = a.noise != nullptr && a.noise_flag[bi] > 0.0f;
    s.drop = a.drop_flag != nullptr && a.drop_flag[bi] > 0.0f;
    sample = s;
  }
  __syncthreads();
  const Sample s = sample;
  const int npix = nrows * a.w;
  const float* xs = a.x + bi * a.sb + r0 * a.sh;
  float* ys = a.y + bi * a.ysb + r0 * a.ysh;
  // the block's first pixel in the noise, rows of one sample being
  // contiguous there
  const float* ns = s.noise ? a.noise + (static_cast<long long>(bi) * a.h + r0) * a.w * 3
                            : nullptr;
  for (int p = threadIdx.x; p < npix; p += kThreads) {
    const int row = p / a.w, col = p - row * a.w;
    const float* px = xs + row * a.sh + col * a.sw;
    float c0 = px[0], c1 = px[a.sc], c2 = px[2 * a.sc];
    float n[3];
    if (s.noise) {
      n[0] = ns[3 * p];
      n[1] = ns[3 * p + 1];
      n[2] = ns[3 * p + 2];
    }
    tail_pixel(c0, c1, c2, s, n, a);
    float* py = ys + row * a.ysh + col * a.ysw;
    py[0] = c0;
    py[a.ysc] = c1;
    py[2 * a.ysc] = c2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// for arguments the kernel does not take (sizes <= 0, W >= 2^29, a grid
// beyond the launch limit, jitter without factors, noise without its
// coins).  Pointers are device pointers: x and y of (b, h, w, 3) floats at
// strides (sb, sh, sw, sc) and (ysb, ysh, ysw, ysc) elements; hf, sf, af,
// bf (b,) floats (null without jitter); noise contiguous (b, h, w, 3)
// floats with its (b,) coins noise_flag, or both null; drop_flag (b,)
// coins or null.
int peclr_photometric(const float* x, long long sb, long long sh, long long sw, long long sc,
                      float* y, long long ysb, long long ysh, long long ysw, long long ysc,
                      int b, int h, int w, const float* hf, const float* sf, const float* af,
                      const float* bf, const float* noise, const float* noise_flag,
                      float noise_std, const float* drop_flag, int jitter, int normalize,
                      void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || w >= (1 << 29)) return -1;
  const int rows = w >= kBlockPixels ? 1 : kBlockPixels / w;
  if (jitter && (!hf || !sf || !af || !bf)) return -1;
  if ((noise == nullptr) != (noise_flag == nullptr)) return -1;
  const long long blocks = (h + rows - 1) / rows * static_cast<long long>(b);
  if (blocks > 0x7fffffffLL) return -1;
  const Args a{x, sb, sh, sw, sc, y, ysb, ysh, ysw, ysc, b, h, w, rows, hf, sf, af, bf,
               noise, noise_flag, drop_flag, noise_std, jitter, normalize};
  photometric_elementwise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* peclr_photometric_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
