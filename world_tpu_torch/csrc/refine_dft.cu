// K2, Harvest's refinement (GetRefinedF0) for every (candidate, frame) pair.
//
// Replaces the Pallas kernel world_tpu/ops/refine_dft.py::_kernel /
// _kernel_body (launched by _refine_pallas).  Its spec is the XLA twin
// refine_full_xla, and the plain PyTorch twin is
// world_tpu_torch/ops/refine_dft.py::refine_plain.
//
// Per pair (candidate c, frame f) with f0 = f0[c, f]:
//   * the Blackman window and its centred-difference derivative over the
//     candidate's own half-width half = ceil(3 fs / f0 / 2);
//   * the <= 6 harmonic bins of both windowed DFTs, read at bin
//     K = bins * S / fft_size of one size-S DFT;
//   * the instantaneous frequency of each bin, the amplitude-weighted refined
//     f0 and score = 1 / mean relative deviation;
//   * the gate floor <= f0 <= ceil and score >= 2.5.  Empty slots give (0, 0).
//
// Design.  The TPU kernel multiplies every windowed row by a dense (W, S+2)
// cos/sin basis on the MXU and selects the bins afterwards.  Here one warp
// owns one pair and keeps 24 running sums (6 harmonics x {main, derivative}
// x {re, im}); it loops only over the samples inside the candidate's own
// window (the GPU form of the TPU code's f0 bucketing) and returns at once
// for an empty slot.  The basis is an S-entry cos/sin table built on the
// host in float64 and read at (K*n) mod S, which is the TPU basis angle
// -2 pi K n / S without a trig call per sample.  Window cosines use cos()
// (correctly rounded library cos; no fast math: a 2e-6 cosine error was
// enough to flip candidate scores).  In float32 the instantaneous-frequency
// numerator re_s*im_d - im_s*re_d is compensated with an fma two-product.
// Bound: C2*F ~ 223k pairs x up to W = 341 samples x (2 cos + 24 FMA + 3
// loads) per sample — arithmetic and the trig units, not bytes (the frame
// rows are shared by the 48 candidate slots and stay in L2).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kHarm = 6;
constexpr int kWarpsPerBlock = 8;

// the math library, spelled out per type (no reliance on C++ overloads)
template <typename T> struct M;
template <> struct M<float> {
  static __device__ __forceinline__ float tiny() { return 1.17549435e-38f; }
  static __device__ __forceinline__ float cos(float x) { return cosf(x); }
  static __device__ __forceinline__ float ceil(float x) { return ceilf(x); }
  static __device__ __forceinline__ float floor(float x) { return floorf(x); }
  static __device__ __forceinline__ float trunc(float x) { return truncf(x); }
  static __device__ __forceinline__ float log2(float x) { return log2f(x); }
  static __device__ __forceinline__ float exp2(float x) { return exp2f(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
};
template <> struct M<double> {
  static __device__ __forceinline__ double tiny() { return 2.2250738585072014e-308; }
  static __device__ __forceinline__ double cos(double x) { return ::cos(x); }
  static __device__ __forceinline__ double ceil(double x) { return ::ceil(x); }
  static __device__ __forceinline__ double floor(double x) { return ::floor(x); }
  static __device__ __forceinline__ double trunc(double x) { return ::trunc(x); }
  static __device__ __forceinline__ double log2(double x) { return ::log2(x); }
  static __device__ __forceinline__ double exp2(double x) { return ::exp2(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double abs(double x) { return ::fabs(x); }
  static __device__ __forceinline__ double min(double a, double b) { return ::fmin(a, b); }
  static __device__ __forceinline__ double max(double a, double b) { return ::fmax(a, b); }
};

// a*b - c*d: compensated in float32 (two-product error terms recovered with
// fma), plain in float64 (the CPU golden path).
template <typename T>
__device__ __forceinline__ T prod_diff(T a, T b, T c, T d) {
  if constexpr (std::is_same<T, float>::value) {
    const float p = a * b;
    const float ep = fmaf(a, b, -p);
    const float q = c * d;
    const float eq = fmaf(c, d, -q);
    return (p - q) + (ep - eq);
  } else {
    return a * b - c * d;
  }
}

template <typename T>
__device__ __forceinline__ T main_window(const T* ph, int j, int jlo, int jhi,
                                         T pi, T wlt) {
  if (j < jlo || j > jhi) return T(0);
  const T common = pi * ph[j] / wlt;
  const T c2 = M<T>::cos(T(2) * common);
  const T c4 = M<T>::cos(T(4) * common);
  return T(0.42) + T(0.5) * c2 + T(0.08) * c4;
}

template <typename T>
__global__ void refine_kernel(const T* __restrict__ seg,
                              const T* __restrict__ phase,
                              const T* __restrict__ f0s, int C, int F, int W,
                              int max_half, int S,
                              const T* __restrict__ cos_tab,
                              const T* __restrict__ sin_tab, T fs, T three_fs,
                              T half_fs, T f0_floor, T f0_ceil,
                              T* __restrict__ out) {
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= (long long)C * F) return;
  const int f = (int)(pair % F);
  const T f0 = f0s[pair];
  T* o = out + 2 * pair;
  if (!(f0 > T(1e-6))) {           // empty slot: the gate gives (0, 0)
    if (lane == 0) { o[0] = T(0); o[1] = T(0); }
    return;
  }
  const T pi = T(3.141592653589793);
  const T half = M<T>::ceil(three_fs / f0 / T(2));
  const T wlt = (T(2) * half + T(1)) / fs;
  const T fft_size = M<T>::exp2(M<T>::ceil(M<T>::log2(half * T(2) + T(1)) + T(1)));
  const T n_harm = M<T>::min(M<T>::floor(half_fs / f0), T(6));
  const int nh = (int)n_harm;
  T bins[kHarm];
  int K[kHarm];
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    bins[h] = M<T>::trunc(f0 * fft_size / fs * T(h + 1) + T(0.5));
    const T k = M<T>::min(M<T>::max(bins[h] * (T(S) / fft_size), T(0)), T(S / 2));
    K[h] = (int)k;
  }

  // window support: |j - max_half| <= half, clipped to the row
  const int ih = (int)M<T>::min(half, T(max_half));
  const int jlo = max_half - ih;
  const int jhi = max_half + ih;
  const T* row = seg + (size_t)f * W;
  const T* ph = phase + (size_t)f * W;

  T acc[kHarm][4];
#pragma unroll
  for (int h = 0; h < kHarm; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = T(0);

  for (int j0 = jlo; j0 <= jhi; j0 += 32) {
    const int j = j0 + lane;
    const T m0 = main_window(ph, j, jlo, jhi, pi, wlt);
    T left = __shfl_up_sync(0xffffffffu, m0, 1);
    T right = __shfl_down_sync(0xffffffffu, m0, 1);
    if (lane == 0) left = main_window(ph, j - 1, jlo, jhi, pi, wlt);
    if (lane == 31) right = main_window(ph, j + 1, jlo, jhi, pi, wlt);
    if (j > jhi) continue;
    const T dw = -(right - left) / T(2);
    const T xv = row[j];
    const T xm = xv * m0;
    const T xd = xv * dw;
#pragma unroll
    for (int h = 0; h < kHarm; ++h) {
      if (h < nh) {
        const int m = (int)(((long long)K[h] * j) & (S - 1));
        const T cb = cos_tab[m];
        const T sb = sin_tab[m];
        acc[h][0] += xm * cb;
        acc[h][1] += xm * sb;
        acc[h][2] += xd * cb;
        acc[h][3] += xd * sb;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kHarm; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      for (int s = 16; s > 0; s >>= 1)
        acc[h][c] += __shfl_xor_sync(0xffffffffu, acc[h][c], s);
  if (lane != 0) return;

  // tail of GetRefinedF0 (world_tpu/ops/refine_dft.py:_refine_math)
  const T tiny = M<T>::tiny();
  T num_acc = T(0), den_acc = T(0), var_acc = T(0);
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    const bool hm = h < nh;
    const T re_s = hm ? acc[h][0] : T(0);
    const T im_s = hm ? acc[h][1] : T(0);
    const T re_d = hm ? acc[h][2] : T(0);
    const T im_d = hm ? acc[h][3] : T(0);
    const T numerator = prod_diff(re_s, im_d, im_s, re_d);
    const T power = re_s * re_s + im_s * im_s;
    const T inst = (bins[h] / fft_size + numerator / M<T>::max(power, tiny) / T(2) / pi) * fs;
    const T amp = M<T>::sqrt(power) * (hm ? T(1) : T(0));
    num_acc = num_acc + amp * inst;
    den_acc = den_acc + amp * T(h + 1);
    var_acc = var_acc + (hm ? M<T>::abs((inst / T(h + 1) - f0) / f0) : T(0));
  }
  const T refined = num_acc / M<T>::max(den_acc, tiny);
  const T score = T(1) / (T(1e-12) + var_acc / M<T>::max(n_harm, T(1)));
  const bool ok = refined >= f0_floor && refined <= f0_ceil &&
                  score >= T(2.5) && f0 > T(1e-6);
  o[0] = ok ? refined : T(0);
  o[1] = ok ? score : T(0);
}

template <typename T>
int launch_refine(const T* seg, const T* phase, const T* f0, int C, int F,
                  int W, int max_half, int S, const T* cos_tab,
                  const T* sin_tab, double fs, double f0_floor, double f0_ceil,
                  T* out, cudaStream_t stream) {
  if (C <= 0 || F <= 0 || W != 2 * max_half + 1 || S <= 0 || (S & (S - 1)))
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)C * F;
  const long long blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  refine_kernel<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      seg, phase, f0, C, F, W, max_half, S, cos_tab, sin_tab, (T)fs,
      (T)(3.0 * fs), (T)(fs / 2.0), (T)f0_floor, (T)f0_ceil, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int world_refine_dft_f32(const float* seg, const float* phase,
                                    const float* f0, int C, int F, int W,
                                    int max_half, int S, const float* cos_tab,
                                    const float* sin_tab, double fs,
                                    double f0_floor, double f0_ceil,
                                    float* out, cudaStream_t stream) {
  return launch_refine<float>(seg, phase, f0, C, F, W, max_half, S, cos_tab,
                              sin_tab, fs, f0_floor, f0_ceil, out, stream);
}

extern "C" int world_refine_dft_f64(const double* seg, const double* phase,
                                    const double* f0, int C, int F, int W,
                                    int max_half, int S, const double* cos_tab,
                                    const double* sin_tab, double fs,
                                    double f0_floor, double f0_ceil,
                                    double* out, cudaStream_t stream) {
  return launch_refine<double>(seg, phase, f0, C, F, W, max_half, S, cos_tab,
                               sin_tab, fs, f0_floor, f0_ceil, out, stream);
}
