// K6 and K7, D4C's coarse group-delay aperiodicity for every frame.
//
// The JAX package computes it with stock XLA ops, batched over frames
// (world_tpu/aperiodicity/common.py: _centroid_from_slab and
// static_centroid_half :137-173, smoothed_power_spectrum_half :176-185,
// static_group_delay_half :188-209, coarse_aperiodicity :212-236, called by
// coarse_ap_frames :244-254); it has no Pallas kernel.  The plain PyTorch
// twins are world_tpu_torch/ops/d4c_spectra.py::centroid_plain (K6) and
// ::band_ap_plain (K7), the stock ops the port ran before these kernels.
//
// K6, d4c_centroid: one block a frame.  For both window shifts t +- T0/4:
// the integer row shift into the frame's slab (clamped to [0, 2 margin]),
// the 2-period Blackman window with its sub-sample shift, the weighted-mean
// removal, the L2 normalisation, then S = FFT(xn) and U = FFT(xn t_true)
// as ONE complex FFT of fft_size points (xn + i xn t_true sigma, sigma the
// power of two nearest below 1 / (half + 1), so that both halves carry
// comparable magnitudes and neither drowns the other's rounding; the
// scaling is exact), unpacked into Re(conj(S) U).  The two shifts are
// summed and the low band gets its mirrored replica (dsp/dcfill.py).
//
// K7, d4c_band_ap: one block a frame.  The 2-period Hanning power spectrum
// of the inner slab (the slab read at an offset of margin, no copy), its
// replica fill, the rectangular smoothing by f0 (the running sum and its
// differences in float64, as the plain version keeps them), the floor and
// the division of K6's centroid, the smoothings by f0 / 2 and f0 and their
// difference, then for each band the Nuttall-windowed segment of the
// mirrored group delay, its FFT, power, the sum of all bins and of the
// boundary + 1 largest, and -10 log10 of the share outside them.  Each of
// K7's real FFTs of N points is one complex FFT of N / 2 (the even samples
// real, the odd imaginary) and a pass that splits it (real_power).
//
// Each frame's chain lives in shared memory: the window row, the
// fft_size-point spectrum (at most 8,192 complex values, 128 KB in
// float64), the half spectra and the float64 running sum (only the
// 2 span + nb + 1 entries the smoothing reads: a constant offset of the
// running sum cancels in its differences).  At fft_size 8,192 in float64
// (classic D4C to 96 kHz, or an explicit fft_size) K7 holds ~200 KB and K6
// ~165 KB, inside one block's 227 KB, so K7 is one kernel; a geometry that
// needs more (a window row past 8,192 samples) is refused at launch.
//
// What bounds them on the H100.  At the 60 s glide (12,001 frames, slab
// width 2,119, fft_size 2,048) K6 needs the slab samples inside its two
// windows and writes the centroid (~49 MB), and K7 needs the inner
// window's samples and the centroid bins its bands reach and writes 2
// floats a frame.  Their operations (2 complex fft_size-point FFTs a
// frame in K6, 1 + n_ap real ones in K7, 5 N log2 N flops each, and the
// windows, sums and scans) come to ~3.4 GFLOP each, ~0.05 ms at 67
// TFLOP/s, more than their bytes take (chip_smoke.d4c_bounds).  A frame's
// chain is a sequence of dependent block-wide steps (a barrier each FFT
// pass, reductions, scans, the top-k's bit passes): the barriers' latency
// and shared memory, not bytes or flops, set the time (3-7% of the bound
// at x16 and 60 s on an H100; kernel_variants.py d4c times the parts), so
// the design keeps work in registers between barriers and many blocks
// resident an SM.
//
// The FFT: an iterative radix-2 decimation in time, in place in shared
// memory on separate real and imaginary arrays (one pad word every 32,
// against bank conflicts), the input placed in bit-reversed order and the
// output in natural order; stage s (span 2^s)
// combines a[i] and a[i + 2^(s-1)] with the twiddle W^(pos N / 2^s), W =
// exp(-2 pi i / N), read from the wrapper's table (computed in float64 by
// numpy, then cast).  The stages run three a pass, each thread holding the
// eight elements a pass combines in registers (one barrier a pass, not a
// stage: the butterflies took 60% of K6's time a stage a barrier, by
// kernel_variants.py); the arithmetic is the radix-2 stages', to the bit.
// tests/test_torch_d4c_spectra.py models it op for op.
//
// The top (boundary + 1) of a band: a bitwise binary search, over the
// ordered integer keys of the power values, for the k-th largest key tau
// (one block count a bit, 32 in float32, 64 in float64); the sum is the
// values above tau plus (k - their count) times tau's value, which is the
// sum of the k largest whatever the ties.  A NaN is the largest key, as
// torch.topk orders it.
//
// Every sum is in a fixed order (a thread's elements in index order, then
// an xor-shuffle tree in each warp and the warps in order; the running sum
// a chunk a thread, then a block scan), with no atomics: a launch repeats
// its bits.  The elementwise operations are the plain version's on the
// card (-fmad=false): a tensor divided by a Python scalar is a product
// with its reciprocal there, and so it is here; cos, sqrt, hypot and
// log10 are the correctly rounded or libdevice functions PyTorch calls.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKL = 256;           // the replica fill's low band (KL), <= kThreads
constexpr int kMaxN = 8192;        // the largest fft_size
// the half-spectrum bins a thread of K7 holds in registers at fft_size n:
// K7 is compiled for n up to 4,096 and for 8,192
__host__ __device__ constexpr int bins_per_thread(int n) {
  return (n / 2 + 1 + kThreads - 1) / kThreads;
}
constexpr int kPerSmall = bins_per_thread(4096), kPerLarge = bins_per_thread(kMaxN);
constexpr int kKLPer = (kKL + kThreads - 1) / kThreads;          // fill bins a thread
// Blocks an SM each kernel is compiled for (registers at most 65,536 /
// (blocks x kThreads)): the barriers' latency is hidden by other blocks.
// Compiled with their registers unbounded, K6 ran 1.2-1.3x and K7
// 1.6-1.7x slower at x16 and on the 60 s glide (kernel_variants.py
// unbounded_registers, an H100 80GB HBM3 at 700 W).
// At fft_size 8,192 one block fills an SM's shared memory.
constexpr int kCentroidBlocks = 8, kBandBlocks = 8;

template <typename T> struct M;
template <> struct M<float> {
  static __device__ __forceinline__ float cos(float x) { return cosf(x); }
  static __device__ __forceinline__ float floor(float x) { return floorf(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float hypot(float a, float b) { return hypotf(a, b); }
  static __device__ __forceinline__ float log10(float x) { return log10f(x); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
  static __device__ __forceinline__ float eps() { return 1.1920928955078125e-07f; }
  static __device__ __forceinline__ float tiny() { return 1.17549435082228751e-38f; }
};
template <> struct M<double> {
  static __device__ __forceinline__ double cos(double x) { return ::cos(x); }
  static __device__ __forceinline__ double floor(double x) { return ::floor(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double hypot(double a, double b) { return ::hypot(a, b); }
  static __device__ __forceinline__ double log10(double x) { return ::log10(x); }
  static __device__ __forceinline__ double abs(double x) { return ::fabs(x); }
  static __device__ __forceinline__ double eps() { return 2.220446049250313e-16; }
  static __device__ __forceinline__ double tiny() { return 2.2250738585072014e-308; }
};

// the ordered integer key of a value (a NaN the largest) and back
template <typename T> struct Key;
template <> struct Key<float> {
  using U = unsigned;
  static constexpr int kBits = 32;
  static __device__ __forceinline__ U of(float v) {
    if (isnan(v)) return 0xffffffffu;
    const U b = __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  static __device__ __forceinline__ float value(U k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
  }
};
template <> struct Key<double> {
  using U = unsigned long long;
  static constexpr int kBits = 64;
  static __device__ __forceinline__ U of(double v) {
    if (isnan(v)) return ~0ull;
    const U b = (U)__double_as_longlong(v);
    return (b & (1ull << 63)) ? ~b : (b | (1ull << 63));
  }
  static __device__ __forceinline__ double value(U k) {
    return __longlong_as_double(
        (long long)((k & (1ull << 63)) ? (k & ~(1ull << 63)) : ~k));
  }
};

// The block's sum of v; every thread gets the same bits (an xor-shuffle
// tree in each warp, then the warps' sums in warp order).  red: kWarps.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) s = s + red[i];
  __syncthreads();
  return s;
}

// block_sum of two values at once (one pair of barriers).  red: 2 kWarps.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    a = a + __shfl_xor_sync(kFull, a, off);
    b = b + __shfl_xor_sync(kFull, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[kWarps];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    a = a + red[i];
    b = b + red[kWarps + i];
  }
  __syncthreads();
}

// The block's sum of the counts c.  red: 2 kWarps, the half of parity p
// (callers alternate p, so one barrier a call suffices).
__device__ __forceinline__ unsigned block_count(unsigned c, unsigned* red, int p) {
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) red[p * kWarps + (threadIdx.x >> 5)] = c;
  __syncthreads();
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[p * kWarps + i];
  return s;
}

// The sum of v over the threads before this one, in a fixed order.
// red: kWarps doubles.
__device__ __forceinline__ double block_exclusive_scan(double v, double* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  double inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc = inc + o;
  }
  double exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = 0.0;
  if (lane == 31) red[w] = inc;
  __syncthreads();
  double base = 0.0;
  for (int i = 0; i < w; ++i) base = base + red[i];
  __syncthreads();
  return base + exc;
}

// The FFT buffers' layout: one pad word after every 32, so that the
// strided accesses of the FFT's first passes and of the bit reversal fall
// in distinct banks.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded_len(int n) { return pad(n) + 1; }

__device__ __forceinline__ int bit_reverse(int j, int log_n) {
  return (int)(__brev((unsigned)j) >> (32 - log_n));
}

// Put re/im[0..N) into bit-reversed order, in place.
template <typename T>
__device__ __forceinline__ void bit_reverse_permute(T* re, T* im, int N, int log_n) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const int r = bit_reverse(j, log_n);
    if (j < r) {
      const int pj = pad(j), pr = pad(r);
      const T a = re[pj], b = im[pj];
      re[pj] = re[pr];
      im[pj] = im[pr];
      re[pr] = a;
      im[pr] = b;
    }
  }
  __syncthreads();
}

// Stages s0 + 1 .. s0 + R of the radix-2 decimation-in-time FFT, in place:
// the 2^R elements a[base + k h] (h = 2^s0) that those stages combine only
// among themselves are held in registers by one thread, and each stage's
// butterflies are the radix-2 ones (the same twiddle, products and sums,
// in the same order), so the result is the radix-2 FFT's to the bit.
template <typename T, int R>
__device__ __forceinline__ void fft_pass(T* re, T* im, int N, int s0,
                                         const T* __restrict__ tw, int step) {
  constexpr int G = 1 << R;
  const int h = 1 << s0;
  for (int gi = threadIdx.x; gi < N / G; gi += kThreads) {
    const int o = gi & (h - 1);
    const int base = (gi >> s0) * G * h + o;
    T xr[G], xi[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      xr[k] = re[pad(base + k * h)];
      xi[k] = im[pad(base + k * h)];
    }
#pragma unroll
    for (int st = 0; st < R; ++st) {
      // the twiddle W_N^(pos N / 2 half) is entry pos x stride of the table
      const int stride = (N >> (s0 + 1 + st)) * step;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (k & (1 << st)) continue;
        const int kk = k + (1 << st);
        const int pos = o + (k & ((1 << st) - 1)) * h;
        const T wr = __ldg(tw + 2 * pos * stride);
        const T wi = __ldg(tw + 2 * pos * stride + 1);
        const T tr = wr * xr[kk] - wi * xi[kk];
        const T ti = wr * xi[kk] + wi * xr[kk];
        xr[kk] = xr[k] - tr;
        xi[kk] = xi[k] - ti;
        xr[k] = xr[k] + tr;
        xi[k] = xi[k] + ti;
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      re[pad(base + k * h)] = xr[k];
      im[pad(base + k * h)] = xi[k];
    }
  }
  __syncthreads();
}

// Radix-2 decimation-in-time FFT of N points in place: input in
// bit-reversed order, output in natural order.  tw: the (cos, sin) pairs
// of -2 pi m / (N step), of which every step-th is W_N^m.  Stage s combines
// a[i] and a[i + 2^(s-1)] (i's offset pos in its block of 2^s) with the
// twiddle W_N^(pos N / 2^s); the stages run three a pass.
template <typename T>
__device__ void fft(T* re, T* im, int N, int log_n, const T* __restrict__ tw,
                    int step) {
  int s0 = 0;
  for (; s0 + 3 <= log_n; s0 += 3) fft_pass<T, 3>(re, im, N, s0, tw, step);
  if (log_n - s0 == 2) fft_pass<T, 2>(re, im, N, s0, tw, step);
  if (log_n - s0 == 1) fft_pass<T, 1>(re, im, N, s0, tw, step);
}

// |X[k]|^2 for k in [0, h] of a real sequence x of 2h points, from the
// h-point FFT Z (natural order in re/im) of z[n] = x[2n] + i x[2n + 1]:
// X[k] = E[k] + W_2h^k O[k], E[k] = (Z[k] + conj Z[h-k]) / 2 and O[k] =
// (Z[k] - conj Z[h-k]) / 2i the FFTs of the even and the odd samples; tw is
// the 2h-point table.
template <typename T>
__device__ __forceinline__ T real_power(const T* re, const T* im, int h, int k,
                                        const T* __restrict__ tw) {
  const int k0 = k == h ? 0 : k;
  const int kk = (h - k0) & (h - 1);
  const T zr = re[pad(k0)], zi = im[pad(k0)], yr = re[pad(kk)], yi = im[pad(kk)];
  const T er = (zr + yr) * T(0.5), ei = (zi - yi) * T(0.5);
  const T orr = (zi + yi) * T(0.5), oi = (yr - zr) * T(0.5);
  T xr, xi;
  if (k == h) {                       // W_2h^h = -1
    xr = er - orr;
    xi = ei - oi;
  } else {
    const T wr = __ldg(tw + 2 * k), wi = __ldg(tw + 2 * k + 1);
    xr = er + (wr * orr - wi * oi);
    xi = ei + (wr * oi + wi * orr);
  }
  const T a = M<T>::hypot(xr, xi);
  return a * a;
}

// The F0-adaptive window of frames.py::apply_adaptive_window on the row
// seg[0..w0), aligned to base index -max_half..max_half: stages
// sw = seg * mask * window in re[j] and the window in im[j], then the
// weighted-mean-removed waveform in re[j] (0 outside the mask).  Blackman
// (K6) or Hanning (K7), half_length 2, the sub-sample shift frac.  Returns
// this thread's part of the sum of the waveform's squares, in index order.
template <typename T, bool kBlackman>
__device__ T adaptive_window(const T* __restrict__ seg, int w0, int max_half,
                             T half, T f0, T fs_t, T frac, T* re, T* im,
                             T* red) {
  T s_sw = T(0), s_w = T(0);
  for (int j = threadIdx.x; j < w0; j += kThreads) {
    const T b = T(j - max_half);
    const bool in = M<T>::abs(b) <= half;
    const T x = seg[j] * (in ? T(1) : T(0));
    T wv = T(0);
    if (in) {
      const T ta = (b / fs_t) / T(2) + frac;
      const T arg = T(3.14159265358979323846) * ta * f0;
      const T c1 = M<T>::cos(arg);
      wv = kBlackman ? (T(0.08) * M<T>::cos(T(2) * arg) + T(0.5) * c1) + T(0.42)
                     : T(0.5) * c1 + T(0.5);
    }
    const T sw = x * wv;
    re[pad(j)] = sw;
    im[pad(j)] = wv;
    s_sw = s_sw + sw;
    s_w = s_w + wv;
  }
  block_sum2(s_sw, s_w, red);
  const T ratio = s_sw / s_w;
  T s2 = T(0);
  for (int j = threadIdx.x; j < w0; j += kThreads) {
    const bool in = M<T>::abs(T(j - max_half)) <= half;
    const T wf = in ? re[pad(j)] - im[pad(j)] * ratio : T(0);
    re[pad(j)] = wf;
    s2 = s2 + wf * wf;
  }
  __syncthreads();
  return s2;
}

// dsp/dcfill.py::dc_fill_add(h, f0, fs, N, boundary_factor=1.2, KL=256) in
// place on the half spectrum h[0..nb): the low band's replica read at
// f0 - f, added below f0.
template <typename T>
__device__ void dc_fill_add(T* h, int nb, T f0, T df_t) {
  const int KL = nb < kKL ? nb : kKL;
  const T bound = T(1.2) * f0;
  auto ysrc = [&](long long i) { return T(i) * df_t < bound ? h[i] : T(0); };
  int m = 0;
#pragma unroll
  for (int q = 0; q < kKLPer; ++q) {
    const int k = threadIdx.x + q * kThreads;
    m += __syncthreads_count(k < KL && T(k) * df_t < bound);
  }
  const T alpha = T(m - 1) - f0 * (T(1) / df_t);
  const long long af = (long long)M<T>::floor(alpha);
  long long sh = KL - m + af;
  sh = sh < 0 ? 0 : (sh > KL + KL / 2 ? KL + KL / 2 : sh);
  auto z = [&](long long j) {
    const long long q = sh + j;
    return q < KL ? ysrc(KL - 1 - q) : T(0);
  };
  T v[kKLPer];
#pragma unroll
  for (int q = 0; q < kKLPer; ++q) {
    const int k = threadIdx.x + q * kThreads;
    v[q] = T(0);
    if (k < KL) {
      const long long bu = k + af;
      const long long hi = m - 2;
      const bool clipped = bu > hi;
      const T y0 = clipped ? ysrc(1) : z(k);
      const T y1 = clipped ? ysrc(0) : z(k + 1);
      const T fr = (T(k) + alpha) - T(bu < hi ? bu : hi);
      const T rep = y0 + (y1 - y0) * fr;
      v[q] = h[k] + (T(k) * df_t < f0 ? rep : T(0));
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kKLPer; ++q) {
    const int k = threadIdx.x + q * kThreads;
    if (k < KL) h[k] = v[q];
  }
  __syncthreads();
}

struct Smooth {
  int N, nb, span, L;   // L = 2 span + nb + 1 running-sum entries
  double df, x0;
};

// aperiodicity/common.py::rect_smooth_half(mirror_full(h), width, fs, N):
// out[k] = (cs(k + a_hi) - cs(k + a_lo)) / width, cs the running sum of
// the doubled even spectrum times df, read by linear interpolation, in
// float64.  P holds the running sum from bin N - span on (the offset
// cs[N - span - 1] cancels in the difference).  out may alias nothing the
// call reads.
template <typename T>
__device__ void rect_smooth(const T* h, T* out, double width, const Smooth& g,
                            double* P, double* red) {
  const int per = (g.L + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < g.L ? lo + per : g.L;
  double run = 0.0;
  for (int i = lo; i < hi; ++i) {
    int q = (g.N - g.span + i) & (g.N - 1);
    if (q > g.N / 2) q = g.N - q;
    run = run + (double)h[q] * g.df;
    P[i] = run;
  }
  const double base = block_exclusive_scan(run, red);
  for (int i = lo; i < hi; ++i) P[i] = base + P[i];
  __syncthreads();
  const double a_lo = (-width * 0.5 - g.x0) / g.df;
  const double a_hi = (width * 0.5 - g.x0) / g.df;
  const double m_lo = ::floor(a_lo), m_hi = ::floor(a_hi);
  const double f_lo = a_lo - m_lo, f_hi = a_hi - m_hi;
  const long long origin = g.N - g.span;
  long long s_lo = (long long)m_lo - origin, s_hi = (long long)m_hi - origin;
  s_lo = s_lo < 0 ? 0 : (s_lo > 2 * g.span ? 2 * g.span : s_lo);
  s_hi = s_hi < 0 ? 0 : (s_hi > 2 * g.span ? 2 * g.span : s_hi);
  for (int k = threadIdx.x; k < g.nb; k += kThreads) {
    const double vh = P[s_hi + k] * (1.0 - f_hi) + P[s_hi + k + 1] * f_hi;
    const double vl = P[s_lo + k] * (1.0 - f_lo) + P[s_lo + k + 1] * f_lo;
    out[k] = (T)((vh - vl) / width);
  }
  __syncthreads();
}

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// K6's shared memory: red, re, im (Lb each, padded), the summed centroid (nb)
template <typename T>
size_t centroid_smem(int Lb, int nb) {
  return align16(2 * kWarps * sizeof(double)) + align16(2 * (size_t)Lb * sizeof(T)) +
         align16((size_t)nb * sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kCentroidBlocks)
centroid_kernel(const T* __restrict__ slab, const T* __restrict__ f0p,
                const double* __restrict__ tp, const T* __restrict__ tw, int Ws,
                int max_half, int margin, int N, int log_n, int Lb, double fs,
                T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  T* re = reinterpret_cast<T*>(smem + align16(2 * kWarps * sizeof(double)));
  T* im = re + Lb;
  T* acc = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(re) +
                                align16(2 * (size_t)Lb * sizeof(T)));
  const int r = blockIdx.x;
  const int w0 = 2 * max_half + 1;
  const int nb = N / 2 + 1;
  const T f0 = f0p[r];
  const double t = tp[r];
  const T fs_t = T(fs);
  const T quarter = (T(1) / f0) * T(0.25);
  const double c_base = ::floor(t * fs + 0.501) + 1.0;
  const T half = M<T>::floor(T(2.0 * fs) / f0 + T(0.5));
  // sigma = 2^-e <= 1 / (half + 1) < 2^(1-e): U's half of the packed FFT at
  // S's scale (exact scaling)
  int e = ilogb((double)(half + T(1)));
  e = e < 0 ? 0 : (e > 60 ? 60 : e);
  const T sigma = (T)ldexp(1.0, -e), inv_sigma = (T)ldexp(1.0, e);
  for (int side = 0; side < 2; ++side) {
    const double ts = side == 0 ? t + (double)quarter : t - (double)quarter;
    const double c_shift = ::floor(ts * fs + 0.501) + 1.0;
    long long sh = (long long)(c_shift - c_base) + margin;
    sh = sh < 0 ? 0 : (sh > 2 * margin ? 2 * margin : sh);
    const T frac = (T)((ts * fs - ::floor(ts * fs + 0.5)) / fs);
    const T s2 = adaptive_window<T, true>(slab + (size_t)r * Ws + sh, w0,
                                          max_half, half, f0, fs_t, frac, re,
                                          im, red);
    const T norm = M<T>::sqrt(block_sum(s2, red));
    // the FFT's input: the first N samples of the row (cut or zero-padded)
    for (int j = threadIdx.x; j < N; j += kThreads) {
      T xr = T(0), xi = T(0);
      if (j < w0) {
        const T b = T(j - max_half);
        const T t_true = M<T>::abs(b) <= half ? (b + half) + T(1) : T(0);
        xr = re[pad(j)] / norm;
        xi = (xr * t_true) * sigma;
      }
      re[pad(j)] = xr;
      im[pad(j)] = xi;
    }
    __syncthreads();
    bit_reverse_permute(re, im, N, log_n);
    fft(re, im, N, log_n, tw, 1);
    // Z = S + i sigma U: S[k] = (Z[k] + conj Z[N-k]) / 2,
    // sigma U[k] = (Z[k] - conj Z[N-k]) / 2i
    for (int k = threadIdx.x; k < nb; k += kThreads) {
      const int kk = (N - k) & (N - 1);
      const T zr = re[pad(k)], zi = im[pad(k)], yr = re[pad(kk)], yi = im[pad(kk)];
      const T sr = (zr + yr) * T(0.5), si = (zi - yi) * T(0.5);
      const T ur = ((zi + yi) * T(0.5)) * inv_sigma;
      const T ui = ((yr - zr) * T(0.5)) * inv_sigma;
      const T c = sr * ur + si * ui;
      acc[k] = side == 0 ? c : acc[k] + c;
    }
    __syncthreads();
  }
  dc_fill_add(acc, nb, f0, T(fs / N));
  T* o = out + (size_t)r * nb;
  for (int k = threadIdx.x; k < nb; k += kThreads) o[k] = acc[k];
}

// K7's shared memory: red (kWarps doubles), counts (2 kWarps), the running
// sum P (L doubles), re, im (Lb each, padded), the half spectrum A (nb).
// kPer: the bins a thread holds in the top-k search (bins_per_thread)
template <typename T>
size_t band_smem(int Lb, int nb, int L) {
  return align16(2 * kWarps * sizeof(double)) + align16(2 * kWarps * sizeof(unsigned)) +
         align16((size_t)L * sizeof(double)) + align16(2 * (size_t)Lb * sizeof(T)) +
         align16((size_t)nb * sizeof(T));
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads, kPer <= kPerSmall ? kBandBlocks : 1)
band_ap_kernel(const T* __restrict__ slab, const T* __restrict__ centroid,
               const T* __restrict__ f0p, const double* __restrict__ tp,
               const T* __restrict__ tw, const T* __restrict__ win,
               const int* __restrict__ band_lo, int Ws, int max_half,
               int margin, int N, int log_n, int Lb, double fs, int n_ap,
               int wl, int top_k, Smooth g, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  double* red = reinterpret_cast<double*>(p);
  p += align16(2 * kWarps * sizeof(double));
  unsigned* cnt = reinterpret_cast<unsigned*>(p);
  p += align16(2 * kWarps * sizeof(unsigned));
  double* P = reinterpret_cast<double*>(p);
  p += align16((size_t)g.L * sizeof(double));
  T* re = reinterpret_cast<T*>(p);
  T* im = re + Lb;
  p += align16(2 * (size_t)Lb * sizeof(T));
  T* A = reinterpret_cast<T*>(p);
  T* redT = reinterpret_cast<T*>(red);
  const int r = blockIdx.x;
  const int w0 = 2 * max_half + 1;
  const int nb = g.nb;
  const T f0 = f0p[r];
  const double t = tp[r];
  const T half = M<T>::floor(T(2.0 * fs) / f0 + T(0.5));
  const T frac = (T)((t * fs - ::floor(t * fs + 0.5)) / fs);

  // the smoothed power spectrum; each real FFT of N points is one complex
  // FFT of h = N / 2 (the even samples real, the odd imaginary)
  const int h = N / 2;
  adaptive_window<T, false>(slab + (size_t)r * Ws + margin, w0, max_half, half,
                            f0, T(fs), frac, re, im, redT);
  // the even samples to A (free until it takes the power), the odd to im,
  // the even back to re, then into bit-reversed order
  for (int n = threadIdx.x; n < h; n += kThreads) {
    A[n] = 2 * n < w0 ? re[pad(2 * n)] : T(0);
    im[pad(n)] = 2 * n + 1 < w0 ? re[pad(2 * n + 1)] : T(0);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < h; n += kThreads) re[pad(n)] = A[n];
  __syncthreads();
  bit_reverse_permute(re, im, h, log_n - 1);
  fft(re, im, h, log_n - 1, tw, 2);
  for (int k = threadIdx.x; k < nb; k += kThreads) A[k] = real_power(re, im, h, k, tw);
  __syncthreads();
  dc_fill_add(A, nb, f0, T(g.df));
  T* B = re;   // the smoothed power, then the group delay
  T* C = im;   // the group delay smoothed by f0 / 2
  rect_smooth(A, B, (double)f0, g, P, red);

  // the group delay: the centroid over the floored smoothed power
  T s_abs = T(0);
  for (int k = threadIdx.x; k < nb; k += kThreads) s_abs = s_abs + M<T>::abs(B[k]);
  const T floor_v = (block_sum(s_abs, redT) / T(nb)) * M<T>::eps() * M<T>::eps();
  const T* cen = centroid + (size_t)r * nb;
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    const T sp = B[k];
    B[k] = cen[k] / (M<T>::abs(sp) < floor_v ? floor_v : sp);
  }
  __syncthreads();
  rect_smooth(B, C, (double)(f0 * T(0.5)), g, P, red);
  rect_smooth(C, A, (double)f0, g, P, red);
  for (int k = threadIdx.x; k < nb; k += kThreads) A[k] = C[k] - A[k];
  __syncthreads();

  // the bands, each from its first bin of the mirrored group delay
  using K = Key<T>;
  using U = typename K::U;
  int parity = 0;
  for (int band = 0; band < n_ap; ++band) {
    const int lo = __ldg(band_lo + band);
    auto seg = [&](int j) {             // the windowed segment, 0 past wl
      if (j >= wl) return T(0);
      int q = lo + j;
      if (q > h) q = N - q;
      return A[q] * __ldg(win + j);
    };
    for (int n = threadIdx.x; n < h; n += kThreads) {
      const int rn = pad(bit_reverse(n, log_n - 1));
      re[rn] = seg(2 * n);
      im[rn] = seg(2 * n + 1);
    }
    __syncthreads();
    fft(re, im, h, log_n - 1, tw, 2);
    U key[kPer];                        // a bin's power is K::value(its key)
    T s_all = T(0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int k = threadIdx.x + q * kThreads;
      key[q] = 0;
      if (k < nb) {
        const T pw = real_power(re, im, h, k, tw);
        key[q] = K::of(pw);
        s_all = s_all + pw;
      }
    }
    const T den = block_sum(s_all, redT);
    // the top_k-th largest key, bit by bit from the top
    U tau = 0;
    for (int bit = K::kBits - 1; bit >= 0; --bit) {
      const U cand = tau | ((U)1 << bit);
      unsigned c = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        c += (threadIdx.x + q * kThreads < nb && key[q] >= cand) ? 1u : 0u;
      if (block_count(c, cnt, parity) >= (unsigned)top_k) tau = cand;
      parity ^= 1;
    }
    unsigned c_gt = 0;
    T s_gt = T(0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (threadIdx.x + q * kThreads < nb && key[q] > tau) {
        c_gt += 1u;
        s_gt = s_gt + K::value(key[q]);
      }
    }
    const unsigned n_gt = block_count(c_gt, cnt, parity);
    parity ^= 1;
    const T top = block_sum(s_gt, redT) + T((int)(top_k - n_gt)) * K::value(tau);
    if (threadIdx.x == 0) {
      const T num = den - top;
      out[(size_t)r * n_ap + band] =
          T(-10) * M<T>::log10((num + M<T>::tiny()) / (den + M<T>::tiny()));
    }
    __syncthreads();   // re/im are rewritten by the next band
  }
}

int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem, long long R) {
  if (R < 1 || R > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next call to read
    return (int)err;
  }
  return 0;
}

template <typename T>
int launch_centroid(const T* slab, const T* f0, const double* t, const T* tw,
                    int R, int Ws, int max_half, int margin, int N, double fs,
                    T* out, cudaStream_t stream) {
  const int log_n = log2_exact(N);
  const int w0 = 2 * max_half + 1;
  if (log_n < 4 || N > kMaxN || max_half < 0 || margin < 0 ||
      Ws != w0 + 2 * margin)
    return (int)cudaErrorInvalidValue;
  const int Lb = padded_len(N > w0 ? N : w0);
  const size_t smem = centroid_smem<T>(Lb, N / 2 + 1);
  if (int err = prepare(centroid_kernel<T>, smem, R)) return err;
  centroid_kernel<T><<<R, kThreads, smem, stream>>>(
      slab, f0, t, tw, Ws, max_half, margin, N, log_n, Lb, fs, out);
  return (int)cudaGetLastError();
}

template <typename T, int kPer>
int launch_band_ap_for(const T* slab, const T* centroid, const T* f0,
                       const double* t, const T* tw, const T* win,
                       const int* band_lo, int R, int Ws, int max_half,
                       int margin, int N, int log_n, int Lb, double fs,
                       int n_ap, int wl, int top_k, const Smooth& g, T* out,
                       cudaStream_t stream) {
  const size_t smem = band_smem<T>(Lb, g.nb, g.L);
  if (int err = prepare(band_ap_kernel<T, kPer>, smem, R)) return err;
  band_ap_kernel<T, kPer><<<R, kThreads, smem, stream>>>(
      slab, centroid, f0, t, tw, win, band_lo, Ws, max_half, margin, N, log_n,
      Lb, fs, n_ap, wl, top_k, g, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_band_ap(const T* slab, const T* centroid, const T* f0,
                   const double* t, const T* tw, const T* win,
                   const int* band_lo, int R, int Ws, int max_half, int margin,
                   int N, double fs, int n_ap, int wl, int top_k, int span,
                   T* out, cudaStream_t stream) {
  const int log_n = log2_exact(N);
  const int w0 = 2 * max_half + 1;
  const int nb = N / 2 + 1;
  if (log_n < 4 || N > kMaxN || max_half < 0 || margin < 0 ||
      Ws != w0 + 2 * margin || n_ap < 1 || wl < 1 || wl > N || top_k < 1 ||
      top_k > nb || span < 0 || 2 * span + 2 >= N)
    return (int)cudaErrorInvalidValue;
  Smooth g;
  g.N = N;
  g.nb = nb;
  g.span = span;
  g.L = 2 * span + nb + 1;
  g.df = fs / N;
  g.x0 = -fs + g.df / 2;
  const int Lb = padded_len(N > w0 ? N : w0);
  if (bins_per_thread(N) <= kPerSmall)
    return launch_band_ap_for<T, kPerSmall>(slab, centroid, f0, t, tw, win,
                                            band_lo, R, Ws, max_half, margin, N,
                                            log_n, Lb, fs, n_ap, wl, top_k, g,
                                            out, stream);
  return launch_band_ap_for<T, kPerLarge>(slab, centroid, f0, t, tw, win,
                                          band_lo, R, Ws, max_half, margin, N,
                                          log_n, Lb, fs, n_ap, wl, top_k, g,
                                          out, stream);
}

}  // namespace

extern "C" int world_d4c_centroid_f32(const float* slab, const float* f0,
                                      const double* t, const float* tw, int R,
                                      int Ws, int max_half, int margin, int N,
                                      double fs, float* out, cudaStream_t stream) {
  return launch_centroid<float>(slab, f0, t, tw, R, Ws, max_half, margin, N, fs,
                                out, stream);
}

extern "C" int world_d4c_centroid_f64(const double* slab, const double* f0,
                                      const double* t, const double* tw, int R,
                                      int Ws, int max_half, int margin, int N,
                                      double fs, double* out, cudaStream_t stream) {
  return launch_centroid<double>(slab, f0, t, tw, R, Ws, max_half, margin, N,
                                 fs, out, stream);
}

extern "C" int world_d4c_band_ap_f32(const float* slab, const float* centroid,
                                     const float* f0, const double* t,
                                     const float* tw, const float* win,
                                     const int* band_lo, int R, int Ws,
                                     int max_half, int margin, int N,
                                     double fs, int n_ap, int wl, int top_k,
                                     int span, float* out, cudaStream_t stream) {
  return launch_band_ap<float>(slab, centroid, f0, t, tw, win, band_lo, R, Ws,
                               max_half, margin, N, fs, n_ap, wl, top_k, span,
                               out, stream);
}

extern "C" int world_d4c_band_ap_f64(const double* slab, const double* centroid,
                                     const double* f0, const double* t,
                                     const double* tw, const double* win,
                                     const int* band_lo, int R, int Ws,
                                     int max_half, int margin, int N,
                                     double fs, int n_ap, int wl, int top_k,
                                     int span, double* out, cudaStream_t stream) {
  return launch_band_ap<double>(slab, centroid, f0, t, tw, win, band_lo, R, Ws,
                                max_half, margin, N, fs, n_ap, wl, top_k, span,
                                out, stream);
}
