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
// K6, d4c_centroid.  For both window shifts t +- T0/4: the integer row
// shift into the frame's slab (clamped to [0, 2 margin]), the 2-period
// Blackman window with its sub-sample shift, the weighted-mean removal, the
// L2 normalisation, then S = FFT(xn) and U = FFT(xn t_true) as ONE complex
// FFT of fft_size points (xn + i xn t_true sigma, sigma the power of two
// nearest below 1 / (half + 1), so that both halves carry comparable
// magnitudes and neither drowns the other's rounding; the scaling is
// exact), unpacked into Re(conj(S) U).  The two shifts are summed (side 0
// first, as the plain version's c1 + c2) and the low band gets its mirrored
// replica (dsp/dcfill.py).
//
// K7, d4c_band_ap.  The 2-period Hanning power spectrum of the inner slab
// (the slab read at an offset of margin, no copy), its replica fill, the
// rectangular smoothing by f0 (the running sum and its differences in
// float64, as the plain version keeps them), the floor and the division of
// K6's centroid, the smoothings by f0 / 2 and f0 and their difference, then
// for each band the Nuttall-windowed segment of the mirrored group delay,
// its FFT, power, the sum of all bins and of the boundary + 1 largest, and
// -10 log10 of the share outside them.  Each of K7's real FFTs of N points
// is one complex FFT of N / 2 (the even samples real, the odd imaginary)
// and a pass that splits it (real_power).
//
// A frame is a cluster of blocks of 128 threads (one launch of
// cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension; a frame that
// needs one block is a plain launch).  The launchers pick the cluster from
// the geometry, the type and the number of frames (choose_ranks,
// centroid_geometry), and each choice computes the same bits as the others
// wherever they share a geometry, but for the split frames' sums:
//
//  * "one": one block holds a frame's whole chain (every main-path
//    geometry; K7 wherever one block's shared memory holds it, to fft_size
//    8,192 in both types).
//  * "pair" (K6, fft_size >= 1,024, where the frames' pairs of blocks are
//    all resident at once, i.e. the launch is latency-bound: 48 kHz, path
//    C's buckets): a cluster of 2 blocks, one a window shift, that run
//    their two FFTs at once; rank 0 then sums the low half of the bins and
//    rank 1 the high half, each reading the other's terms through
//    distributed shared memory, side 0's term first.
//  * "split" (fft_size 8,192 and up for K6, 4,096 in float64, 16,384 and
//    up for K7, to 32,768: classic D4C at 384 kHz, ~660 KB of K6's
//    buffers in float64): C = 2, 4 or 8 ranks share a frame, the fewest
//    whose share leaves kMinBlocks blocks an SM (else the fewest that fit).  Each rank holds 1/C of the FFT buffers, the
//    half spectra and the float64 running sum.  The window goes straight
//    into bit-reversed order, so that rank c holds one contiguous block of
//    N / C positions: the first log2(N / C) stages are local to a rank, and
//    the last log2(C) are one radix-C pass that reads and writes the
//    partners' blocks through distributed shared memory
//    (cooperative_groups::this_cluster().map_shared_rank) between
//    cluster.sync()s.  Sums (the window's, the running sums' rank totals,
//    the top-k's counts and the band sums) are each rank's block sum, then
//    the ranks' in rank order; nothing uses atomics, so a launch repeats
//    its bits.
//
// Each frame's chain lives in shared memory: K6's fft_size-point spectrum
// (a whole frame's: its window row, when longer) and its half-spectrum sum,
// K7's fft_size / 2-point spectrum, its half spectra and the float64
// running sum (only the 2 span + nb + 1 entries the smoothing reads: a
// constant offset of the running sum cancels in its differences).
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
// pass, reductions, scans, the top-k's rounds): the barriers' latency and
// shared memory, not bytes or flops, set the time (kernel_variants.py d4c
// times the parts), so the design keeps work in registers between
// barriers and many blocks resident an SM: 64 registers a thread (K7's
// main path holds 9 keys a thread, not 17), one barrier a reduction (its
// slots alternate), K7's window straight into its FFT's order, K6's two
// shifts in parallel where the launch is latency-bound.  Tensor cores do
// not serve: the FFTs stay in FP32/FP64 (TF32 would break ROADMAP's
// precision rule).
//
// The FFT: an iterative radix-2 decimation in time on separate real and
// imaginary arrays (one pad word every 32, against bank conflicts), the
// input in bit-reversed order and the output in natural order; stage s
// (span 2^s) combines a[i] and a[i + 2^(s-1)] with the twiddle W^(pos N /
// 2^s), W = exp(-2 pi i / N), read from the wrapper's table (computed in
// float64 by numpy, then cast).  The stages run several a pass (three, or
// four in float32 where that measured faster), each thread holding the
// elements a pass combines in registers; the arithmetic is the radix-2
// stages', to the bit, however the stages are grouped and whichever rank
// holds the elements.  tests/test_torch_d4c_spectra.py models it op for
// op, split over ranks.
//
// The top (boundary + 1) of a band: the k-th largest of the ordered
// integer keys of the power values, tau; the sum is the values above tau
// plus (k - their count) times tau's value, which is the sum of the k
// largest whatever the ties.  A NaN is the largest key, as torch.topk
// orders it.  A whole frame finds tau bit by bit from the top (one block
// count a bit); a split frame by 8-bit digits (a 256-bin histogram a round
// of the keys that match the digits found so far, each warp's built with
// __match_any_sync, then the warps' and the ranks' in order: 4 cluster
// barriers in float32 instead of 32).
//
// The elementwise operations are the plain version's on the card
// (-fmad=false): a tensor divided by a Python scalar is a product with its
// reciprocal there, and so it is here; cos, sqrt, hypot and log10 are the
// correctly rounded or libdevice functions PyTorch calls.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKL = 256;           // the replica fill's low band (KL), <= kThreads
constexpr int kMaxN = 32768;       // the largest fft_size
constexpr int kMaxRanks = 8;       // the portable cluster size on Hopper
// the half-spectrum bins a rank of K7 holds in registers: K7 is compiled
// for up to 1,025 bins a rank (9 a thread: fft_size 2,048 and below, the
// main path), 2,049 (17) and 4,225 (33)
__host__ __device__ constexpr int bins_per_thread(int bins) {
  return (bins + kThreads - 1) / kThreads;
}
constexpr int kPerTiny = bins_per_thread(1025), kPerSmall = bins_per_thread(2049),
              kPerLarge = bins_per_thread(4225);
constexpr int kKLPer = (kKL + kThreads - 1) / kThreads;          // fill bins a thread
// Blocks an SM each kernel is compiled for (registers at most 65,536 /
// (blocks x kThreads)): the barriers' latency is hidden by other blocks.
// Compiled with their registers unbounded, the one-block K6 ran 1.2-1.3x and K7
// 1.6-1.7x slower at x16 and on the 60 s glide (kernel_variants.py
// unbounded_registers, an H100 80GB HBM3 at 700 W).
constexpr int kCentroidBlocks = 8, kBandBlocks = 8;
// A frame is split over a cluster where one block's shared memory would
// leave fewer than kMinBlocks blocks an SM.
constexpr int kMinBlocks = 4;
// K7 keeps a frame in one block wherever one block's shared memory holds it
constexpr bool kBandWholeFirst = true;
// kernel_variants.py: a cluster size forced for every geometry (0: chosen
// by choose_ranks), and K6's pair of shift blocks forced off (0) or on (1)
constexpr int kForceRanks = 0;
constexpr int kForcePair = -1;
// K7's top-k: by 8-bit digits in split frames (4 cluster-wide rounds in
// float32 instead of 32; 0.95-0.99x of the bits' time at 192 and 384 kHz)
// and one bit a round in whole frames (there, with 9 keys a thread, the
// bits took 0.71-0.94x of the digits' time: kernel_variants.py bit_topk,
// digit_topk)
constexpr bool kDigitSplit = true, kDigitWhole = false;
// Radix-2 stages a register pass: four in float32 for K6's split frames
// (passes as even as they come; 0.91-0.92x of three's time at fft_size
// 8,192 to 32,768: k6_split_radix8) and for its whole frames from fft_size
// 2^kWholeRadix16Log on (0.91-0.98x at 2,048 and 4,096, 1.01-1.11x at
// 1,024: k6_whole_radix16, k6_whole_radix8); three elsewhere (K7 with four:
// 1.05-1.16x on the main path, k7_radix16); whole frames and K7 R a pass
// and the rest last.
template <typename T> struct PassStages { static constexpr int value = 4; };
template <> struct PassStages<double> { static constexpr int value = 3; };
constexpr int kBandPassStages = 3;
constexpr int kWholeRadix16Log = 11;

// how a frame's blocks share its chain
enum Mode { kOne = 0, kPair = 1, kSplit = 2 };

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

// ---------------------------------------------------------------------------
// the cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// p, a pointer into this block's shared memory, in rank's
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)rank);
}
__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}

// A barrier over the frame's chain: the cluster's where a frame is split
template <int kMode>
__device__ __forceinline__ void frame_sync() {
  if constexpr (kMode == kSplit) cluster_sync(); else __syncthreads();
}

// The reductions' slots: red (2 parities x 2 kWarps doubles) for the warps'
// partial sums, pub (2 parities x 2 doubles) for the rank's (read by the
// cluster), then K7's top-k choice (2 parities x 2 counts).  Each reduction writes the slots of parity p, passes one
// barrier, reads them and flips p: a slot is written again two reductions
// later, after a barrier that every reader has passed.
struct Red {
  double* red;
  double* pub;
  int p;
};

// The frame's sums of a[0..kV) (the block's: an xor-shuffle tree in each
// warp, then the warps' sums in warp order; split: then the ranks' sums in
// rank order); every thread gets the same bits.  The slots hold T.
template <typename T, int kMode, int kV>
__device__ __forceinline__ void frame_sum(T (&a)[kV], Red& r, int C) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
#pragma unroll
    for (int v = 0; v < kV; ++v) a[v] = a[v] + __shfl_xor_sync(kFull, a[v], off);
  }
  T* slot = reinterpret_cast<T*>(r.red + r.p * 2 * kWarps);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int v = 0; v < kV; ++v) slot[v * kWarps + (threadIdx.x >> 5)] = a[v];
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    a[v] = slot[v * kWarps];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) a[v] = a[v] + slot[v * kWarps + i];
  }
  if constexpr (kMode == kSplit) {
    T* pub = reinterpret_cast<T*>(r.pub + r.p * 2);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int v = 0; v < kV; ++v) pub[v] = a[v];
    }
    cluster_sync();
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      a[v] = at_rank(pub, 0)[v];
      for (int q = 1; q < C; ++q) a[v] = a[v] + at_rank(pub, q)[v];
    }
  }
  r.p ^= 1;
}

template <typename T, int kMode>
__device__ __forceinline__ T frame_sum1(T v, Red& r, int C) {
  T a[1] = {v};
  frame_sum<T, kMode, 1>(a, r, C);
  return a[0];
}

// The frame's sum of the counts c (one barrier; split: then the ranks' in
// rank order).
template <int kMode>
__device__ __forceinline__ unsigned frame_count(unsigned c, Red& r, int C) {
  c = __reduce_add_sync(kFull, c);
  unsigned* slot = reinterpret_cast<unsigned*>(r.red + r.p * 2 * kWarps);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = c;
  __syncthreads();
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += slot[i];
  if constexpr (kMode == kSplit) {
    unsigned* pub = reinterpret_cast<unsigned*>(r.pub + r.p * 2);
    if (threadIdx.x == 0) pub[0] = s;
    cluster_sync();
    s = 0;
    for (int q = 0; q < C; ++q) s += at_rank(pub, q)[0];
  }
  r.p ^= 1;
  return s;
}

// The sum of v over the threads before this one (split: and over the lower
// ranks, their totals added in rank order first), in a fixed order.
template <int kMode>
__device__ __forceinline__ double frame_exclusive_scan(double v, Red& r, int rank) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  double inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc = inc + o;
  }
  double exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = 0.0;
  double* slot = r.red + r.p * 2 * kWarps;
  if (lane == 31) slot[w] = inc;
  __syncthreads();
  double base = 0.0;
  for (int i = 0; i < w; ++i) base = base + slot[i];
  base = base + exc;
  if constexpr (kMode == kSplit) {
    double* pub = r.pub + r.p * 2;
    if (threadIdx.x == kThreads - 1) pub[0] = base + v;   // the rank's total
    cluster_sync();
    double below = 0.0;
    for (int q = 0; q < rank; ++q) below = below + at_rank(pub, q)[0];
    base = below + base;
  }
  r.p ^= 1;
  return base;
}

// ---------------------------------------------------------------------------
// the FFT
// ---------------------------------------------------------------------------

// The FFT buffers' layout: one pad word after every 32, so that the
// strided accesses of the FFT's passes fall in distinct banks.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded_len(int n) { return pad(n) + 1; }

__device__ __forceinline__ int bit_reverse(int j, int log_n) {
  return log_n ? (int)(__brev((unsigned)j) >> (32 - log_n)) : 0;
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

// Stages s0 + 1 .. s0 + R of the radix-2 decimation-in-time FFT for the
// groups [g0, g1): group gi's 2^R elements a[base + k h] (h = 2^s0, base =
// (gi >> s0) 2^R h + (gi & (h - 1))), which those stages combine only among
// themselves, are read by ld(position, re, im) into one thread's registers
// and written back by st.  Each stage's butterflies are the radix-2 ones
// (the twiddle W_N^(pos N / 2^s), entry pos (N >> s) step of the table; the
// same products and sums in the same order), so the result is the radix-2
// FFT's to the bit however the stages are grouped.
template <typename T, int R, typename Ld, typename St>
__device__ __forceinline__ void butterflies(int g0, int g1, int N, int s0,
                                            const T* __restrict__ tw, int step,
                                            Ld ld, St st) {
  constexpr int G = 1 << R;
  const int h = 1 << s0;
  for (int gi = g0 + (int)threadIdx.x; gi < g1; gi += kThreads) {
    const int o = gi & (h - 1);
    const int base = (gi >> s0) * G * h + o;
    T xr[G], xi[G];
#pragma unroll
    for (int k = 0; k < G; ++k) ld(base + k * h, xr[k], xi[k]);
#pragma unroll
    for (int st_ = 0; st_ < R; ++st_) {
      const int stride = (N >> (s0 + 1 + st_)) * step;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (k & (1 << st_)) continue;
        const int kk = k + (1 << st_);
        const int pos = o + (k & ((1 << st_) - 1)) * h;
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
    for (int k = 0; k < G; ++k) st(base + k * h, xr[k], xi[k]);
  }
}

template <typename T, int R, typename Ld, typename St>
__device__ __forceinline__ void butterflies_r(int r, int g1, int N, int s0,
                                              const T* __restrict__ tw, int step,
                                              Ld ld, St st) {
  if (r == 1) butterflies<T, 1>(0, g1 >> 1, N, s0, tw, step, ld, st);
  if (r == 2) butterflies<T, 2>(0, g1 >> 2, N, s0, tw, step, ld, st);
  if (r == 3) butterflies<T, 3>(0, g1 >> 3, N, s0, tw, step, ld, st);
  if constexpr (R >= 4) {
    if (r == 4) butterflies<T, 4>(0, g1 >> 4, N, s0, tw, step, ld, st);
  }
}

// The whole FFT of a frame, its input in bit-reversed order, its output in
// natural order (rank c holding positions [c 2^lc, (c + 1) 2^lc)): stages
// 1 .. lc on this rank's chunk in ceil(lc / R) passes (of stages as even as
// they come, or R each and the rest last), a block barrier after each, the
// first pass reading its input by load(local position, re, im); then, for
// a split frame, the last log2(C) stages as one radix-C pass, group o of
// this rank's share combining position o of every rank's chunk, read and
// written in the partners' shared memory between cluster barriers.
template <typename T, int kMode, int R, bool kEven, typename Load>
__device__ void fft(T* re, T* im, int lc, int N, int C, int rank,
                    const T* __restrict__ tw, int step, Load load) {
  const int passes = (lc + R - 1) / R;
  auto stages = [&](int i) {
    if constexpr (kEven) return lc / passes + (i < lc % passes ? 1 : 0);
    return i < passes - 1 ? R : lc - R * (passes - 1);
  };
  auto st = [&](int p, T xr, T xi) {
    re[pad(p)] = xr;
    im[pad(p)] = xi;
  };
  butterflies_r<T, R>(stages(0), 1 << lc, N, 0, tw, step, load, st);
  __syncthreads();
  int s0 = stages(0);
  for (int i = 1; i < passes; ++i) {
    const int r = stages(i);
    butterflies_r<T, R>(r, 1 << lc, N, s0, tw, step,
                        [&](int p, T& xr, T& xi) {
                          xr = re[pad(p)];
                          xi = im[pad(p)];
                        },
                        st);
    __syncthreads();
    s0 += r;
  }
  if constexpr (kMode == kSplit) {
    const int share = (1 << lc) / C;
    auto ld_all = [&](int p, T& xr, T& xi) {
      const int q = pad(p & ((1 << lc) - 1));
      xr = at_rank(re, p >> lc)[q];
      xi = at_rank(im, p >> lc)[q];
    };
    auto st_all = [&](int p, T xr, T xi) {
      const int q = pad(p & ((1 << lc) - 1));
      at_rank(re, p >> lc)[q] = xr;
      at_rank(im, p >> lc)[q] = xi;
    };
    cluster_sync();
    if (C == 2)
      butterflies<T, 1>(rank * share, (rank + 1) * share, N, lc, tw, step, ld_all, st_all);
    if (C == 4)
      butterflies<T, 2>(rank * share, (rank + 1) * share, N, lc, tw, step, ld_all, st_all);
    if (C == 8)
      butterflies<T, 3>(rank * share, (rank + 1) * share, N, lc, tw, step, ld_all, st_all);
    cluster_sync();
  }
}

// Element i of a padded buffer spread over the ranks in chunks of 2^lc
// (this rank's buffer when the frame is not split)
template <int kMode, typename T>
__device__ __forceinline__ T spread(const T* p, int i, int lc) {
  if constexpr (kMode == kSplit)
    return at_rank(const_cast<T*>(p), i >> lc)[pad(i & ((1 << lc) - 1))];
  else
    return p[pad(i)];
}

// |X[k]|^2 for k in [0, h] of a real sequence x of 2h points, from the
// h-point FFT Z (natural order in re/im) of z[n] = x[2n] + i x[2n + 1]:
// X[k] = E[k] + W_2h^k O[k], E[k] = (Z[k] + conj Z[h-k]) / 2 and O[k] =
// (Z[k] - conj Z[h-k]) / 2i the FFTs of the even and the odd samples; tw is
// the 2h-point table.
template <typename T, int kMode>
__device__ __forceinline__ T real_power(const T* re, const T* im, int lc, int h,
                                        int k, const T* __restrict__ tw) {
  const int k0 = k == h ? 0 : k;
  const int kk = (h - k0) & (h - 1);
  const T zr = spread<kMode>(re, k0, lc), zi = spread<kMode>(im, k0, lc);
  const T yr = spread<kMode>(re, kk, lc), yi = spread<kMode>(im, kk, lc);
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

// ---------------------------------------------------------------------------
// the window, the replica fill and the smoothing
// ---------------------------------------------------------------------------

// frames.py::apply_adaptive_window's weights and weighted samples at sample
// j of the row seg (aligned to base index -max_half..max_half): Blackman
// (K6) or Hanning (K7), half_length 2, the sub-sample shift frac; 0 outside
// the mask and past the row's w0 samples.
template <typename T, bool kBlackman, bool kInRow = false>
__device__ __forceinline__ void window_at(const T* __restrict__ seg, int j, int w0,
                                          int max_half, T half, T f0, T fs_t,
                                          T frac, bool& in, T& sw, T& wv) {
  const T b = T(j - max_half);
  const bool row = kInRow || j < w0;              // kInRow: the caller's j < w0
  in = row && M<T>::abs(b) <= half;
  const T x = row ? seg[j] * (in ? T(1) : T(0)) : T(0);
  wv = T(0);
  if (in) {
    const T ta = (b / fs_t) / T(2) + frac;
    const T arg = T(3.14159265358979323846) * ta * f0;
    const T c1 = M<T>::cos(arg);
    wv = kBlackman ? (T(0.08) * M<T>::cos(T(2) * arg) + T(0.5) * c1) + T(0.42)
                   : T(0.5) * c1 + T(0.5);
  }
  sw = x * wv;
}

// dsp/dcfill.py::dc_fill_add(h, f0, fs, N, boundary_factor=1.2, KL=256) in
// place on the half spectrum h[0..nb) (its first KL bins, in this block):
// the low band's replica read at f0 - f, added below f0.
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
  int Lc;               // the entries a rank holds (L when one block a frame)
  double df, x0;
};

// K7's half spectra: nb bins, rank c holding [c 2^lc, (c + 1) 2^lc) (the
// last rank also bin h = N / 2), unpadded
template <int kMode, typename T>
__device__ __forceinline__ T half_bin(const T* p, int k, int lc, int C) {
  if constexpr (kMode == kSplit) {
    int q = k >> lc;
    q = q < C ? q : C - 1;
    return at_rank(const_cast<T*>(p), q)[k - (q << lc)];
  } else {
    return p[k];
  }
}

// aperiodicity/common.py::rect_smooth_half(mirror_full(h), width, fs, N):
// out[k] = (cs(k + a_hi) - cs(k + a_lo)) / width, cs the running sum of
// the doubled even spectrum times df, read by linear interpolation, in
// float64.  P holds the running sum from bin N - span on (the offset
// cs[N - span - 1] cancels in the difference), rank c its entries [c Lc,
// (c + 1) Lc).  h and out are this rank's half spectra (bins [k0, k0 +
// nk)); out may alias nothing the call reads.  The frame's h must be
// complete on entry; out is complete and P free on return.
template <typename T, int kMode>
__device__ void rect_smooth(const T* h, T* out, double width, const Smooth& g,
                            double* P, Red& r, int C, int rank, int lc, int k0,
                            int nk) {
  const int i0 = rank * g.Lc;
  const int n_own = (g.L - i0 < g.Lc ? g.L - i0 : g.Lc);
  const int per = (n_own + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < n_own ? lo + per : n_own;
  double run = 0.0;
  for (int i = lo; i < hi; ++i) {
    int q = (g.N - g.span + i0 + i) & (g.N - 1);
    if (q > g.N / 2) q = g.N - q;
    run = run + (double)half_bin<kMode>(h, q, lc, C) * g.df;
    P[i] = run;
  }
  const double base = frame_exclusive_scan<kMode>(run, r, rank);
  for (int i = lo; i < hi; ++i) P[i] = base + P[i];
  frame_sync<kMode>();
  auto cs = [&](long long i) {
    if constexpr (kMode == kSplit) {
      const int q = (int)(i / g.Lc);
      return at_rank(P, q)[i - (long long)q * g.Lc];
    } else {
      return P[i];
    }
  };
  const double a_lo = (-width * 0.5 - g.x0) / g.df;
  const double a_hi = (width * 0.5 - g.x0) / g.df;
  const double m_lo = ::floor(a_lo), m_hi = ::floor(a_hi);
  const double f_lo = a_lo - m_lo, f_hi = a_hi - m_hi;
  const long long origin = g.N - g.span;
  long long s_lo = (long long)m_lo - origin, s_hi = (long long)m_hi - origin;
  s_lo = s_lo < 0 ? 0 : (s_lo > 2 * g.span ? 2 * g.span : s_lo);
  s_hi = s_hi < 0 ? 0 : (s_hi > 2 * g.span ? 2 * g.span : s_hi);
  for (int j = threadIdx.x; j < nk; j += kThreads) {
    const int k = k0 + j;
    const double vh = cs(s_hi + k) * (1.0 - f_hi) + cs(s_hi + k + 1) * f_hi;
    const double vl = cs(s_lo + k) * (1.0 - f_lo) + cs(s_lo + k + 1) * f_lo;
    out[j] = (T)((vh - vl) / width);
  }
  frame_sync<kMode>();
}

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// the reductions' slots (Red) and the top-k's choice: 4 kWarps + 6 doubles
constexpr size_t kRedBytes = align16((4 * kWarps + 6) * sizeof(double));

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// K6's shared memory: the reductions' slots, re, im (buf positions each,
// padded), the half-spectrum sum (acc bins), the weights of the window's
// samples past N (ovf, split frames)
template <typename T>
size_t centroid_smem(int buf, int acc, int ovf) {
  return kRedBytes + align16(2 * (size_t)padded_len(buf) * sizeof(T)) +
         align16((size_t)acc * sizeof(T)) + align16((size_t)ovf * sizeof(T));
}

// K6's FFT buffers: a whole frame's window row (max(N, w0) samples), or a
// split frame's N / C positions
__host__ __device__ constexpr int centroid_buf(bool split, int chunk, int w0) {
  return split || chunk >= w0 ? chunk : w0;
}

template <typename T, int kMode, int kWholeR>
__global__ void __launch_bounds__(kThreads, kCentroidBlocks)
centroid_kernel(const T* __restrict__ slab, const T* __restrict__ f0p,
                const double* __restrict__ tp, const T* __restrict__ tw, int Ws,
                int max_half, int margin, int N, int log_n, int C, int lc,
                double fs, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Red red{reinterpret_cast<double*>(smem),
          reinterpret_cast<double*>(smem) + 4 * kWarps, 0};
  const int w0 = 2 * max_half + 1;
  const int Lb = padded_len(centroid_buf(kMode == kSplit, 1 << lc, w0));
  T* re = reinterpret_cast<T*>(smem + kRedBytes);
  T* im = re + Lb;
  T* acc = reinterpret_cast<T*>(smem + kRedBytes + align16(2 * (size_t)Lb * sizeof(T)));
  const int blocks = kMode == kOne ? 1 : (kMode == kPair ? 2 : C);
  int rank = 0;
  if constexpr (kMode != kOne) rank = cluster_rank();
  const int r = blockIdx.x / blocks;
  const int c = kMode == kSplit ? rank : 0;       // the FFT rank
  const int Cs = kMode == kSplit ? C : 1;
  const int log_c = __ffs(Cs) - 1;
  const int jr = bit_reverse(c, log_c);           // rank c's samples: j = jr mod Cs
  const int nb = N / 2 + 1;
  // this block's bins of the half-spectrum sum
  const int nbc = N / (2 * Cs);
  const int k0 = c * nbc;
  const int nk = kMode == kSplit ? nbc + (c == Cs - 1 ? 1 : 0) : nb;
  // the weights of this rank's window samples j >= N (m >= N / Cs)
  T* ovf = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(acc) +
                                align16((size_t)(kMode == kSplit ? nbc + 1 : nb) *
                                        sizeof(T)));
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
  const int jmax = w0 > N ? w0 : N;
  // xn + i xn t_true sigma at sample j from the waveform's sample wf
  auto packed = [&](int j, T wf, T norm, T& xr, T& xi) {
    xr = T(0);
    xi = T(0);
    if (j < w0) {
      const T b = T(j - max_half);
      const T t_true = M<T>::abs(b) <= half ? (b + half) + T(1) : T(0);
      xr = wf / norm;
      xi = (xr * t_true) * sigma;
    }
  };
  const int side0 = kMode == kPair ? rank : 0, side1 = kMode == kPair ? rank + 1 : 2;
  for (int side = side0; side < side1; ++side) {
    const double ts = side == 0 ? t + (double)quarter : t - (double)quarter;
    const double c_shift = ::floor(ts * fs + 0.501) + 1.0;
    long long sh = (long long)(c_shift - c_base) + margin;
    sh = sh < 0 ? 0 : (sh > 2 * margin ? 2 * margin : sh);
    const T frac = (T)((ts * fs - ::floor(ts * fs + 0.5)) / fs);
    const T* seg = slab + (size_t)r * Ws + sh;
    T s[2] = {T(0), T(0)};
    if constexpr (kMode != kSplit) {
      // a whole frame: the window row in order, the weighted-mean-removed
      // waveform, the FFT's input (the first N samples, cut or zero-padded),
      // then its bit-reversed order (the order of passes that measured faster
      // here than the split frames' placement)
      for (int j = threadIdx.x; j < w0; j += kThreads) {
        bool in;
        T sw, wv;
        window_at<T, true, true>(seg, j, w0, max_half, half, f0, fs_t, frac, in, sw,
                                 wv);
        re[pad(j)] = sw;
        im[pad(j)] = wv;
        s[0] = s[0] + sw;
        s[1] = s[1] + wv;
      }
      frame_sum<T, kMode, 2>(s, red, C);
      const T ratio = s[0] / s[1];
      T s2 = T(0);
      for (int j = threadIdx.x; j < w0; j += kThreads) {
        const bool in = M<T>::abs(T(j - max_half)) <= half;
        const T wf = in ? re[pad(j)] - im[pad(j)] * ratio : T(0);
        re[pad(j)] = wf;
        s2 = s2 + wf * wf;
      }
      const T norm = M<T>::sqrt(frame_sum1<T, kMode>(s2, red, C));
      for (int j = threadIdx.x; j < N; j += kThreads) {
        T xr, xi;
        packed(j, j < w0 ? re[pad(j)] : T(0), norm, xr, xi);
        re[pad(j)] = xr;
        im[pad(j)] = xi;
      }
      __syncthreads();
      bit_reverse_permute(re, im, N, log_n);
      fft<T, kMode, kWholeR, false>(re, im, lc, N, 1, 0, tw, 1,
                                                  [&](int p, T& xr, T& xi) {
        xr = re[pad(p)];
        xi = im[pad(p)];
      });
    } else {
      // a split frame: the window's weighted samples and weights, each at
      // its FFT position (this rank's samples: those below N; the rest only
      // summed, their weights kept)
      for (int m = threadIdx.x;; m += kThreads) {
        const int j = jr + Cs * m;
        if (j >= jmax) break;
        bool in;
        T sw, wv;
        window_at<T, true>(seg, j, w0, max_half, half, f0, fs_t, frac, in, sw, wv);
        if (j < N) {
          const int p = pad(bit_reverse(j, log_n) & ((1 << lc) - 1));
          re[p] = sw;
          im[p] = wv;
        } else {
          ovf[m - N / Cs] = wv;
        }
        if (j < w0) {
          s[0] = s[0] + sw;
          s[1] = s[1] + wv;
        }
      }
      frame_sum<T, kMode, 2>(s, red, C);
      const T ratio = s[0] / s[1];
      // the weighted-mean-removed waveform and the sum of its squares
      T s2 = T(0);
      for (int m = threadIdx.x;; m += kThreads) {
        const int j = jr + Cs * m;
        if (j >= jmax) break;
        const bool in = j < w0 && M<T>::abs(T(j - max_half)) <= half;
        T wf;
        if (j < N) {
          const int p = pad(bit_reverse(j, log_n) & ((1 << lc) - 1));
          wf = in ? re[p] - im[p] * ratio : T(0);
          re[p] = wf;
        } else {                  // window_at's product, from the kept weight
          const T wv = ovf[m - N / Cs];
          const T sw = (seg[j] * (in ? T(1) : T(0))) * wv;
          wf = in ? sw - wv * ratio : T(0);
        }
        if (j < w0) s2 = s2 + wf * wf;
      }
      const T norm = M<T>::sqrt(frame_sum1<T, kMode>(s2, red, C));
      // the FFT's input made as its first pass loads it
      fft<T, kMode, PassStages<T>::value, true>(
          re, im, lc, N, C, rank, tw, 1, [&](int p, T& xr, T& xi) {
            packed(bit_reverse((c << lc) + p, log_n), re[pad(p)], norm, xr, xi);
          });
    }
    // Z = S + i sigma U: S[k] = (Z[k] + conj Z[N-k]) / 2,
    // sigma U[k] = (Z[k] - conj Z[N-k]) / 2i
    for (int q = threadIdx.x; q < nk; q += kThreads) {
      const int k = k0 + q;
      const int kk = (N - k) & (N - 1);
      const T zr = spread<kMode>(re, k, lc), zi = spread<kMode>(im, k, lc);
      const T yr = spread<kMode>(re, kk, lc), yi = spread<kMode>(im, kk, lc);
      const T sr = (zr + yr) * T(0.5), si = (zi - yi) * T(0.5);
      const T ur = ((zi + yi) * T(0.5)) * inv_sigma;
      const T ui = ((yr - zr) * T(0.5)) * inv_sigma;
      const T cv = sr * ur + si * ui;
      acc[q] = side == side0 ? cv : acc[q] + cv;
    }
    frame_sync<kMode>();
  }
  T* o = out + (size_t)r * nb;
  if constexpr (kMode == kPair) {
    // side 0 + side 1: rank 0 the bins below hb (into its acc, for the
    // replica fill), rank 1 the others (straight out)
    cluster_sync();
    const int hb = nb / 2;
    T* other = at_rank(acc, rank ^ 1);
    if (rank == 0) {
      for (int k = threadIdx.x; k < hb; k += kThreads) acc[k] = acc[k] + other[k];
    } else {
      for (int k = hb + threadIdx.x; k < nb; k += kThreads) o[k] = other[k] + acc[k];
    }
    cluster_arrive();      // this block's reads of the other's acc are done
    if (rank == 0) {
      __syncthreads();
      dc_fill_add(acc, nb, f0, T(fs / N));
      for (int k = threadIdx.x; k < hb; k += kThreads) o[k] = acc[k];
    }
    cluster_wait();        // and the other's of this block's
  } else {
    if (c == 0) dc_fill_add(acc, nb, f0, T(fs / N));
    for (int q = threadIdx.x; q < nk; q += kThreads) o[k0 + q] = acc[q];
  }
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// K7's layout: the reductions' slots; (split) the ranks' top-k histograms,
// 2 x 256 counts; re, im (2^lc positions each, padded; later the smoothed
// spectra); the scratch: the running sum P (Lc doubles), the window's
// weights (this rank's N / C samples) and the warps' histograms; the half
// spectrum A (2^lc + 1 bins).
struct BandLayout {
  size_t hpub, fft, scratch, A, bytes;
};
template <typename T>
__host__ __device__ BandLayout band_layout(int lc, int Lc, int C, int N) {
  BandLayout b;
  b.hpub = kRedBytes;
  b.fft = b.hpub + (C > 1 ? align16(2 * 256 * sizeof(unsigned)) : 0);
  b.scratch = b.fft + align16(2 * (size_t)padded_len(1 << lc) * sizeof(T));
  size_t s = (size_t)Lc * sizeof(double);
  const size_t win = (size_t)(N / C) * sizeof(T), hist = kWarps * 256 * sizeof(unsigned);
  s = s > win ? s : win;
  s = s > hist ? s : hist;
  b.A = b.scratch + align16(s);
  b.bytes = b.A + align16((size_t)((1 << lc) + 1) * sizeof(T));
  return b;
}

// The top_k-th largest of the keys of the frame's bins (this thread's
// key[q], bin threadIdx.x + q kThreads of the rank's nk): tau, by 8-bit
// digits from the top.  hist: the warps' 256-bin histograms; hpub: the
// rank's (split), 2 x 256; sel: 2 x 2 counts.  Returns tau; krem is how
// many of the top_k equal tau.
template <typename T, int kPer, int kMode>
__device__ typename Key<T>::U kth_key(const typename Key<T>::U (&key)[kPer], int nk,
                                      int top_k, unsigned* hist, unsigned* hpub,
                                      unsigned* sel, Red& r, int C,
                                      unsigned& krem) {
  using K = Key<T>;
  using U = typename K::U;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* hw = hist + w * 256;
  U prefix = 0;
  krem = (unsigned)top_k;
  for (int shift = K::kBits - 8; shift >= 0; shift -= 8) {
    for (int i = lane; i < 256; i += 32) hw[i] = 0;
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (q * kThreads + (threadIdx.x & ~31) >= nk) break;   // the warp's bins end
      const bool active = threadIdx.x + q * kThreads < nk &&
                          (shift + 8 == K::kBits ||
                           (key[q] >> (shift + 8)) == (prefix >> (shift + 8)));
      const unsigned d = (unsigned)(key[q] >> shift) & 255u;
      const unsigned peers = __match_any_sync(kFull, active ? d : 256u + lane);
      if (active && lane == __ffs(peers) - 1) hw[d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // this thread's bins 2t and 2t + 1: the warps' counts, then the ranks'
    const int b0 = 2 * threadIdx.x;
    unsigned c0 = 0, c1 = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      c0 += hist[i * 256 + b0];
      c1 += hist[i * 256 + b0 + 1];
    }
    if constexpr (kMode == kSplit) {
      unsigned* hp = hpub + (r.p & 1) * 256;
      hp[b0] = c0;
      hp[b0 + 1] = c1;
      cluster_sync();
      c0 = c1 = 0;
      for (int q = 0; q < C; ++q) {
        const unsigned* o = at_rank(hp, q);
        c0 += o[b0];
        c1 += o[b0 + 1];
      }
    }
    // the counts at or above each of the two bins, from the warps' suffix
    // sums and the higher warps' totals
    const unsigned v = c0 + c1;
    unsigned suf = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_down_sync(kFull, suf, off);
      if (lane + off < 32) suf += o;
    }
    double* slot = r.red + r.p * 2 * kWarps;
    if (lane == 0) slot[w] = (double)suf;
    __syncthreads();
    unsigned above = 0;
    for (int i = w + 1; i < kWarps; ++i) above += (unsigned)slot[i];
    const unsigned s2 = above + (suf - v);     // at or above bin 2t + 2
    const unsigned s1 = s2 + c1, s0 = s1 + c0;
    unsigned* sp = sel + (r.p & 1) * 2;
    if (s1 >= krem && s2 < krem) {
      sp[0] = b0 + 1;
      sp[1] = krem - s2;
    }
    if (s0 >= krem && s1 < krem) {
      sp[0] = b0;
      sp[1] = krem - s1;
    }
    __syncthreads();
    prefix |= (U)sp[0] << shift;
    krem = sp[1];
    r.p ^= 1;
  }
  return prefix;
}

// kth_key's result by the search one bit a round: tau from the top, one
// frame count of the keys at or above the candidate a bit.
template <typename T, int kPer, int kMode>
__device__ typename Key<T>::U kth_key_bits(const typename Key<T>::U (&key)[kPer],
                                           int nk, int top_k, Red& r, int C,
                                           unsigned& krem) {
  using K = Key<T>;
  using U = typename K::U;
  U tau = 0;
  for (int bit = K::kBits - 1; bit >= 0; --bit) {
    const U cand = tau | ((U)1 << bit);
    unsigned c = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      c += (threadIdx.x + q * kThreads < nk && key[q] >= cand) ? 1u : 0u;
    if (frame_count<kMode>(c, r, C) >= (unsigned)top_k) tau = cand;
  }
  unsigned c_gt = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    c_gt += (threadIdx.x + q * kThreads < nk && key[q] > tau) ? 1u : 0u;
  krem = (unsigned)top_k - frame_count<kMode>(c_gt, r, C);
  return tau;
}

template <typename T, int kPer, int kMode, bool kDigits>
__global__ void __launch_bounds__(kThreads, kPer <= kPerSmall ? kBandBlocks : 1)
band_ap_kernel(const T* __restrict__ slab, const T* __restrict__ centroid,
               const T* __restrict__ f0p, const double* __restrict__ tp,
               const T* __restrict__ tw, const T* __restrict__ win,
               const int* __restrict__ band_lo, int Ws, int max_half,
               int margin, int N, int log_n, int C, int lc, double fs, int n_ap,
               int wl, int top_k, Smooth g, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int rank = 0;
  if constexpr (kMode == kSplit) rank = cluster_rank();
  const int Cs = kMode == kSplit ? C : 1;
  const BandLayout L = band_layout<T>(lc, g.Lc, Cs, N);
  Red red{reinterpret_cast<double*>(smem),
          reinterpret_cast<double*>(smem) + 4 * kWarps, 0};
  unsigned* hpub = reinterpret_cast<unsigned*>(smem + L.hpub);
  const int Lb = padded_len(1 << lc);
  T* re = reinterpret_cast<T*>(smem + L.fft);
  T* im = re + Lb;
  double* P = reinterpret_cast<double*>(smem + L.scratch);
  T* wscr = reinterpret_cast<T*>(smem + L.scratch);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + L.scratch);
  T* A = reinterpret_cast<T*>(smem + L.A);
  // the top-k's chosen digit and remaining count (2 parities)
  unsigned* sel = reinterpret_cast<unsigned*>(red.pub + 4);
  const int r = blockIdx.x / Cs;
  const int log_c = __ffs(Cs) - 1;
  const int nr = bit_reverse(rank, log_c);        // rank c's pairs: n = nr mod Cs
  const int w0 = 2 * max_half + 1;
  const int nb = g.nb;
  const int h = N / 2;
  const int k0 = rank << lc;                      // this rank's bins [k0, k0 + nk)
  const int nk = (1 << lc) + (rank == Cs - 1 ? 1 : 0);
  const T f0 = f0p[r];
  const double t = tp[r];
  const T half = M<T>::floor(T(2.0 * fs) / f0 + T(0.5));
  const T frac = (T)((t * fs - ::floor(t * fs + 0.5)) / fs);
  const T* seg = slab + (size_t)r * Ws + margin;
  const int jmax = w0 > N ? w0 : N;

  // the smoothed power spectrum; each real FFT of N points is one complex
  // FFT of h = N / 2 (the even samples real, the odd imaginary), and the
  // window goes straight to its place there: sample j = 2 n + e at
  // position bitrev(n), this rank's when n = nr mod C
  T s[2] = {T(0), T(0)};
  for (int m = threadIdx.x;; m += kThreads) {
    const int j = 2 * (nr + Cs * (m >> 1)) + (m & 1);
    if (j >= jmax) break;
    bool in;
    T sw, wv;
    window_at<T, false>(seg, j, w0, max_half, half, f0, T(fs), frac, in, sw, wv);
    if (j < N) {
      const int p = pad(bit_reverse(j >> 1, log_n - 1) & ((1 << lc) - 1));
      ((j & 1) ? im : re)[p] = sw;
      wscr[m] = wv;
    }
    if (j < w0) {
      s[0] = s[0] + sw;
      s[1] = s[1] + wv;
    }
  }
  frame_sum<T, kMode, 2>(s, red, C);
  const T ratio = s[0] / s[1];
  for (int m = threadIdx.x;; m += kThreads) {
    const int j = 2 * (nr + Cs * (m >> 1)) + (m & 1);
    if (j >= N) break;
    const bool in = j < w0 && M<T>::abs(T(j - max_half)) <= half;
    T* b = (j & 1) ? im : re;
    const int p = pad(bit_reverse(j >> 1, log_n - 1) & ((1 << lc) - 1));
    b[p] = in ? b[p] - wscr[m] * ratio : T(0);
  }
  __syncthreads();
  auto in_place = [&](int p, T& xr, T& xi) {
    xr = re[pad(p)];
    xi = im[pad(p)];
  };
  fft<T, kMode, kBandPassStages, false>(re, im, lc, h, C, rank, tw, 2, in_place);
  for (int q = threadIdx.x; q < nk; q += kThreads)
    A[q] = real_power<T, kMode>(re, im, lc, h, k0 + q, tw);
  frame_sync<kMode>();
  if (rank == 0) dc_fill_add(A, nb, f0, T(g.df));
  if constexpr (kMode == kSplit) cluster_sync();
  T* B = re;   // the smoothed power, then the group delay
  T* Cg = im;  // the group delay smoothed by f0 / 2
  rect_smooth<T, kMode>(A, B, (double)f0, g, P, red, C, rank, lc, k0, nk);

  // the group delay: the centroid over the floored smoothed power
  T s_abs = T(0);
  for (int q = threadIdx.x; q < nk; q += kThreads) s_abs = s_abs + M<T>::abs(B[q]);
  const T floor_v = (frame_sum1<T, kMode>(s_abs, red, C) / T(nb)) * M<T>::eps() *
                    M<T>::eps();
  const T* cen = centroid + (size_t)r * nb + k0;
  for (int q = threadIdx.x; q < nk; q += kThreads) {
    const T sp = B[q];
    B[q] = cen[q] / (M<T>::abs(sp) < floor_v ? floor_v : sp);
  }
  frame_sync<kMode>();
  rect_smooth<T, kMode>(B, Cg, (double)(f0 * T(0.5)), g, P, red, C, rank, lc, k0, nk);
  rect_smooth<T, kMode>(Cg, A, (double)f0, g, P, red, C, rank, lc, k0, nk);
  for (int q = threadIdx.x; q < nk; q += kThreads) A[q] = Cg[q] - A[q];
  frame_sync<kMode>();

  // the bands, each from its first bin of the mirrored group delay
  using K = Key<T>;
  using U = typename K::U;
  for (int band = 0; band < n_ap; ++band) {
    const int lo = __ldg(band_lo + band);
    auto segv = [&](int j) {             // the windowed segment, 0 past wl
      if (j >= wl) return T(0);
      int q = lo + j;
      if (q > h) q = N - q;
      return half_bin<kMode>(A, q, lc, Cs) * __ldg(win + j);
    };
    // the segment's pairs in order, each to its bit-reversed position
    // (read in order: A's bins in bit-reversed order fall in few banks)
    for (int m = threadIdx.x; m < (1 << lc); m += kThreads) {
      const int n = nr + Cs * m;
      const int q = pad(bit_reverse(n, log_n - 1) & ((1 << lc) - 1));
      re[q] = segv(2 * n);
      im[q] = segv(2 * n + 1);
    }
    __syncthreads();
    fft<T, kMode, kBandPassStages, false>(re, im, lc, h, C, rank, tw, 2, in_place);
    U key[kPer];                        // a bin's power is K::value(its key)
    T s_all = T(0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int k = threadIdx.x + q * kThreads;
      key[q] = 0;
      if (k < nk) {
        const T pw = real_power<T, kMode>(re, im, lc, h, k0 + k, tw);
        key[q] = K::of(pw);
        s_all = s_all + pw;
      }
    }
    const T den = frame_sum1<T, kMode>(s_all, red, C);
    unsigned krem;
    U tau;
    if constexpr (kDigits)
      tau = kth_key<T, kPer, kMode>(key, nk, top_k, hist, hpub, sel, red, C, krem);
    else
      tau = kth_key_bits<T, kPer, kMode>(key, nk, top_k, red, C, krem);
    T s_gt = T(0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (threadIdx.x + q * kThreads < nk && key[q] > tau) s_gt = s_gt + K::value(key[q]);
    }
    const T top = frame_sum1<T, kMode>(s_gt, red, C) + T((int)krem) * K::value(tau);
    if (rank == 0 && threadIdx.x == 0) {
      const T num = den - top;
      out[(size_t)r * n_ap + band] =
          T(-10) * M<T>::log10((num + M<T>::tiny()) / (den + M<T>::tiny()));
    }
  }
  if constexpr (kMode == kSplit) cluster_sync();   // the partners' last reads
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

// The current device's attribute, read once a device and kept (the
// launchers run under CUDA graph capture and from several host threads:
// each thread writes the same value)
int device_attr(cudaDeviceAttr attr) {
  constexpr int kDevices = 64, kAttrs = 3;
  static int kept[kDevices][kAttrs];
  const int a = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 0
                : attr == cudaDevAttrMultiProcessorCount        ? 1
                                                                : 2;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (dev < kDevices && kept[dev][a]) return kept[dev][a];
  int v = 0;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (dev < kDevices) kept[dev][a] = v;
  return v;
}
// the shared memory a block may opt in to (232,448 bytes on an H100)
int max_smem() { return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin); }

// The blocks of `smem` bytes each that the device keeps resident at once
// (at most `per_sm` an SM, the bound the kernel is compiled for)
long long resident_blocks(size_t smem, int per_sm) {
  const long long sm = device_attr(cudaDevAttrMultiProcessorCount);
  const long long bytes = device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor);
  long long b = bytes / (long long)(smem + 1024);   // 1 KB reserved a block
  b = b < per_sm ? b : per_sm;
  return sm * b;
}

// The ranks of a frame's cluster: with whole_first one block wherever it
// holds the frame; else the fewest (1, 2, 4 or 8) whose share leaves
// kMinBlocks blocks an SM, else the fewest that fit one block's shared
// memory; 0 where none fits.  smem(C) is a rank's bytes, 0 where C does not
// suit the geometry.  (At fft_size 8,192 in float32 K6 split over 2 ranks
// took half the time of one block a frame, and K7 in one block 0.84 of it
// split: kernel_variants.py ranks_1, ranks_2.)
template <typename F>
int choose_ranks(F smem, bool whole_first) {
  const int cap = max_smem();
  if (kForceRanks) {
    const size_t b = smem(kForceRanks);
    return b && b <= (size_t)cap ? kForceRanks : 0;
  }
  if (whole_first && smem(1) && smem(1) <= (size_t)cap) return 1;
  for (int C = 1; C <= kMaxRanks; C *= 2) {
    const size_t b = smem(C);
    if (b && b * kMinBlocks <= (size_t)cap) return C;
  }
  for (int C = 1; C <= kMaxRanks; C *= 2) {
    const size_t b = smem(C);
    if (b && b <= (size_t)cap) return C;
  }
  return 0;
}

// One launch of R frames of `blocks` blocks each (a cluster of that many
// where blocks > 1) on the stream.
template <typename... Params, typename... Args>
int launch_frames(void (*kernel)(Params...), long long R, int blocks, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (R < 1 || R * blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next call to read
    return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// K6's geometry for R frames: the FFT ranks C (0 where nothing fits), the
// window weights past N a split frame's rank keeps, and whether the two
// shifts run as a pair of blocks: where one block holds a frame and the
// pairs fit the device's resident blocks at once (then each frame's chain
// halves; where they do not, the pair only adds its cluster barriers:
// kernel_variants.py no_pair, pair).
template <typename T>
void centroid_geometry(int N, int w0, long long R, int& C, int& ovf, bool& pair) {
  auto share = [&](int c) { return c > 1 && w0 > N ? (w0 - N + c - 1) / c : 0; };
  auto bytes = [&](int c) {
    return centroid_smem<T>(centroid_buf(c > 1, N / c, w0),
                            c > 1 ? N / (2 * c) + 1 : N / 2 + 1, share(c));
  };
  C = choose_ranks([&](int c) -> size_t {
    if (c > 1 && (N / c < 16 || N / (2 * c) < kKL)) return 0;
    return bytes(c);
  }, false);
  ovf = C ? share(C) : 0;
  pair = false;
  if (C == 1 && N >= 4 * kKL)
    pair = kForcePair < 0 ? 2 * R <= resident_blocks(bytes(1), kCentroidBlocks)
                          : kForcePair == 1;
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
  int C, ovf;
  bool pair;
  centroid_geometry<T>(N, w0, R, C, ovf, pair);
  if (!C) return (int)cudaErrorInvalidConfiguration;
  const int lc = log2_exact(N / C);
  const size_t smem = centroid_smem<T>(centroid_buf(C > 1, N / C, w0),
                                       C > 1 ? N / (2 * C) + 1 : N / 2 + 1, ovf);
#define WORLD_D4C_CENTROID_ARGS \
  slab, f0, t, tw, Ws, max_half, margin, N, log_n, C, lc, fs, out
  if (C > 1)
    return launch_frames(centroid_kernel<T, kSplit, 3>, R, C, smem, stream,
                         WORLD_D4C_CENTROID_ARGS);
  constexpr int kR = PassStages<T>::value;       // 4 in float32, 3 in float64
  const bool r16 = log_n >= kWholeRadix16Log;
  if (pair)
    return r16 ? launch_frames(centroid_kernel<T, kPair, kR>, R, 2, smem, stream,
                               WORLD_D4C_CENTROID_ARGS)
               : launch_frames(centroid_kernel<T, kPair, 3>, R, 2, smem, stream,
                               WORLD_D4C_CENTROID_ARGS);
  return r16 ? launch_frames(centroid_kernel<T, kOne, kR>, R, 1, smem, stream,
                             WORLD_D4C_CENTROID_ARGS)
             : launch_frames(centroid_kernel<T, kOne, 3>, R, 1, smem, stream,
                             WORLD_D4C_CENTROID_ARGS);
#undef WORLD_D4C_CENTROID_ARGS
}

// K7's geometry: the ranks C (0 where nothing fits) and the smoothing's
template <typename T>
int band_geometry_ranks(int N, int span, Smooth& g) {
  g.N = N;
  g.nb = N / 2 + 1;
  g.span = span;
  g.L = 2 * span + g.nb + 1;
  g.df = 0.0;
  g.x0 = 0.0;
  const int C = choose_ranks([&](int c) -> size_t {
    if (c > 1 && (N / (2 * c) < kKL || N / (2 * c) < 16)) return 0;
    if ((N / (2 * c)) + 1 > kPerLarge * kThreads) return 0;
    const int lc = log2_exact(N / (2 * c));
    return band_layout<T>(lc, (g.L + c - 1) / c, c, N).bytes;
  }, kBandWholeFirst);
  g.Lc = C ? (g.L + C - 1) / C : 0;
  return C;
}

template <typename T, int kPer, int kMode, bool kDigits>
int launch_band_ap_for(int C, const T* slab, const T* centroid, const T* f0,
                       const double* t, const T* tw, const T* win,
                       const int* band_lo, int R, int Ws, int max_half,
                       int margin, int N, int log_n, int lc, double fs, int n_ap,
                       int wl, int top_k, const Smooth& g, T* out,
                       cudaStream_t stream) {
  const size_t smem = band_layout<T>(lc, g.Lc, C, N).bytes;
  return launch_frames(band_ap_kernel<T, kPer, kMode, kDigits>, R, C, smem, stream,
                       slab, centroid, f0, t, tw, win, band_lo, Ws, max_half, margin,
                       N, log_n, C, lc, fs, n_ap, wl, top_k, g, out);
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
  const int C = band_geometry_ranks<T>(N, span, g);
  if (!C) return (int)cudaErrorInvalidConfiguration;
  g.df = fs / N;
  g.x0 = -fs + g.df / 2;
  const int lc = log2_exact(N / (2 * C));
  const int bins = (1 << lc) + 1;                 // a rank's
  const int per = bins_per_thread(bins);
#define WORLD_D4C_BAND_ARGS                                                       \
  C, slab, centroid, f0, t, tw, win, band_lo, R, Ws, max_half, margin, N, log_n, lc, \
      fs, n_ap, wl, top_k, g, out, stream
  if (C > 1)
    return per <= kPerSmall
               ? launch_band_ap_for<T, kPerSmall, kSplit, kDigitSplit>(WORLD_D4C_BAND_ARGS)
               : launch_band_ap_for<T, kPerLarge, kSplit, kDigitSplit>(WORLD_D4C_BAND_ARGS);
  if (per <= kPerTiny)
    return launch_band_ap_for<T, kPerTiny, kOne, kDigitWhole>(WORLD_D4C_BAND_ARGS);
  return per <= kPerSmall
             ? launch_band_ap_for<T, kPerSmall, kOne, kDigitWhole>(WORLD_D4C_BAND_ARGS)
             : launch_band_ap_for<T, kPerLarge, kOne, kDigitWhole>(WORLD_D4C_BAND_ARGS);
#undef WORLD_D4C_BAND_ARGS
}

template <typename T>
int d4c_clusters(int N, int max_half, int span, int R, int* k6_blocks,
                 int* k7_blocks) {
  if (log2_exact(N) < 4 || N > kMaxN || max_half < 0 || span < 0 ||
      2 * span + 2 >= N || R < 1)
    return (int)cudaErrorInvalidValue;
  int C, ovf;
  bool pair;
  centroid_geometry<T>(N, 2 * max_half + 1, R, C, ovf, pair);
  *k6_blocks = pair ? -2 : C;
  Smooth g;
  *k7_blocks = band_geometry_ranks<T>(N, span, g);
  return 0;
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

// The blocks a frame of each kernel launches with for R frames at fft_size
// N (K6: C ranks, or -2 for its pair of shift blocks; K7: C ranks; 0 where
// the geometry does not fit), without launching anything.
extern "C" int world_d4c_clusters_f32(int N, int max_half, int span, int R, int* k6,
                                      int* k7) {
  return d4c_clusters<float>(N, max_half, span, R, k6, k7);
}

extern "C" int world_d4c_clusters_f64(int N, int max_half, int span, int R, int* k6,
                                      int* k7) {
  return d4c_clusters<double>(N, max_half, span, R, k6, k7);
}
