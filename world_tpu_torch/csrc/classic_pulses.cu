// K8, the classic synthesis' pulses: each live pulse's response, then the
// overlap-add of the responses, on the slots that hold a pulse only.
//
// It replaces no Pallas kernel: the JAX package computes the classic
// synthesis with stock XLA ops over every slot of its static pulse axis
// (world_tpu/synth/classic.py::_synthesis_core), and so did the port
// (world_tpu_torch/ops/classic_pulses.py::pulses_plain, the plain twin, and
// the yardstick).  There the synthesis was 71% of the classic round trip's
// graph replay on the H100 (16 rows of 5 s at 16 kHz: 28.3 of 39.8 ms), and
// about 80% of its work went to slots past a row's pulse count, whose
// results the overlap-add then left out: a CUDA graph replays static
// shapes and cannot skip them.  These kernels read each row's pulse count
// on the device instead.
//
// Grid 1, pulse_responses.  Persistent blocks of 256 threads walk the
// (row, slot) pairs of the launch's pulse range; a pair past its row's
// count costs one read and a branch, a live one is computed whole by its
// block:
//   * the 2-frame lerp of the spectrum, of the aperiodicity's square (AP)
//     and of the periodic share max(1 - AP, 0.001), at the pulse's frame
//     pair and weights;
//   * the two real log amplitudes (periodic: spectrum x periodic share;
//     aperiodic: spectrum, x AP where voiced), mirrored, as one complex FFT
//     of fft_size points: both are real and even, so their cepstra are the
//     real and the imaginary part of the one transform;
//   * both complex cepstra as one inverse FFT of one complex sequence,
//     split into the two transforms, each exponentiated into its minimum-
//     phase half spectrum; the periodic one turned by the pulse's
//     fractional-shift phase;
//   * both real inverse transforms as one complex inverse FFT of the
//     Hermitian sequence periodic + i aperiodic;
//   * the periodic response's DC remover and sqrt(noise size) gain, the
//     voicing gate, and the aperiodic response's direct convolution with
//     the pulse's mean-removed noise row (n_noise <= max_noise samples: at
//     16 kHz 404 at most, 32 for an unvoiced 500 Hz pulse, ~80-160 for a
//     voiced one), fused products in the working type, m ascending.  Direct
//     and not by FFT: at fft_size 1,024 and n_noise ~100 it is ~2 x 10^5
//     flops, fewer than the three 2,048-point FFTs of the plain version's
//     convolution (~3.4 x 10^5), and it needs no buffer of twice the size;
//   * the sum, written to the pulse's row of the response buffer.
// The FFT is radix-2 decimation in time, bit-reversed input, natural
// output, on separate real and imaginary arrays (one pad word every 32:
// the bit-reversed scatters were 32-way bank conflicts, 21% of grid 1's
// time at the cell), with the twiddles of ops/d4c_spectra.py::fft_twiddles
// (cos and sin of -2 pi m / N in float64, cast).  A pulse's buffers are 4
// padded fft_size values and its noise row: in shared memory where one
// block can opt in to them (fft_size 8,192 in float32, 4,096 in float64),
// else in a device-memory scratch of the wrapper's, one slice a block (two
// blocks an SM there).  Each live pulse adds one to the launch's live count
// (one atomic add a block, integers).
//
// Grid 2, pulse_ola.  A gather overlap-add: a block owns 256 samples of one
// row's output.  A pulse of start s lies in the 32-sample slot (s + base) /
// 32 of dsp/ola.py::SlotGrid; the pulses of a slot are a contiguous range,
// since the starts of the live pulses are nondecreasing and the live pulses
// are a prefix of the row.  The block finds each slot's first pulse by
// binary search, and each sample adds, for its chunks c = 0, 1, ... (slot
// blk - c), the sum in pulse order of the slot's first max_rank pulses that
// reach it: SlotGrid's rank passes and uniform_ola's fold, in their order,
// so the output is bitwise SlotGrid's of the same responses, and a call
// repeats its bits (no float atomics).  Pulses past max_rank in a slot are
// left out, as SlotGrid leaves them; the wrapper flags them from the ranks.
//
// Blocks of pulses (where the response buffer of all slots would pass the
// stage budget): the wrapper runs the blocks last first; grid 1 computes a
// block's pulses and the next 32, grid 2 adds the slots whose first pulse
// lies in the block, to the partial sums of the later blocks: the fold adds
// a sample's later slots first, so any blocking gives the same bits.
//
// What bounds them.  16 rows of 5 s at 16 kHz, fft_size 1,024: ~23,500
// live pulses of 8,192 x 16 slots.  The function needs the frames the
// pulses reach (of two arrays), their noise samples and the 16 rows of
// output once: ~0.07 GB, 0.02 ms at 3.35 TB/s (the response buffer
// between the grids, ~0.1 GB each way, is this design's).  Its operations:
// three complex FFTs of 1,024 points (5 N log2 N flops each), the
// convolution's ~2 N n_noise flops and ~30 a bin besides: ~0.28 MFLOP a
// pulse, 6.5 GFLOP, 0.10 ms at 67 TFLOP/s (chip_smoke.k8_bound).  The chain is a sequence of block-wide steps with a
// barrier each FFT stage (~35 a pulse), and its instructions (index
// arithmetic, shared-memory loads and stores, libdevice's transcendentals)
// outnumber its flops: 18 KiB of shared memory a block in float32, eight
// blocks an SM, instruction-bound at ~4% of the bound (PERF.md's K8 row).
//
// The elementwise operations are the plain version's (-fmad=false); log,
// exp, cos and sin are the correctly rounded or libdevice functions
// PyTorch calls.  The FFTs and the direct convolution round otherwise than
// cuFFT's and the plain version's FFT convolution: the responses agree with
// the plain version's to its own card-against-CPU difference.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;           // grid 2's samples a block
constexpr int kSlot = 32;            // dsp/ola.py's SLOT
constexpr unsigned kFull = 0xffffffffu;
// the reduction slots at the head of grid 1's shared memory: 2 sums a warp
constexpr int kRedBytes = 2 * kWarps * (int)sizeof(double);
// blocks an SM where a pulse's buffers live in device memory
constexpr int kScratchBlocks = 2;
// the convolution's outputs a thread computes at once (one read of each
// noise sample for kConv products)
constexpr int kConv = 4;

template <typename T> struct M;
template <> struct M<float> {
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float cos(float x) { return cosf(x); }
  static __device__ __forceinline__ float sin(float x) { return sinf(x); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
};
template <> struct M<double> {
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double cos(double x) { return ::cos(x); }
  static __device__ __forceinline__ double sin(double x) { return ::sin(x); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return ::fma(a, b, c); }
};

__device__ __forceinline__ int bitrev(int k, int log_n) {
  return (int)(__brev((unsigned)k) >> (32 - log_n));
}

// An FFT array's element i sits at pad(i): one pad word every 32, so that
// the bit-reversed scatters (32 consecutive k land 32 apart or more) and the
// butterflies of a stage fall on distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded(int n) { return n + (n >> 5); }

// In-place forward FFT of N = 2^log_n points (re, im, padded): bit-reversed
// input, natural output; tw holds cos and sin of -2 pi m / N, m < N / 2.
// Ends with a barrier.
template <typename T>
__device__ void fft(T* re, T* im, const T* __restrict__ tw, int n, int log_n) {
  for (int s = 0; s < log_n; ++s) {
    const int h = 1 << s;
    const int step = n >> (s + 1);
    for (int q = threadIdx.x; q < (n >> 1); q += kThreads) {
      const int j = q & (h - 1);
      const int i = ((q >> s) << (s + 1)) + j;
      const int m = j * step;
      const T wr = tw[2 * m], wi = tw[2 * m + 1];
      const int a = pad(i), b = pad(i + h);
      const T xr = re[b], xi = im[b];
      const T tr = xr * wr - xi * wi;
      const T ti = xr * wi + xi * wr;
      const T ur = re[a], ui = im[a];
      re[a] = ur + tr;
      im[a] = ui + ti;
      re[b] = ur - tr;
      im[b] = ui - ti;
    }
    __syncthreads();
  }
}

// The block's sums of a and b, each in a fixed order (each warp's xor tree
// read at lane 0, then the warps in order); every thread gets them.
__device__ __forceinline__ void block_sum2(double& a, double& b, double* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
  __syncthreads();
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
pulse_responses_kernel(const T* __restrict__ sp, const T* __restrict__ ap,
                       const long long* __restrict__ count,
                       const long long* __restrict__ f1,
                       const long long* __restrict__ f2,
                       const T* __restrict__ wa, const T* __restrict__ wb,
                       const unsigned char* __restrict__ voiced,
                       const T* __restrict__ phase_step,
                       const T* __restrict__ gain,
                       const long long* __restrict__ n_noise,
                       const T* __restrict__ noise,
                       const T* __restrict__ dc_base, const T* __restrict__ tw,
                       int B, int P, int F, int n, int log_n, int max_noise,
                       int p_lo, int p_hi, int p_own_hi, T* __restrict__ resp,
                       T* scratch, unsigned long long* live) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);
  T* buf = kShared ? reinterpret_cast<T*>(smem + kRedBytes)
                   : scratch + (size_t)blockIdx.x * (4 * padded(n) + max_noise);
  const int np = padded(n);
  T* ar = buf;                // A and B: padded FFT arrays
  T* ai = buf + np;
  T* br = buf + 2 * np;
  T* bi = buf + 3 * np;
  T* xs = br;                 // n + max_noise <= 2 np, unpadded, once B is read
  T* dn = buf + 4 * np;       // max_noise
  const int half = n >> 1, bins = half + 1, tid = threadIdx.x;
  const int rows = p_hi - p_lo;
  const T inv_n = (T)1 / (T)n;            // powers of two: exact scalings
  const T inv_2n = inv_n / (T)2;
  const T eps = (T)2.220446049250313e-16;
  unsigned long long done = 0;
  for (long long idx = blockIdx.x; idx < (long long)B * rows; idx += gridDim.x) {
    const int b = (int)(idx / rows);
    const int p = p_lo + (int)(idx - (long long)b * rows);
    const long long cnt = count[b] < P ? count[b] : P;
    if (p >= cnt) continue;
    if (p < p_own_hi) ++done;
    const size_t q = (size_t)b * P + p;
    const T a = wa[q], w = wb[q];
    const bool v = voiced[q] != 0;
    const T* s1 = sp + ((size_t)b * F + f1[q]) * bins;
    const T* s2 = sp + ((size_t)b * F + f2[q]) * bins;
    const T* a1 = ap + ((size_t)b * F + f1[q]) * bins;
    const T* a2 = ap + ((size_t)b * F + f2[q]) * bins;

    // the log amplitudes, mirrored, into A in bit-reversed order
    for (int k = tid; k < bins; k += kThreads) {
      const T s = a * s1[k] + w * s2[k];
      const T x1 = a1[k] * a1[k], x2 = a2[k] * a2[k];
      const T aps = a * x1 + w * x2;
      const T per = a * M<T>::max((T)1 - x1, (T)0.001)
                    + w * M<T>::max((T)1 - x2, (T)0.001);
      const T l1 = M<T>::log(M<T>::max(s * per, eps)) / (T)2;
      const T l2 = M<T>::log(M<T>::max(v ? s * aps : s, eps)) / (T)2;
      int r = pad(bitrev(k, log_n));
      ar[r] = l1;
      ai[r] = l2;
      if (k > 0 && k < half) {
        r = pad(bitrev(n - k, log_n));
        ar[r] = l1;
        ai[r] = l2;
      }
    }
    __syncthreads();
    fft(ar, ai, tw, n, log_n);

    // the complex cepstra (cep[0], 0 below N / 2, 2 cep from N / 2 on) as
    // cc1 + i cc2, conjugated into B in bit-reversed order: the inverse FFT
    // is the conjugate of the forward FFT of the conjugate, over N
    for (int k = tid; k < n; k += kThreads) {
      const int o = pad(k);
      const T c1 = k == 0 ? ar[o] : (k >= half ? ar[o] * (T)2 : (T)0);
      const T c2 = k == 0 ? ai[o] : (k >= half ? ai[o] * (T)2 : (T)0);
      const int r = pad(bitrev(k, log_n));
      br[r] = c1;
      bi[r] = -c2;
    }
    __syncthreads();
    fft(br, bi, tw, n, log_n);

    // V = FFT(conj(cc1 + i cc2)): the two inverse transforms are A1 =
    // ifft(cc1) and A2 = ifft(cc2) on bins k <= N / 2; their exponentials
    // are the minimum-phase spectra X1 (turned by the pulse's shift phase)
    // and X2.  conj(Z), Z = X1 + i X2 made Hermitian (bins 0 and N / 2
    // real), goes into A in bit-reversed order.
    const T ps = phase_step[q];
    for (int k = tid; k < bins; k += kThreads) {
      const int k2 = (n - k) & (n - 1);
      const int o = pad(k), o2 = pad(k2);
      const T vr = br[o], vi = bi[o], ur = br[o2], ui = bi[o2];
      const T a1r = (vr + ur) * inv_2n, a1i = (ui - vi) * inv_2n;
      const T a2r = -(vi + ui) * inv_2n, a2i = (ur - vr) * inv_2n;
      const T e1 = M<T>::exp(a1r), e2 = M<T>::exp(a2r);
      const T m1r = e1 * M<T>::cos(a1i), m1i = e1 * M<T>::sin(a1i);
      const T x2r = e2 * M<T>::cos(a2i), x2i = e2 * M<T>::sin(a2i);
      const T theta = ps * (T)k;
      const T cr = M<T>::cos(theta), ci = M<T>::sin(theta);
      const T x1r = m1r * cr - m1i * ci, x1i = m1r * ci + m1i * cr;
      if (k == 0 || k == half) {
        const int r = pad(bitrev(k, log_n));
        ar[r] = x1r;
        ai[r] = -x2r;
      } else {
        int r = pad(bitrev(k, log_n));
        ar[r] = x1r - x2i;
        ai[r] = -(x1i + x2r);
        r = pad(bitrev(n - k, log_n));
        ar[r] = x1r + x2i;
        ai[r] = -(x2r - x1i);
      }
    }
    __syncthreads();
    fft(ar, ai, tw, n, log_n);

    // the periodic response is ar / N and the aperiodic -ai / N (unshifted):
    // the aperiodic one fftshifted into B after max_noise zeros (xs), the
    // pulse's noise row into D
    const long long nn = n_noise[q];
    double psum = 0.0, nsum = 0.0;
    for (int k = tid; k < n; k += kThreads) {
      psum += (double)(ar[pad(k)] * inv_n);
      xs[max_noise + k] = -ai[pad((k + half) & (n - 1))] * inv_n;
    }
    for (int m = tid; m < max_noise; m += kThreads) xs[m] = (T)0;
    for (int m = tid; m < nn; m += kThreads) {
      const T d = noise ? noise[q * max_noise + m] : (T)0.1;
      dn[m] = d;
      nsum += (double)d;
    }
    block_sum2(psum, nsum, red);
    const T mean = (T)nsum / (T)nn;
    const T neg_sum = -(T)psum;
    for (int m = tid; m < nn; m += kThreads) dn[m] = dn[m] - mean;
    __syncthreads();

    // the outputs: periodic + the convolution sum_m d[m] xs[j - m] (fused
    // products, m ascending; xs is zero before its first sample), kConv
    // outputs a thread at once
    const T g = gain[q];
    T* out = resp + ((size_t)b * rows + (p - p_lo)) * n;
    for (int j0 = tid; j0 < n; j0 += kConv * kThreads) {
      T acc[kConv];
#pragma unroll
      for (int r = 0; r < kConv; ++r) acc[r] = (T)0;
      const T* x0 = xs + max_noise + j0;
      for (int m = 0; m < nn; ++m) {
        const T d = dn[m];
#pragma unroll
        for (int r = 0; r < kConv; ++r)
          if (j0 + r * kThreads < n) acc[r] = M<T>::fma(d, x0[r * kThreads - m], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kConv; ++r) {
        const int j = j0 + r * kThreads;
        if (j >= n) break;
        const T x1s = ar[pad((j + half) & (n - 1))] * inv_n;
        const T periodic = v ? (x1s + dc_base[j] * neg_sum) * g : (T)0;
        out[j] = periodic + acc[r];
      }
    }
    __syncthreads();
  }
  if (tid == 0 && done) atomicAdd(live, done);
}

// grid 2: the row's output y (B, y_length) += the slots' sums of the
// pulses whose slot's first pulse lies in [p_lo, p_own_hi); resp holds the
// rows of pulses p_lo .. p_lo + rows - 1.
template <typename T>
__global__ void __launch_bounds__(kTile)
pulse_ola_kernel(const T* __restrict__ resp, const long long* __restrict__ starts,
                 const long long* __restrict__ count, int P, int n, int y_length,
                 int max_rank, int base, int n_chunks, int p_lo, int p_own_hi,
                 int rows, T* __restrict__ y) {
  extern __shared__ int first[];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const long long cnt = count[b] < P ? count[b] : P;
  const long long* st = starts + (size_t)b * P;
  const int t_end = min(t0 + kTile, y_length);
  const int blk_lo = (t0 + base) >> 5, blk_hi = (t_end - 1 + base) >> 5;
  const int f_lo = blk_lo - (n_chunks - 1);
  const int nf = blk_hi - f_lo + 2;
  // each slot's first pulse: the first of the row's live pulses whose start
  // lies at or past the slot's
  for (int k = tid; k < nf; k += kTile) {
    const long long target = (long long)(f_lo + k) * kSlot - base;
    int lo = 0, hi = (int)cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (st[mid] < target) lo = mid + 1; else hi = mid;
    }
    first[k] = lo;
  }
  __syncthreads();
  const int t = t0 + tid;
  if (t >= y_length) return;
  const int blk = (t + base) >> 5;
  T acc = y[(size_t)b * y_length + t];
  for (int c = 0; c < n_chunks; ++c) {
    const int f = blk - c;
    if (f < 0) break;
    const int lo = first[f - f_lo], hi = first[f - f_lo + 1];
    if (lo >= hi || lo < p_lo || lo >= p_own_hi) continue;
    // SlotGrid's grid row of slot f at column 32 c + i: its pulses' samples
    // t - start, in rank order from 0
    const int e = min(hi, lo + max_rank);
    T g = (T)0;
    for (int p = lo; p < e; ++p) {
      const long long j = t - st[p];
      if (j >= 0 && j < n) g = g + resp[((size_t)b * rows + (p - p_lo)) * n + j];
    }
    acc = acc + g;
  }
  y[(size_t)b * y_length + t] = acc;
}

template <typename T>
int plan(int n, int max_noise, int* grid, int* smem, int* scratch_items,
         bool* shared) {
  int dev, sms, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t items = 4 * (size_t)padded(n) + (size_t)max_noise;
  const size_t need = (size_t)kRedBytes + items * sizeof(T);
  *shared = need <= (size_t)optin;
  *smem = *shared ? (int)need : kRedBytes;
  *scratch_items = *shared ? 0 : (int)items;
  const void* fn = *shared ? (const void*)pulse_responses_kernel<T, true>
                           : (const void*)pulse_responses_kernel<T, false>;
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem);
    if (err != cudaSuccess) return (int)err;
  }
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads, *smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidValue;
  if (!*shared && occ > kScratchBlocks) occ = kScratchBlocks;
  *grid = occ * sms;
  return 0;
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

template <typename T>
int responses(const T* sp, const T* ap, const long long* count,
              const long long* f1, const long long* f2, const T* wa,
              const T* wb, const unsigned char* voiced, const T* phase_step,
              const T* gain, const long long* n_noise, const T* noise,
              const T* dc_base, const T* tw, int B, int P, int F, int n,
              int max_noise, int p_lo, int p_hi, int p_own_hi, T* resp,
              T* scratch, long long* live, cudaStream_t stream) {
  const int log_n = log2_of(n);
  if (log_n < 5 || max_noise > n || p_lo < 0 || p_hi > P || p_lo > p_own_hi
      || p_own_hi > p_hi)
    return (int)cudaErrorInvalidValue;
  int grid, smem, scratch_items;
  bool shared;
  int err = plan<T>(n, max_noise, &grid, &smem, &scratch_items, &shared);
  if (err) return err;
  if (scratch_items && !scratch) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * (p_hi - p_lo);
  if (items <= 0) return 0;
  if (items < grid) grid = (int)items;
  unsigned long long* lv = reinterpret_cast<unsigned long long*>(live);
  if (shared)
    pulse_responses_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        sp, ap, count, f1, f2, wa, wb, voiced, phase_step, gain, n_noise,
        noise, dc_base, tw, B, P, F, n, log_n, max_noise, p_lo, p_hi,
        p_own_hi, resp, scratch, lv);
  else
    pulse_responses_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        sp, ap, count, f1, f2, wa, wb, voiced, phase_step, gain, n_noise,
        noise, dc_base, tw, B, P, F, n, log_n, max_noise, p_lo, p_hi,
        p_own_hi, resp, scratch, lv);
  return (int)cudaGetLastError();
}

template <typename T>
int ola(const T* resp, const long long* starts, const long long* count, int B,
        int P, int n, int y_length, int max_rank, int p_lo, int p_own_hi,
        int rows, T* y, cudaStream_t stream) {
  if (log2_of(n) < 5 || max_rank < 1 || max_rank > kSlot || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || y_length <= 0) return 0;
  const int base = kSlot * (n / kSlot + 1);          // SlotGrid's base
  const int n_chunks = (n + kSlot + kSlot - 1) / kSlot;
  const int smem = (kTile / kSlot + n_chunks + 2) * (int)sizeof(int);
  const dim3 grid((y_length + kTile - 1) / kTile, B);
  pulse_ola_kernel<T><<<grid, kTile, smem, stream>>>(
      resp, starts, count, P, n, y_length, max_rank, base, n_chunks, p_lo,
      p_own_hi, rows, y);
  return (int)cudaGetLastError();
}

}  // namespace

#define WORLD_PULSES(SUFFIX, T)                                                \
  extern "C" int world_pulse_plan_##SUFFIX(int n, int max_noise, int* grid,    \
                                           int* smem, int* scratch_items) {    \
    bool shared;                                                               \
    return plan<T>(n, max_noise, grid, smem, scratch_items, &shared);          \
  }                                                                            \
  extern "C" int world_pulse_responses_##SUFFIX(                               \
      const T* sp, const T* ap, const long long* count, const long long* f1,   \
      const long long* f2, const T* wa, const T* wb,                           \
      const unsigned char* voiced, const T* phase_step, const T* gain,         \
      const long long* n_noise, const T* noise, const T* dc_base,              \
      const T* tw, int B, int P, int F, int n, int max_noise, int p_lo,        \
      int p_hi, int p_own_hi, T* resp, T* scratch, long long* live,            \
      cudaStream_t stream) {                                                   \
    return responses<T>(sp, ap, count, f1, f2, wa, wb, voiced, phase_step,     \
                        gain, n_noise, noise, dc_base, tw, B, P, F, n,         \
                        max_noise, p_lo, p_hi, p_own_hi, resp, scratch, live,  \
                        stream);                                               \
  }                                                                            \
  extern "C" int world_pulse_ola_##SUFFIX(                                     \
      const T* resp, const long long* starts, const long long* count, int B,   \
      int P, int n, int y_length, int max_rank, int p_lo, int p_own_hi,        \
      int rows, T* y, cudaStream_t stream) {                                   \
    return ola<T>(resp, starts, count, B, P, n, y_length, max_rank, p_lo,      \
                  p_own_hi, rows, y, stream);                                  \
  }

WORLD_PULSES(f32, float)
WORLD_PULSES(f64, double)
