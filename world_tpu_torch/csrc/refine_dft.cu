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
// What bounds it on the H100.  The work is each live slot's own window:
// per sample, 24 multiply-adds into the 6 harmonic bins of two DFTs, fed by
// 12 reads of the cos/sin basis at (K*n) mod S.  Counted as 60 float32
// operations a sample, the bound is about 10 us at the main path's operands,
// and the bytes are a tenth of that.  In practice the instruction issue
// rate and the latency of each frame's dependent phases bound it: with
// -fmad=false and the table's indexing a sample costs ~85 instructions per
// slot, the two correctly rounded cosines of each window sample as much
// again, and only a third of a frame's ~18 live slots share a window.  The
// one-warp-per-pair design lost most of its time elsewhere: basis reads
// from device memory K entries apart (up to 32 L1 wavefronts a load), both
// window cosines recomputed per pair with lanes 0 and 31 diverging, 63% of
// the warps finding an empty slot, a 120-shuffle reduction and a serial
// tail on lane 0.
//
// Design.  A persistent block of 4 warps walks over frames (several blocks
// per SM) and loads the basis into shared memory once:
//   * the S-entry cos/sin table (built on the host in float64: the exact
//     values of dft_table), interleaved as (cos, sin) pairs, with one pair
//     of padding every 16 so that a group's stride-K reads spread over the
//     banks;
//   * the frame's seg and phase rows, loaded once and coalesced;
//   * the block reads the frame's candidates and compacts the live ones with
//     a ballot and a block scan (any pattern of live slots), then finds the
//     distinct half-widths among them.  The window depends only on the frame
//     and on half, so each (frame, half) window is computed once, by one
//     warp, with the same correctly rounded cos() in refine_plain's
//     operations (each sample once; its neighbours for the derivative come
//     by shuffles), and stored premultiplied by the frame row: seg*window and
//     seg*derivative, the products refine_plain forms.  Windows are ordered
//     by half, longest first, and packed by their support into a pool of
//     kPool samples; a frame that needs more runs in chunks;
//   * the live slots, in the same order, go to quarter-warps (8 lanes), so
//     the 4 slots of a warp mostly share a window length, and the last,
//     partly filled round gets the shortest windows.  The 8 lanes read all
//     6 bins' basis values at once (a read per harmonic behind its own
//     branch serialized them) and accumulate the 24 sums over the slot's
//     window; a transposed butterfly (28 shuffles per 4 slots) leaves
//     harmonic h's 4 sums on lane h, lanes 0-5 compute their harmonic's
//     bin, IF, amplitude and deviation in parallel, and lane 0 sums them in
//     harmonic order and gates (the float32 IF numerator stays an fma
//     two-product).
// The DFT stays on the CUDA cores: each slot needs 6 bins at its own K out
// of S/2+1, so a dense product on the tensor cores would do ~85x the work,
// and TF32/bf16 would miss the float32 parity bars.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kHarm = 6;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPool = 2048;            // window samples per chunk (+ W slack)
constexpr unsigned kFull = 0xffffffffu;

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

// shared-memory slot of basis pair m: one padding pair every 16 pairs
// (16 pairs of float32 fill the 32 banks)
__device__ __forceinline__ int padded(int m) { return m + (m >> 4); }

__host__ __device__ constexpr int padded_len(int S) { return S + (S >> 4); }

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// the Blackman window at phase ph, in refine_plain's operations
template <typename T>
__device__ __forceinline__ T blackman(T ph, T pi, T wlt) {
  const T common = pi * ph / wlt;
  const T c2 = M<T>::cos(T(2) * common);
  const T c4 = M<T>::cos(T(4) * common);
  return T(0.42) + T(0.5) * c2 + T(0.08) * c4;
}

// Exclusive prefix sum of v over the block; *total gets the sum.  Holds a
// barrier, so every thread of the block must call it, and warp_tot may be
// rewritten only after a later barrier.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += u;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    off += w < warp ? t : 0;
    tot += t;
  }
  *total = tot;
  return off + incl - v;
}

// One step of the transposed butterfly within a group of 8 lanes: lanes
// whose bit `o` is clear keep the lower half of a[0:2H], the others the
// upper half, each summed with its partner lane's copy.
template <typename T, int H>
__device__ __forceinline__ void fold(T* a, int o, unsigned mask) {
  const bool upper = (threadIdx.x & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T keep = upper ? a[i + H] : a[i];
    const T send = upper ? a[i] : a[i + H];
    a[i] = keep + __shfl_xor_sync(mask, send, o, 8);
  }
}

// window support |j - max_half| <= half, clipped to the row
template <typename T>
__device__ __forceinline__ int half_index(T half, int max_half) {
  return (int)M<T>::min(half, T(max_half));
}

// The block's shared memory, carved from one dynamic allocation.
template <typename T>
struct Smem {
  using P = typename Pair<T>::type;
  P* tab;         // padded_len(S) (cos, sin) pairs
  T* seg_s;       // W
  T* ph_s;        // W
  T* xm_s;        // kPool + W: seg * window, packed by support
  T* xd_s;        // kPool + W: seg * derivative
  T* live_f0;     // kThreads: f0 of the k-th live slot of the group
  T* live_half;   // kThreads
  T* win_half;    // kThreads: half of the k-th distinct window
  int* live_c;    // kThreads: candidate index of the k-th live slot
  int* live_rep;  // kThreads: 1 where the slot is its half's first
  int* live_win;  // kThreads: its window
  int* sorted;    // kThreads: live slots in window order
  int* win_off;   // kThreads: window offset in the pool
  int* win_chunk; // kThreads: the chunk that computes it
  int* warp_tot;  // kWarps

  static size_t bytes(int S, int W) {
    return sizeof(P) * (size_t)padded_len(S) +
           sizeof(T) * (2 * (size_t)W + 2 * ((size_t)kPool + W) + 3 * kThreads) +
           sizeof(int) * (6 * kThreads + kWarps);
  }

  __device__ Smem(void* base, int S, int W) {
    tab = static_cast<P*>(base);
    T* p = reinterpret_cast<T*>(tab + padded_len(S));
    seg_s = p; p += W;
    ph_s = p; p += W;
    xm_s = p; p += kPool + W;
    xd_s = p; p += kPool + W;
    live_f0 = p; p += kThreads;
    live_half = p; p += kThreads;
    win_half = p; p += kThreads;
    int* q = reinterpret_cast<int*>(p);
    live_c = q; q += kThreads;
    live_rep = q; q += kThreads;
    live_win = q; q += kThreads;
    sorted = q; q += kThreads;
    win_off = q; q += kThreads;
    win_chunk = q; q += kThreads;
    warp_tot = q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
refine_kernel(const T* __restrict__ seg, const T* __restrict__ phase,
              const T* __restrict__ f0s, int C, int F, int W, int max_half,
              int S, const T* __restrict__ cos_tab,
              const T* __restrict__ sin_tab, T fs, T three_fs, T half_fs,
              T f0_floor, T f0_ceil, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> sm(smem_raw, S, W);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gl = lane & 7;                         // lane within its group
  const unsigned gmask = 0xffu << (lane & 24);     // its group's lanes
  const int worker = warp * 4 + (lane >> 3);       // one slot per group
  const T pi = T(3.141592653589793);

  for (int m = tid; m < S; m += kThreads) {
    sm.tab[padded(m)].x = cos_tab[m];
    sm.tab[padded(m)].y = sin_tab[m];
  }

  // every frame ends on a barrier after its last read of shared memory
  for (int f = blockIdx.x; f < F; f += gridDim.x) {
    for (int j = tid; j < W; j += kThreads) {
      sm.seg_s[j] = seg[(size_t)f * W + j];
      sm.ph_s[j] = phase[(size_t)f * W + j];
    }

    for (int base = 0; base < C; base += kThreads) {
      // 1. the group's live slots, in candidate order
      const int c = base + tid;
      T f0 = T(0);
      if (c < C) f0 = f0s[(size_t)c * F + f];
      const bool live = c < C && f0 > T(1e-6);
      if (c < C && !live) {           // empty slot: the gate gives (0, 0)
        T* o = out + 2 * ((size_t)c * F + f);
        o[0] = T(0);
        o[1] = T(0);
      }
      int n_live;
      const int pos = block_scan(live ? 1 : 0, sm.warp_tot, &n_live);
      if (live) {
        sm.live_c[pos] = c;
        sm.live_f0[pos] = f0;
        sm.live_half[pos] = M<T>::ceil(three_fs / f0 / T(2));
      }
      __syncthreads();
      if (n_live == 0) continue;      // uniform across the block

      // 2. the distinct half-widths, one window each, ranked by half from
      // the largest, so that neighbouring windows and slots have similar
      // lengths and the last, partly filled round of each phase gets the
      // shortest; a slot's place in window order is the count of slots of
      // larger half plus its rank among the slots of its own half
      int occ = 0;
      T my_half = T(0);
      if (tid < n_live) {
        my_half = sm.live_half[tid];
        for (int s2 = 0; s2 < tid; ++s2) occ += sm.live_half[s2] == my_half;
        sm.live_rep[tid] = occ == 0;
      }
      __syncthreads();
      int rank = 0, slot0 = 0, start = 0, n_win = 0, total_len = 0;
      for (int s2 = 0; s2 < n_live; ++s2) {
        const T h2 = sm.live_half[s2];
        const int rep2 = sm.live_rep[s2];
        const int len2 = rep2 ? 2 * half_index(h2, max_half) + 1 : 0;
        const bool before = h2 > my_half;
        rank += before ? rep2 : 0;
        slot0 += before ? 1 : 0;
        start += before ? len2 : 0;
        n_win += rep2;
        total_len += len2;
      }
      if (tid < n_live) {
        if (occ == 0) {
          // window `rank` holds samples [start, start+len) of the frame's
          // flat order; chunk k computes the windows ending in (k*kPool,
          // (k+1)*kPool], at pool offsets below kPool + W
          const int len = 2 * half_index(my_half, max_half) + 1;
          const int chunk = (start + len - 1) / kPool;
          sm.win_half[rank] = my_half;
          sm.win_off[rank] = start - chunk * kPool + W - 1;
          sm.win_chunk[rank] = chunk;
        }
        sm.live_win[tid] = rank;
        sm.sorted[slot0 + occ] = tid;
      }
      __syncthreads();

      const int n_chunks = (total_len + kPool - 1) / kPool;
      for (int k = 0; k < n_chunks; ++k) {
        // 3. this chunk's windows, one warp per window: seg*window and
        // seg*derivative at pool index o + j
        for (int w = warp; w < n_win; w += kWarps) {
          if (sm.win_chunk[w] != k) continue;
          const T h = sm.win_half[w];
          const T wlt = (T(2) * h + T(1)) / fs;
          const int ih = half_index(h, max_half);
          const int jlo = max_half - ih, jhi = max_half + ih;
          const int o = sm.win_off[w] - jlo;
          T cur = T(0);                    // the window at j = j0 + lane
          if (jlo + lane <= jhi) cur = blackman(sm.ph_s[jlo + lane], pi, wlt);
          T before = T(0);                 // the window at j0 - 1
          for (int j0 = jlo; j0 <= jhi; j0 += 32) {
            const int j = j0 + lane;
            T next = T(0);
            if (j + 32 <= jhi) next = blackman(sm.ph_s[j + 32], pi, wlt);
            T right = __shfl_down_sync(kFull, cur, 1);
            const T next0 = __shfl_sync(kFull, next, 0);
            if (lane == 31) right = next0;
            T left = __shfl_up_sync(kFull, cur, 1);
            if (lane == 0) left = before;
            before = __shfl_sync(kFull, cur, 31);
            if (j <= jhi) {
              const T dw = -(right - left) / T(2);
              const T xv = sm.seg_s[j];
              sm.xm_s[o + j] = xv * cur;
              sm.xd_s[o + j] = xv * dw;
            }
            cur = next;
          }
        }
        __syncthreads();

        // 4. one group of 8 lanes per live slot whose window this chunk holds
        for (int i = worker; i < n_live; i += 4 * kWarps) {
          const int s = sm.sorted[i];
          const int w = sm.live_win[s];
          if (sm.win_chunk[w] != k) continue;
          const T f0v = sm.live_f0[s];
          const T h = sm.live_half[s];
          const T fft_size = M<T>::exp2(M<T>::ceil(M<T>::log2(h * T(2) + T(1)) + T(1)));
          const T n_harm = M<T>::min(M<T>::floor(half_fs / f0v), T(6));
          const int nh = (int)n_harm;
          const int ih = half_index(h, max_half);
          const int jlo = max_half - ih, jhi = max_half + ih;
          const int o = sm.win_off[w] - jlo;
          // lane gl holds harmonic gl's bin; the group shares the K's
          const T bin = M<T>::trunc(f0v * fft_size / fs * T(gl + 1) + T(0.5));
          const T kf = M<T>::min(M<T>::max(bin * (T(S) / fft_size), T(0)), T(S / 2));
          const int Kg = (int)kf;
          int m[kHarm], step[kHarm];
#pragma unroll
          for (int hh = 0; hh < kHarm; ++hh) {
            const long long K = __shfl_sync(gmask, Kg, hh, 8);
            m[hh] = (int)((K * (jlo + gl)) & (S - 1));
            step[hh] = (int)((K * 8) & (S - 1));
          }
          T a[4 * 8];                      // 8 harmonics' sums, 6 real
#pragma unroll
          for (int q = 0; q < 4 * 8; ++q) a[q] = T(0);
#pragma unroll 2
          for (int j = jlo + gl; j <= jhi; j += 8) {
            const T xm = sm.xm_s[o + j];
            const T xd = sm.xd_s[o + j];
            // all 6 bins, so that the 6 table reads issue together; the
            // tail ignores harmonics past n_harm
            typename Pair<T>::type b[kHarm];
#pragma unroll
            for (int hh = 0; hh < kHarm; ++hh) b[hh] = sm.tab[padded(m[hh])];
#pragma unroll
            for (int hh = 0; hh < kHarm; ++hh) {
              a[4 * hh + 0] += xm * b[hh].x;
              a[4 * hh + 1] += xm * b[hh].y;
              a[4 * hh + 2] += xd * b[hh].x;
              a[4 * hh + 3] += xd * b[hh].y;
              m[hh] = (m[hh] + step[hh]) & (S - 1);
            }
          }
          // transposed butterfly: lane gl ends with harmonic gl's
          // (re_s, im_s, re_d, im_d), each summed over the group's 8 lanes
          fold<T, 16>(a, 4, gmask);
          fold<T, 8>(a, 2, gmask);
          fold<T, 4>(a, 1, gmask);

          // tail of GetRefinedF0 (world_tpu/ops/refine_dft.py:_refine_math):
          // lane gl < 6 evaluates harmonic gl, lane 0 sums in harmonic order
          const T tiny = M<T>::tiny();
          const bool hm = gl < nh;
          const T re_s = hm ? a[0] : T(0);
          const T im_s = hm ? a[1] : T(0);
          const T re_d = hm ? a[2] : T(0);
          const T im_d = hm ? a[3] : T(0);
          const T numerator = prod_diff(re_s, im_d, im_s, re_d);
          const T power = re_s * re_s + im_s * im_s;
          const T inst = (bin / fft_size +
                          numerator / M<T>::max(power, tiny) / T(2) / pi) * fs;
          const T amp = M<T>::sqrt(power) * (hm ? T(1) : T(0));
          const T t_num = amp * inst;
          const T t_den = amp * T(gl + 1);
          const T t_var = hm ? M<T>::abs((inst / T(gl + 1) - f0v) / f0v) : T(0);
          T num_acc = T(0), den_acc = T(0), var_acc = T(0);
#pragma unroll
          for (int hh = 0; hh < kHarm; ++hh) {
            num_acc = num_acc + __shfl_sync(gmask, t_num, hh, 8);
            den_acc = den_acc + __shfl_sync(gmask, t_den, hh, 8);
            var_acc = var_acc + __shfl_sync(gmask, t_var, hh, 8);
          }
          if (gl == 0) {
            const T refined = num_acc / M<T>::max(den_acc, tiny);
            const T score = T(1) / (T(1e-12) + var_acc / M<T>::max(n_harm, T(1)));
            const bool ok = refined >= f0_floor && refined <= f0_ceil &&
                            score >= T(2.5) && f0v > T(1e-6);
            T* op = out + 2 * ((size_t)sm.live_c[s] * F + f);
            op[0] = ok ? refined : T(0);
            op[1] = ok ? score : T(0);
          }
        }
        __syncthreads();              // the pool is rewritten by the next chunk
      }
    }
  }
}

template <typename T>
int launch_refine(const T* seg, const T* phase, const T* f0, int C, int F,
                  int W, int max_half, int S, const T* cos_tab,
                  const T* sin_tab, double fs, double f0_floor, double f0_ceil,
                  T* out, cudaStream_t stream) {
  if (C <= 0 || F <= 0 || W != 2 * max_half + 1 || S < 16 || (S & (S - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Smem<T>::bytes(S, W);
  cudaError_t err = cudaFuncSetAttribute(
      refine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next call to read
    return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, refine_kernel<T>, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = F < per_sm * sms ? F : per_sm * sms;
  refine_kernel<T><<<blocks, kThreads, smem, stream>>>(
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
