// K3, DIO's extension scans: FixStep3 (forward) and FixStep4 (backward).
//
// The JAX package runs each as a jax.lax.scan over the frames
// (world_tpu/f0/dio.py::_fix_step3 and ::_fix_step4); there is no Pallas
// kernel.  The plain PyTorch twin is
// world_tpu_torch/ops/extension_scan.py::extension_scan_plain.
//
// For each row, one frame after another (last to first when backward), with
// the carry (prev1, prev2, active, limit) starting at (0, 0, false, 0):
//   in_ext = active && (p <= limit)          forward
//            active && (p >= limit - 1)      backward
//   ext    = select_best_f0(prev1, prev2, cands[:, p])
//   val    = in_ext ? ext : base[p]
//   active = in_ext && ext != 0;  at a flagged frame active = true and
//            limit = limits[p]
//   prev2 = prev1;  prev1 = val;  out[p] = val
// select_best_f0 (world_tpu/f0/dio.py::_select_best_f0): the candidate
// nearest reference = (prev1 * 3 - prev2) / 2, the first of equal errors,
// kept when |1 - best / (reference + eps)| <= allowed_range, else 0, with eps
// float64's machine epsilon in the working type.  Every operation is the
// plain version's, rounded once: the products and differences are written
// with the _rn intrinsics (and the file is built with -fmad=false), so that
// nvcc contracts nothing into an FMA, and the divisions are IEEE.
//
// The decomposition.  Take the frames in scan order, s = p forward and
// s = n - 1 - p backward; an extension from the flag at s' runs through s
// while s <= reach(s'), reach = limits[p'] forward and n - limits[p']
// backward (p >= limit - 1 is s <= n - limit).
//  - A flagged frame f is a *head* if no flag comes before it, or if the
//    previous flag f' has f' < f - 1 and reach(f') < f - 1 (backward, in
//    frames: f' > f + 1 and limits[f'] - 1 > f + 1).  Every other flag
//    continues the chain of f'.
//  - Why a head is independent: frame s is written only by the chain of the
//    last flag before it in scan order, and only where s <= its reach.  So at
//    a head the frame of the flag and the frame before it still hold base,
//    and the scan's carry after the head is (base[f], base[f - 1], active,
//    reach(f)); at s = 0 there is no frame before, and prev2 is the initial
//    carry's 0.
//  - A group is a head and the flags that continue it.  One thread walks a
//    group: it runs the serial rule exactly, frame after frame, while the
//    carry is active; where it is not, it jumps to the group's next flag
//    (the frames between keep base, and so does that flag's own frame), and
//    it stops at the next head or the row's end.
//  - Frames outside every chain are base: the block copies base to out
//    (coalesced) before any walker writes, with a barrier between the two,
//    and the walkers write only the frames their extensions run through.
// The worst case, every flag in one group, is one thread's walk of the row,
// as the serial kernel before this design did.
//
// What bounds it on the H100.  At DIO's 929 frames and 7 candidates a row
// reads 42 KB in float32, 0.013 us at 3.35 TB/s; the work is a few dependent
// picks.  So the time is latency: the row copy's rounds of loads, the block
// scans' barriers and the longest group's chain of picks (DIO: at most ~11
// picks a chain, ~30 frames of dependent chains at 60 s), not 929 or 12,001
// frames of one thread as before.  Layout: one block a row.  Pass 1: each
// warp copies words of 32 frames and ballots their flags into a bitmap in
// shared memory, in scan order, kUnroll words in flight.  Pass 2: two block
// scans give, for each word, the last flag at or before it and the first flag
// at or after it, so that the flag before a frame and the next flag from a
// frame are two shared-memory reads.  Pass 3: each thread takes the flags of
// its words and walks the group of each head.  A walker issues the next
// frame's candidate loads (kPrefetch of them into registers; any further
// ones are read in the pick) before the current pick, so a step waits on one
// pick, not on a pick and a round of loads.  Shared memory: 12 bytes each 32
// frames (12,001 frames: 4.5 KB), opted in past 48 KB; the launcher refuses
// a row whose bitmap does not fit (about 600,000 frames on the H100).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                  // words a warp copies at once
constexpr int kPrefetch = 8;                // candidates held in registers
constexpr size_t kStaticSmem = 48 * 1024;   // beyond it, opt in
constexpr unsigned kFull = 0xffffffffu;
constexpr double kF64Eps = 2.220446049250313e-16;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// one row's operands, addressed in scan order
template <typename T>
struct Row {
  const T* base;
  const uint8_t* flags;
  const long long* limits;
  const T* cands;
  T* out;
  int n, C;
  bool backward;

  __device__ __forceinline__ int frame(int s) const { return backward ? n - 1 - s : s; }
  // the last frame, in scan order, that the extension from the flag at s
  // may run through
  __device__ __forceinline__ long long reach(int s) const {
    const long long limit = limits[frame(s)];
    return backward ? (long long)n - limit : limit;
  }
  // the first kPrefetch candidates of the frame at s, where s is a frame
  __device__ __forceinline__ void load(int s, T (&c)[kPrefetch]) const {
    if (s >= n) return;
    const T* col = cands + frame(s);
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k)
      if (k < C) c[k] = col[(size_t)k * n];
  }
};

// select_best_f0 of the frame at s: the serial kernel's select_best,
// operation for operation, its first kPrefetch candidates from registers
template <typename T>
__device__ __forceinline__ T select_best(T prev1, T prev2, const T (&c)[kPrefetch],
                                         const Row<T>& r, int s, T allowed) {
  const T reference = div_rn(sub_rn(mul_rn(prev1, T(3)), prev2), T(2));
  T best = c[0];
  T best_err = fabs(sub_rn(reference, best));
#pragma unroll
  for (int k = 1; k < kPrefetch; ++k) {
    if (k < r.C) {
      const T err = fabs(sub_rn(reference, c[k]));
      if (err < best_err) {
        best_err = err;
        best = c[k];
      }
    }
  }
  const T* col = r.cands + r.frame(s);
  for (int k = kPrefetch; k < r.C; ++k) {
    const T v = col[(size_t)k * r.n];
    const T err = fabs(sub_rn(reference, v));
    if (err < best_err) {
      best_err = err;
      best = v;
    }
  }
  const T ratio = div_rn(best, add_rn(reference, T(kF64Eps)));
  return fabs(sub_rn(T(1), ratio)) <= allowed ? best : T(0);
}

__device__ __forceinline__ int op(int a, int b, bool is_max) {
  return is_max ? max(a, b) : min(a, b);
}

// the exclusive scan of one value a thread, in thread order, under max or min
__device__ int block_exclusive(int v, int identity, bool is_max, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(x, y, is_max);
  }
  int before = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) before = identity;
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? scratch[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = op(w, y, is_max);
    }
    if (lane < kWarps) scratch[lane] = w;
  }
  __syncthreads();
  if (warp > 0) before = op(before, scratch[warp - 1], is_max);
  __syncthreads();  // the next scan reuses scratch
  return before;
}

__device__ __forceinline__ bool flagged(const unsigned* bits, int s) {
  return (bits[s >> 5] >> (s & 31)) & 1u;
}

// the last flag before s in scan order, or -1
__device__ __forceinline__ int flag_before(const unsigned* bits, const int* last,
                                           int s) {
  const int w = s >> 5;
  const unsigned m = bits[w] & ((1u << (s & 31)) - 1u);
  if (m) return w * 32 + 31 - __clz(m);
  return w > 0 ? last[w - 1] : -1;
}

// the first flag at or after s in scan order, or n
__device__ __forceinline__ int flag_from(const unsigned* bits, const int* first,
                                         int nw, int n, int s) {
  if (s >= n) return n;
  const int w = s >> 5;
  const unsigned m = bits[w] & (kFull << (s & 31));
  if (m) return w * 32 + __ffs(m) - 1;
  return w + 1 < nw ? first[w + 1] : n;
}

// the group of the head h: the serial rule from the carry after h, to the
// next head or the row's end
template <typename T>
__device__ void walk(const Row<T>& r, const unsigned* bits, const int* first,
                     int nw, int h, T allowed) {
  T prev1 = r.base[r.frame(h)];
  T prev2 = h > 0 ? r.base[r.frame(h - 1)] : T(0);
  int last = h;                  // the last flag walked
  long long reach = r.reach(h);
  bool active = true;
  int s = h;
  T next[kPrefetch];
  r.load(s + 1, next);
  for (;;) {
    const int s1 = s + 1;
    if (s1 >= r.n) return;
    if (active && s1 <= reach) {
      T cur[kPrefetch];
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) cur[k] = next[k];
      r.load(s1 + 1, next);      // the next frame's loads, before this pick
      const T v = select_best(prev1, prev2, cur, r, s1, allowed);
      r.out[r.frame(s1)] = v;
      active = v != T(0);
      if (flagged(bits, s1)) {   // inside the reach: it continues the group
        last = s1;
        reach = r.reach(s1);
        active = true;
      }
      prev2 = prev1;
      prev1 = v;
      s = s1;
    } else {
      // the carry is inactive from s1 on: the frames keep base up to the
      // next flag g, and g's own frame too
      const int g = flag_from(bits, first, nw, r.n, s1);
      if (g >= r.n || (g - last > 1 && (long long)(g - 1) > reach)) return;
      prev2 = g - 1 == s ? prev1 : r.base[r.frame(g - 1)];
      prev1 = r.base[r.frame(g)];
      last = g;
      reach = r.reach(g);
      active = true;
      s = g;
      r.load(s + 1, next);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
extension_scan(const T* __restrict__ base, const uint8_t* __restrict__ flags,
               const long long* __restrict__ limits, const T* __restrict__ cands,
               int C, int n, int backward, T allowed, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (n + 31) >> 5;
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem);  // flags, scan order
  int* s_last = reinterpret_cast<int*>(s_bits + nw);     // last flag in words <= w
  int* s_first = s_last + nw;                            // first flag in words >= w
  int* s_scan = s_first + nw;                            // kWarps

  const size_t row = blockIdx.x;
  const Row<T> r{base + row * n, flags + row * n, limits + row * n,
                 cands + row * (size_t)C * n, out + row * n, n, C, backward != 0};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // pass 1: out = base, and the flags' bitmap
  for (int w0 = warp; w0 < nw; w0 += kUnroll * kWarps) {
    T v[kUnroll];
    bool f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = (w0 + u * kWarps) * 32 + lane;
      f[u] = false;
      if (s < n) {
        v[u] = r.base[r.frame(s)];
        f[u] = r.flags[r.frame(s)] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * kWarps;
      const int s = w * 32 + lane;
      if (s < n) r.out[r.frame(s)] = v[u];
      const unsigned m = __ballot_sync(kFull, f[u]);
      if (lane == 0 && w < nw) s_bits[w] = m;
    }
  }
  __syncthreads();

  // pass 2: each thread a run of words; the last flag at or before each
  // word, then the first flag at or after it (the runs taken from the end)
  const int per = (nw + kThreads - 1) / kThreads;
  {
    const int lo = threadIdx.x * per, hi = min(nw, lo + per);
    int run = -1;
    for (int w = lo; w < hi; ++w)
      if (s_bits[w]) run = w * 32 + 31 - __clz(s_bits[w]);
    run = block_exclusive(run, -1, true, s_scan);
    for (int w = lo; w < hi; ++w) {
      if (s_bits[w]) run = w * 32 + 31 - __clz(s_bits[w]);
      s_last[w] = run;
    }
  }
  {
    const int lo = (kThreads - 1 - threadIdx.x) * per, hi = min(nw, lo + per);
    int run = n;
    for (int w = hi - 1; w >= lo; --w)
      if (s_bits[w]) run = w * 32 + __ffs(s_bits[w]) - 1;
    run = block_exclusive(run, n, false, s_scan);
    for (int w = hi - 1; w >= lo; --w) {
      if (s_bits[w]) run = w * 32 + __ffs(s_bits[w]) - 1;
      s_first[w] = run;
    }
  }
  __syncthreads();

  // pass 3: the heads, each walked by the thread of its word
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    unsigned m = s_bits[w];
    while (m) {
      const int h = w * 32 + __ffs(m) - 1;
      m &= m - 1;
      const int prev = flag_before(s_bits, s_last, h);
      if (prev < 0 || (prev < h - 1 && r.reach(prev) < (long long)(h - 1)))
        walk(r, s_bits, s_first, nw, h, allowed);
    }
  }
}

template <typename T>
int launch_extension_scan(const T* base, const uint8_t* flags,
                          const long long* limits, const T* cands, int rows,
                          int C, int n, int backward, double allowed, T* out,
                          cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const size_t nw = ((size_t)n + 31) / 32;
  const size_t smem = 3 * sizeof(int) * nw + sizeof(int) * kWarps;
  if (smem > kStaticSmem) {
    int dev = 0, optin = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
      return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(extension_scan<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // leave no error behind for the next call to read
      return (int)err;
    }
  }
  extension_scan<T><<<rows, kThreads, smem, stream>>>(
      base, flags, limits, cands, C, n, backward, (T)allowed, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int world_extension_scan_f32(const float* base, const uint8_t* flags,
                                        const long long* limits,
                                        const float* cands, int rows, int C,
                                        int n, int backward, double allowed,
                                        float* out, cudaStream_t stream) {
  return launch_extension_scan<float>(base, flags, limits, cands, rows, C, n,
                                      backward, allowed, out, stream);
}

extern "C" int world_extension_scan_f64(const double* base, const uint8_t* flags,
                                        const long long* limits,
                                        const double* cands, int rows, int C,
                                        int n, int backward, double allowed,
                                        double* out, cudaStream_t stream) {
  return launch_extension_scan<double>(base, flags, limits, cands, rows, C, n,
                                       backward, allowed, out, stream);
}
