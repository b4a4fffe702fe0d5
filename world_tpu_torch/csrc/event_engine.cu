// K1, the zero-crossing event engine of Harvest and DIO.
//
// Replaces the Pallas kernel world_tpu/ops/edge_interp.py::_event_kernel
// (launched by _interval_interp_pallas).  Its spec is the XLA twin
// world_tpu/f0/events.py::batched_interval_interp + interval_select, and the
// plain PyTorch twin is world_tpu_torch/f0/events.py::batched_interval_interp.
//
// For each signal row:
//   * negative-going zero crossings  x[i]*x[i+1] < 0 && x[i+1] < x[i]  at the
//     sub-sample position  (i+1) - x[i]/(x[i+1]-x[i]);
//   * for each frame q, the 4 previous crossings at or before sample
//     clip(floor(q*pnum/qden) - 2) and the 5 next crossings at or after
//     sample clip(floor(q*pnum/qden) - 1) (the TPU kernel's chain margins);
//   * the crossing interval that holds the frame time, with f0 = fs/interval
//     linearly interpolated between interval midpoints;
//   * the interval count per row.
//
// What bounds it on the H100.  Reading the rows once: at Harvest's
// geometry 608 rows x 37,152 samples, 90 MB of float32, against 11 MB of
// output; the bound is device-memory bandwidth (30 us).  In practice each
// pass is a chain of dependent steps per block (load, scan, barrier,
// store), so what decides the time is how well the blocks overlap those
// chains.  The one-block-per-row design ran a block-wide barrier 4 times per
// 1,024 samples with one scalar load per thread between them, left 104 of
// 132 SMs idle at DIO's 28 rows, and ran two binary searches through device
// memory (about 28 dependent loads), 9 recomputed positions and 11 IEEE
// divisions per frame.
//
// Design, two launches:
//   1. scan_crossings, one block per (tile of kTile samples, row), so rows
//      are split across blocks at every geometry: each thread reads a
//      contiguous run of kRun samples with 16-byte vector loads (plus one
//      sample of halo from its neighbour lane), marks its crossings, and the
//      block runs one scan per tile to place them in order.  It stores each
//      crossing's sub-sample position (the plain version's expression, so
//      the two stay bitwise equal) in the tile's own segment of the row's
//      scratch, and the tile's crossing count.  Since g(q) =
//      floor(q*pnum/qden) is monotone, the frames whose edge sample p_prev(q)
//      falls in the tile form a range; for each of them the block writes the
//      count of the tile's crossings at or before p_prev(q), read off the
//      scan in O(1).
//   2. select_intervals, one block per (row, ~kSpanSamples samples of
//      frames): it loads its frames' ranks and times, turns the row's tile
//      counts into offsets in shared memory (a frame's rank among the row's
//      crossings is then one add), stages the crossings its frames read, and
//      computes each interval's midpoint, time and f0 once, in
//      interval_select's operations, where neighbouring frames recomputed
//      them.  Each frame then runs interval_select's choice and
//      interpolation unchanged, with +-inf for missing edges.  The first
//      block of each row writes the interval count.
// No binary search touches device memory.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPrev = 4;
constexpr int kNext = 5;
constexpr int kEdges = kPrev + kNext;
constexpr int kThreads = 256;                // pass 2's block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 256;            // pass 1's block
constexpr int kRun = 16;                     // contiguous samples per thread
constexpr int kTile = kScanThreads * kRun;   // samples per pass-1 block
constexpr int kTileCap = kTile / 2;          // crossings a tile can hold
constexpr int kSpanSamples = 8192;           // samples per pass-2 block
constexpr int kMaxFrames = 1024;             // frames per pass-2 block, at most
constexpr int kFramesPerThread = kMaxFrames / kThreads;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ bool is_crossing(T x, T x_next) {
  return (x_next * x < T(0)) && (x_next < x);
}

// finite: neither +-inf nor NaN (E holds +-inf for missing edges and NaN
// only where a position is undefined)
template <typename T>
__device__ __forceinline__ bool finite(T v) {
  return v - v == T(0);
}

// the run [s, s+kRun) of a row of n samples; zero past the row's end
__device__ __forceinline__ void load_run(const float* xr, int s, int n,
                                         bool vec, float (&v)[kRun]) {
  if (vec && s + kRun <= n) {
    const float4* p = reinterpret_cast<const float4*>(xr + s);
#pragma unroll
    for (int k = 0; k < kRun / 4; ++k) {
      const float4 u = __ldg(p + k);
      v[4 * k] = u.x; v[4 * k + 1] = u.y; v[4 * k + 2] = u.z; v[4 * k + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = s + k < n ? xr[s + k] : 0.0f;
  }
}

__device__ __forceinline__ void load_run(const double* xr, int s, int n,
                                         bool vec, double (&v)[kRun]) {
  if (vec && s + kRun <= n) {
    const double2* p = reinterpret_cast<const double2*>(xr + s);
#pragma unroll
    for (int k = 0; k < kRun / 2; ++k) {
      const double2 u = __ldg(p + k);
      v[2 * k] = u.x; v[2 * k + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = s + k < n ? xr[s + k] : 0.0;
  }
}

// Exclusive prefix sum of v over the block; *total gets the sum.  Holds a
// barrier, so every thread of the block must call it, and warp_tot may be
// rewritten only after a later barrier.
template <int kBlockWarps>
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
  for (int w = 0; w < kBlockWarps; ++w) {
    const int t = warp_tot[w];
    off += w < warp ? t : 0;
    tot += t;
  }
  *total = tot;
  return off + incl - v;
}

// floor(a / b) for a >= 0, b > 0, in 32-bit division where a fits (a
// 64-bit division is a long subroutine)
__device__ __forceinline__ long long div_floor(long long a, int b) {
  return a <= 0xffffffffLL ? (long long)((unsigned)a / (unsigned)b) : a / b;
}

// frame q's sample floor(q*pnum/qden)
__device__ __forceinline__ long long frame_sample(int q, int pnum, int qden) {
  return div_floor((long long)q * pnum, qden);
}

// frame q's edge sample: clip(floor(q*pnum/qden) - 2, 0, n-1)
__device__ __forceinline__ int prev_sample(long long g, int n) {
  return (int)(g - 2 < 0 ? 0 : (g - 2 > n - 1 ? n - 1 : g - 2));
}

// the first frame q < Q whose prev_sample is >= a (Q if none): for
// 1 <= a <= n-1 that is the first q with q*pnum >= (a+2)*qden
__device__ __forceinline__ int first_frame_at(int a, int n, int Q, int pnum,
                                              int qden) {
  if (a <= 0) return 0;
  if (a > n - 1 || pnum <= 0) return Q;
  const long long q = div_floor((long long)(a + 2) * qden + pnum - 1, pnum);
  return q < Q ? (int)q : Q;
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
scan_crossings(const T* __restrict__ x, int n, int n_tiles, int cap, int Q,
               int pnum, int qden, bool vec, T* __restrict__ pos,
               int* __restrict__ rank, int* __restrict__ tile_count) {
  __shared__ int warp_tot[kScanThreads / 32];
  __shared__ int run_off[kScanThreads];
  __shared__ unsigned short run_bits[kScanThreads];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const T* xr = x + (size_t)row * n;
  const int tile0 = tile * kTile;
  const int s = tile0 + tid * kRun;

  T v[kRun];
  load_run(xr, s, n, vec, v);
  // the sample after the run: the next lane's first, or one more load
  T after = __shfl_down_sync(kFull, v[0], 1);
  if (lane == 31) after = s + kRun < n ? xr[s + kRun] : T(0);

  // the last sample pairs with itself (x_next = x): never a crossing
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const T nx = k + 1 < kRun ? v[k + 1] : after;
    if (s + k < n - 1 && is_crossing(v[k], nx)) bits |= 1u << k;
  }
  int total;
  const int off = block_scan<kScanThreads / 32>(__popc(bits), warp_tot, &total);

  T* pr = pos + (size_t)row * cap + (size_t)tile * kTileCap;
  int o = off;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (bits & (1u << k)) {
      const T nx = k + 1 < kRun ? v[k + 1] : after;
      const T den = nx - v[k];
      pr[o++] = T(s + k + 1) - v[k] / (den == T(0) ? T(1) : den);
    }
  }
  run_off[tid] = off;
  run_bits[tid] = (unsigned short)bits;
  if (tid == 0) tile_count[(size_t)row * n_tiles + tile] = total;
  __syncthreads();

  // the frames whose edge sample lies in this tile: their count of the
  // tile's crossings at or before it
  const int q_lo = first_frame_at(tile0, n, Q, pnum, qden);
  const int q_hi = first_frame_at(tile0 + kTile, n, Q, pnum, qden);
  for (int q = q_lo + tid; q < q_hi; q += kScanThreads) {
    const int d = prev_sample(frame_sample(q, pnum, qden), n) - tile0;
    const int u = d / kRun;
    const unsigned below = (2u << (d % kRun)) - 1u;
    rank[(size_t)row * Q + q] = run_off[u] + __popc(run_bits[u] & below);
  }
}

// the tile holding the row's crossing of rank k (0 <= k < total): the last
// tile whose offset in `start` (n_tiles + 1 entries) is <= k
__device__ __forceinline__ int tile_of(const int* start, int n_tiles, int k) {
  int lo = 0, hi = n_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// interval_select's sel(): entry j, or entry 0 when j matches none
__device__ __forceinline__ int sel(int j) {
  return (j >= 0 && j < kEdges - 1) ? j : 0;
}

// interval_select (world_tpu/f0/events.py:137-170), same operation order:
// fin[i] says whether edge i is finite, mid_at(i), x_at(i) = mid_at(i) / fs
// and f0_at(i) give interval i (between edges i and i+1)
template <typename T, typename Mid, typename X, typename F0>
__device__ __forceinline__ T interval_value(const bool (&fin)[kEdges], Mid mid_at,
                                            X x_at, F0 f0_at, T tv, T fs) {
  const T Tq = tv * fs;
  int left_invalid = 0, v_count = 0, raw_cnt = 0;
#pragma unroll
  for (int j = 0; j < kPrev; ++j) left_invalid += fin[j] ? 0 : 1;
#pragma unroll
  for (int j = 0; j < kEdges - 1; ++j) {
    const bool valid = fin[j] && fin[j + 1];
    v_count += valid ? 1 : 0;
    raw_cnt += (valid && mid_at(j) <= Tq) ? 1 : 0;
  }
  raw_cnt += left_invalid;
  const int hi_v = left_invalid + max(v_count, 2) - 1;
  const int j = min(max(raw_cnt - 1, left_invalid), hi_v - 1);
  const T x0 = x_at(sel(j));
  const T x1 = x_at(sel(j + 1));
  const T y0 = f0_at(sel(j));
  const T y1 = f0_at(sel(j + 1));
  const T dx = x1 - x0;
  return y0 + (y1 - y0) / (dx == T(0) ? T(1) : dx) * (tv - x0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_intervals(const T* __restrict__ pos, const int* __restrict__ rank,
                 const int* __restrict__ tile_count, int n, int n_tiles,
                 int cap, const T* __restrict__ tq, int Q, int pnum, int qden,
                 int frames_per_block, int span_cap, T fs,
                 T* __restrict__ out_f0, int* __restrict__ out_m) {
  // the block's span of the row's crossings: edges, and the midpoint, its
  // time and the f0 of each interval between neighbours; then the tiles'
  // offsets among the row's crossings
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* edge = reinterpret_cast<T*>(smem_raw);
  T* mid = edge + span_cap;
  T* xmid = mid + span_cap;
  T* f0i = xmid + span_cap;
  int* start = reinterpret_cast<int*>(f0i + span_cap);
  __shared__ int warp_tot[kWarps];
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int* rr = rank + (size_t)row * Q;
  const int q0 = blockIdx.x * frames_per_block;
  const int q1 = min(q0 + frames_per_block, Q);
  // the block's loads go out together: its frames' ranks and times, the
  // ranks at its ends, then the row's tile counts
  int rk[kFramesPerThread];
  T tv[kFramesPerThread];
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    const int q = q0 + tid + i * kThreads;
    rk[i] = q < q1 ? rr[q] : 0;
    tv[i] = q < q1 ? tq[q] : T(0);
  }
  const int rank_first = rr[q0], rank_last = rr[q1 - 1];
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int i = base + tid;
    const int c = i < n_tiles ? tile_count[(size_t)row * n_tiles + i] : 0;
    int sum;
    const int ex = block_scan<kWarps>(c, warp_tot, &sum);
    if (i < n_tiles) start[i] = carry + ex;
    carry += sum;
    __syncthreads();                  // warp_tot is rewritten next
  }
  const int cnt = carry;
  if (tid == 0) start[n_tiles] = cnt;
  __syncthreads();
  if (blockIdx.x == 0 && tid == 0) out_m[row] = cnt > 1 ? cnt - 1 : 0;

  // crossings at <= p_prev(q), monotone in q: every frame's edges have
  // ranks in [k_prev(q0) - 4, k_prev(q1-1) + 5); the frames with g < 2
  // read ranks 0..4, inside it too
  auto k_prev_of = [&](int q, int r) {
    return start[prev_sample(frame_sample(q, pnum, qden), n) / kTile] + r;
  };
  const int klo = k_prev_of(q0, rank_first) - kPrev;
  const int span = min(k_prev_of(q1 - 1, rank_last) + kNext - klo, span_cap);
  const T inf = T(INFINITY);
  const T* pr = pos + (size_t)row * cap;
  for (int i = tid; i < span; i += kThreads) {
    const int k = klo + i;
    T e;
    if (k < 0) {
      e = -inf;
    } else if (k >= cnt) {
      e = inf;
    } else {
      const int t = tile_of(start, n_tiles, k);
      e = pr[(size_t)t * kTileCap + (k - start[t])];
    }
    edge[i] = e;
  }
  __syncthreads();
  for (int i = tid; i < span - 1; i += kThreads) {
    mid[i] = (edge[i] + edge[i + 1]) / T(2);
    const T d = edge[i + 1] - edge[i];
    f0i[i] = fs / (d <= T(0) ? T(1) : d);
    xmid[i] = mid[i] / fs;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    const int q = q0 + tid + i * kThreads;
    if (q >= q1) break;
    const long long g = frame_sample(q, pnum, qden);
    const int k_prev = k_prev_of(q, rk[i]);
    T f;
    bool fin[kEdges];
    if (g >= 2) {
      // the crossings before p_next = clip(g-1) are those at <= p_prev
      // (index n-1 is never a crossing): 9 consecutive ranks, whose
      // intervals the block has computed
      const int b = k_prev - kPrev - klo;
#pragma unroll
      for (int j = 0; j < kEdges; ++j) fin[j] = finite(edge[b + j]);
      f = interval_value<T>(fin, [&](int j) { return mid[b + j]; },
                            [&](int j) { return xmid[b + j]; },
                            [&](int j) { return f0i[b + j]; }, tv[i], fs);
    } else {
      // g < 2: no crossing lies before p_next = 0
      T E[kEdges], mids[kEdges - 1], xs[kEdges - 1], f0s[kEdges - 1];
#pragma unroll
      for (int j = 0; j < kPrev; ++j) E[j] = edge[k_prev - kPrev + j - klo];
#pragma unroll
      for (int j = 0; j < kNext; ++j) E[kPrev + j] = edge[j - klo];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) fin[j] = finite(E[j]);
#pragma unroll
      for (int j = 0; j < kEdges - 1; ++j) {
        mids[j] = (E[j] + E[j + 1]) / T(2);
        const T d = E[j + 1] - E[j];
        f0s[j] = fs / (d <= T(0) ? T(1) : d);
        xs[j] = mids[j] / fs;
      }
      auto at = [](const T (&a)[kEdges - 1], int j) {
        T v = a[0];
#pragma unroll
        for (int i = 1; i < kEdges - 1; ++i) v = i == j ? a[i] : v;
        return v;
      };
      f = interval_value<T>(fin, [&](int j) { return at(mids, j); },
                            [&](int j) { return at(xs, j); },
                            [&](int j) { return at(f0s, j); }, tv[i], fs);
    }
    out_f0[(size_t)row * Q + q] = f;
  }
}

template <typename T>
int launch_event_engine(const T* x, int rows, int n, const T* tq, int Q,
                        int pnum, int qden, double fs, int tile, int cap,
                        T* pos, int* rank, int* tile_count, T* out_f0,
                        int* out_m, cudaStream_t stream) {
  if (rows <= 0 || n < 2 || Q <= 0 || qden <= 0 || pnum < 0 || tile != kTile)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + kTile - 1) / kTile;
  // the last tile's crossings lie in [last0, n-1), no two adjacent
  const long long last0 = (long long)(n_tiles - 1) * kTile;
  if ((long long)(n_tiles - 1) * kTileCap + (n - 1 - last0 + 1) / 2 > cap)
    return (int)cudaErrorInvalidValue;
  // a grid's y extent: the caller splits more rows than that
  if (rows > 65535) return (int)cudaErrorInvalidConfiguration;
  // frames per pass-2 block: those spanning about kSpanSamples samples, so
  // that the block's crossings fit its shared memory
  const long long fpb_raw =
      pnum > 0 ? (long long)kSpanSamples * qden / pnum / 32 * 32 : kMaxFrames;
  const int fpb = (int)(fpb_raw < 32 ? 32 : (fpb_raw > kMaxFrames ? kMaxFrames : fpb_raw));
  // its ranks span at most ((fpb-1)*pnum/qden + 2)/2 crossings + 9 edges
  const int span_cap = (int)(((long long)(fpb - 1) * pnum / qden + 3) / 2 + 12);
  const size_t smem = 4 * sizeof(T) * (size_t)span_cap +
                      sizeof(int) * ((size_t)n_tiles + 1);
  // sized before the first pass is launched: a geometry the second pass
  // cannot hold launches nothing
  cudaError_t err = smem > INT_MAX ? cudaErrorInvalidValue
                                   : cudaFuncSetAttribute(
                                         select_intervals<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next call to read
    return (int)err;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   ((size_t)n * sizeof(T)) % 16 == 0;
  scan_crossings<T><<<dim3(n_tiles, rows), kScanThreads, 0, stream>>>(
      x, n, n_tiles, cap, Q, pnum, qden, vec, pos, rank, tile_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_intervals<T><<<dim3((Q + fpb - 1) / fpb, rows), kThreads, smem,
                        stream>>>(pos, rank, tile_count, n, n_tiles, cap, tq,
                                  Q, pnum, qden, fpb, span_cap, (T)fs, out_f0,
                                  out_m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int world_event_engine_f32(const float* x, int rows, int n,
                                      const float* tq, int Q, int pnum,
                                      int qden, double fs, int tile, int cap,
                                      float* pos, int* rank, int* tile_count,
                                      float* out_f0, int* out_m,
                                      cudaStream_t stream) {
  return launch_event_engine<float>(x, rows, n, tq, Q, pnum, qden, fs, tile,
                                    cap, pos, rank, tile_count, out_f0, out_m,
                                    stream);
}

extern "C" int world_event_engine_f64(const double* x, int rows, int n,
                                      const double* tq, int Q, int pnum,
                                      int qden, double fs, int tile, int cap,
                                      double* pos, int* rank, int* tile_count,
                                      double* out_f0, int* out_m,
                                      cudaStream_t stream) {
  return launch_event_engine<double>(x, rows, n, tq, Q, pnum, qden, fs, tile,
                                     cap, pos, rank, tile_count, out_f0, out_m,
                                     stream);
}
