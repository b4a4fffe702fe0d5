// K1, the zero-crossing event engine of Harvest (and later DIO).
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
// Design.  The TPU kernel builds 9 dense running max/min chains per row and
// samples them with a one-hot matmul; none of that is needed here.
//   1. compact_crossings: one block per row streams the row once, marks the
//      crossings, and compacts their sample indices in order with a warp
//      ballot + block prefix sum into a per-row scratch (sized n: noise rows
//      cross at almost every other sample).
//   2. select_intervals: one thread per (row, frame) binary-searches the
//      row's crossing list for its 4 previous / 5 next edges, recomputes their
//      sub-sample positions from x, and runs interval_select's arithmetic
//      unchanged, with +-inf for missing edges.
// Bound: about 4 bytes read per input sample in pass 1 plus a few scattered
// reads per frame in pass 2 — device-memory bandwidth at these sizes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPrev = 4;
constexpr int kNext = 5;
constexpr int kEdges = kPrev + kNext;
constexpr int kCompactThreads = 1024;

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

template <typename T>
__device__ __forceinline__ T edge_position(const T* row, int i) {
  T x = row[i];
  T den = row[i + 1] - x;
  return T(i + 1) - x / (den == T(0) ? T(1) : den);
}

template <typename T>
__global__ void compact_crossings(const T* __restrict__ x, int n,
                                  int* __restrict__ idx,
                                  int* __restrict__ count) {
  __shared__ int warp_tot[kCompactThreads / 32];
  __shared__ int running;
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * n;
  int* ir = idx + (size_t)row * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) running = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    // the last sample pairs with itself (x_next = x): never a crossing
    const bool flag = (i < n - 1) && is_crossing(xr[i], xr[i + 1]);
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    const int lane_off = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int v = lane < n_warps ? warp_tot[lane] : 0;
      // inclusive scan over the warp totals
      for (int s = 1; s < 32; s <<= 1) {
        int u = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v += u;
      }
      if (lane < n_warps) warp_tot[lane] = v;
    }
    __syncthreads();
    const int warp_off = warp == 0 ? 0 : warp_tot[warp - 1];
    if (flag) ir[running + warp_off + lane_off] = i;
    __syncthreads();
    if (threadIdx.x == 0) running += warp_tot[n_warps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) count[row] = running;
}

// number of entries of a[0:len] that are <= v (a ascending)
__device__ __forceinline__ int count_le(const int* a, int len, int v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// number of entries of a[0:len] that are < v (a ascending)
__device__ __forceinline__ int count_lt(const int* a, int len, int v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ T pick(const T* arr, int j) {
  // interval_select's sel(): index j, or entry 0 when j matches none
  return (j >= 0 && j < kEdges - 1) ? arr[j] : arr[0];
}

template <typename T>
__global__ void select_intervals(const T* __restrict__ x, int n,
                                 const int* __restrict__ idx,
                                 const int* __restrict__ count,
                                 const T* __restrict__ tq, int Q, int pnum,
                                 int qden, T fs, T* __restrict__ out_f0) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (q >= Q) return;
  const T* xr = x + (size_t)row * n;
  const int* ir = idx + (size_t)row * n;
  const int cnt = count[row];
  const T inf = T(INFINITY);

  const long long g = ((long long)q * pnum) / qden;
  const long long last = n - 1;
  const int p_prev = (int)(g - 2 < 0 ? 0 : (g - 2 > last ? last : g - 2));
  const int p_next = (int)(g - 1 < 0 ? 0 : (g - 1 > last ? last : g - 1));
  const int k_prev = count_le(ir, cnt, p_prev);   // crossings at <= p_prev
  const int k_next = count_lt(ir, cnt, p_next);   // crossings before p_next

  T E[kEdges];
#pragma unroll
  for (int j = 0; j < kPrev; ++j) {               // ascending: P4 .. P1
    const int k = k_prev - kPrev + j;
    E[j] = k >= 0 ? edge_position(xr, ir[k]) : -inf;
  }
#pragma unroll
  for (int j = 0; j < kNext; ++j) {               // N1 .. N5
    const int k = k_next + j;
    E[kPrev + j] = k < cnt ? edge_position(xr, ir[k]) : inf;
  }

  // interval_select (world_tpu/f0/events.py:137-170), same operation order
  const T t = tq[q];
  const T Tq = t * fs;
  T mids[kEdges - 1], f0s[kEdges - 1];
  bool mid_valid[kEdges - 1];
  int left_invalid = 0, v_count = 0, raw_cnt = 0;
#pragma unroll
  for (int j = 0; j < kPrev; ++j) left_invalid += finite(E[j]) ? 0 : 1;
#pragma unroll
  for (int j = 0; j < kEdges - 1; ++j) {
    mids[j] = (E[j] + E[j + 1]) / T(2);
    const T d = E[j + 1] - E[j];
    f0s[j] = fs / (d <= T(0) ? T(1) : d);
    mid_valid[j] = finite(E[j]) && finite(E[j + 1]);
    v_count += mid_valid[j] ? 1 : 0;
    raw_cnt += (mid_valid[j] && mids[j] <= Tq) ? 1 : 0;
  }
  raw_cnt += left_invalid;
  const int hi_v = left_invalid + max(v_count, 2) - 1;
  const int j = min(max(raw_cnt - 1, left_invalid), hi_v - 1);
  const T x0 = pick(mids, j) / fs;
  const T x1 = pick(mids, j + 1) / fs;
  const T y0 = pick(f0s, j);
  const T y1 = pick(f0s, j + 1);
  const T dx = x1 - x0;
  out_f0[(size_t)row * Q + q] = y0 + (y1 - y0) / (dx == T(0) ? T(1) : dx) * (t - x0);
}

__global__ void interval_counts(const int* __restrict__ count, int rows,
                                int* __restrict__ out_m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) out_m[r] = max(count[r] - 1, 0);
}

template <typename T>
int launch_event_engine(const T* x, int rows, int n, const T* tq, int Q,
                        int pnum, int qden, double fs, int* scratch_idx,
                        int* count, T* out_f0, int* out_m,
                        cudaStream_t stream) {
  if (rows <= 0 || n < 2 || Q <= 0) return (int)cudaErrorInvalidValue;
  compact_crossings<T><<<rows, kCompactThreads, 0, stream>>>(x, n, scratch_idx,
                                                            count);
  dim3 grid((Q + 255) / 256, rows);
  select_intervals<T><<<grid, 256, 0, stream>>>(x, n, scratch_idx, count, tq,
                                                Q, pnum, qden, (T)fs, out_f0);
  interval_counts<<<(rows + 255) / 256, 256, 0, stream>>>(count, rows,
                                                             out_m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int world_event_engine_f32(const float* x, int rows, int n,
                                      const float* tq, int Q, int pnum,
                                      int qden, double fs, int* scratch_idx,
                                      int* count, float* out_f0, int* out_m,
                                      cudaStream_t stream) {
  return launch_event_engine<float>(x, rows, n, tq, Q, pnum, qden, fs,
                                    scratch_idx, count, out_f0, out_m, stream);
}

extern "C" int world_event_engine_f64(const double* x, int rows, int n,
                                      const double* tq, int Q, int pnum,
                                      int qden, double fs, int* scratch_idx,
                                      int* count, double* out_f0, int* out_m,
                                      cudaStream_t stream) {
  return launch_event_engine<double>(x, rows, n, tq, Q, pnum, qden, fs,
                                     scratch_idx, count, out_f0, out_m, stream);
}
