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
// What bounds it on the H100.  The work is a chain of dependent steps, one a
// frame, and its inputs are small: at DIO's 929 frames and 7 candidates a
// row reads 42 KB in float32, 0.013 us at 3.35 TB/s.  So the latency of the
// chain sets the time, not the bytes, and the kernel sits far from its
// bytes bound by its nature.  The design keeps that chain short: one block
// per row; its threads stage a tile of frames (base, flags, limits and the
// candidates) in shared memory with coalesced loads, one thread runs the
// chain over the tile with the carry in registers, reading shared memory
// only, and the block writes the tile back.  The candidates are searched
// only on the frames the chain extends (the gaps after a section), so a
// voiced or idle frame costs a load, two compares and a store.  Rows run on
// separate SMs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 1024;              // frames staged at once
constexpr int kMinTile = 32;
constexpr size_t kSmemBudget = 48 * 1024;   // static limit: no opt-in needed
constexpr double kF64Eps = 2.220446049250313e-16;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// select_best_f0 over the C candidates of one frame, c[k * stride]
template <typename T>
__device__ __forceinline__ T select_best(T prev1, T prev2, const T* c, int stride,
                                         int C, T allowed) {
  const T reference = div_rn(sub_rn(mul_rn(prev1, T(3)), prev2), T(2));
  T best = c[0];
  T best_err = fabs(sub_rn(reference, best));
  for (int k = 1; k < C; ++k) {
    const T v = c[k * stride];
    const T err = fabs(sub_rn(reference, v));
    if (err < best_err) {
      best_err = err;
      best = v;
    }
  }
  const T ratio = div_rn(best, add_rn(reference, T(kF64Eps)));
  return fabs(sub_rn(T(1), ratio)) <= allowed ? best : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
extension_scan(const T* __restrict__ base, const uint8_t* __restrict__ flags,
               const long long* __restrict__ limits, const T* __restrict__ cands,
               int C, int n, int tile, int backward, T allowed,
               T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_lim = reinterpret_cast<long long*>(smem);
  T* s_val = reinterpret_cast<T*>(s_lim + tile);
  T* s_cand = s_val + tile;
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_cand + (size_t)C * tile);

  const size_t row = blockIdx.x;
  base += row * n;
  flags += row * n;
  limits += row * n;
  out += row * n;
  cands += row * (size_t)C * n;

  // the carry, in thread 0's registers across the tiles
  T prev1 = T(0), prev2 = T(0);
  bool active = false;
  long long limit = 0;

  const int n_tiles = (n + tile - 1) / tile;
  for (int k = 0; k < n_tiles; ++k) {
    const int lo = (backward ? n_tiles - 1 - k : k) * tile;
    const int len = min(tile, n - lo);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      s_val[j] = base[lo + j];
      s_lim[j] = limits[lo + j];
      s_flag[j] = flags[lo + j];
    }
    for (int c = 0; c < C; ++c)
      for (int j = threadIdx.x; j < len; j += blockDim.x)
        s_cand[c * tile + j] = cands[(size_t)c * n + lo + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < len; ++s) {
        const int j = backward ? len - 1 - s : s;
        const long long p = lo + j;
        const bool in_ext =
            active && (backward ? p >= limit - 1 : p <= limit);
        T val = s_val[j];
        active = false;
        if (in_ext) {
          val = select_best(prev1, prev2, s_cand + j, tile, C, allowed);
          active = val != T(0);
        }
        if (s_flag[j]) {
          active = true;
          limit = s_lim[j];
        }
        prev2 = prev1;
        prev1 = val;
        s_val[j] = val;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) out[lo + j] = s_val[j];
    __syncthreads();  // the next tile overwrites shared memory
  }
}

// frames a block stages at once: as many as fit kSmemBudget, a multiple of
// 32, at most kMaxTile; 0 where not even kMinTile fit
template <typename T>
int tile_frames(int C) {
  const size_t per_frame = sizeof(long long) + sizeof(T) * (size_t)(C + 1) + 1;
  size_t t = kSmemBudget / per_frame / 32 * 32;
  if (t > (size_t)kMaxTile) t = kMaxTile;
  return t < (size_t)kMinTile ? 0 : (int)t;
}

template <typename T>
int launch_extension_scan(const T* base, const uint8_t* flags,
                          const long long* limits, const T* cands, int rows,
                          int C, int n, int backward, double allowed, T* out,
                          cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int tile = tile_frames<T>(C);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (sizeof(long long) + sizeof(T) * (size_t)(C + 1) + 1) * (size_t)tile;
  extension_scan<T><<<rows, kThreads, smem, stream>>>(
      base, flags, limits, cands, C, n, tile, backward, (T)allowed, out);
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
