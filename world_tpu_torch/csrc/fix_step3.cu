// K4 and K5, Harvest's FixStep3: ExtendF0's chains and MergeF0's walk.
//
// The JAX package runs each as a jax.lax.scan (world_tpu/f0/harvest.py
// ::_extend_chain :499-525, vmapped over the sections at :575, and
// fix_step3's merge_body :585-631); there is no Pallas kernel.  The plain
// PyTorch twins are world_tpu_torch/ops/fix_step3.py::extend_chains_plain
// and ::merge_plain; both kernels are held bitwise to them.
//
// K4, the chains.  Every (utterance, chain) is independent: B x R chains
// (R = 2 max_sections: forward from each section's end, backward from each
// start) of n_steps SelectBestF0 picks among C candidates.  Chain (b, r)
// starts at origin o with tmp = f0[b, o], misses 0, shifted o, running;
// step k (0-based) reads position p = o + shift (k + 1) and
//   active = running && reach >= k + 1,  reach = shift (last - o) + 1
//   ref    = max(tmp, tiny)                       (NaN stays NaN)
//   err_c  = |ref - cands[b, c, clamp(p)]| / ref  (IEEE division)
//   j      = the last c of least err (a NaN counts as least, the last NaN)
//   val    = (err_j <= allowed && active) ? cand_j : 0
//   hit    = active && val != 0: tmp = val, shifted = p, misses = 0;
//            else misses += active
//   running = active && misses < 4
// and writes (p, val, active).  Only the carry is sequential: the
// positions are known before the walk.  So one warp takes a chain: its
// lanes stage the chain's n_steps x C candidates in shared memory with
// independent loads (consecutive steps are consecutive frames, forward or
// backward), then walk the carry together: at each step every lane scores
// its candidates (c = lane, lane + 32, ...) and a butterfly of shuffles
// picks the best under a total order (NaN first, then the least error,
// then the greater index), which no reduction order can change.  Every
// lane keeps the carry; lane 0 records each step, and the warp writes the
// steps out, the inactive ones too.
//
// K5, the merge.  Sequential over the sorted rows, parallel over frames:
// one block an utterance.  The carried state (the merged contour f0_m and
// its scores ss_m, cur_st, cur_ed, started) stays in device memory
// between the launches of successive section chunks; at 60 s the contour
// and its scores (480 KB in float32) do not fit shared memory, and L2
// holds them.  A step whose row is not kept is skipped by the whole block.
// A kept step touches only its intervals: the overlap [st2, cur_ed], whose
// scores s1 (contour) and s2 (row) are summed only where the step neither
// starts a section nor lies inside the last one, and the copy of the row
// and its scores over [take_lo, ed2].  The sums are float64 (the plain
// version's too): each thread sums a strided slice in order, then a fixed
// tree in shared memory, no atomics, so a replay gives the same bits.
//
// What bounds them on the H100.  Both are chains of dependent steps over
// little data: K4 reads n_steps x C candidates a chain (19 KB in float32 at
// C = 48), K5 touches each kept section's frames a few times.  Their bytes
// bounds are microseconds; the steps' latency (a shuffle tree a pick, two
// barriers a merge step) sets their time.  The design keeps every step in
// registers and shared memory and replaces ~10k small launches by 1 + the
// number of section chunks.
//
// Every operation is the plain version's, rounded once: the subtraction
// and the division are written with the _rn intrinsics (and the file is
// built with -fmad=false), and allowed_range is rounded to the working
// type, as PyTorch rounds a Python scalar against a tensor.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChainWarps = 4;       // chains a block of K4
constexpr int kMergeThreads = 512;   // threads of K5's block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }

// whether (e, j) is picked before (be, bj): a NaN error first, then the
// least error, then the greater index; j < 0 is no candidate
template <typename T>
__device__ __forceinline__ bool better(T e, int j, T be, int bj) {
  if (bj < 0) return j >= 0;
  if (j < 0) return false;
  const bool en = isnan(e), bn = isnan(be);
  if (en != bn) return en;
  if (!en && e != be) return e < be;
  return j > bj;
}

template <typename T>
__global__ void __launch_bounds__(kChainWarps * 32)
extend_chains(const T* __restrict__ f0, const long long* __restrict__ origin,
              const long long* __restrict__ last,
              const long long* __restrict__ shift, const T* __restrict__ cands,
              int R, int C, int n, int n_steps, long long chains,
              size_t warp_bytes, T allowed, long long* __restrict__ out_pos,
              T* __restrict__ out_val, uint8_t* __restrict__ out_act,
              long long* __restrict__ out_shifted) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= chains) return;  // the whole warp: no block barrier below
  T* s_cand = reinterpret_cast<T*>(smem + warp * warp_bytes);  // C x n_steps
  T* s_val = s_cand + (size_t)C * n_steps;
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_val + n_steps);

  const long long b = chain / R;
  const long long o = origin[chain], sh = shift[chain % R];
  const long long reach = sh * (last[chain] - o) + 1;
  const T* cb = cands + b * (long long)C * n;
  for (int c = 0; c < C; ++c) {
    const T* row = cb + (size_t)c * n;
    for (int k = lane; k < n_steps; k += 32) {
      long long p = o + sh * (k + 1);
      p = p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
      s_cand[(size_t)c * n_steps + k] = row[p];
    }
  }
  __syncwarp();

  // the origins are sections' ends and starts, inside the row; the read is
  // clamped all the same, so that none leaves it
  const long long oc = o < 0 ? 0 : (o > n - 1 ? n - 1 : o);
  T tmp = f0[b * n + oc];
  int misses = 0;
  long long shifted = o;
  bool running = true;
  const T tiny = tiny_of(T(0));
  for (int k = 0; k < n_steps; ++k) {
    const bool active = running && reach >= k + 1;
    const T ref = tmp < tiny ? tiny : tmp;
    T be = T(0), bv = T(0);
    int bj = -1;
    for (int c = lane; c < C; c += 32) {
      const T v = s_cand[(size_t)c * n_steps + k];
      const T e = div_rn(fabs(sub_rn(ref, v)), ref);
      if (better(e, c, be, bj)) {
        be = e;
        bj = c;
        bv = v;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T oe = __shfl_xor_sync(kFull, be, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      const T ov = __shfl_xor_sync(kFull, bv, off);
      if (better(oe, oj, be, bj)) {
        be = oe;
        bj = oj;
        bv = ov;
      }
    }
    const T val = (be <= allowed && active) ? bv : T(0);
    const bool hit = active && val != T(0);
    if (hit) {
      tmp = val;
      shifted = o + sh * (k + 1);
      misses = 0;
    } else if (active) {
      ++misses;
    }
    running = active && misses < 4;
    if (lane == 0) {
      s_val[k] = val;
      s_act[k] = active;
    }
  }
  __syncwarp();
  for (int k = lane; k < n_steps; k += 32) {
    const size_t at = (size_t)chain * n_steps + k;
    out_pos[at] = o + sh * (k + 1);
    out_val[at] = s_val[k];
    out_act[at] = s_act[k];
  }
  if (lane == 0) out_shifted[chain] = shifted;
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_sections(const T* __restrict__ rows, const T* __restrict__ ss,
               const long long* __restrict__ st, const long long* __restrict__ ed,
               const uint8_t* __restrict__ keep, int c, int n,
               T* __restrict__ f0_m, T* __restrict__ ss_m,
               long long* __restrict__ cur_st_p, long long* __restrict__ cur_ed_p,
               uint8_t* __restrict__ started_p) {
  __shared__ double red1[kMergeThreads], red2[kMergeThreads];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  rows += b * c * (size_t)n;
  ss += b * c * (size_t)n;
  st += b * c;
  ed += b * c;
  keep += b * c;
  f0_m += b * n;
  ss_m += b * n;
  long long cur_st = cur_st_p[b], cur_ed = cur_ed_p[b];
  bool started = started_p[b] != 0;
  const long long last = n - 1;

  for (int k = 0; k < c; ++k) {
    if (!keep[k]) continue;  // the same for the whole block
    const long long st2 = st[k], ed2 = ed[k];
    const bool disjoint = st2 > cur_ed;
    const bool contained = cur_st <= st2 && cur_ed >= ed2;
    const bool fresh = !started || disjoint;
    const bool extends = fresh || !contained;
    const T* row = rows + (size_t)k * n;
    const T* row_ss = ss + (size_t)k * n;
    long long take_lo = st2;
    if (!fresh && extends) {
      // MergeF0Sub: the scores of the contour and of the row over the
      // overlap [st2, cur_ed]
      const long long lo = st2 < 0 ? 0 : st2, hi = cur_ed > last ? last : cur_ed;
      double a1 = 0.0, a2 = 0.0;
      for (long long i = lo + tid; i <= hi; i += kMergeThreads) {
        a1 += (double)ss_m[i];
        a2 += (double)row_ss[i];
      }
      red1[tid] = a1;
      red2[tid] = a2;
      __syncthreads();
      for (int s = kMergeThreads / 2; s > 0; s >>= 1) {
        if (tid < s) {
          red1[tid] += red1[tid + s];
          red2[tid] += red2[tid + s];
        }
        __syncthreads();
      }
      if (red1[0] > red2[0]) take_lo = cur_ed;
      __syncthreads();  // red1[0] and red2[0] are read before they change
    }
    if (extends) {
      const long long lo = take_lo < 0 ? 0 : take_lo, hi = ed2 > last ? last : ed2;
      for (long long i = lo + tid; i <= hi; i += kMergeThreads) {
        f0_m[i] = row[i];
        ss_m[i] = row_ss[i];
      }
      __syncthreads();  // the next step's sums read ss_m
    }
    if (fresh) cur_st = st2;
    if (extends) cur_ed = ed2;
    started = true;
  }
  if (tid == 0) {
    cur_st_p[b] = cur_st;
    cur_ed_p[b] = cur_ed;
    started_p[b] = started;
  }
}

template <typename T>
int launch_extend_chains(const T* f0, const long long* origin,
                         const long long* last, const long long* shift,
                         const T* cands, int B, int R, int C, int n,
                         int n_steps, double allowed, long long* out_pos,
                         T* out_val, uint8_t* out_act, long long* out_shifted,
                         cudaStream_t stream) {
  if (B <= 0 || R <= 0 || C <= 0 || n <= 0 || n_steps <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
    return (int)err;
  // a chain's candidates, values and flags, rounded up to 16 bytes
  const size_t warp_bytes =
      (sizeof(T) * ((size_t)C + 1) * n_steps + n_steps + 15) / 16 * 16;
  int warps = kChainWarps;
  while (warps > 1 && warps * warp_bytes > (size_t)optin) --warps;
  const size_t smem = warps * warp_bytes;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(extend_chains<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next call to read
    return (int)err;
  }
  const long long chains = (long long)B * R;
  const long long blocks = (chains + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  extend_chains<T><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      f0, origin, last, shift, cands, R, C, n, n_steps, chains, warp_bytes,
      (T)allowed, out_pos, out_val, out_act, out_shifted);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge_sections(const T* rows, const T* ss, const long long* st,
                          const long long* ed, const uint8_t* keep, int B,
                          int c, int n, T* f0_m, T* ss_m, long long* cur_st,
                          long long* cur_ed, uint8_t* started,
                          cudaStream_t stream) {
  if (B <= 0 || c <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  merge_sections<T><<<B, kMergeThreads, 0, stream>>>(
      rows, ss, st, ed, keep, c, n, f0_m, ss_m, cur_st, cur_ed, started);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int world_extend_chains_f32(
    const float* f0, const long long* origin, const long long* last,
    const long long* shift, const float* cands, int B, int R, int C, int n,
    int n_steps, double allowed, long long* out_pos, float* out_val,
    uint8_t* out_act, long long* out_shifted, cudaStream_t stream) {
  return launch_extend_chains<float>(f0, origin, last, shift, cands, B, R, C, n,
                                     n_steps, allowed, out_pos, out_val,
                                     out_act, out_shifted, stream);
}

extern "C" int world_extend_chains_f64(
    const double* f0, const long long* origin, const long long* last,
    const long long* shift, const double* cands, int B, int R, int C, int n,
    int n_steps, double allowed, long long* out_pos, double* out_val,
    uint8_t* out_act, long long* out_shifted, cudaStream_t stream) {
  return launch_extend_chains<double>(f0, origin, last, shift, cands, B, R, C,
                                      n, n_steps, allowed, out_pos, out_val,
                                      out_act, out_shifted, stream);
}

extern "C" int world_merge_sections_f32(
    const float* rows, const float* ss, const long long* st,
    const long long* ed, const uint8_t* keep, int B, int c, int n, float* f0_m,
    float* ss_m, long long* cur_st, long long* cur_ed, uint8_t* started,
    cudaStream_t stream) {
  return launch_merge_sections<float>(rows, ss, st, ed, keep, B, c, n, f0_m,
                                      ss_m, cur_st, cur_ed, started, stream);
}

extern "C" int world_merge_sections_f64(
    const double* rows, const double* ss, const long long* st,
    const long long* ed, const uint8_t* keep, int B, int c, int n,
    double* f0_m, double* ss_m, long long* cur_st, long long* cur_ed,
    uint8_t* started, cudaStream_t stream) {
  return launch_merge_sections<double>(rows, ss, st, ed, keep, B, c, n, f0_m,
                                       ss_m, cur_st, cur_ed, started, stream);
}
