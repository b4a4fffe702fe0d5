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
// lanes stage the chain's n_steps x C candidates in shared memory, a batch
// of kStageBatch independent loads a lane at a time, then walk the carry
// together.  At each step every lane scores its candidates (c = lane, lane
// + 32, ...) and keeps its own best; the warp's pick is a total order (NaN
// first, then the least error, then the greater index), which no reduction
// order can change.  In float32 it is two warp reductions: __reduce_min_sync
// of an ordered key of the error (a NaN 0, any other error its bits + 1:
// the bits of a non-negative float order as unsigned integers), then
// __reduce_max_sync of the index over the lanes that hold that key; the
// value is read back from shared memory and the error from the key.
// redux.sync is 32-bit only, so float64 keeps a butterfly of shuffles under
// the same order.  Every lane keeps the carry; lane 0 records each step, and
// the warp writes the steps out, the inactive ones too.  What is left of a
// pick's time is its latency: the IEEE division (about half of it on the
// x16 operands, by kernel_variants.py) and the two reductions.
//
// K5, the merge.  Sequential over the merge's steps, parallel over frames:
// one block an utterance, one launch for the whole merge.  It reads no
// precomputed section row and no score.  Step k merges section s =
// order[k], whose row is rebuilt at a frame i only where the step needs
// it: f0[i] inside [starts[s], ends[s]], else the forward chain's value
// val[s, i - ends[s] - 1] or the backward chain's val[S + s, starts[s] - i
// - 1] where that step is one of the chain's and active, else 0.  The steps'
// sections and bounds are staged in shared memory a tile at a time; the
// walk stops at the first step that is not kept (the order puts the kept
// ones first).  A kept step touches only its intervals: over the overlap
// [st2, cur_ed] MergeF0Sub sums SerachScore of the contour and of the row
// (max over c of (cands[c, i] == v ? scores[c, i] : 0), NaN propagating
// as torch.amax) where the step neither starts a section nor lies inside
// the last one, and the row is copied over [take_lo, ed2].
//
// The sums are the step's cost: C candidates and scores a frame.  Only the
// frames where the row and the contour differ are scored (where the values
// are equal, so are their scores, and they add the same to both sums; on
// the 60 s glide most overlap frames agree), kFrameLanes frames a warp,
// a frame's candidates over two lanes, all of a lane's loads issued before
// its comparisons.  The sums are float64 (the plain version's too): each
// lane sums its frames in order, then an xor-shuffle tree in the warp and
// one in a warp over the block's warps, so every lane holds the same bits;
// no atomics, so a replay gives the same bits.  Float32 scores summed in
// float64 give the plain version's decision but for ties closer than
// float64's rounding (ROADMAP, "kept on purpose").  Two barriers a deciding
// step (after the warps' sums and after the copy), one a step that only
// copies.  The merged contour stays in device memory (at 60 s, 240 KB in
// float32; L2 holds it, and one utterance's candidates and scores, 11.5 MB
// each).  The carried state (f0_m, cur_st, cur_ed, started) is read and
// written back, so a range of steps may be merged a launch.
//
// What bounds them on the H100.  Both are chains of dependent steps over
// little data: K4 reads n_steps x C candidates a chain (19 KB in float32 at
// C = 48), K5 touches each kept section's frames a few times and the
// candidates of each frame it scores once.  Their bytes bounds are
// microseconds; the steps' latency (a pick's division and warp reductions,
// a merge step's loads and barriers) sets their time.
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
constexpr int kMergeWarps = kMergeThreads / 32;  // a power of 2, <= 32
constexpr int kStepTile = kMergeThreads;  // merge steps staged at a time
// K5 scores kFrameLanes frames a warp at once, each frame's candidates split
// over the kCandGroups lanes that share it, kCandsPerLane loads a lane in one
// batch (C = 48 in one round of loads)
constexpr int kFrameLanes = 16;
constexpr int kCandGroups = 32 / kFrameLanes;
constexpr int kCandsPerLane = 24;
constexpr int kPassFrames = kMergeWarps * kFrameLanes;
// K4 stages a chain's candidates kStageBatch loads a lane at a time
constexpr int kStageBatch = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }

// whether (e, j) is picked before (be, bj): a NaN error first, then the
// least error, then the greater index; j < 0 is no candidate
__device__ __forceinline__ bool better(double e, int j, double be, int bj) {
  if (bj < 0) return j >= 0;
  if (j < 0) return false;
  const bool en = isnan(e), bn = isnan(be);
  if (en != bn) return en;
  if (!en && e != be) return e < be;
  return j > bj;
}

// One SelectBestF0 pick of a chain at step k: the value of the warp's best
// candidate where its error is at most allowed, else 0.  Lane l scores
// candidates l, l + 32, ...; s_cand is the chain's C x n_steps candidates.
// float32: the order above as two warp reductions of 32-bit keys.  An
// error is never negative (|x| / ref, ref > 0, or NaN), so its bits + 1
// order it, and a NaN takes key 0; a lane with no candidate holds the
// greatest key.  The least key's error is its bits - 1 (key 0 gives the
// bits of a NaN, which the test refuses, as PyTorch's comparison does).
__device__ __forceinline__ float pick(const float* s_cand, int C, int n_steps,
                                      int k, int lane, float ref,
                                      float allowed) {
  unsigned bkey = kFull;
  int bj = -1;
  for (int c = lane; c < C; c += 32) {
    const float e = div_rn(fabsf(sub_rn(ref, s_cand[(size_t)c * n_steps + k])), ref);
    const unsigned key = isnan(e) ? 0u : __float_as_uint(e) + 1u;
    if (key <= bkey) {  // candidates ascend: the last of equal keys
      bkey = key;
      bj = c;
    }
  }
  const unsigned kmin = __reduce_min_sync(kFull, bkey);
  const int j = __reduce_max_sync(kFull, bkey == kmin ? bj : -1);
  return __uint_as_float(kmin - 1u) <= allowed ? s_cand[(size_t)j * n_steps + k]
                                               : 0.0f;
}

// float64: a butterfly of shuffles under the same total order
__device__ __forceinline__ double pick(const double* s_cand, int C,
                                       int n_steps, int k, int lane,
                                       double ref, double allowed) {
  double be = 0.0, bv = 0.0;
  int bj = -1;
  for (int c = lane; c < C; c += 32) {
    const double v = s_cand[(size_t)c * n_steps + k];
    const double e = div_rn(fabs(sub_rn(ref, v)), ref);
    if (better(e, c, be, bj)) {
      be = e;
      bj = c;
      bv = v;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double oe = __shfl_xor_sync(kFull, be, off);
    const int oj = __shfl_xor_sync(kFull, bj, off);
    const double ov = __shfl_xor_sync(kFull, bv, off);
    if (better(oe, oj, be, bj)) {
      be = oe;
      bj = oj;
      bv = ov;
    }
  }
  return be <= allowed ? bv : 0.0;
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
  // a batch of independent loads a lane, then their stores
  const int total = C * n_steps;
  for (int base = lane; base < total; base += 32 * kStageBatch) {
    T got[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int at = min(base + 32 * u, total - 1);
      const int c = at / n_steps, k = at - c * n_steps;
      long long p = o + sh * (k + 1);
      p = p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
      got[u] = cb[(size_t)c * n + p];
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (base + 32 * u < total) s_cand[base + 32 * u] = got[u];
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
    const T picked = pick(s_cand, C, n_steps, k, lane, ref, allowed);
    const T val = active ? picked : T(0);
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

// the value of section s's extended row at frame i (inside the row): f0
// inside the section [sst, sed], else the forward chain's step i - sed - 1
// or the backward chain's step sst - i - 1 where it is one of the chain's
// and active, else 0.  All five reads are made (at clamped steps), so that
// they are in flight together.
template <typename T>
__device__ __forceinline__ T row_value(long long i, const T* __restrict__ f0,
                                       long long sst, long long sed,
                                       const T* __restrict__ vf,
                                       const uint8_t* __restrict__ af,
                                       const T* __restrict__ vb,
                                       const uint8_t* __restrict__ ab,
                                       int n_steps) {
  const long long kf = i - sed - 1, kb = sst - i - 1;
  const bool in_f = kf >= 0 && kf < n_steps, in_b = kb >= 0 && kb < n_steps;
  const int jf = in_f ? (int)kf : 0, jb = in_b ? (int)kb : 0;
  const T x = f0[i], v_f = vf[jf], v_b = vb[jb];
  const bool a_f = af[jf] != 0, a_b = ab[jb] != 0;
  if (i >= sst && i <= sed) return x;
  if (in_f) return a_f ? v_f : T(0);
  return in_b && a_b ? v_b : T(0);
}

// SerachScore's running max, torch.amax's: x where it is greater or a NaN
// (a NaN stays); in any order the same but for the sign of a zero
template <typename T>
__device__ __forceinline__ T score_max(T acc, T x) {
  return (x > acc || isnan(x)) ? x : acc;
}

// The row's values over the frames [lo, hi] (inside the row) into the
// contour, then a block barrier: the next step's sums read it.
template <typename T>
__device__ __forceinline__ void copy_row(T* f0_m, long long lo, long long hi,
                                         int tid, const T* __restrict__ f0,
                                         long long sst, long long sed,
                                         const T* __restrict__ vf,
                                         const uint8_t* __restrict__ af,
                                         const T* __restrict__ vb,
                                         const uint8_t* __restrict__ ab,
                                         int n_steps) {
  for (long long i = lo + tid; i <= hi; i += kMergeThreads)
    f0_m[i] = row_value(i, f0, sst, sed, vf, af, vb, ab, n_steps);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_sections(const T* __restrict__ f0, const T* __restrict__ cands,
               const T* __restrict__ scores,
               const long long* __restrict__ starts,
               const long long* __restrict__ ends, const T* __restrict__ val,
               const uint8_t* __restrict__ act,
               const long long* __restrict__ order,
               const long long* __restrict__ st_o,
               const long long* __restrict__ ed_o,
               const uint8_t* __restrict__ keep_o, int C, int n, int S,
               int n_steps, int c, T* f0_m, long long* __restrict__ cur_st_p,
               long long* __restrict__ cur_ed_p,
               uint8_t* __restrict__ started_p) {
  __shared__ long long s_st[kStepTile], s_ed[kStepTile], s_sst[kStepTile],
      s_sed[kStepTile];
  __shared__ int s_sec[kStepTile];
  __shared__ uint8_t s_keep[kStepTile];
  __shared__ double red[2][kMergeWarps];  // the warps' sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fl = lane % kFrameLanes, g = lane / kFrameLanes;
  const size_t b = blockIdx.x;
  f0 += b * n;
  cands += b * C * (size_t)n;
  scores += b * C * (size_t)n;
  starts += b * S;
  ends += b * S;
  val += b * 2 * S * (size_t)n_steps;
  act += b * 2 * S * (size_t)n_steps;
  order += b * c;
  st_o += b * c;
  ed_o += b * c;
  keep_o += b * c;
  f0_m += b * n;
  long long cur_st = cur_st_p[b], cur_ed = cur_ed_p[b];
  bool started = started_p[b] != 0;
  const long long last = n - 1;

  bool done = false;
  for (int t0 = 0; t0 < c && !done; t0 += kStepTile) {
    const int m = min(kStepTile, c - t0);
    __syncthreads();  // the last tile's steps are read
    if (tid < m) {
      const int k = t0 + tid;
      s_keep[tid] = keep_o[k];
      if (keep_o[k]) {
        const long long sec = order[k];
        s_sec[tid] = (int)sec;
        s_st[tid] = st_o[k];
        s_ed[tid] = ed_o[k];
        s_sst[tid] = starts[sec];
        s_sed[tid] = ends[sec];
      }
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      if (!s_keep[j]) {  // the same for the whole block: the kept steps end
        done = true;
        break;
      }
      const long long st2 = s_st[j], ed2 = s_ed[j];
      const bool disjoint = st2 > cur_ed;
      const bool contained = cur_st <= st2 && cur_ed >= ed2;
      const bool fresh = !started || disjoint;
      const bool extends = fresh || !contained;
      if (extends) {
        const int sec = s_sec[j];
        const long long sst = s_sst[j], sed = s_sed[j];
        const T* vf = val + (size_t)sec * n_steps;
        const uint8_t* af = act + (size_t)sec * n_steps;
        const T* vb = val + (size_t)(S + sec) * n_steps;
        const uint8_t* ab = act + (size_t)(S + sec) * n_steps;
        const long long lo = st2 < 0 ? 0 : st2, hi_row = ed2 > last ? last : ed2;
        if (fresh) {
          copy_row(f0_m, lo, hi_row, tid, f0, sst, sed, vf, af, vb, ab, n_steps);
        } else {
          // MergeF0Sub: the row is taken from its start or from the
          // contour's end, by the greater score over the overlap
          const long long hi = cur_ed > last ? last : cur_ed;
          // SerachScore of the contour and of the row summed over the
          // overlap [st2, cur_ed], where they differ (where they agree,
          // equal scores add the same to both sums).  Frame i is scored by
          // lanes i % kFrameLanes + kFrameLanes g of warp (i / kFrameLanes)
          // % kMergeWarps, candidates g, g + kCandGroups, ...; the frame's
          // lanes take the max of their maxima and lane g = 0 adds it.
          double a1 = 0.0, a2 = 0.0;
          for (long long base = lo - lo % kPassFrames; base <= hi; base += kPassFrames) {
            const long long i0 = base + warp * kFrameLanes + fl;
            const bool live = i0 >= lo && i0 <= hi;
            if (!__any_sync(kFull, live)) continue;  // the whole warp
            const long long i = live ? i0 : lo;
            const T vm = f0_m[i];
            const T vr = row_value(i, f0, sst, sed, vf, af, vb, ab, n_steps);
            const bool scored = live && !(vm == vr);
            T m1 = T(0), m2 = T(0);
            for (int q0 = g; q0 < C && scored; q0 += kCandGroups * kCandsPerLane) {
              T cv[kCandsPerLane], sv[kCandsPerLane];
#pragma unroll
              for (int u = 0; u < kCandsPerLane; ++u) {
                const int q = min(q0 + u * kCandGroups, C - 1);
                cv[u] = cands[(size_t)q * n + i];
                sv[u] = scores[(size_t)q * n + i];
              }
#pragma unroll
              for (int u = 0; u < kCandsPerLane; ++u) {
                const bool ok = q0 + u * kCandGroups < C;
                m1 = score_max(m1, ok && cv[u] == vm ? sv[u] : T(0));
                m2 = score_max(m2, ok && cv[u] == vr ? sv[u] : T(0));
              }
            }
            for (int off = kFrameLanes; off < 32; off <<= 1) {
              m1 = score_max(m1, __shfl_xor_sync(kFull, m1, off));
              m2 = score_max(m2, __shfl_xor_sync(kFull, m2, off));
            }
            if (g == 0 && scored) {
              a1 += (double)m1;
              a2 += (double)m2;
            }
          }
          // an xor butterfly: each pair adds the same two terms, so every
          // lane ends with the same bits; then the block's warps the same
          // way (the copy's barrier parts one step's reads of red from the
          // next step's writes)
          for (int off = 16; off > 0; off >>= 1) {
            a1 += __shfl_xor_sync(kFull, a1, off);
            a2 += __shfl_xor_sync(kFull, a2, off);
          }
          if (lane == 0) {
            red[0][warp] = a1;
            red[1][warp] = a2;
          }
          __syncthreads();
          double s1 = red[0][lane % kMergeWarps], s2 = red[1][lane % kMergeWarps];
          for (int off = kMergeWarps / 2; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(kFull, s1, off);
            s2 += __shfl_xor_sync(kFull, s2, off);
          }
          const long long take_lo = s1 > s2 ? cur_ed : st2;
          copy_row(f0_m, take_lo < 0 ? 0 : take_lo, hi_row, tid, f0, sst, sed, vf,
                   af, vb, ab, n_steps);
        }
      }
      if (fresh) cur_st = st2;
      if (extends) cur_ed = ed2;
      started = true;
    }
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
int launch_merge_sections(const T* f0, const T* cands, const T* scores,
                          const long long* starts, const long long* ends,
                          const T* val, const uint8_t* act,
                          const long long* order, const long long* st_o,
                          const long long* ed_o, const uint8_t* keep_o, int B,
                          int C, int n, int S, int n_steps, int c, T* f0_m,
                          long long* cur_st, long long* cur_ed,
                          uint8_t* started, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || n <= 0 || S <= 0 || n_steps <= 0 || c <= 0)
    return (int)cudaErrorInvalidValue;
  merge_sections<T><<<B, kMergeThreads, 0, stream>>>(
      f0, cands, scores, starts, ends, val, act, order, st_o, ed_o, keep_o, C,
      n, S, n_steps, c, f0_m, cur_st, cur_ed, started);
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
    const float* f0, const float* cands, const float* scores, const long long* starts,
    const long long* ends, const float* val, const uint8_t* act,
    const long long* order, const long long* st_o, const long long* ed_o,
    const uint8_t* keep_o, int B, int C, int n, int S, int n_steps, int c,
    float* f0_m, long long* cur_st, long long* cur_ed, uint8_t* started,
    cudaStream_t stream) {
  return launch_merge_sections<float>(f0, cands, scores, starts, ends, val, act,
                                    order, st_o, ed_o, keep_o, B, C, n, S,
                                    n_steps, c, f0_m, cur_st, cur_ed, started,
                                    stream);
}

extern "C" int world_merge_sections_f64(
    const double* f0, const double* cands, const double* scores, const long long* starts,
    const long long* ends, const double* val, const uint8_t* act,
    const long long* order, const long long* st_o, const long long* ed_o,
    const uint8_t* keep_o, int B, int C, int n, int S, int n_steps, int c,
    double* f0_m, long long* cur_st, long long* cur_ed, uint8_t* started,
    cudaStream_t stream) {
  return launch_merge_sections<double>(f0, cands, scores, starts, ends, val, act,
                                    order, st_o, ed_o, keep_o, B, C, n, S,
                                    n_steps, c, f0_m, cur_st, cur_ed, started,
                                    stream);
}
