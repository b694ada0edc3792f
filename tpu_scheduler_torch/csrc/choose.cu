// choose: fused feasibility + score + masked argmax for a block of pods
// against every node, for Hopper (sm_90a).
//
// Replaces: tpu_scheduler/ops/pallas_choose.py::choose_block_pallas with the
// plain kernel body _make_choose_kernel(False) — the same function as the
// jnp tree tpu_scheduler/ops/assign.py::_choose_block.  Per pod p and node n:
//   fit     exact int32 req[p,r] <= avail[n,r] for every resource column r
//   counts  sel·labels == selc, ntol·taints == 0, aff·node_aff > 0 or !has_aff
//   masks   node valid, pod active
//   score   LeastRequested + BalancedAllocation, + w3·pref, − w4·soft taints,
//           then the uint32 jitter hash and the bucket-quantized tie-break
//   argmax  masked (−inf), the LOWEST node index among equal maxima
// Outputs choice [B] i32 (0 where nothing is feasible), has [B] bool,
// best [B] f32 (−inf where nothing is feasible).
//
// What bounds it on the H100: operations.  Each (pod, node) pair costs about
// 2·(L+T+A+A2+Ts) flops of small dot products plus ~45 scalar ops (fit,
// predicates, two IEEE divisions, score, hash, quantize, compare): ~125 ops
// at the flagship widths (8 each), so one flagship block of 8192 × 10,112
// pairs is ~10 G ops against ~2 MB of operand bytes — hundreds of ops per
// byte, far above the card's ~20 flop/byte float32 ridge.
//
// Design for that bound: one thread block per tile of PODS pods, with the
// tile's pod rows staged once in shared memory (every thread of a warp reads
// the same word: broadcast, no bank conflicts).  Threads stride over the
// nodes in ascending order; each node's columns are read once per tile and
// reused for all PODS pods held in registers, so the node tensors (~1.8 MB
// at the flagship, L2-resident) are read B/PODS times from L2, never the
// [B, N] intermediates that the plain version materialises.  Each thread
// keeps a strict-'>' running best per pod; a warp-shuffle then shared-memory
// reduction on (score desc, index asc) finishes the argmax.  Nothing
// carries across blocks.  Vocabulary widths and R are runtime arguments: no
// banding, no width limit beyond the shared-memory tile (checked by the
// launcher), so every cluster takes the kernel.
//
// Bit-exactness traps (the results must equal the NumPy/XLA tree bit for bit):
// * FMA contraction: nvcc would fuse w0*lr + w1*ba and floor(s/q)*q + jw*h
//   into FMAs, which round once instead of twice.  The score arithmetic is
//   written with __fmul_rn/__fadd_rn/__fsub_rn (never contracted) and the
//   build passes -fmad=false as well.  Division is __fdiv_rn (IEEE, also
//   what -prec-div=true gives); never build with --use_fast_math.
// * Conversions: used_after can exceed 2^24, so int32 -> f32 must round to
//   nearest as numpy does: __int2float_rn.  The hash is < 2^16: exact.
// * Integer wraparound: (alloc - avail) + req wraps in int32 in numpy and
//   XLA; it is computed in uint32 here (defined wraparound) and cast back.
// * Tie-break: the JAX package found a Mosaic argmax that returned the
//   higher index on a tie.  Here each thread visits nodes in ascending order
//   and replaces its best only on a strictly greater score, and every
//   reduction step prefers the greater score, then the lower index — so the
//   result is the lowest index among equal maxima, as jnp.argmax gives.
// * Padding: pods past B in the last tile are staged as inactive (never
//   feasible) and never written; nodes past N are never visited, and invalid
//   nodes are skipped, so neither can win.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define PODS 8
#define NO_NODE 0x7fffffff

static __device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(THREADS) choose_kernel(
    const int32_t* __restrict__ req, const float* __restrict__ sel, const float* __restrict__ selc,
    const float* __restrict__ ntol, const float* __restrict__ aff, const float* __restrict__ has_aff,
    const float* __restrict__ pref_w, const float* __restrict__ ntol_soft, const bool* __restrict__ active,
    const int32_t* __restrict__ ranks, const int32_t* __restrict__ avail, const int32_t* __restrict__ alloc,
    const bool* __restrict__ valid, const float* __restrict__ labels, const float* __restrict__ taints,
    const float* __restrict__ node_aff, const float* __restrict__ node_pref, const float* __restrict__ taints_soft,
    int B, int N, int R, int L, int T, int A, int A2, int Ts, float w_lr, float w_ba, float w_jit, float w_pref,
    float w_soft, uint32_t salt, uint32_t node_offset, int32_t* __restrict__ choice, bool* __restrict__ has,
    float* __restrict__ best) {
  extern __shared__ float smem[];
  const int W = L + T + A + A2 + Ts;
  float* feat = smem;                                   // [PODS][W] pod feature rows
  int32_t* sreq = reinterpret_cast<int32_t*>(smem + PODS * W);  // [PODS][R]
  __shared__ float s_selc[PODS], s_hasaff[PODS];
  __shared__ uint32_t s_rank[PODS];
  __shared__ int s_active[PODS];
  __shared__ float red_score[WARPS][PODS];
  __shared__ int red_idx[WARPS][PODS];

  const int p0 = blockIdx.x * PODS;
  const int np = min(PODS, B - p0);

  // Stage the tile's pod rows: [sel | ntol | aff | pref_w | ntol_soft].
  for (int i = threadIdx.x; i < PODS * W; i += THREADS) {
    const int p = i / W, k = i % W;
    float v = 0.0f;
    if (p < np) {
      const size_t row = (size_t)(p0 + p);
      if (k < L) v = sel[row * L + k];
      else if (k < L + T) v = ntol[row * T + (k - L)];
      else if (k < L + T + A) v = aff[row * A + (k - L - T)];
      else if (k < L + T + A + A2) v = pref_w[row * A2 + (k - L - T - A)];
      else v = ntol_soft[row * Ts + (k - L - T - A - A2)];
    }
    feat[i] = v;
  }
  for (int i = threadIdx.x; i < PODS * R; i += THREADS) {
    const int p = i / R, r = i % R;
    sreq[i] = p < np ? req[(size_t)(p0 + p) * R + r] : 0;
  }
  if (threadIdx.x < PODS) {
    const int p = threadIdx.x;
    const bool in = p < np;
    s_selc[p] = in ? selc[p0 + p] : 0.0f;
    s_hasaff[p] = in ? has_aff[p0 + p] : 0.0f;
    s_rank[p] = in ? (uint32_t)ranks[p0 + p] : 0u;
    s_active[p] = in ? (int)active[p0 + p] : 0;  // padding pods are inactive: never feasible
  }
  __syncthreads();

  float bscore[PODS];
  int bidx[PODS];
#pragma unroll
  for (int p = 0; p < PODS; ++p) {
    bscore[p] = -INFINITY;
    bidx[p] = NO_NODE;
  }

  for (int n = threadIdx.x; n < N; n += THREADS) {  // ascending per thread
    if (!valid[n]) continue;
    const size_t nr = (size_t)n * R;
    uint32_t fit = (1u << PODS) - 1u;
    for (int r = 0; r < R; ++r) {
      const int32_t a = avail[nr + r];
#pragma unroll
      for (int p = 0; p < PODS; ++p)
        if (sreq[p * R + r] > a) fit &= ~(1u << p);
    }
    if (fit == 0u) continue;

    // Exact small-integer dot products (0/1 bitmaps, integer weights): any
    // summation order gives the same float.
    float c_sel[PODS], c_tol[PODS], c_aff[PODS], c_pref[PODS], c_soft[PODS];
#pragma unroll
    for (int p = 0; p < PODS; ++p) c_sel[p] = c_tol[p] = c_aff[p] = c_pref[p] = c_soft[p] = 0.0f;
    for (int k = 0; k < L; ++k) {
      const float v = labels[(size_t)n * L + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_sel[p] = __fadd_rn(c_sel[p], __fmul_rn(feat[p * W + k], v));
    }
    for (int k = 0; k < T; ++k) {
      const float v = taints[(size_t)n * T + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_tol[p] = __fadd_rn(c_tol[p], __fmul_rn(feat[p * W + L + k], v));
    }
    for (int k = 0; k < A; ++k) {
      const float v = node_aff[(size_t)n * A + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_aff[p] = __fadd_rn(c_aff[p], __fmul_rn(feat[p * W + L + T + k], v));
    }
    for (int k = 0; k < A2; ++k) {
      const float v = node_pref[(size_t)n * A2 + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_pref[p] = __fadd_rn(c_pref[p], __fmul_rn(feat[p * W + L + T + A + k], v));
    }
    for (int k = 0; k < Ts; ++k) {
      const float v = taints_soft[(size_t)n * Ts + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p)
        c_soft[p] = __fadd_rn(c_soft[p], __fmul_rn(feat[p * W + L + T + A + A2 + k], v));
    }

    const int32_t alloc_c = alloc[nr], alloc_m = alloc[nr + 1];
    const int32_t avail_c = avail[nr], avail_m = avail[nr + 1];
    const bool safe_c = alloc_c > 0, safe_m = alloc_m > 0;
    const float den_c = safe_c ? __int2float_rn(alloc_c) : 1.0f;
    const float den_m = safe_m ? __int2float_rn(alloc_m) : 1.0f;
    const uint32_t used_c = (uint32_t)alloc_c - (uint32_t)avail_c;
    const uint32_t used_m = (uint32_t)alloc_m - (uint32_t)avail_m;
    const uint32_t h_node = ((uint32_t)n + node_offset) * 2246822519u + salt * 3266489917u;

#pragma unroll
    for (int p = 0; p < PODS; ++p) {
      const bool ok = s_active[p] && ((fit >> p) & 1u) && c_sel[p] == s_selc[p] && c_tol[p] == 0.0f &&
                      (c_aff[p] > 0.0f || s_hasaff[p] == 0.0f);
      if (!ok) continue;
      const int32_t uc = (int32_t)(used_c + (uint32_t)sreq[p * R]);
      const int32_t um = (int32_t)(used_m + (uint32_t)sreq[p * R + 1]);
      const float fc = safe_c ? __fdiv_rn(__int2float_rn(uc), den_c) : 1.0f;
      const float fm = safe_m ? __fdiv_rn(__int2float_rn(um), den_m) : 1.0f;
      const float lr = __fmul_rn(__fadd_rn(__fsub_rn(1.0f, fc), __fsub_rn(1.0f, fm)), 50.0f);
      const float ba = __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(fc, fm))), 100.0f);
      float s = __fadd_rn(__fmul_rn(w_lr, lr), __fmul_rn(w_ba, ba));
      s = __fadd_rn(s, __fmul_rn(w_pref, c_pref[p]));
      s = __fsub_rn(s, __fmul_rn(w_soft, c_soft[p]));
      uint32_t h = s_rank[p] * 2654435761u + h_node;
      h = (h ^ (h >> 15)) & 0xFFFFu;
      const float q = w_jit > 0.0f ? __fmul_rn(floorf(__fdiv_rn(s, w_jit)), w_jit) : s;
      s = __fadd_rn(q, __fmul_rn(w_jit, __fdiv_rn(__uint2float_rn(h), 65536.0f)));
      if (s > bscore[p]) {  // strict: an equal score later in the walk never replaces
        bscore[p] = s;
        bidx[p] = n;
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < PODS; ++p) {
    float s = bscore[p];
    int i = bidx[p];
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, s, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(os, oi, s, i)) {
        s = os;
        i = oi;
      }
    }
    if (lane == 0) {
      red_score[warp][p] = s;
      red_idx[warp][p] = i;
    }
  }
  __syncthreads();
  if (threadIdx.x < PODS) {
    const int p = threadIdx.x;
    float s = -INFINITY;
    int i = NO_NODE;
    for (int w = 0; w < WARPS; ++w) {
      if (better(red_score[w][p], red_idx[w][p], s, i)) {
        s = red_score[w][p];
        i = red_idx[w][p];
      }
    }
    if (p < np) {
      const bool found = i != NO_NODE;
      choice[p0 + p] = found ? i : 0;
      has[p0 + p] = found;
      best[p0 + p] = found ? s : -INFINITY;
    }
  }
}

extern "C" {

// Shared-memory bytes one block needs for the pod tile.
static size_t tile_bytes(int R, int W) { return sizeof(float) * (size_t)PODS * ((size_t)W + (size_t)R); }

// Launches on `stream`, allocates nothing, does not synchronise.  Returns
// cudaGetLastError() after the launch (0 = launched).
int tsched_choose_launch(const void* req, const void* sel, const void* selc, const void* ntol, const void* aff,
                         const void* has_aff, const void* pref_w, const void* ntol_soft, const void* active,
                         const void* ranks, const void* avail, const void* alloc, const void* valid,
                         const void* labels, const void* taints, const void* node_aff, const void* node_pref,
                         const void* taints_soft, int B, int N, int R, int L, int T, int A, int A2, int Ts, float w_lr,
                         float w_ba, float w_jit, float w_pref, float w_soft, uint32_t salt, uint32_t node_offset,
                         void* choice, void* has, void* best, void* stream) {
  if (B <= 0) return 0;
  if (R < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_bytes(R, L + T + A + A2 + Ts);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(choose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + PODS - 1) / PODS;
  choose_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)req, (const float*)sel, (const float*)selc, (const float*)ntol, (const float*)aff,
      (const float*)has_aff, (const float*)pref_w, (const float*)ntol_soft, (const bool*)active,
      (const int32_t*)ranks, (const int32_t*)avail, (const int32_t*)alloc, (const bool*)valid,
      (const float*)labels, (const float*)taints, (const float*)node_aff, (const float*)node_pref,
      (const float*)taints_soft, B, N, R, L, T, A, A2, Ts, w_lr, w_ba, w_jit, w_pref, w_soft, salt, node_offset,
      (int32_t*)choice, (bool*)has, (float*)best);
  return (int)cudaGetLastError();
}

const char* tsched_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
