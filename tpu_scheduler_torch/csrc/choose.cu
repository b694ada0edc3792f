// choose: fused feasibility + score + masked argmax for a block of pods
// against every node, for Hopper (sm_90a).  One template, two kernels:
//
// choose_kernel<false> replaces tpu_scheduler/ops/pallas_choose.py::
// choose_block_pallas with the plain kernel body _make_choose_kernel(False)
// — the same function as the jnp tree tpu_scheduler/ops/assign.py::
// _choose_block.  Per pod p and node n:
//   fit     exact int32 req[p,r] <= avail[n,r] for every resource column r
//   counts  sel·labels == selc, ntol·taints == 0, aff·node_aff > 0 or !has_aff
//   masks   node valid, pod active
//   score   LeastRequested + BalancedAllocation, + w3·pref, − w4·soft taints,
//           then the uint32 jitter hash and the bucket-quantized tie-break
//   argmax  masked (−inf), the LOWEST node index among equal maxima
// Outputs choice [B] i32 (0 where nothing is feasible), has [B] bool,
// best [B] f32 (−inf where nothing is feasible).
//
// choose_kernel<true> replaces _make_choose_kernel(True), the constrained
// variant (pallas_choose.py:172-351, operands :117-169), the choose of one
// round of a constrained cycle.  Beyond the above:
//   block   a node is infeasible for p when Σ_k blk_pod[p,k]·blk_node[k,n] > 0
//           over the band [aa carries | aa matched | spread declares |
//           gated positive affinity] × [aa_m; aa_c; sp; pa_unmatched]; every
//           operand is 0/1, so the sum is exact in any order
//   score   after the jitter, in this order: − w5·(sps_pod·sps_node),
//           − (2·w2)·(spd_pod·spl_node), + ppaw_pod·ppa_node
// Both instances also serve kernel #2b, the per-shard choose of the sharded
// cycle (tpu_scheduler/parallel/sharded.py:261-270, choose_block_pallas with
// node_offset and return_best): node_offset is the global index of node 0
// of a tp shard's node slice, and the jitter hash reads n + node_offset
// (uint32), so every shard scores as the unsharded launch does; choice stays
// local to the slice and best is the cross-shard merge operand.
// Node-side constraint operands are [W, N] (as round_blocked_masks makes
// them): threads striding over n read them coalesced.  A feature absent
// from the cycle has width 0 and its loop never runs (no term is added).
//
// What bounded the constrained instance, and what the live lists do about
// it: walking every row of the four node operands (440 at the flagship
// widths Wb=224, Ss=S=104, Tp=8) per node visited cost one dependent L2
// load and a data-dependent branch each, ~18 GB of L2 traffic per flagship
// launch, eight times kernel #1's whole time.  The pod side is what is
// sparse: an 8-pod tile's active pods use ~12 of the 440 columns (p99 18).
// So after staging, one warp per operand builds the tile's ascending list
// of LIVE columns — those where some ACTIVE pod of the tile has a non-zero
// pod value — in shared memory (__ballot_sync, the write position from
// __popc of the lower lanes), and the node walk loops over those lists
// only: one coalesced load of node[k·N + n] per live k, reused for the 8
// pods, with a loop bound that is the same for every thread of the block
// and no per-element branch.  The pod rows of all nine operands and the
// lists stay in shared memory (8 pods × ~483 words + 440 list words ≈
// 17 KB at the flagship).  A tile whose active pods use every column walks
// full-width lists, as the earlier kernel did, less the branch.  What
// bounds the constrained instance now is what bounds the plain one (below):
// operations per pair, plus 2 flops per pod for each live column of the
// node visited (~12 · 16 per node at the flagship, against ~1,000 ops of
// base work for the tile's 8 pairs).
//
// Every instance reads the tile's 8 active flags first and returns at once
// from a tile with no active pod (the padding and the tail rounds of the
// sharded cycle, which launches over all rows): it writes (0, false, −inf)
// and reads nothing more.  In a tile with an active pod, only the active
// pods' rows are read; the others are staged as zeros (never feasible).
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
//   feasible, zero rows) and never written; nodes past N are never visited, and invalid
//   nodes are skipped, so neither can win.
// * Exact sums in the constrained terms: every product is an integer and
//   every partial sum stays below 2^24 in the workloads this serves (0/1
//   bitmaps against domain counts; |w| ≤ 100 preferred weights), so any
//   summation order gives the same float; 2·w2 is one float product formed
//   first, as the reference tree does.
// * Live columns are exact: a column outside a tile's list has a zero pod
//   value for every active pod, so its products are ±0 and any subset of
//   columns that holds every non-zero product gives the same float.  The
//   lists are built from ACTIVE pods only (an inactive pod's row is staged
//   as zeros): its `ok` bit is 0 from the start, so its sums are never
//   read, and it still gets (0, false, −inf).
// * The sign of zero: a negative preferred weight against a zero count is
//   −0.0; every sum starts at +0.0 and +0.0 + −0.0 = +0.0, so summing or
//   skipping such a product (no per-element branch now) gives equal bits.
// * Feature presence is keyed on the operand WIDTHS (Ss > 0, Tp > 0; the
//   level term always), never on a tile's live count: the plain version
//   adds a term iff the feature is in the cycle, and skipping a +0.0 term
//   could turn a −0.0 score into another bit pattern.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define PODS 8
#define NO_NODE 0x7fffffff
// Returned by a launcher (never by CUDA) when the pod tile needs more shared
// memory than the device grants one block.
#define TSCHED_ERR_SMEM 100001

static __device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Stage the tile's rows of a [B, width] operand into the shared pod rows
// (row stride `stride`, column offset `off`): an active pod's row is read,
// an inactive or padding pod gets zeros without a read.
static __device__ __forceinline__ void stage(float* feat, int stride, int off, const float* __restrict__ src,
                                             int width, int p0, const int* s_active) {
  for (int i = threadIdx.x; i < PODS * width; i += THREADS) {
    const int p = i / width, k = i % width;
    feat[p * stride + off + k] = s_active[p] ? src[(size_t)(p0 + p) * width + k] : 0.0f;
  }
}

// The tile's live columns of one pod operand (columns [off, off + width) of
// the shared pod rows): the ascending k where some active pod has a
// non-zero value (inactive pods' rows are staged as zeros), written to
// list[0, *len).  Run by one whole warp: the trip count is the same for all
// 32 lanes, so the ballot sees every lane.
static __device__ __forceinline__ void build_live(int* list, int* len, const float* feat, int stride, int off,
                                                  int width) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  int count = 0;
  for (int base = 0; base < width; base += 32) {
    const int k = base + lane;
    bool live = false;
    if (k < width) {
#pragma unroll
      for (int p = 0; p < PODS; ++p) live |= feat[p * stride + off + k] != 0.0f;
    }
    const uint32_t mask = __ballot_sync(0xffffffffu, live);
    if (live) list[count + __popc(mask & below)] = k;
    count += __popc(mask);
  }
  if (lane == 0) *len = count;
}

// c[p] += Σ_{k in live} feat[p][off + k] · node[k·N + n] for a [K, N] node
// operand, over the tile's live columns only.
static __device__ __forceinline__ void dot_live(float* c, const float* feat, int stride, int off,
                                                const float* __restrict__ node, const int* live, int nlive, int N,
                                                int n) {
  for (int i = 0; i < nlive; ++i) {
    const int k = live[i];
    const float v = node[(size_t)k * N + n];
#pragma unroll
    for (int p = 0; p < PODS; ++p) c[p] = __fadd_rn(c[p], __fmul_rn(feat[p * stride + off + k], v));
  }
}

template <bool CONSTRAINED>
__global__ void __launch_bounds__(THREADS) choose_kernel(
    const int32_t* __restrict__ req, const float* __restrict__ sel, const float* __restrict__ selc,
    const float* __restrict__ ntol, const float* __restrict__ aff, const float* __restrict__ has_aff,
    const float* __restrict__ pref_w, const float* __restrict__ ntol_soft, const bool* __restrict__ active,
    const int32_t* __restrict__ ranks, const int32_t* __restrict__ avail, const int32_t* __restrict__ alloc,
    const bool* __restrict__ valid, const float* __restrict__ labels, const float* __restrict__ taints,
    const float* __restrict__ node_aff, const float* __restrict__ node_pref, const float* __restrict__ taints_soft,
    const float* __restrict__ blk_pod, const float* __restrict__ blk_node, const float* __restrict__ sps_pod,
    const float* __restrict__ sps_node, const float* __restrict__ spd_pod, const float* __restrict__ spl_node,
    const float* __restrict__ ppaw_pod, const float* __restrict__ ppa_node, int B, int N, int R, int L, int T,
    int A, int A2, int Ts, int Wb, int Ss, int S, int Tp, float w_lr, float w_ba, float w_jit, float w_pref,
    float w_soft, float w_topo, uint32_t salt, uint32_t node_offset, int32_t* __restrict__ choice,
    bool* __restrict__ has, float* __restrict__ best) {
  extern __shared__ float smem[];
  const int W = L + T + A + A2 + Ts;
  // Pod row: [sel | ntol | aff | pref_w | ntol_soft] then, constrained,
  // [blk | sps | spd | ppaw].
  const int WT = CONSTRAINED ? W + Wb + Ss + S + Tp : W;
  const int o_blk = W, o_sps = W + Wb, o_spd = W + Wb + Ss, o_ppa = W + Wb + Ss + S;
  float* feat = smem;                                            // [PODS][WT]
  int32_t* sreq = reinterpret_cast<int32_t*>(smem + PODS * WT);  // [PODS][R]
  int* live = sreq + PODS * R;  // constrained: live columns, [Wb | Ss | S | Tp]
  __shared__ float s_selc[PODS], s_hasaff[PODS];
  __shared__ uint32_t s_rank[PODS];
  __shared__ int s_active[PODS];
  __shared__ int s_nlive[4];
  __shared__ float red_score[WARPS][PODS];
  __shared__ int red_idx[WARPS][PODS];

  const int p0 = blockIdx.x * PODS;
  const int np = min(PODS, B - p0);

  if (threadIdx.x < PODS)  // padding pods are inactive: never feasible
    s_active[threadIdx.x] = threadIdx.x < np ? (int)active[p0 + threadIdx.x] : 0;
  __syncthreads();

  // A tile with no active pod has nothing to search and reads nothing more
  // (s_active is shared, so every thread of the block takes the same branch).
  bool any_active = false;
#pragma unroll
  for (int p = 0; p < PODS; ++p) any_active |= s_active[p] != 0;
  if (!any_active) {
    if (threadIdx.x < np) {
      choice[p0 + threadIdx.x] = 0;
      has[p0 + threadIdx.x] = false;
      best[p0 + threadIdx.x] = -INFINITY;
    }
    return;
  }

  stage(feat, WT, 0, sel, L, p0, s_active);
  stage(feat, WT, L, ntol, T, p0, s_active);
  stage(feat, WT, L + T, aff, A, p0, s_active);
  stage(feat, WT, L + T + A, pref_w, A2, p0, s_active);
  stage(feat, WT, L + T + A + A2, ntol_soft, Ts, p0, s_active);
  if constexpr (CONSTRAINED) {
    stage(feat, WT, o_blk, blk_pod, Wb, p0, s_active);
    stage(feat, WT, o_sps, sps_pod, Ss, p0, s_active);
    stage(feat, WT, o_spd, spd_pod, S, p0, s_active);
    stage(feat, WT, o_ppa, ppaw_pod, Tp, p0, s_active);
  }
  for (int i = threadIdx.x; i < PODS * R; i += THREADS) {
    const int p = i / R, r = i % R;
    sreq[i] = s_active[p] ? req[(size_t)(p0 + p) * R + r] : 0;
  }
  if (threadIdx.x < PODS) {
    const int p = threadIdx.x;
    const bool in = s_active[p] != 0;
    s_selc[p] = in ? selc[p0 + p] : 0.0f;
    s_hasaff[p] = in ? has_aff[p0 + p] : 0.0f;
    s_rank[p] = in ? (uint32_t)ranks[p0 + p] : 0u;
  }
  __syncthreads();

  if constexpr (CONSTRAINED) {  // one warp per operand builds its live list
    const int warp = threadIdx.x >> 5;
    if (warp == 0) build_live(live, &s_nlive[0], feat, WT, o_blk, Wb);
    else if (warp == 1) build_live(live + Wb, &s_nlive[1], feat, WT, o_sps, Ss);
    else if (warp == 2) build_live(live + Wb + Ss, &s_nlive[2], feat, WT, o_spd, S);
    else if (warp == 3) build_live(live + Wb + Ss + S, &s_nlive[3], feat, WT, o_ppa, Tp);
    __syncthreads();
  }
  const int n_blk = CONSTRAINED ? s_nlive[0] : 0, n_sps = CONSTRAINED ? s_nlive[1] : 0;
  const int n_spd = CONSTRAINED ? s_nlive[2] : 0, n_ppa = CONSTRAINED ? s_nlive[3] : 0;

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
    uint32_t ok = 0u;
#pragma unroll
    for (int p = 0; p < PODS; ++p)
      if (s_active[p]) ok |= 1u << p;
    for (int r = 0; r < R; ++r) {
      const int32_t a = avail[nr + r];
#pragma unroll
      for (int p = 0; p < PODS; ++p)
        if (sreq[p * R + r] > a) ok &= ~(1u << p);
    }
    if (ok == 0u) continue;

    // Exact small-integer dot products (0/1 bitmaps, integer weights): any
    // summation order gives the same float.
    float c_sel[PODS], c_tol[PODS], c_aff[PODS];
#pragma unroll
    for (int p = 0; p < PODS; ++p) c_sel[p] = c_tol[p] = c_aff[p] = 0.0f;
    for (int k = 0; k < L; ++k) {
      const float v = labels[(size_t)n * L + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_sel[p] = __fadd_rn(c_sel[p], __fmul_rn(feat[p * WT + k], v));
    }
    for (int k = 0; k < T; ++k) {
      const float v = taints[(size_t)n * T + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_tol[p] = __fadd_rn(c_tol[p], __fmul_rn(feat[p * WT + L + k], v));
    }
    for (int k = 0; k < A; ++k) {
      const float v = node_aff[(size_t)n * A + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_aff[p] = __fadd_rn(c_aff[p], __fmul_rn(feat[p * WT + L + T + k], v));
    }
#pragma unroll
    for (int p = 0; p < PODS; ++p)
      if (!(c_sel[p] == s_selc[p] && c_tol[p] == 0.0f && (c_aff[p] > 0.0f || s_hasaff[p] == 0.0f)))
        ok &= ~(1u << p);
    if (ok == 0u) continue;

    float c_sps[PODS], c_spl[PODS], c_ppa[PODS];
    if constexpr (CONSTRAINED) {
      float c_blk[PODS];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_blk[p] = c_sps[p] = c_spl[p] = c_ppa[p] = 0.0f;
      dot_live(c_blk, feat, WT, o_blk, blk_node, live, n_blk, N, n);
#pragma unroll
      for (int p = 0; p < PODS; ++p)
        if (c_blk[p] > 0.0f) ok &= ~(1u << p);
      if (ok == 0u) continue;
      dot_live(c_sps, feat, WT, o_sps, sps_node, live + Wb, n_sps, N, n);
      dot_live(c_spl, feat, WT, o_spd, spl_node, live + Wb + Ss, n_spd, N, n);
      dot_live(c_ppa, feat, WT, o_ppa, ppa_node, live + Wb + Ss + S, n_ppa, N, n);
    }

    float c_pref[PODS], c_soft[PODS];
#pragma unroll
    for (int p = 0; p < PODS; ++p) c_pref[p] = c_soft[p] = 0.0f;
    for (int k = 0; k < A2; ++k) {
      const float v = node_pref[(size_t)n * A2 + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p) c_pref[p] = __fadd_rn(c_pref[p], __fmul_rn(feat[p * WT + L + T + A + k], v));
    }
    for (int k = 0; k < Ts; ++k) {
      const float v = taints_soft[(size_t)n * Ts + k];
#pragma unroll
      for (int p = 0; p < PODS; ++p)
        c_soft[p] = __fadd_rn(c_soft[p], __fmul_rn(feat[p * WT + L + T + A + A2 + k], v));
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
      if (!((ok >> p) & 1u)) continue;
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
      if constexpr (CONSTRAINED) {  // after the jitter, in the reference tree's order; keyed on widths
        if (Ss > 0) s = __fsub_rn(s, __fmul_rn(w_topo, c_sps[p]));
        s = __fsub_rn(s, __fmul_rn(__fmul_rn(2.0f, w_jit), c_spl[p]));
        if (Tp > 0) s = __fadd_rn(s, c_ppa[p]);
      }
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

// Shared-memory bytes one block needs for the pod tile of row width `wt`
// and `nlive` live-column slots (the constrained operands' summed width, 0
// for the unconstrained instance); raises the kernel's dynamic limit when
// it exceeds the 48 KB default.  Returns 0, TSCHED_ERR_SMEM when the device
// cannot grant it, or a CUDA error.
template <bool CONSTRAINED>
static int prepare_smem(int R, int wt, int nlive, size_t* smem) {
  *smem = sizeof(float) * (size_t)PODS * ((size_t)wt + (size_t)R) + sizeof(int) * (size_t)nlive;
  if (*smem <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, choose_kernel<CONSTRAINED>);
  if (e != cudaSuccess) return (int)e;
  if (*smem + attr.sharedSizeBytes > (size_t)optin) return TSCHED_ERR_SMEM;
  return (int)cudaFuncSetAttribute(choose_kernel<CONSTRAINED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

extern "C" {

// Both launchers launch on `stream`, allocate nothing and do not
// synchronise.  They return cudaGetLastError() after the launch (0 =
// launched), or TSCHED_ERR_SMEM.

int tsched_choose_launch(const void* req, const void* sel, const void* selc, const void* ntol, const void* aff,
                         const void* has_aff, const void* pref_w, const void* ntol_soft, const void* active,
                         const void* ranks, const void* avail, const void* alloc, const void* valid,
                         const void* labels, const void* taints, const void* node_aff, const void* node_pref,
                         const void* taints_soft, int B, int N, int R, int L, int T, int A, int A2, int Ts, float w_lr,
                         float w_ba, float w_jit, float w_pref, float w_soft, uint32_t salt, uint32_t node_offset,
                         void* choice, void* has, void* best, void* stream) {
  if (B <= 0) return 0;
  if (R < 2) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int err = prepare_smem<false>(R, L + T + A + A2 + Ts, 0, &smem);
  if (err != 0) return err;
  const int grid = (B + PODS - 1) / PODS;
  choose_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)req, (const float*)sel, (const float*)selc, (const float*)ntol, (const float*)aff,
      (const float*)has_aff, (const float*)pref_w, (const float*)ntol_soft, (const bool*)active,
      (const int32_t*)ranks, (const int32_t*)avail, (const int32_t*)alloc, (const bool*)valid,
      (const float*)labels, (const float*)taints, (const float*)node_aff, (const float*)node_pref,
      (const float*)taints_soft, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, N, R, L,
      T, A, A2, Ts, 0, 0, 0, 0, w_lr, w_ba, w_jit, w_pref, w_soft, 0.0f, salt, node_offset, (int32_t*)choice,
      (bool*)has, (float*)best);
  return (int)cudaGetLastError();
}

// The constrained choose: the operands of tsched_choose_launch plus the
// pod/node pairs [B, Wb]/[Wb, N] (blocked band), [B, Ss]/[Ss, N] (soft
// spread), [B, S]/[S, N] (hard-spread level), [B, Tp]/[Tp, N] (preferred
// inter-pod), and w_topo (profile weight 5).
int tsched_choose_constrained_launch(
    const void* req, const void* sel, const void* selc, const void* ntol, const void* aff, const void* has_aff,
    const void* pref_w, const void* ntol_soft, const void* active, const void* ranks, const void* avail,
    const void* alloc, const void* valid, const void* labels, const void* taints, const void* node_aff,
    const void* node_pref, const void* taints_soft, const void* blk_pod, const void* blk_node, const void* sps_pod,
    const void* sps_node, const void* spd_pod, const void* spl_node, const void* ppaw_pod, const void* ppa_node,
    int B, int N, int R, int L, int T, int A, int A2, int Ts, int Wb, int Ss, int S, int Tp, float w_lr, float w_ba,
    float w_jit, float w_pref, float w_soft, float w_topo, uint32_t salt, uint32_t node_offset, void* choice,
    void* has, void* best, void* stream) {
  if (B <= 0) return 0;
  if (R < 2 || Wb < 0 || Ss < 0 || S < 0 || Tp < 0) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int err = prepare_smem<true>(R, L + T + A + A2 + Ts + Wb + Ss + S + Tp, Wb + Ss + S + Tp, &smem);
  if (err != 0) return err;
  const int grid = (B + PODS - 1) / PODS;
  choose_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)req, (const float*)sel, (const float*)selc, (const float*)ntol, (const float*)aff,
      (const float*)has_aff, (const float*)pref_w, (const float*)ntol_soft, (const bool*)active,
      (const int32_t*)ranks, (const int32_t*)avail, (const int32_t*)alloc, (const bool*)valid,
      (const float*)labels, (const float*)taints, (const float*)node_aff, (const float*)node_pref,
      (const float*)taints_soft, (const float*)blk_pod, (const float*)blk_node, (const float*)sps_pod,
      (const float*)sps_node, (const float*)spd_pod, (const float*)spl_node, (const float*)ppaw_pod,
      (const float*)ppa_node, B, N, R, L, T, A, A2, Ts, Wb, Ss, S, Tp, w_lr, w_ba, w_jit, w_pref, w_soft, w_topo,
      salt, node_offset, (int32_t*)choice, (bool*)has, (float*)best);
  return (int)cudaGetLastError();
}

const char* tsched_error_string(int code) {
  if (code == TSCHED_ERR_SMEM) return "the pod tile needs more shared memory than one block may use";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
