// choose: fused feasibility + score + masked argmax for a block of pods
// against every node, for Hopper (sm_90a).  One template, two families,
// each with and without the gang term:
//
// choose_kernel<false, …> replaces tpu_scheduler/ops/pallas_choose.py::
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
// choose_kernel<true, …> replaces _make_choose_kernel(True), the constrained
// variant (pallas_choose.py:172-351, operands :117-169), the choose of one
// round of a constrained cycle.  Beyond the above:
//   block   a node is infeasible for p when Σ_k blk_pod[p,k]·blk_node[k,n] > 0
//           over the band [aa carries | aa matched | spread declares |
//           gated positive affinity] × [aa_m; aa_c; sp; pa_unmatched]; every
//           operand is 0/1, so the sum is exact in any order
//   score   after the jitter, in this order: − w5·(sps_pod·sps_node),
//           − (2·w2)·(spd_pod·spl_node), + ppaw_pod·ppa_node
//
// choose_kernel<·, ·, true> adds the gang co-placement term of a topology
// cycle (topology/locality.py; the JAX package runs topology cycles on its
// jnp tree instead of its Pallas kernel, tpu_scheduler/ops/assign.py:229-233,
// the term tpu_scheduler/topology/locality.py:170-215, added at
// ops/score.py:141-150).  The term of gang g at node n depends only on g and
// n's domain at each level l, so the kernel computes it from small
// per-(gang, domain) state instead of reading a dense [G+1, N] tensor: each
// node's domain column per level, dom_col[l·N + n], the domain's free
// cpu/memory dom_free[c], and per gang the placed counts placed[g·Dt + c],
// the herd values herd[g·Dt + c], total[g] and the remaining demand rem[g]
// (the last two staged with the tile).  In the reference's order, with correctly rounded
// float ops:
//   t = 0; per level: t = t − (16·d_l)·(total − same); t = t + d_l·(fits·herd)
//   term = w·t, and +0.0 for gang 0
// and the score takes it as its LAST add, after every other term, before
// the masked argmax, and `best` includes it.  Gang members are adjacent in
// priority order, so a tile's 8 pods hold 1-3 gangs: the tile's run starts
// (a pod whose gang differs from the previous pod's; an inactive pod rides
// the previous run) are one mask, the same for every thread, built after
// staging; in the unrolled pod loop the term is computed at a run start
// and reused by the rest of the run, with no divergence between the
// block's threads (skipping a run none of whose pods passed at the node
// measured 2 % slower: the branch diverges).
// A run's reads are 4 per level (the node's column and its domain's
// capacity, the gang's placed count and herd value), coalesced across the
// threads' nodes (a warp's 32 nodes span 8 slices) and L1-resident across
// the walk.  The flag is a template parameter, so the
// launches without the term run the instances they ran before, unchanged
// (a runtime branch in the unrolled pod loop costs 8-12 %, see the jitter
// modes below).
//
// The two families without the term serve kernel #2b, the per-shard choose
// of the sharded cycle (tpu_scheduler/parallel/sharded.py:261-270,
// choose_block_pallas with node_offset and return_best): node_offset is the
// global index of node 0 of a tp shard's node slice, and the jitter hash
// reads n + node_offset (uint32), so every shard scores as the unsharded
// launch does; choice stays local to the slice and best is the cross-shard
// merge operand.
//
// Bitmaps as words.  Every hard predicate and the soft-taint count is a dot
// product of 0/1 bitmaps, so it is an exact integer count: popc(sel & labels)
// == selc, (ntol & taints) == 0, (aff & node_aff) != 0 || !has_aff and
// popc(ntol_soft & taints_soft).  The node side arrives as words built once
// per cycle by ops/choose.pack_node_words: [ceil(W/32), N] uint32, bit k of
// word j is column 32·j + k, transposed so a thread per node reads them
// coalesced.  The pod side is packed here, while the tile is staged: one
// warp per (pod, word) reads 32 columns of the pod's float row coalesced and
// __ballot_sync(v != 0) is the word.  The wrapper checks that every bitmap
// operand is exactly 0.0 or 1.0 (ValueError otherwise): that is what makes a
// popcount equal the float sum.  pref_w holds integer weights and stays
// float: the tile keeps the row, plus the word of its non-zero columns, and
// c_pref is the ascending sum of pref_w[p,k] over the set bits of
// (nz(pref_w[p]) & node_pref): each skipped column's product is ±0.
//
// Tiles.  One thread block per tile of PODS = 8 pods, two blocks per SM
// (16- and 32-pod tiles need 248 and 255 registers and ran slower on the
// H100; PERF.md records the times).  Threads stride over the nodes in ascending order;
// a node's words, capacities and flag are read once per tile and reused for
// the PODS pods, so the node side (~0.5 MB at the flagship) is read B/PODS
// times from L2, and each thread loads its next node's row while it scores
// the current one.  ONE_WORD instances serve launches whose every
// vocabulary fits one word (the flagship: all five are 8 wide): each
// thread keeps its tile's selector, toleration and affinity words, selector
// counts and cpu/memory requests in registers, and a node costs five
// coalesced word loads.  The generic instances loop over the words (no
// width limit beyond the tile's shared memory, checked by the launcher),
// reading the pod words from shared memory (broadcast); at the flagship
// they are ~22 % slower than ONE_WORD.  Every pod of the tile is scored for
// a node that passes some pod's predicates, with no branch between pods,
// so the pods' dependency chains interleave; a pod that failed never
// updates its strict-'>' running best.  The jitter's mode (none, power of
// two, division) is the same for the whole launch, so the node walk is
// compiled once per mode and the launch takes one: a runtime branch on the
// mode inside the pod loop is 8-12 % slower at the flagship.  A
// warp-shuffle then shared-memory reduction on (score desc, index asc)
// finishes the argmax.  Nothing carries across blocks.
//
// The constrained family also walks, per tile, only the LIVE constraint
// columns — those where some ACTIVE pod of the tile has a non-zero pod
// value.  After staging, one warp per operand builds the tile's ascending
// list in shared memory (__ballot_sync, the write position from __popc of
// the lower lanes); the node walk loads node[k·N + n] coalesced for each
// live k only, reused for the 8 pods, with a loop bound that is the same for
// every thread of the block.  Node-side constraint operands are [W, N] (as
// round_blocked_masks makes them).  A feature absent from the cycle has
// width 0 and its loop never runs (no term is added).
//
// Every instance reads the tile's active flags first and returns at once
// from a tile with no active pod (the padding and the tail rounds of the
// sharded cycle, which launches over all rows): it writes (0, false, −inf)
// and reads nothing more.  In a tile with an active pod, only the active
// pods' rows are read; the others are staged as zeros (never feasible).
//
// What bounds it on the H100: operations.  chip_smoke.choose_bound_ms counts
// the function's work, 2 ops per dot-product term plus ~45 scalar ops per
// pair (~127 at the flagship widths), whatever implements it.  With words a
// pair costs far fewer instructions than that count: the fit compares, ~10
// integer ops for the three predicates, and the score.  What is left is the
// score: its two IEEE divisions by node capacity (each a reciprocal, five
// FMAs and a range check that can branch to the slow path, which fences
// the pods' chains from one another), the int -> float conversions, the
// floor, ~25 float ops and the hash; and the registers that the unrolled
// pod loop holds, which set how many warps an SM keeps in flight.  The
// pod side costs nothing per pair.
//
// Bit-exactness traps (the results must equal the NumPy/XLA tree bit for bit):
// * FMA contraction: nvcc would fuse w0*lr + w1*ba and floor(s/q)*q + jw*h
//   into FMAs, which round once instead of twice.  The score arithmetic is
//   written with __fmul_rn/__fadd_rn/__fsub_rn (never contracted) and the
//   build passes -fmad=false as well.  Division is __fdiv_rn (IEEE, also
//   what -prec-div=true gives); never build with --use_fast_math.
// * Counts are exact: for 0/1 operands a popcount is the float dot product
//   (an integer below 2^24; the soft count, below 2^23 by the launcher's
//   width check, becomes a float by exact bit arithmetic); selc is compared
//   as the integer it must equal (-1, never matched, when it is none).
// * Division by a power of two: when w_jit > 0 is a power of two whose
//   reciprocal is a finite float (the launcher checks, and passes the flag
//   and the reciprocal), s / w_jit and s · (1 / w_jit) are the correctly
//   rounded values of one real number, so they are equal bit for bit (±0,
//   ±inf and subnormal results included); otherwise __fdiv_rn stays.  The
//   hash term h / 65536 (h < 2^16) is exact: 1 + h·2^-16 is built in the
//   mantissa and 1 subtracted.  fc and fm divide by node capacities and keep
//   __fdiv_rn: a per-node reciprocal would round twice.
// * Conversions: used_after can exceed 2^24, so int32 -> f32 must round to
//   nearest as numpy does: __int2float_rn.
// * Integer wraparound: (alloc - avail) + req wraps in int32 in numpy and
//   XLA; it is computed in uint32 here (defined wraparound) and cast back.
// * Tie-break: the JAX package found a Mosaic argmax that returned the
//   higher index on a tie.  Here each thread visits nodes in ascending order
//   and replaces its best only on a strictly greater score, and every
//   reduction step prefers the greater score, then the lower index — so the
//   result is the lowest index among equal maxima, as jnp.argmax gives.
// * Padding: pods past B in the last tile are staged as inactive (never
//   feasible, zero words) and never written; nodes past N are never
//   visited, and invalid nodes are skipped, so neither can win.
// * Exact sums in the preferred and constrained terms: every product is an
//   integer and every partial sum stays below 2^24 in the workloads this
//   serves (0/1 bitmaps against domain counts; |w| ≤ 100 weights), so any
//   summation order gives the same float; 2·w2 is one float product formed
//   first, as the reference tree does.
// * Skipped products are exact: a column outside a tile's live list (or a
//   clear bit of nz(pref_w) & node_pref) has a ±0 product for every active
//   pod, so any subset of columns that holds every non-zero product gives
//   the same float; a tile with no preferred weight (no soft toleration
//   gap) takes c_pref (the soft count) as the +0.0 its sum would be.  Live lists are built from ACTIVE pods only (an inactive
//   pod's row is staged as zeros): its `ok` bit is 0 from the start, so its
//   sums are never read, and it still gets (0, false, −inf).
// * The sign of zero: a negative weight against a zero count is −0.0; every
//   sum starts at +0.0 and +0.0 + −0.0 = +0.0, so a sum never becomes −0.0
//   and summing or skipping such a product gives equal bits.
// * The gang term follows the reference tree op for op (__fsub_rn,
//   __fmul_rn, __fadd_rn); fits·herd is a product, as the reference forms
//   it; `same` and `total` are integer counts, equal to the reference's
//   placed @ onehot.T in any order; gang 0's term is +0.0; and the term is
//   added even where it is +0.0 (a −0.0 score plus +0.0 is +0.0).  An
//   out-of-range gang id or domain column would read outside the state, so
//   the wrapper checks them (ops/choose.check_gang_ids, check_domain_columns,
//   once per cycle in assign_cycle), and the launcher refuses more than
//   MAX_LEVELS levels.
// * Feature presence is keyed on the operand WIDTHS (Ss > 0, Tp > 0; the
//   level term always), never on a tile's live count: the plain version
//   adds a term iff the feature is in the cycle, and skipping a +0.0 term
//   could turn a −0.0 score into another bit pattern.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define THREADS 256
#define WARPS (THREADS / 32)
#define PODS 8  // pods per tile, the bits of one word
#define NO_NODE 0x7fffffff
// Returned by a launcher (never by CUDA) when the pod tile needs more shared
// memory than the device grants one block.
#define TSCHED_ERR_SMEM 100001
// The soft count becomes a float by exact bit arithmetic below this width.
#define MAX_SOFT_WIDTH (1 << 23)
// The topology levels the gang term takes (ops/choose.MAX_LEVELS).
#define MAX_LEVELS 4

static __device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// c as a float, exactly, for c < 2^23: 2^23 + c in the mantissa, less 2^23.
static __device__ __forceinline__ float small_count(uint32_t c) {
  return __fsub_rn(__uint_as_float(0x4b000000u | c), 8388608.0f);
}

// h · 2^-16 exactly, for h < 2^16: 1 + h·2^-16 in the mantissa, less 1.
static __device__ __forceinline__ float unit16(uint32_t h) {
  return __fsub_rn(__uint_as_float(0x3f800000u | (h << 7)), 1.0f);
}

// The jitter's quantization, floor(s / w_jit) · w_jit, by mode: none
// (w_jit <= 0: s as it is), by the exact reciprocal (w_jit a power of two),
// or by IEEE division.
enum { JIT_NONE = 0, JIT_POW2 = 1, JIT_DIV = 2 };

template <int JIT>
static __device__ __forceinline__ float quantize(float s, float w_jit, float inv_jit) {
  if constexpr (JIT == JIT_NONE) return s;
  else if constexpr (JIT == JIT_POW2) return __fmul_rn(floorf(__fmul_rn(s, inv_jit)), w_jit);
  else return __fmul_rn(floorf(__fdiv_rn(s, w_jit)), w_jit);
}

// The operands of one launch.  Node bitmaps are words ([ceil(W/32), N]);
// constraint operands are null and 0 wide for the unconstrained family.
struct ChooseArgs {
  const int32_t* req;
  const float *sel, *selc, *ntol, *aff, *has_aff, *pref_w, *ntol_soft;
  const bool* active;
  const int32_t* ranks;
  const int32_t *avail, *alloc;
  const bool* valid;
  const uint32_t *labels, *taints, *node_aff, *node_pref, *taints_soft;
  const float *blk_pod, *blk_node, *sps_pod, *sps_node, *spd_pod, *spl_node, *ppaw_pod, *ppa_node;
  const int32_t* gang_id;  // [B]; null without the gang term
  int B, N, R, L, T, A, A2, Ts, Wb, Ss, S, Tp;
  float w_lr, w_ba, w_jit, w_pref, w_soft, w_topo, inv_jit;
  int jit_pow2;  // w_jit > 0 is a power of two and inv_jit its exact reciprocal
  uint32_t salt, node_offset;
  int32_t* choice;
  bool* has;
  float* best;
  // The rest of the gang term, after every field the instances without it
  // read (ahead of them, the struct's layout moved the register allocation
  // of choose_kernel<true, true, false>): domain columns [Lv, N] int32,
  // level distances [Lv], per (gang, domain) placed counts and herd values
  // [G+1, Dt], per gang total [G+1] and remaining demand [G+1, 2], per
  // domain free capacity [Dt, 2].
  const int32_t* dom_col;
  const float *level_dist, *placed, *total, *rem, *dom_free, *herd;
  int Lv, Dt;
  float w_gang;
};

static __host__ __device__ __forceinline__ int words_of(int width) { return (width + 31) / 32; }

// What the walk reads of one node before its pods: the flag, cpu/memory
// capacities and, ONE_WORD, the five bitmap words (0 for a 0-wide one).
struct NodeRow {
  bool valid;
  int32_t avail_c, avail_m, alloc_c, alloc_m;
  uint32_t lab, tnt, naf, npref, nsoft;
};

template <bool ONE_WORD>
static __device__ __forceinline__ void load_node(NodeRow& r, const ChooseArgs& a, int n) {
  const size_t nr = (size_t)n * a.R;
  r.valid = a.valid[n];
  r.avail_c = a.avail[nr], r.avail_m = a.avail[nr + 1];
  r.alloc_c = a.alloc[nr], r.alloc_m = a.alloc[nr + 1];
  if constexpr (ONE_WORD) {
    r.lab = a.L ? a.labels[n] : 0u;
    r.tnt = a.T ? a.taints[n] : 0u;
    r.naf = a.A ? a.node_aff[n] : 0u;
    r.npref = a.A2 ? a.node_pref[n] : 0u;
    r.nsoft = a.Ts ? a.taints_soft[n] : 0u;
  }
}

// The gang term of gang g at node n, in the reference's op order (header);
// tot and (rc, rm) are g's total and remaining demand, anchor[l] = 16·d_l.
// The node's domain column and free capacity are read here, per level, from
// L1 after the first run of the tile: held in registers across the pod loop
// (loaded one step ahead with the node's other data, or once per node)
// they made the instance spill and run 2-4 % slower (PERF.md).
static __device__ __forceinline__ float gang_term(const ChooseArgs& a, int g, float tot, float rc, float rm,
                                                  int n, const float* dist, const float* anchor) {
  if (g == 0) return 0.0f;  // where(g > 0, w·t, 0): +0.0
  const float* placed = a.placed + (size_t)g * a.Dt;
  const float* herd = a.herd + (size_t)g * a.Dt;
  float t = 0.0f;
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (l < a.Lv) {
      const int c = __ldg(a.dom_col + (size_t)l * a.N + n);
      const float2 f = __ldg(reinterpret_cast<const float2*>(a.dom_free) + c);
      t = __fsub_rn(t, __fmul_rn(anchor[l], __fsub_rn(tot, __ldg(placed + c))));
      const float fits = (rc <= f.x && rm <= f.y) ? 1.0f : 0.0f;
      t = __fadd_rn(t, __fmul_rn(dist[l], __fmul_rn(fits, __ldg(herd + c))));
    }
  }
  return __fmul_rn(a.w_gang, t);
}

// Stage the tile's rows of a [B, width] operand into shared rows (row stride
// `stride`, column offset `off`): an active pod's row is read, an inactive
// or padding pod gets zeros without a read.
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

// Word counts of the five bitmap operands and their slots in a pod's row of
// shared words: [sel | ntol | aff | nz(pref_w) | ntol_soft].  ONE_WORD gives
// every operand exactly one slot (a 0-wide operand's word is 0).
template <bool ONE_WORD>
struct Slots {
  int nL, nT, nA, nA2, nTs, o_tol, o_aff, o_pnz, o_soft, per_pod;
  __host__ __device__ Slots(int L, int T, int A, int A2, int Ts) {
    nL = ONE_WORD ? 1 : words_of(L);
    nT = ONE_WORD ? 1 : words_of(T);
    nA = ONE_WORD ? 1 : words_of(A);
    nA2 = ONE_WORD ? 1 : words_of(A2);
    nTs = ONE_WORD ? 1 : words_of(Ts);
    o_tol = nL;
    o_aff = o_tol + nT;
    o_pnz = o_aff + nA;
    o_soft = o_pnz + nA2;
    per_pod = o_soft + nTs;
  }
};

// Two resident blocks per SM: at most 128 registers a thread, a few spilled.
template <bool CONSTRAINED, bool ONE_WORD, bool TOPO>
__global__ void __launch_bounds__(THREADS, 2) choose_kernel(const ChooseArgs a) {
  static_assert(PODS <= 32, "a tile's pods are the bits of one word");
  extern __shared__ uint32_t smem[];
  const Slots<ONE_WORD> sl(a.L, a.T, a.A, a.A2, a.Ts);
  const int R = a.R, N = a.N, A2 = a.A2;
  // Constrained pod rows: [blk | sps | spd | ppaw] floats.
  const int WC = CONSTRAINED ? a.Wb + a.Ss + a.S + a.Tp : 0;
  const int o_sps = a.Wb, o_spd = a.Wb + a.Ss, o_ppa = a.Wb + a.Ss + a.S;
  uint32_t* s_words = smem;                                            // [PODS][per_pod]
  float* s_prefw = reinterpret_cast<float*>(s_words + PODS * sl.per_pod);  // [PODS][A2]
  int32_t* sreq = reinterpret_cast<int32_t*>(s_prefw + PODS * A2);     // [PODS][R]
  float* feat = reinterpret_cast<float*>(sreq + PODS * R);             // constrained: [PODS][WC]
  int* live = reinterpret_cast<int*>(feat + PODS * WC);                // constrained: [WC] live columns
  __shared__ int s_need[PODS];  // selc as the integer count it must equal, −1 for none
  __shared__ float s_hasaff[PODS];
  __shared__ uint32_t s_rank[PODS];
  __shared__ int s_gid[PODS];  // TOPO: the pod's gang (0 for an inactive pod)
  __shared__ float s_gtot[PODS], s_grem[PODS][2];  // TOPO: its gang's total and remaining demand
  __shared__ float s_dist[MAX_LEVELS], s_anchor[MAX_LEVELS];  // TOPO: d_l and 16·d_l
  __shared__ int s_active[PODS];
  __shared__ int s_nlive[4];
  __shared__ float red_score[WARPS][PODS];
  __shared__ int red_idx[WARPS][PODS];

  const int p0 = blockIdx.x * PODS;
  const int np = min(PODS, a.B - p0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x < PODS)  // padding pods are inactive: never feasible
    s_active[threadIdx.x] = threadIdx.x < np ? (int)a.active[p0 + threadIdx.x] : 0;
  __syncthreads();

  // A tile with no active pod has nothing to search and reads nothing more
  // (s_active is shared, so every thread of the block takes the same branch).
  uint32_t act = 0u;
#pragma unroll
  for (int p = 0; p < PODS; ++p)
    if (s_active[p]) act |= 1u << p;
  if (act == 0u) {
    if (threadIdx.x < np) {
      a.choice[p0 + threadIdx.x] = 0;
      a.has[p0 + threadIdx.x] = false;
      a.best[p0 + threadIdx.x] = -INFINITY;
    }
    return;
  }

  // Pod bitmap words: one warp per (pod, slot); lane k reads column 32·j + k
  // of the pod's row (coalesced) and the ballot of v != 0 is the word.  The
  // trip count depends on the warp only, so every lane reaches the ballot.
  for (int t = warp; t < PODS * sl.per_pod; t += WARPS) {
    const int p = t / sl.per_pod;
    int j = t % sl.per_pod;
    const float* src;
    int width;
    if (j < sl.o_tol) {
      src = a.sel, width = a.L;
    } else if (j < sl.o_aff) {
      src = a.ntol, width = a.T, j -= sl.o_tol;
    } else if (j < sl.o_pnz) {
      src = a.aff, width = a.A, j -= sl.o_aff;
    } else if (j < sl.o_soft) {
      src = a.pref_w, width = A2, j -= sl.o_pnz;
    } else {
      src = a.ntol_soft, width = a.Ts, j -= sl.o_soft;
    }
    const int k = 32 * j + lane;
    const bool bit = s_active[p] && k < width && src[(size_t)(p0 + p) * width + k] != 0.0f;
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) s_words[t] = word;  // t == p * per_pod + slot
  }
  stage(s_prefw, A2, 0, a.pref_w, A2, p0, s_active);
  if constexpr (CONSTRAINED) {
    stage(feat, WC, 0, a.blk_pod, a.Wb, p0, s_active);
    stage(feat, WC, o_sps, a.sps_pod, a.Ss, p0, s_active);
    stage(feat, WC, o_spd, a.spd_pod, a.S, p0, s_active);
    stage(feat, WC, o_ppa, a.ppaw_pod, a.Tp, p0, s_active);
  }
  for (int i = threadIdx.x; i < PODS * R; i += THREADS) {
    const int p = i / R, r = i % R;
    sreq[i] = s_active[p] ? a.req[(size_t)(p0 + p) * R + r] : 0;
  }
  if (threadIdx.x < PODS) {
    const int p = threadIdx.x;
    const bool in = s_active[p] != 0;
    const float c = in ? a.selc[p0 + p] : 0.0f;
    s_need[p] = (c >= 0.0f && c < 16777216.0f && floorf(c) == c) ? (int)c : -1;
    s_hasaff[p] = in ? a.has_aff[p0 + p] : 0.0f;
    s_rank[p] = in ? (uint32_t)a.ranks[p0 + p] : 0u;
    if constexpr (TOPO) {
      const int g = in ? a.gang_id[p0 + p] : 0;
      s_gid[p] = g;
      s_gtot[p] = a.total[g];
      s_grem[p][0] = a.rem[2 * g];
      s_grem[p][1] = a.rem[2 * g + 1];
    }
  }
  if constexpr (TOPO) {
    if (threadIdx.x < a.Lv) {
      const float d = a.level_dist[threadIdx.x];
      s_dist[threadIdx.x] = d;
      s_anchor[threadIdx.x] = __fmul_rn(16.0f, d);
    }
  }
  __syncthreads();

  // TOPO: the tile's run starts, one bit per pod whose gang differs from the
  // previous pod's (pod 0 always; an inactive pod rides the previous run).
  // The same for every thread of the block.
  uint32_t starts = 0u;
  if constexpr (TOPO) {
    int prev = 0;
#pragma unroll
    for (int p = 0; p < PODS; ++p) {
      const int g = s_active[p] ? s_gid[p] : prev;
      if (p == 0 || g != prev) starts |= 1u << p;
      prev = g;
    }
  }

  if constexpr (CONSTRAINED) {  // one warp per operand builds its live list
    if (warp == 0) build_live(live, &s_nlive[0], feat, WC, 0, a.Wb);
    else if (warp == 1) build_live(live + a.Wb, &s_nlive[1], feat, WC, o_sps, a.Ss);
    else if (warp == 2) build_live(live + o_spd, &s_nlive[2], feat, WC, o_spd, a.S);
    else if (warp == 3) build_live(live + o_ppa, &s_nlive[3], feat, WC, o_ppa, a.Tp);
    __syncthreads();
  }
  const int n_blk = CONSTRAINED ? s_nlive[0] : 0, n_sps = CONSTRAINED ? s_nlive[1] : 0;
  const int n_spd = CONSTRAINED ? s_nlive[2] : 0, n_ppa = CONSTRAINED ? s_nlive[3] : 0;

  // Per-thread copies of what every pair reads: cpu/memory requests and
  // selector counts, the pods without required affinity as bits and, for
  // ONE_WORD, the three hard-predicate words.  Whether any pod of the tile
  // has a preferred weight or a soft toleration gap is the same for every
  // thread: without one, c_pref and the soft count are +0.0 for every pair.
  int32_t req_c[PODS], req_m[PODS];
  int need[PODS];
  uint32_t w_sel[PODS], w_tol[PODS], w_aff[PODS];
  uint32_t noaff = 0u, any_pnz = 0u, any_soft = 0u;
#pragma unroll
  for (int p = 0; p < PODS; ++p) {
    req_c[p] = sreq[p * R];
    req_m[p] = sreq[p * R + 1];
    need[p] = s_need[p];
    if (s_hasaff[p] == 0.0f) noaff |= 1u << p;
    if constexpr (ONE_WORD) {
      w_sel[p] = s_words[p * sl.per_pod];
      w_tol[p] = s_words[p * sl.per_pod + sl.o_tol];
      w_aff[p] = s_words[p * sl.per_pod + sl.o_aff];
    }
    for (int j = 0; j < sl.nA2; ++j) any_pnz |= s_words[p * sl.per_pod + sl.o_pnz + j];
    for (int j = 0; j < sl.nTs; ++j) any_soft |= s_words[p * sl.per_pod + sl.o_soft + j];
  }

  float bscore[PODS];
  int bidx[PODS];
#pragma unroll
  for (int p = 0; p < PODS; ++p) {
    bscore[p] = -INFINITY;
    bidx[p] = NO_NODE;
  }

  // The node walk, one copy per jitter mode (the mode is the same for the
  // whole launch, so the pod loop below has no branch on it).  Each node's
  // scalars (and, ONE_WORD, its words) are loaded one step ahead.
  auto walk = [&](auto mode) {
    constexpr int JIT = decltype(mode)::value;
    NodeRow cur, nxt;
    const int first = threadIdx.x;
    if (first < N) load_node<ONE_WORD>(cur, a, first);
    for (int n = first; n < N; n += THREADS, cur = nxt) {  // ascending per thread
      if (n + THREADS < N) load_node<ONE_WORD>(nxt, a, n + THREADS);
      if (!cur.valid) continue;
      const size_t nr = (size_t)n * R;
      uint32_t ok = act;
#pragma unroll
      for (int p = 0; p < PODS; ++p)
        if (req_c[p] > cur.avail_c || req_m[p] > cur.avail_m) ok &= ~(1u << p);
      for (int r = 2; r < R; ++r) {
        const int32_t v = a.avail[nr + r];
#pragma unroll
        for (int p = 0; p < PODS; ++p)
          if (sreq[p * R + r] > v) ok &= ~(1u << p);
      }
      if (ok == 0u) continue;

      // Hard predicates from words.
      if constexpr (ONE_WORD) {
#pragma unroll
        for (int p = 0; p < PODS; ++p) {
          const bool pass = __popc(w_sel[p] & cur.lab) == need[p] && (w_tol[p] & cur.tnt) == 0u &&
                            ((w_aff[p] & cur.naf) != 0u || ((noaff >> p) & 1u));
          if (!pass) ok &= ~(1u << p);
        }
      } else {
        int cnt[PODS];
        uint32_t tol_hit = 0u, aff_hit = noaff;
#pragma unroll
        for (int p = 0; p < PODS; ++p) cnt[p] = 0;
        for (int j = 0; j < sl.nL; ++j) {
          const uint32_t w = a.labels[(size_t)j * N + n];
#pragma unroll
          for (int p = 0; p < PODS; ++p) cnt[p] += __popc(s_words[p * sl.per_pod + j] & w);
        }
        for (int j = 0; j < sl.nT; ++j) {
          const uint32_t w = a.taints[(size_t)j * N + n];
#pragma unroll
          for (int p = 0; p < PODS; ++p)
            if (s_words[p * sl.per_pod + sl.o_tol + j] & w) tol_hit |= 1u << p;
        }
        for (int j = 0; j < sl.nA; ++j) {
          const uint32_t w = a.node_aff[(size_t)j * N + n];
#pragma unroll
          for (int p = 0; p < PODS; ++p)
            if (s_words[p * sl.per_pod + sl.o_aff + j] & w) aff_hit |= 1u << p;
        }
#pragma unroll
        for (int p = 0; p < PODS; ++p)
          if (cnt[p] != need[p]) ok &= ~(1u << p);
        ok &= ~tol_hit & aff_hit;
      }
      if (ok == 0u) continue;

      float c_sps[PODS], c_spl[PODS], c_ppa[PODS];
      if constexpr (CONSTRAINED) {
        float c_blk[PODS];
#pragma unroll
        for (int p = 0; p < PODS; ++p) c_blk[p] = c_sps[p] = c_spl[p] = c_ppa[p] = 0.0f;
        dot_live(c_blk, feat, WC, 0, a.blk_node, live, n_blk, N, n);
#pragma unroll
        for (int p = 0; p < PODS; ++p)
          if (c_blk[p] > 0.0f) ok &= ~(1u << p);
        if (ok == 0u) continue;
        dot_live(c_sps, feat, WC, o_sps, a.sps_node, live + a.Wb, n_sps, N, n);
        dot_live(c_spl, feat, WC, o_spd, a.spl_node, live + o_spd, n_spd, N, n);
        dot_live(c_ppa, feat, WC, o_ppa, a.ppa_node, live + o_ppa, n_ppa, N, n);
      }

      // Preferred affinity: the ascending sum of pref_w[p,k] over the set
      // bits of nz(pref_w[p]) & node_pref; the soft taint count.
      float c_pref[PODS];
      uint32_t soft[PODS];
#pragma unroll
      for (int p = 0; p < PODS; ++p) {
        c_pref[p] = 0.0f;
        soft[p] = 0u;
      }
      if (any_pnz) {
#pragma unroll
        for (int p = 0; p < PODS; ++p) {
          for (int j = 0; j < sl.nA2; ++j) {
            uint32_t m = s_words[p * sl.per_pod + sl.o_pnz + j] & (ONE_WORD ? cur.npref : a.node_pref[(size_t)j * N + n]);
            while (m) {
              c_pref[p] = __fadd_rn(c_pref[p], s_prefw[p * A2 + 32 * j + (__ffs(m) - 1)]);
              m &= m - 1u;
            }
          }
        }
      }
      if (any_soft) {
#pragma unroll
        for (int p = 0; p < PODS; ++p)
          for (int j = 0; j < sl.nTs; ++j)
            soft[p] += __popc(s_words[p * sl.per_pod + sl.o_soft + j] &
                              (ONE_WORD ? cur.nsoft : a.taints_soft[(size_t)j * N + n]));
      }

      const bool safe_c = cur.alloc_c > 0, safe_m = cur.alloc_m > 0;
      const float den_c = safe_c ? __int2float_rn(cur.alloc_c) : 1.0f;
      const float den_m = safe_m ? __int2float_rn(cur.alloc_m) : 1.0f;
      const uint32_t used_c = (uint32_t)cur.alloc_c - (uint32_t)cur.avail_c;
      const uint32_t used_m = (uint32_t)cur.alloc_m - (uint32_t)cur.avail_m;
      const uint32_t h_node = ((uint32_t)n + a.node_offset) * 2246822519u + a.salt * 3266489917u;
      float gterm = 0.0f;  // TOPO: the term of the current run of pods, computed at its start

      // Every pod is scored (no branch between pods, so their chains
      // interleave); a pod that is not ok never updates its best.
#pragma unroll
      for (int p = 0; p < PODS; ++p) {
        const int32_t uc = (int32_t)(used_c + (uint32_t)req_c[p]);
        const int32_t um = (int32_t)(used_m + (uint32_t)req_m[p]);
        const float dc = __fdiv_rn(__int2float_rn(uc), den_c), dm = __fdiv_rn(__int2float_rn(um), den_m);
        const float fc = safe_c ? dc : 1.0f, fm = safe_m ? dm : 1.0f;
        const float lr = __fmul_rn(__fadd_rn(__fsub_rn(1.0f, fc), __fsub_rn(1.0f, fm)), 50.0f);
        const float ba = __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(fc, fm))), 100.0f);
        float s = __fadd_rn(__fmul_rn(a.w_lr, lr), __fmul_rn(a.w_ba, ba));
        s = __fadd_rn(s, __fmul_rn(a.w_pref, c_pref[p]));
        s = __fsub_rn(s, __fmul_rn(a.w_soft, small_count(soft[p])));
        uint32_t h = s_rank[p] * 2654435761u + h_node;
        h = (h ^ (h >> 15)) & 0xFFFFu;
        s = __fadd_rn(quantize<JIT>(s, a.w_jit, a.inv_jit), __fmul_rn(a.w_jit, unit16(h)));
        if constexpr (CONSTRAINED) {  // after the jitter, in the reference tree's order; keyed on widths
          if (a.Ss > 0) s = __fsub_rn(s, __fmul_rn(a.w_topo, c_sps[p]));
          s = __fsub_rn(s, __fmul_rn(__fmul_rn(2.0f, a.w_jit), c_spl[p]));
          if (a.Tp > 0) s = __fadd_rn(s, c_ppa[p]);
        }
        if constexpr (TOPO) {  // the gang term, last
          if ((starts >> p) & 1u)  // a run start: the same branch for every thread
            gterm = gang_term(a, s_gid[p], s_gtot[p], s_grem[p][0], s_grem[p][1], n, s_dist, s_anchor);
          s = __fadd_rn(s, gterm);
        }
        // strict: an equal score later in the walk never replaces
        const bool take = ((ok >> p) & 1u) && s > bscore[p];
        bscore[p] = take ? s : bscore[p];
        bidx[p] = take ? n : bidx[p];
      }
    }
  };
  if (!(a.w_jit > 0.0f)) walk(std::integral_constant<int, JIT_NONE>{});
  else if (a.jit_pow2) walk(std::integral_constant<int, JIT_POW2>{});
  else walk(std::integral_constant<int, JIT_DIV>{});

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
      a.choice[p0 + p] = found ? i : 0;
      a.has[p0 + p] = found;
      a.best[p0 + p] = found ? s : -INFINITY;
    }
  }
}

// Launch one instance on `stream`: the dynamic shared memory it needs (the
// pod words, the pref_w rows, the requests and, constrained, the constraint
// rows and their live lists), raising the kernel's limit past the 48 KB
// default when it must.  Returns 0, TSCHED_ERR_SMEM when the device cannot
// grant it, or a CUDA error.
template <bool CONSTRAINED, bool ONE_WORD, bool TOPO>
static int launch(const ChooseArgs& a, cudaStream_t stream) {
  const Slots<ONE_WORD> sl(a.L, a.T, a.A, a.A2, a.Ts);
  const size_t wc = CONSTRAINED ? (size_t)a.Wb + a.Ss + a.S + a.Tp : 0;
  const size_t smem = 4 * ((size_t)PODS * ((size_t)sl.per_pod + a.A2 + a.R + wc) + wc);
  const void* fn = (const void*)choose_kernel<CONSTRAINED, ONE_WORD, TOPO>;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return (int)e;
    if (smem + attr.sharedSizeBytes > (size_t)optin) return TSCHED_ERR_SMEM;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (a.B + PODS - 1) / PODS;
  choose_kernel<CONSTRAINED, ONE_WORD, TOPO><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool CONSTRAINED>
static int launch_widths(const ChooseArgs& a, cudaStream_t stream) {
  const bool one = a.L <= 32 && a.T <= 32 && a.A <= 32 && a.A2 <= 32 && a.Ts <= 32;
  if (a.gang_id != nullptr)
    return one ? launch<CONSTRAINED, true, true>(a, stream) : launch<CONSTRAINED, false, true>(a, stream);
  return one ? launch<CONSTRAINED, true, false>(a, stream) : launch<CONSTRAINED, false, false>(a, stream);
}

static int check_args(const ChooseArgs& a) {
  if (a.R < 2 || a.N < 0 || a.L < 0 || a.T < 0 || a.A < 0 || a.A2 < 0 || a.Ts < 0 || a.Ts >= MAX_SOFT_WIDTH ||
      a.Wb < 0 || a.Ss < 0 || a.S < 0 || a.Tp < 0)
    return (int)cudaErrorInvalidValue;
  if (a.gang_id != nullptr) {  // the gang term: every operand, 1..MAX_LEVELS levels, a non-empty domain axis
    if (!a.dom_col || !a.level_dist || !a.placed || !a.total || !a.rem || !a.dom_free || !a.herd || a.Lv < 1 ||
        a.Lv > MAX_LEVELS || a.Dt < 1)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

static void gang_args(ChooseArgs& a, const void* gang_id, const void* dom_col, const void* level_dist,
                      const void* placed, const void* total, const void* rem, const void* dom_free, const void* herd,
                      int Lv, int Dt, float w_gang) {
  a.gang_id = (const int32_t*)gang_id, a.dom_col = (const int32_t*)dom_col;
  a.level_dist = (const float*)level_dist, a.placed = (const float*)placed, a.total = (const float*)total;
  a.rem = (const float*)rem, a.dom_free = (const float*)dom_free, a.herd = (const float*)herd;
  a.Lv = Lv, a.Dt = Dt, a.w_gang = w_gang;
}

static ChooseArgs base_args(const void* req, const void* sel, const void* selc, const void* ntol, const void* aff,
                            const void* has_aff, const void* pref_w, const void* ntol_soft, const void* active,
                            const void* ranks, const void* avail, const void* alloc, const void* valid,
                            const void* labels, const void* taints, const void* node_aff, const void* node_pref,
                            const void* taints_soft, int B, int N, int R, int L, int T, int A, int A2, int Ts,
                            float w_lr, float w_ba, float w_jit, float w_pref, float w_soft, float inv_jit,
                            int jit_pow2, uint32_t salt, uint32_t node_offset, void* choice, void* has, void* best) {
  ChooseArgs a = {};
  a.req = (const int32_t*)req, a.sel = (const float*)sel, a.selc = (const float*)selc, a.ntol = (const float*)ntol;
  a.aff = (const float*)aff, a.has_aff = (const float*)has_aff, a.pref_w = (const float*)pref_w;
  a.ntol_soft = (const float*)ntol_soft, a.active = (const bool*)active, a.ranks = (const int32_t*)ranks;
  a.avail = (const int32_t*)avail, a.alloc = (const int32_t*)alloc, a.valid = (const bool*)valid;
  a.labels = (const uint32_t*)labels, a.taints = (const uint32_t*)taints, a.node_aff = (const uint32_t*)node_aff;
  a.node_pref = (const uint32_t*)node_pref, a.taints_soft = (const uint32_t*)taints_soft;
  a.B = B, a.N = N, a.R = R, a.L = L, a.T = T, a.A = A, a.A2 = A2, a.Ts = Ts;
  a.w_lr = w_lr, a.w_ba = w_ba, a.w_jit = w_jit, a.w_pref = w_pref, a.w_soft = w_soft;
  a.inv_jit = inv_jit, a.jit_pow2 = jit_pow2, a.salt = salt, a.node_offset = node_offset;
  a.choice = (int32_t*)choice, a.has = (bool*)has, a.best = (float*)best;
  return a;
}

extern "C" {

// Both launchers launch on `stream`, allocate nothing and do not
// synchronise.  The node bitmaps are the words of ops/choose.pack_node_words
// ([ceil(W/32), N] int32 each).  The gang term's operands (ChooseArgs), Lv,
// Dt and w_gang carry it, the pointers null without it.  `jit_pow2` says that
// w_jit > 0 is a power of two and `inv_jit` its exact reciprocal.  They return
// cudaGetLastError() after the launch (0 = launched) or TSCHED_ERR_SMEM.

int tsched_choose_launch(const void* req, const void* sel, const void* selc, const void* ntol, const void* aff,
                         const void* has_aff, const void* pref_w, const void* ntol_soft, const void* active,
                         const void* ranks, const void* avail, const void* alloc, const void* valid,
                         const void* labels, const void* taints, const void* node_aff, const void* node_pref,
                         const void* taints_soft, const void* gang_id, const void* dom_col,
                         const void* level_dist, const void* placed, const void* total, const void* rem,
                         const void* dom_free, const void* herd, int B, int N, int R, int L, int T, int A, int A2,
                         int Ts, int Lv, int Dt, float w_lr, float w_ba, float w_jit, float w_pref, float w_soft,
                         float inv_jit, int jit_pow2, float w_gang, uint32_t salt, uint32_t node_offset, void* choice,
                         void* has, void* best, void* stream) {
  if (B <= 0) return 0;
  ChooseArgs a = base_args(req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks, avail, alloc,
                           valid, labels, taints, node_aff, node_pref, taints_soft, B, N, R, L, T, A, A2, Ts, w_lr,
                           w_ba, w_jit, w_pref, w_soft, inv_jit, jit_pow2, salt, node_offset, choice, has, best);
  gang_args(a, gang_id, dom_col, level_dist, placed, total, rem, dom_free, herd, Lv, Dt, w_gang);
  const int bad = check_args(a);
  if (bad) return bad;
  return launch_widths<false>(a, (cudaStream_t)stream);
}

// The constrained choose: the operands of tsched_choose_launch plus the
// pod/node pairs [B, Wb]/[Wb, N] (blocked band), [B, Ss]/[Ss, N] (soft
// spread), [B, S]/[S, N] (hard-spread level), [B, Tp]/[Tp, N] (preferred
// inter-pod), the gang term as tsched_choose_launch takes it, and w_topo
// (profile weight 5) before w_gang.
int tsched_choose_constrained_launch(
    const void* req, const void* sel, const void* selc, const void* ntol, const void* aff, const void* has_aff,
    const void* pref_w, const void* ntol_soft, const void* active, const void* ranks, const void* avail,
    const void* alloc, const void* valid, const void* labels, const void* taints, const void* node_aff,
    const void* node_pref, const void* taints_soft, const void* blk_pod, const void* blk_node, const void* sps_pod,
    const void* sps_node, const void* spd_pod, const void* spl_node, const void* ppaw_pod, const void* ppa_node,
    const void* gang_id, const void* dom_col, const void* level_dist, const void* placed, const void* total,
    const void* rem, const void* dom_free, const void* herd, int B, int N, int R, int L, int T, int A, int A2, int Ts,
    int Wb, int Ss, int S, int Tp, int Lv, int Dt, float w_lr, float w_ba, float w_jit, float w_pref, float w_soft,
    float inv_jit, int jit_pow2, float w_topo, float w_gang, uint32_t salt, uint32_t node_offset, void* choice,
    void* has, void* best, void* stream) {
  if (B <= 0) return 0;
  ChooseArgs a = base_args(req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks, avail, alloc, valid,
                           labels, taints, node_aff, node_pref, taints_soft, B, N, R, L, T, A, A2, Ts, w_lr, w_ba,
                           w_jit, w_pref, w_soft, inv_jit, jit_pow2, salt, node_offset, choice, has, best);
  a.blk_pod = (const float*)blk_pod, a.blk_node = (const float*)blk_node, a.sps_pod = (const float*)sps_pod;
  a.sps_node = (const float*)sps_node, a.spd_pod = (const float*)spd_pod, a.spl_node = (const float*)spl_node;
  a.ppaw_pod = (const float*)ppaw_pod, a.ppa_node = (const float*)ppa_node;
  a.Wb = Wb, a.Ss = Ss, a.S = S, a.Tp = Tp, a.w_topo = w_topo;
  gang_args(a, gang_id, dom_col, level_dist, placed, total, rem, dom_free, herd, Lv, Dt, w_gang);
  const int bad = check_args(a);
  if (bad) return bad;
  return launch_widths<true>(a, (cudaStream_t)stream);
}

const char* tsched_error_string(int code) {
  if (code == TSCHED_ERR_SMEM) return "the pod tile needs more shared memory than one block may use";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
