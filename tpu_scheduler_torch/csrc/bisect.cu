// bisect: the choose kernel's per-pair cost, one piece at a time, for
// Hopper (sm_90a).  One template, five kernels:
//
// bisect_kernel<0..3, ·, ·> replaces scripts/bench_kernel_parts.py::
// make(variant) (its `kern`, launched by `run`), the bisection ladder.  Per
// pod p and node n, with avail = info[0:2], alloc = info[2:4] (int32 [8, N]
// node info):
//   v0  s = fit                                   fit = req <= avail (cpu, mem)
//   v1  s = s + (Σ_k sel[p,k]·labels[k,n] == selc[p] ? 1 : 0)
//   v2  s = s + ((1 − fc) + (1 − fm))·50, then s = s + (1 − |fc − fm|)·100,
//       f = ((alloc − avail) + req) / max(alloc, 1)
//   v3  s = s + h / 65536, h = (rank·2654435761 + n·2246822519) mod 2^32,
//       h = (h ^ (h >> 15)) & 0xFFFF
// and the index of the FIRST maximum of s over all nodes (unmasked).
//
// bisect_kernel<4, ·, ·> replaces scripts/bench_wide_kernel.py::kern
// (launched by `run`), the wide-operand choose: pod_i32 [P, 8] (req cpu, req
// mem, active, rank, …) and pod_f32 [P, F] against node info [8, N] and
// node_f32 [F, N]:
//   mask  fit & (Σ_k pod_f32[p,k]·node_f32[k,n] == pod_f32[p,40]) & active
//   s     ((1 − fc) + (1 − fm))·50, + (1 − |fc − fm|)·100, + h / 65536
// and the first maximum of s over the masked nodes, 0 when none is masked in.
//
// What it computes is what the TPU kernels compute, not block by block: they
// walk node tiles in order and keep a strict '>' running best of each tile's
// first argmax, which is the global first maximum.  Here each lane walks its
// nodes in ascending order with a strict '>' best per pod, and the warp's
// reduction prefers the greater score, then the lower index.
//
// Design, after csrc/choose.cu's unconstrained kernel, not carried over from
// the TPU kernels' blocks:
// * Bitmaps as words.  The count operand (labels; node_f32) holds only 0 and
//   1 in its LIVE rows, those with a non-zero entry, and only zeros in the
//   others (the wrapper checks both, and that the pod operand is 0/1 in the
//   live columns and finite everywhere).  So the float dot product is the
//   exact integer popc(pod_word & node_word), compared with selc as the
//   integer it must equal.  A dead row adds exact zeros (a finite pod value
//   times +0), so only the live rows are packed: bit b of word j is live row
//   32·j + b of the launch's list.  Up to 64 live rows: WORDS = 1 or 2.  The
//   node words are built once per call by the wrapper; the pod words while a
//   warp stages its pods: lane b reads live column 32·j + b of pod p's row
//   and __ballot_sync is the word, in every lane's registers.
// * Node side packed once per call, only what the variant reads: each
//   node's capacities as one vector, (avail c, avail m) for v0-v1 and
//   (avail c, avail m, alloc c, alloc m) from v2, then WORDS planes of N
//   words.  A lane reads a node in one 8- or 16-byte load and one 4-byte
//   load per word, coalesced across the warp.  Per node, before its pods:
//   the capacities as floats (den_c, den_m), the used sums and
//   n·2246822519.
// * A warp owns PODS pods (a tile) and walks every node; the block's eight
//   warps walk the same node sequence, so one warp's read of a row serves
//   the others from L1.  No shared memory and no block barrier: lane p
//   reads pod p's scalars and shuffles them to every lane, the running best
//   is reduced across the warp's lanes alone.  PODS is a template parameter
//   with one value per variant (kTilePods), measured at 4, 8, 16 and 32.
// * No branch between pods: every pod of the tile is scored at every node,
//   so the pods' dependency chains interleave; the wide kernel's mask (fit,
//   count, active) only decides whether a pod's strict-'>' best is updated.
// * The jitter's h / 65536 is h · 2^-16, built exactly in the mantissa:
//   h < 2^16, so 1 + h·2^-16 is a float and subtracting 1 is exact.
// * fc and fm keep __fdiv_rn, as kernel #1 does, so that v2 − v1 reads what
//   #1's divisions cost; a per-node reciprocal needs a proof of correct
//   rounding first (PERF.md §7).
//
// Exactness (the results must equal the float32 reference tree bit for
// bit): every score operation is __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn in
// the reference order, and the build passes -fmad=false (no contraction);
// int32 -> float32 rounds to nearest (__int2float_rn); the used-capacity sum
// wraps in uint32 as int32 does in numpy and XLA; the hash is uint32 with
// wraparound; the counts are exact integers.
//
// What bounds it on the H100: operations, not bytes (8-24 bytes a node,
// read from L2 about once per block of 8·PODS pods; ~40 a pod, read once).
// Measured in the SASS of the pod loop (PERF.md): v0 is 6 compare/select
// instructions a pair and v1 ~10 (the popcount among them), all on the
// integer/select pipe that issues 64 lanes a clock per SM, half the float
// rate, and they run at ~95 % of it; v2, v3 and the wide kernel issue ~50-
// 60 instructions a pair, ~20 of them the two IEEE divisions (a reciprocal,
// five FMAs, a range check and its branch each), at ~90 % of the issue rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define THREADS 256
#define WARPS (THREADS / 32)
#define NO_NODE 0x7fffffff
#define WIDE 4
#define MAX_LIVE 64  // live rows of the count operand: two words
#define FULL 0xffffffffu
// Returned by the launcher (never by CUDA) for an unknown variant, a
// negative width, more than MAX_LIVE live rows or a live row outside the
// operand.
#define TSCHED_BISECT_ERR_ARGS 100002

// Pods per warp of v0, v1, v2, v3 and the wide kernel: the fastest of 4, 8,
// 16 and 32 on the H100 (experiments/bench_bisect_tiles; PERF.md records
// every size's time and each instance's registers and spills).  Larger
// tiles need more registers, so fewer warps per SM hide the latency of the
// divisions' chains; smaller ones re-read the node side more often.
constexpr int kTilePods[5] = {4, 4, 8, 4, 4};

// The launch's live rows of the count operand, ascending.
struct LiveRows {
  int n;
  int32_t col[MAX_LIVE];
};

static __device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// h · 2^-16 exactly, for h < 2^16: 1 + h·2^-16 in the mantissa, less 1.
static __device__ __forceinline__ float unit16(uint32_t h) {
  return __fsub_rn(__uint_as_float(0x3f800000u | (h << 7)), 1.0f);
}

// selc as the integer count it must equal; −1, never met, when no count can
// equal it (not an integer in [0, 2^24)).
static __device__ __forceinline__ int exact_count(float c) {
  return (c >= 0.0f && c < 16777216.0f && floorf(c) == c) ? (int)c : -1;
}

template <int V, int WORDS, int PODS>
__global__ void __launch_bounds__(THREADS) bisect_kernel(
    const int32_t* __restrict__ pod_i, int pod_i_cols, const float* __restrict__ feat, int K,
    const float* __restrict__ selc, int selc_stride, const int32_t* __restrict__ ranks, int ranks_stride,
    const int32_t* __restrict__ nodes, const __grid_constant__ LiveRows live, int P, int N,
    int32_t* __restrict__ out) {
  static_assert(PODS <= 32, "lane p stages pod p");
  using Caps = typename std::conditional<(V >= 2), int4, int2>::type;
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * PODS;
  if (p0 >= P) return;  // the whole warp; no block barrier follows

  // Lane p reads pod p's scalars; a padding pod (p0 + p >= P) is never
  // written, and in the wide kernel never masked in, as an inactive pod.
  int32_t my_rc = 0, my_rm = 0;
  int my_need = -1;
  uint32_t my_rank = 0u;
  if (lane < PODS && p0 + lane < P) {
    const size_t r = (size_t)(p0 + lane);
    my_rc = pod_i[r * pod_i_cols];
    my_rm = pod_i[r * pod_i_cols + 1];
    if constexpr (V >= 1) {
      my_need = exact_count(selc[r * selc_stride]);
      if (V == WIDE && pod_i[r * pod_i_cols + 2] <= 0) my_need = -1;
    }
    if constexpr (V >= 3) my_rank = (uint32_t)ranks[r * ranks_stride];
  }
  int32_t req_c[PODS], req_m[PODS];
  int need[PODS];
  uint32_t rank[PODS], w[PODS][WORDS];
#pragma unroll
  for (int p = 0; p < PODS; ++p) {
    req_c[p] = __shfl_sync(FULL, my_rc, p);
    req_m[p] = __shfl_sync(FULL, my_rm, p);
    need[p] = V >= 1 ? __shfl_sync(FULL, my_need, p) : -1;
    rank[p] = V >= 3 ? __shfl_sync(FULL, my_rank, p) : 0u;
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      const int i = 32 * j + lane;
      const bool bit = V >= 1 && i < live.n && p0 + p < P && feat[(size_t)(p0 + p) * K + live.col[i]] != 0.0f;
      w[p][j] = V >= 1 ? __ballot_sync(FULL, bit) : 0u;
    }
  }

  float bscore[PODS];
  int bidx[PODS];
#pragma unroll
  for (int p = 0; p < PODS; ++p) {
    bscore[p] = -INFINITY;
    bidx[p] = NO_NODE;
  }

  // The node walk: ascending per lane.  Loading each node one node ahead
  // (a register copy per node) measured 1-6 % slower than this (PERF.md).
  const Caps* caps = reinterpret_cast<const Caps*>(nodes);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(nodes) + (size_t)N * (sizeof(Caps) / 4);
  for (int n = lane; n < N; n += 32) {
    const Caps cur = __ldg(caps + n);
    uint32_t cw0 = 0u, cw1 = 0u;
    if constexpr (V >= 1) cw0 = __ldg(words + n);
    if constexpr (V >= 1 && WORDS == 2) cw1 = __ldg(words + (size_t)N + n);
    const int32_t avail_c = cur.x, avail_m = cur.y;
    float den_c = 1.0f, den_m = 1.0f;
    uint32_t used_c = 0u, used_m = 0u, h_node = 0u;
    if constexpr (V >= 2) {
      const int32_t alloc_c = cur.z, alloc_m = cur.w;
      den_c = __int2float_rn(max(alloc_c, 1));
      den_m = __int2float_rn(max(alloc_m, 1));
      used_c = (uint32_t)alloc_c - (uint32_t)avail_c;
      used_m = (uint32_t)alloc_m - (uint32_t)avail_m;
    }
    if constexpr (V >= 3) h_node = (uint32_t)n * 2246822519u;

#pragma unroll
    for (int p = 0; p < PODS; ++p) {
      const bool fit = req_c[p] <= avail_c && req_m[p] <= avail_m;
      bool hit = true;
      if constexpr (V >= 1) {
        int c = __popc(w[p][0] & cw0);
        if constexpr (WORDS == 2) c += __popc(w[p][1] & cw1);
        hit = c == need[p];
      }
      float s = 0.0f;
      if constexpr (V < WIDE) {
        s = fit ? 1.0f : 0.0f;
        if constexpr (V >= 1) s = __fadd_rn(s, hit ? 1.0f : 0.0f);
      }
      if constexpr (V >= 2) {
        const float fc = __fdiv_rn(__int2float_rn((int32_t)(used_c + (uint32_t)req_c[p])), den_c);
        const float fm = __fdiv_rn(__int2float_rn((int32_t)(used_m + (uint32_t)req_m[p])), den_m);
        const float lr = __fmul_rn(__fadd_rn(__fsub_rn(1.0f, fc), __fsub_rn(1.0f, fm)), 50.0f);
        const float ba = __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(fc, fm))), 100.0f);
        s = V == WIDE ? lr : __fadd_rn(s, lr);
        s = __fadd_rn(s, ba);
      }
      if constexpr (V >= 3) {
        uint32_t h = rank[p] * 2654435761u + h_node;
        h = (h ^ (h >> 15)) & 0xFFFFu;
        s = __fadd_rn(s, unit16(h));
      }
      // strict: an equal score later in the walk never replaces
      const bool take = (V != WIDE || (fit && hit)) && s > bscore[p];
      bscore[p] = take ? s : bscore[p];
      bidx[p] = take ? n : bidx[p];
    }
  }

  // (score desc, index asc) across the warp's lanes; lane p writes pod p.
#pragma unroll
  for (int p = 0; p < PODS; ++p) {
    float s = bscore[p];
    int i = bidx[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, s, off);
      const int oi = __shfl_xor_sync(FULL, i, off);
      if (better(os, oi, s, i)) {
        s = os;
        i = oi;
      }
    }
    // 0 for a pod with no node (jnp.argmax of an all −inf row)
    if (lane == p && p0 + p < P) out[p0 + p] = i != NO_NODE ? i : 0;
  }
}

template <int V, int WORDS>
static int launch(const int32_t* pi, int pod_i_cols, const float* ft, int K, const float* sc, int selc_stride,
                  const int32_t* rk, int ranks_stride, const int32_t* nodes, const LiveRows& live, int P, int N,
                  int32_t* o, cudaStream_t st) {
  constexpr int PODS = kTilePods[V];
  const int grid = (P + WARPS * PODS - 1) / (WARPS * PODS);
  bisect_kernel<V, WORDS, PODS><<<grid, THREADS, 0, st>>>(pi, pod_i_cols, ft, K, sc, selc_stride, rk, ranks_stride,
                                                          nodes, live, P, N, o);
  return (int)cudaGetLastError();
}

extern "C" {

// Launches variant 0-3 (the ladder) or 4 (the wide-operand choose) on
// `stream`; allocates nothing and does not synchronise.  Pod rows are read
// at pod_i[p·pod_i_cols + {0, 1}] (requests; + 2 active, wide only),
// feat[p·K + live_cols[i]], selc[p·selc_stride], ranks[p·ranks_stride];
// node n's capacities at nodes[C·n .. C·n + C − 1] (avail c/m; C = 2 for
// variants 0-1, avail c/m, alloc c/m; C = 4 from variant 2), then word j of
// the live rows at nodes[C·N + j·N + n] (variants 1-4; two words for more
// than 32 live rows); 16-byte aligned.  live_cols holds the nlive (<= 64) live rows of
// the count operand, ascending (ignored by variant 0).  Returns
// cudaGetLastError() after the launch (0 = launched) or
// TSCHED_BISECT_ERR_ARGS.
int tsched_bisect_launch(int variant, const void* pod_i, int pod_i_cols, const void* feat, int K, const void* selc,
                         int selc_stride, const void* ranks, int ranks_stride, const void* nodes,
                         const int32_t* live_cols, int nlive, int P, int N, void* out, void* stream) {
  if (P <= 0) return 0;
  if (variant < 0 || variant > WIDE || K < 0 || N < 0 || N > (1 << 30) || nlive < 0 || nlive > MAX_LIVE)
    return TSCHED_BISECT_ERR_ARGS;
  LiveRows live;
  live.n = variant >= 1 ? nlive : 0;
  for (int i = 0; i < MAX_LIVE; ++i) {
    if (i < live.n && (live_cols[i] < 0 || live_cols[i] >= K)) return TSCHED_BISECT_ERR_ARGS;
    live.col[i] = i < live.n ? live_cols[i] : 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* pi = (const int32_t*)pod_i;
  const float* ft = (const float*)feat;
  const float* sc = (const float*)selc;
  const int32_t* rk = (const int32_t*)ranks;
  const int32_t* nd = (const int32_t*)nodes;
  int32_t* o = (int32_t*)out;
  const bool two = live.n > 32;
#define TSCHED_BISECT_ARGS pi, pod_i_cols, ft, K, sc, selc_stride, rk, ranks_stride, nd, live, P, N, o, st
  switch (variant) {
    case 0:
      return launch<0, 1>(TSCHED_BISECT_ARGS);
    case 1:
      return two ? launch<1, 2>(TSCHED_BISECT_ARGS) : launch<1, 1>(TSCHED_BISECT_ARGS);
    case 2:
      return two ? launch<2, 2>(TSCHED_BISECT_ARGS) : launch<2, 1>(TSCHED_BISECT_ARGS);
    case 3:
      return two ? launch<3, 2>(TSCHED_BISECT_ARGS) : launch<3, 1>(TSCHED_BISECT_ARGS);
    default:
      return two ? launch<WIDE, 2>(TSCHED_BISECT_ARGS) : launch<WIDE, 1>(TSCHED_BISECT_ARGS);
  }
#undef TSCHED_BISECT_ARGS
}

// Pods per warp of `variant`'s instances (0 for an unknown variant).
int tsched_bisect_pods(int variant) { return variant >= 0 && variant <= WIDE ? kTilePods[variant] : 0; }

const char* tsched_bisect_error_string(int code) {
  if (code == TSCHED_BISECT_ERR_ARGS)
    return "unknown variant, negative width, more than 64 live rows, or a live row outside the operand";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
