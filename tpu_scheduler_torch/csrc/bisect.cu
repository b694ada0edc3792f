// bisect: the choose kernel's per-pair cost, one piece at a time, for
// Hopper (sm_90a).  One template, five kernels:
//
// bisect_kernel<0..3> replaces scripts/bench_kernel_parts.py::make(variant)
// (its `kern`, launched by `run`), the bisection ladder.  Per pod p and node
// n, with avail = info[0:2], alloc = info[2:4] (int32 [8, N] node info):
//   v0  s = fit                                   fit = req <= avail (cpu, mem)
//   v1  s = s + (Σ_k sel[p,k]·labels[k,n] == selc[p] ? 1 : 0)
//   v2  s = s + ((1 − fc) + (1 − fm))·50, then s = s + (1 − |fc − fm|)·100,
//       f = ((alloc − avail) + req) / max(alloc, 1)
//   v3  s = s + h / 65536, h = (rank·2654435761 + n·2246822519) mod 2^32,
//       h = (h ^ (h >> 15)) & 0xFFFF
// and the index of the FIRST maximum of s over all nodes (unmasked).
//
// bisect_kernel<4> replaces scripts/bench_wide_kernel.py::kern (launched by
// `run`), the wide-operand choose: pod_i32 [P, 8] (req cpu, req mem, active,
// rank, …) and pod_f32 [P, F] against node info [8, N] and node_f32 [F, N]:
//   mask  fit & (Σ_k pod_f32[p,k]·node_f32[k,n] == pod_f32[p,40]) & active
//   s     ((1 − fc) + (1 − fm))·50, + (1 − |fc − fm|)·100, + h / 65536
// and the first maximum of s over the masked nodes, 0 when none is masked in.
//
// What it computes is what the TPU kernels compute, not block by block: they
// walk node tiles in order and keep a strict '>' running best of each tile's
// first argmax, which is the global first maximum.  Here each thread walks
// its nodes in ascending order with a strict '>' best per pod, and the
// block reduction prefers the greater score, then the lower index.
//
// Exactness (the results must equal the float32 reference tree bit for
// bit): every score operation is __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn in
// the reference order, and the build passes -fmad=false (no contraction);
// int32 -> float32 rounds to nearest (__int2float_rn); the used-capacity sum
// wraps in uint32 as int32 does in numpy and XLA; the hash is uint32 with
// wraparound; the 0/1 dot is an exact float sum of small integers (no
// matmul, no TF32), so summing in any order — and skipping zero node
// entries — gives the same value.
//
// What bounds it on the H100: operations.  A pair costs ~5 ops (v0) to
// ~2·nnz + 35 (v3, the wide kernel) against ~50 bytes per node and ~40 per
// pod, read once per 8-pod tile from L2.  Design, as csrc/choose.cu: one
// thread block per tile of 8 pods staged in shared memory (broadcast reads),
// 256 threads striding over the nodes, the node's info read once and reused
// for the 8 pods in registers, a warp-shuffle then shared-memory
// (score desc, index asc) reduction.  Nothing carries across blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define PODS 8
#define NO_NODE 0x7fffffff
#define WIDE 4
// Returned by the launcher (never by CUDA) for an unknown variant or a pod
// tile beyond the default 48 KB of shared memory.
#define TSCHED_BISECT_ERR_ARGS 100002

static __device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

template <int V>
__global__ void __launch_bounds__(THREADS) bisect_kernel(
    const int32_t* __restrict__ pod_i, int pod_i_cols, const float* __restrict__ feat, int K,
    const float* __restrict__ selc, int selc_stride, const int32_t* __restrict__ ranks, int ranks_stride,
    const int32_t* __restrict__ info, const float* __restrict__ node_f, int P, int N, int32_t* __restrict__ out) {
  extern __shared__ float sfeat[];  // [PODS][K]
  __shared__ int32_t s_req[PODS][2];
  __shared__ float s_selc[PODS];
  __shared__ uint32_t s_rank[PODS];
  __shared__ int s_in[PODS];
  __shared__ float red_score[WARPS][PODS];
  __shared__ int red_idx[WARPS][PODS];

  const int p0 = blockIdx.x * PODS;
  const int np = min(PODS, P - p0);
  if constexpr (V >= 1) {
    for (int i = threadIdx.x; i < PODS * K; i += THREADS) {
      const int p = i / K, k = i % K;
      sfeat[i] = p < np ? feat[(size_t)(p0 + p) * K + k] : 0.0f;
    }
  }
  if (threadIdx.x < PODS) {
    const int p = threadIdx.x;
    const bool in = p < np;
    const size_t row = (size_t)(p0 + p);
    s_req[p][0] = in ? pod_i[row * pod_i_cols] : 0;
    s_req[p][1] = in ? pod_i[row * pod_i_cols + 1] : 0;
    s_selc[p] = in ? selc[row * selc_stride] : 0.0f;
    s_rank[p] = in ? (uint32_t)ranks[row * ranks_stride] : 0u;
    // Padding pods take no part; the wide kernel also masks inactive pods.
    s_in[p] = in && (V != WIDE || pod_i[row * pod_i_cols + 2] > 0);
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
    const int32_t avail_c = info[n], avail_m = info[N + n];
    const int32_t alloc_c = info[2 * N + n], alloc_m = info[3 * N + n];
    float cnt[PODS];
#pragma unroll
    for (int p = 0; p < PODS; ++p) cnt[p] = 0.0f;
    if constexpr (V >= 1) {
      for (int k = 0; k < K; ++k) {
        const float v = node_f[(size_t)k * N + n];
        if (v == 0.0f) continue;  // adds exact zeros only
#pragma unroll
        for (int p = 0; p < PODS; ++p) cnt[p] = __fadd_rn(cnt[p], __fmul_rn(sfeat[p * K + k], v));
      }
    }
    const float den_c = __int2float_rn(max(alloc_c, 1)), den_m = __int2float_rn(max(alloc_m, 1));
    const uint32_t used_c = (uint32_t)alloc_c - (uint32_t)avail_c;
    const uint32_t used_m = (uint32_t)alloc_m - (uint32_t)avail_m;
    const uint32_t h_node = (uint32_t)n * 2246822519u;

#pragma unroll
    for (int p = 0; p < PODS; ++p) {
      if (!s_in[p]) continue;
      const bool fit = s_req[p][0] <= avail_c && s_req[p][1] <= avail_m;
      if (V == WIDE && !(fit && cnt[p] == s_selc[p])) continue;
      float s = 0.0f;
      if constexpr (V < WIDE) {
        s = fit ? 1.0f : 0.0f;
        if constexpr (V >= 1) s = __fadd_rn(s, cnt[p] == s_selc[p] ? 1.0f : 0.0f);
      }
      if constexpr (V >= 2) {
        const float fc = __fdiv_rn(__int2float_rn((int32_t)(used_c + (uint32_t)s_req[p][0])), den_c);
        const float fm = __fdiv_rn(__int2float_rn((int32_t)(used_m + (uint32_t)s_req[p][1])), den_m);
        const float lr = __fmul_rn(__fadd_rn(__fsub_rn(1.0f, fc), __fsub_rn(1.0f, fm)), 50.0f);
        const float ba = __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(fc, fm))), 100.0f);
        s = V == WIDE ? lr : __fadd_rn(s, lr);
        s = __fadd_rn(s, ba);
      }
      if constexpr (V >= 3) {
        uint32_t h = s_rank[p] * 2654435761u + h_node;
        h = (h ^ (h >> 15)) & 0xFFFFu;
        s = __fadd_rn(s, __fdiv_rn(__uint2float_rn(h), 65536.0f));
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
  if (threadIdx.x < np) {
    const int p = threadIdx.x;
    float s = -INFINITY;
    int i = NO_NODE;
    for (int w = 0; w < WARPS; ++w) {
      if (better(red_score[w][p], red_idx[w][p], s, i)) {
        s = red_score[w][p];
        i = red_idx[w][p];
      }
    }
    out[p0 + p] = i != NO_NODE ? i : 0;  // 0 for a pod with no node (jnp.argmax of an all −inf row)
  }
}

extern "C" {

// Launches variant 0-3 (the ladder) or 4 (the wide-operand choose) on
// `stream`; allocates nothing and does not synchronise.  Pod rows are read
// at pod_i[p·pod_i_cols + {0, 1}] (requests; + 2 active, wide only),
// feat[p·K + k], selc[p·selc_stride], ranks[p·ranks_stride]; node rows at
// info[r·N + n] (r = 0-3) and node_f[k·N + n].  Returns cudaGetLastError()
// after the launch (0 = launched) or TSCHED_BISECT_ERR_ARGS.
int tsched_bisect_launch(int variant, const void* pod_i, int pod_i_cols, const void* feat, int K, const void* selc,
                         int selc_stride, const void* ranks, int ranks_stride, const void* info, const void* node_f,
                         int P, int N, void* out, void* stream) {
  if (P <= 0) return 0;
  if (variant < 0 || variant > WIDE || K < 0 || N < 0) return TSCHED_BISECT_ERR_ARGS;
  const size_t smem = variant >= 1 ? sizeof(float) * (size_t)PODS * (size_t)K : 0;
  if (smem > 48 * 1024) return TSCHED_BISECT_ERR_ARGS;
  const int grid = (P + PODS - 1) / PODS;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* pi = (const int32_t*)pod_i;
  const float* ft = (const float*)feat;
  const float* sc = (const float*)selc;
  const int32_t* rk = (const int32_t*)ranks;
  const int32_t* in = (const int32_t*)info;
  const float* nf = (const float*)node_f;
  int32_t* o = (int32_t*)out;
  switch (variant) {
    case 0:
      bisect_kernel<0><<<grid, THREADS, smem, st>>>(pi, pod_i_cols, ft, K, sc, selc_stride, rk, ranks_stride, in,
                                                    nf, P, N, o);
      break;
    case 1:
      bisect_kernel<1><<<grid, THREADS, smem, st>>>(pi, pod_i_cols, ft, K, sc, selc_stride, rk, ranks_stride, in,
                                                    nf, P, N, o);
      break;
    case 2:
      bisect_kernel<2><<<grid, THREADS, smem, st>>>(pi, pod_i_cols, ft, K, sc, selc_stride, rk, ranks_stride, in,
                                                    nf, P, N, o);
      break;
    case 3:
      bisect_kernel<3><<<grid, THREADS, smem, st>>>(pi, pod_i_cols, ft, K, sc, selc_stride, rk, ranks_stride, in,
                                                    nf, P, N, o);
      break;
    default:
      bisect_kernel<WIDE><<<grid, THREADS, smem, st>>>(pi, pod_i_cols, ft, K, sc, selc_stride, rk, ranks_stride,
                                                       in, nf, P, N, o);
      break;
  }
  return (int)cudaGetLastError();
}

const char* tsched_bisect_error_string(int code) {
  if (code == TSCHED_BISECT_ERR_ARGS) return "unknown variant, negative width, or a pod tile over 48 KB";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
