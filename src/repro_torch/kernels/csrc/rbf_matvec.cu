// Fused RBF Gram-matrix x vector product for a fleet of GP experts, sm_90a.
//
//   out[m, q] = sf2 * sum_j exp(-sum_d ((a_qd - b_mjd) / l_d)^2) * v[m, j]
//
// a (Nt, D) queries and b (M, Ni, D) agent inputs arrive as they are (not
// scaled), l (D,) holds the lengthscales and sf2 (1,) = sigma_f^2, both
// read from device memory (no host sync); v (M, Ni) holds each agent's
// weights alpha = C^-1 y. This is the streamed posterior mean of every
// agent in ONE launch per query tile, with O(Nt + M Ni) memory: the
// (M, Nt, Ni) Gram is never formed.
//
// Replaces the TPU kernel repro/kernels/rbf_matvec.py:rbf_matvec_pallas
// (body `_kernel`), which the JAX package vmaps over agents and whose grid
// carries the sum across a sequential j axis in VMEM scratch.
//
// What bounds it on an H100: per (query, point) pair one exp on the
// special-function units (16 a clock an SM) plus 2D + 1 FP32 operations,
// against 4(Nt D + M Ni (D+1) + M Nt) bytes of input and output. At the
// serving tile (Nt 256, M 4, Ni 8100, D 2) that is 8.3 M exps, 1.98 us at
// the SFU rate, and 0.39 MB, 0.12 us at the memory rate: the SFU bounds
// it, and the FP32 pipe (5 of 8 issue slots a pair at D = 2) comes close.
// A launch also pays latencies no pair can hide: on the card its first
// global loads take about 1 us and a cluster barrier about 1 us (PERF.md
// section 6). So the design spends its instructions on the exp, fills the
// card though a tile holds only 2 M pairs an agent, and keeps one barrier
// of each kind:
//   * Thread-block clusters along Ni (design (a) of the redesign): the S
//     blocks of a cluster (S <= 8, the portable size) split one agent's
//     points for one 16-query tile; grid (S, query tiles, M). Query t of
//     the tile is finished by rank t % S: every rank stores its partial
//     for t into that rank's slots[rank][t] through distributed shared
//     memory (map_shared_rank), one cluster.sync() follows, and the
//     finishing rank sums its slots in rank order. Every remote access
//     precedes the barrier, so no second one is needed before a block
//     leaves. One launch, no scratch tensor, no atomics: the summation
//     order is fixed by the geometry alone, so every call is bitwise
//     repeatable.
//   * Inside a block, 8 query groups x 16 point lanes: a thread holds 2
//     queries in registers and walks every 16th 4-point chunk of the
//     block's stage, two chunks an iteration; each 16-byte shared-memory
//     read of a coordinate (or of the weights) feeds 4 points x 2 queries,
//     (D + 1) / 8 reads a pair. The 16 lanes' strands are summed by a
//     fixed __shfl_xor_sync tree (offsets 1, 2, 4, 8).
//   * Stages of up to 1,024 points (a serving split's whole share),
//     coordinate-major and zero-padded to whole chunks (a padded point has
//     weight 0 and adds exactly 0), arrive by 4-byte cp.async (a run of an
//     agent's points starts at any float; a thread copies whole points)
//     into a ring of three buffers: where a share spans stages, the next
//     stage's copy is in flight while the current one is consumed, one
//     block barrier a stage. Nothing else waits before the first stage:
//     the queries, l and sf2 load beside it.
//   * The scaling folds log2(e) in and touches no staged point: with
//     c_d = sqrt(log2 e) / l_d (rounded once from double) and the
//     query's a'_d = c_d a_qd in registers, a pair's difference is one
//     fused multiply-add, a'_d - c_d b_mjd, rounded once; then
//     2^-(sum_d diff_d^2) = exp(-sum_d ((a_qd - b_mjd) / l_d)^2), so a
//     pair costs one MUFU.EX2 (ex2.approx.ftz: a result flushed below
//     2^-126 changes a sum by under 1e-38 |v|) and 2D + 1 FP32
//     operations. Direct differences, not the Pallas kernel's ||a||^2 +
//     ||b||^2 - 2ab expansion: at small D they cost the same and avoid
//     its cancellation.
//   * D = 1, 2, 3, 4 and 8 are compiled with the queries and c in
//     registers; any other D that fits a stage keeps them in shared
//     memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 16;           // point lanes of a query group
constexpr int kQ = 2;                // queries a thread holds
constexpr int kGroups = kThreads / kLanes;
constexpr int kQB = kGroups * kQ;    // queries of a block (its query tile)
constexpr int kChunk = 4 * kLanes;   // points a lane row reads per chunk step
constexpr int kStageMax = 1024;      // points a stage, at most
constexpr int kBuffers = 3;          // cp.async ring: one barrier a stage
constexpr int kMaxSplits = 8;        // portable cluster size
constexpr int kSmemBudget = 47 * 1024;  // dynamic: 48 KB less 1 KB static
constexpr double kSqrtLog2e = 1.2011224087864498;   // sqrt(log2(e))

static_assert(kThreads % kLanes == 0 && (kLanes & (kLanes - 1)) == 0 &&
              kLanes <= 32, "point lanes: a power of two within a warp");
static_assert(kStageMax % kChunk == 0, "a stage holds whole chunk rows");
static_assert((kMaxSplits * kQB + 64) * sizeof(float) <= 1024,
              "the static shared arrays fit the 1 KB kSmemBudget leaves");

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

#ifdef RBF_TIMELINE
// tools/rbf_matvec_timeline.py builds with -DRBF_TIMELINE: thread 0 of a
// block stamps %globaltimer at its start, once its queries are loaded,
// after its last stage, after the cluster barrier and at its end, and its
// SM, into kStamps words a block at `rbf_timeline` (set by the tool).
constexpr int kStamps = 6;
__device__ unsigned long long* rbf_timeline;

__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x != 0 || rbf_timeline == nullptr) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const size_t blk = blockIdx.x + (size_t)gridDim.x *
                     (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
  rbf_timeline[blk * kStamps + k] = t;
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    rbf_timeline[blk * kStamps + kStamps - 1] = sm;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

__device__ __forceinline__ float lane4(const float4& p, int k) {
  return k == 0 ? p.x : k == 1 ? p.y : k == 2 ? p.z : p.w;
}

// One stage: the points [p0, p0 + n) of agent m, coordinate d at
// buf[d * stage + i] and weights at buf[dim * stage + i]; zeros from n up
// to the next whole chunk row. Thread t copies points t, t + kThreads, ...
// (its D coordinates and its weight), so a warp's copies of one row are
// one contiguous run of shared memory.
template <int DT>
__device__ __forceinline__ void issue_stage(float* buf, const float* bm,
                                            const float* vm, int p0, int n,
                                            int D, int stage) {
  const int dim = DT > 0 ? DT : D;
  const int padded = (n + kChunk - 1) / kChunk * kChunk;
  for (int i = threadIdx.x; i < padded; i += kThreads) {
    if (i < n) {
      const float* src = bm + (size_t)(p0 + i) * dim;
#pragma unroll(DT > 0 ? DT : 1)
      for (int d = 0; d < dim; ++d) cp_async4(buf + d * stage + i, src + d);
      cp_async4(buf + dim * stage + i, vm + p0 + i);
    } else {
#pragma unroll(DT > 0 ? DT + 1 : 1)
      for (int d = 0; d <= dim; ++d) buf[d * stage + i] = 0.f;
    }
  }
}

// DT > 0: D known at compile time, the block's queries in registers;
// DT == 0: any D that fits a stage, the scaled queries in shared memory.
template <int DT>
__global__ void __launch_bounds__(kThreads)
rbf_matvec_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ v, const float* __restrict__ ls,
                  const float* __restrict__ sf2, float* __restrict__ out,
                  int Nt, int Ni, int D, int per_split, int stage) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float slots[kMaxSplits][kQB];   // partials pushed by the ranks
  __shared__ float sc[DT > 0 ? 1 : 64];      // DT == 0: c_d
  const int dim = DT > 0 ? DT : D;
  const int S = gridDim.x;
  const int rank = blockIdx.x;       // the cluster spans gridDim.x
  const int q0 = blockIdx.y * kQB;
  const int m = blockIdx.z;
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  float* sq = smem + kBuffers * (dim + 1) * stage;   // DT == 0: (kQB, D)

  stamp(0);
  const float* bm = b + (size_t)m * Ni * dim;
  const float* vm = v + (size_t)m * Ni;
  const int j0 = min(Ni, rank * per_split);
  const int n_block = min(Ni, j0 + per_split) - j0;
  const int stages = (n_block + stage - 1) / stage;

  // in flight together: stage 0, the queries, l and sf2 (no barrier
  // before the first stage's)
  if (stages > 0)
    issue_stage<DT>(smem, bm, vm, j0, min(stage, n_block), D, stage);
  cp_async_commit();
  const float sf2v = sf2[0];
  float qa[kQ][DT > 0 ? DT : 1];
  float cs[DT > 0 ? DT : 1];
  if constexpr (DT > 0) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      cs[d] = (float)(kSqrtLog2e / (double)ls[d]);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int q = q0 + group * kQ + i;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        qa[i][d] = q < Nt ? a[(size_t)q * DT + d] * cs[d] : 0.f;
    }
  } else {
    if (threadIdx.x < dim)
      sc[threadIdx.x] = (float)(kSqrtLog2e / (double)ls[threadIdx.x]);
    for (int e = threadIdx.x; e < kQB * dim; e += kThreads) {
      const int q = q0 + e / dim;
      sq[e] = q < Nt ? a[(size_t)q0 * dim + e] *
                           (float)(kSqrtLog2e / (double)ls[e % dim])
                     : 0.f;
    }
  }
  stamp(1);

  float acc[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) acc[i] = 0.f;
  for (int s = 0; s < stages; ++s) {
    float* buf = smem + (s % kBuffers) * (dim + 1) * stage;
    const int n = min(stage, n_block - s * stage);
    if (s + 1 < stages)
      issue_stage<DT>(smem + ((s + 1) % kBuffers) * (dim + 1) * stage, bm,
                      vm, j0 + (s + 1) * stage,
                      min(stage, n_block - (s + 1) * stage), D, stage);
    cp_async_commit();
    cp_async_wait<1>();              // this thread's copies of stage s
    __syncthreads();                 // stage s landed for every copier

    const float4* p4 = reinterpret_cast<const float4*>(buf);
    const int s4 = stage / 4;
    const int chunks = (n + kChunk - 1) / kChunk * kChunk / 4;
#pragma unroll 2
    for (int c = lane; c < chunks; c += kLanes) {
      float nd2[4][kQ];
#pragma unroll(DT > 0 ? DT : 1)
      for (int d = 0; d < dim; ++d) {
        const float4 p = p4[d * s4 + c];
        float cd;
        if constexpr (DT > 0) cd = cs[d];
        else cd = sc[d];
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          float qd;
          if constexpr (DT > 0) qd = qa[i][d];
          else qd = sq[(group * kQ + i) * dim + d];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float diff = fmaf(-cd, lane4(p, k), qd);
            nd2[k][i] = d == 0 ? -diff * diff : fmaf(-diff, diff, nd2[k][i]);
          }
        }
      }
      const float4 w = p4[dim * s4 + c];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          acc[i] = fmaf(lane4(w, k), ex2(nd2[k][i]), acc[i]);
    }
  }
  cp_async_wait<0>();                // nothing in flight past this point
  stamp(2);

  // the lanes' strands: a fixed butterfly, equal in every lane after it
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
#pragma unroll
    for (int i = 0; i < kQ; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);

  // the cluster's partials: query t is finished by rank t % S, into whose
  // slots[rank][t] each rank stores its partial (distributed shared
  // memory); after the one cluster barrier, the finishing rank sums its
  // slots in rank order. Every remote store precedes the barrier, so no
  // block's shared memory is touched after it leaves.
  cg::cluster_group cluster = cg::this_cluster();
  if (lane == 0 && S > 1) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int t = group * kQ + i;
      *cluster.map_shared_rank(&slots[rank][t], t % S) = acc[i];
    }
  } else if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) slots[0][group * kQ + i] = acc[i];
  }
  cluster.sync();
  stamp(3);
  const int t = threadIdx.x;
  if (t < kQB && t % S == rank && q0 + t < Nt) {
    float total = 0.f;
    for (int r = 0; r < S; ++r) total += slots[r][t];
    out[(size_t)m * Nt + q0 + t] = total * sf2v;
  }
  stamp(4);
}

template <int DT>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* a, const float* b, const float* v,
                   const float* ls, const float* sf2, float* out, int Nt,
                   int Ni, int D, int per_split, int stage) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rbf_matvec_kernel<DT>, a, b, v, ls, sf2,
                            out, Nt, Ni, D, per_split, stage);
}

}  // namespace

extern "C" {

// The compile-time geometry, for the wrapper to check against its own:
// threads a block, point lanes, queries a thread, points a stage at most,
// splits a cluster at most.
void rbf_matvec_constants(int* out) {
  out[0] = kThreads;
  out[1] = kLanes;
  out[2] = kQ;
  out[3] = kStageMax;
  out[4] = kMaxSplits;
}

// Points a stage for input dimension D: kStageMax while kBuffers stages of
// (D + 1) floats a point and the block's queries fit the default 48 KB of
// shared memory less 1 KB for the static arrays, fewer whole chunk rows
// above that; 0 means D is too large for one stage.
int rbf_matvec_stage(int D) {
  if (D < 1 || D > 64) return 0;
  const int floats = kSmemBudget / (int)sizeof(float) - kQB * D;
  int stage = floats / (kBuffers * (D + 1)) / kChunk * kChunk;
  return stage > kStageMax ? kStageMax : stage;
}

// a (Nt, D), b (M, Ni, D), v (M, Ni), ls (D,), sf2 (1,), all float32 and
// contiguous on the current device; writes out (M, Nt). `splits` blocks
// (one cluster) share each agent's points for each 16-query tile.
// Returns the CUDA error code of the launch (0 on success).
int rbf_matvec_launch(const float* a, const float* b, const float* v,
                      const float* ls, const float* sf2, float* out, int Nt,
                      int M, int Ni, int D, int splits, cudaStream_t stream) {
  const int stage = rbf_matvec_stage(D);
  const int qtiles = (Nt + kQB - 1) / kQB;
  if (stage == 0 || splits < 1 || splits > kMaxSplits || Nt < 1 || M < 1 ||
      Ni < 0 || qtiles > 65535 || M > 65535)
    return cudaErrorInvalidValue;
  const int per_split = (Ni + splits - 1) / splits;
  const dim3 grid(splits, qtiles, M);
  const size_t smem = (size_t)(kBuffers * (D + 1) * stage + kQB * D) *
                      sizeof(float);
  cudaError_t err;
  switch (D) {
    case 1: err = launch<1>(grid, smem, stream, a, b, v, ls, sf2, out, Nt, Ni, D, per_split, stage); break;
    case 2: err = launch<2>(grid, smem, stream, a, b, v, ls, sf2, out, Nt, Ni, D, per_split, stage); break;
    case 3: err = launch<3>(grid, smem, stream, a, b, v, ls, sf2, out, Nt, Ni, D, per_split, stage); break;
    case 4: err = launch<4>(grid, smem, stream, a, b, v, ls, sf2, out, Nt, Ni, D, per_split, stage); break;
    case 8: err = launch<8>(grid, smem, stream, a, b, v, ls, sf2, out, Nt, Ni, D, per_split, stage); break;
    default: err = launch<0>(grid, smem, stream, a, b, v, ls, sf2, out, Nt, Ni, D, per_split, stage); break;
  }
  // read (and so clear) the runtime's last error whatever the launch
  // returned: a refused launch must not be reported by the next good one
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

#ifdef RBF_TIMELINE
int rbf_matvec_set_timeline(unsigned long long* buf) {
  return (int)cudaMemcpyToSymbol(rbf_timeline, &buf, sizeof(buf));
}

// Clusters of `splits` blocks of the D = 2 kernel that fit the card at
// once, at the shared memory a D = 2 launch asks for.
int rbf_matvec_max_active_clusters(int splits) {
  const int stage = rbf_matvec_stage(2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)(kBuffers * 3 * stage + kQB * 2) *
                         sizeof(float);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, (void*)rbf_matvec_kernel<2>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
#endif

const char* rbf_matvec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
