// Fused RBF Gram-matrix x vector product for a fleet of GP experts, sm_90a.
//
//   out[m, q] = sf2 * sum_j exp(-||a_q - b_{m,j}||^2) * v[m, j]
//
// a (Nt, D) queries and b (M, Ni, D) agent inputs arrive pre-scaled by
// 1/lengthscale, v (M, Ni) holds each agent's weights alpha = C^-1 y, and
// sf2 = sigma_f^2 is read from device memory (no host sync). This is the
// streamed posterior mean of every agent in ONE launch per query tile, with
// O(Nt + M Ni) memory: the (M, Nt, Ni) Gram is never formed.
//
// Replaces the TPU kernel repro/kernels/rbf_matvec.py:rbf_matvec_pallas
// (body `_kernel`), which the JAX package vmaps over agents and whose grid
// carries the sum across a sequential j axis in VMEM scratch.
//
// What bounds it on an H100: per (query, point) pair one exp on the SFU
// plus about 3 + 2D FP32 operations, against 4(Nt D + M Ni (D+1) + M Nt)
// bytes of input and output. At the serving shapes (Nt 256, M 4, Ni 8100,
// D 2) that is 8.3 M exps and 0.39 MB, so the SFU's exp rate bounds it,
// far below the memory bound. The design therefore keeps every byte
// on-chip after one read and spends the instructions on the exp:
//   * one query per thread, its coordinates in registers;
//   * a block loops over its share of Ni itself (no cross-block carry),
//     staging (point, weight) tiles in shared memory that all its threads
//     read as broadcasts;
//   * Ni is split across blocks so a 256-query tile of a 4-agent fleet
//     still fills the 132 SMs; a second launch sums the splits in a fixed
//     order, so results are deterministic (no atomics);
//   * direct differences sum_d (a_d - b_d)^2 instead of the Pallas
//     kernel's ||a||^2 + ||b||^2 - 2ab expansion: at small D they cost
//     the same and avoid the cancellation that the Pallas clamp hides;
//   * exp(-x) as exp2f(-x log2 e), one SFU ex2 per pair.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // queries per block
constexpr float kLog2e = 1.4426950408889634f;

// DT > 0: D known at compile time (query held in registers);
// DT == 0: any D, query read from global memory (L1-cached).
template <int DT>
__global__ void __launch_bounds__(kThreads)
rbf_matvec_partial(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ v,
                   const float* __restrict__ params, float* __restrict__ part,
                   int Nt, int Ni, int D, int per_split, int tile) {
  extern __shared__ float smem[];
  const int dim = DT > 0 ? DT : D;
  float* sb = smem;                  // (dim, tile): coordinate-major
  float* sv = smem + dim * tile;     // (tile,)
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int m = blockIdx.z;
  const int M = gridDim.z;
  const bool live = q < Nt;

  float qa[DT > 0 ? DT : 1];
  if constexpr (DT > 0) {
#pragma unroll
    for (int d = 0; d < DT; ++d) qa[d] = live ? a[(size_t)q * DT + d] : 0.f;
  }

  const float* bm = b + (size_t)m * Ni * dim;
  const float* vm = v + (size_t)m * Ni;
  const int j0 = split * per_split;
  const int j1 = min(Ni, j0 + per_split);
  float acc = 0.f;
  for (int t0 = j0; t0 < j1; t0 += tile) {
    const int n = min(tile, j1 - t0);
    __syncthreads();                 // the previous tile is consumed
    // the tile is one contiguous run of n*dim floats: coalesced reads
    for (int i = threadIdx.x; i < n * dim; i += kThreads) {
      const int j = i / dim;
      sb[(i - j * dim) * tile + j] = bm[(size_t)t0 * dim + i];
    }
    for (int j = threadIdx.x; j < n; j += kThreads) sv[j] = vm[t0 + j];
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        float d2 = 0.f;
        if constexpr (DT > 0) {
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const float diff = qa[d] - sb[d * tile + j];
            d2 = fmaf(diff, diff, d2);
          }
        } else {
          for (int d = 0; d < dim; ++d) {
            const float diff = a[(size_t)q * dim + d] - sb[d * tile + j];
            d2 = fmaf(diff, diff, d2);
          }
        }
        acc = fmaf(sv[j], exp2f(-kLog2e * d2), acc);
      }
    }
  }
  if (live) part[((size_t)split * M + m) * Nt + q] = acc * params[0];
}

// out[i] = sum_s part[s, i], in split order (deterministic).
__global__ void rbf_matvec_reduce(const float* __restrict__ part,
                                  float* __restrict__ out, int splits,
                                  int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
  out[i] = s;
}

template <int DT>
void launch_partial(dim3 grid, size_t smem, cudaStream_t stream,
                    const float* a, const float* b, const float* v,
                    const float* params, float* part, int Nt, int Ni, int D,
                    int per_split, int tile) {
  rbf_matvec_partial<DT><<<grid, kThreads, smem, stream>>>(
      a, b, v, params, part, Nt, Ni, D, per_split, tile);
}

}  // namespace

extern "C" {

// Shared-memory tile (points per stage) for input dimension D: 256 points
// while (D + 1) floats each fit the default 48 KB, fewer (a multiple of
// 32) above that. 0 means D is too large for one stage.
int rbf_matvec_tile(int D) {
  const int budget = 48 * 1024 / (int)sizeof(float);
  int tile = budget / (D + 1);
  if (tile >= 256) return 256;
  return tile >= 32 ? tile / 32 * 32 : 0;
}

// a (Nt, D), b (M, Ni, D), v (M, Ni), params (1,) = sigma_f^2, all float32
// and contiguous on the current device. With splits > 1, `part` is scratch
// of splits * M * Nt floats; with splits == 1 it may be null. Writes out
// (M, Nt). Returns the CUDA error code of the launches (0 on success).
int rbf_matvec_launch(const float* a, const float* b, const float* v,
                      const float* params, float* part, float* out, int Nt,
                      int M, int Ni, int D, int splits, cudaStream_t stream) {
  const int tile = rbf_matvec_tile(D);
  if (tile == 0 || splits < 1 || Nt < 1 || M < 1) return cudaErrorInvalidValue;
  const int per_split = (Ni + splits - 1) / splits;
  const dim3 grid((Nt + kThreads - 1) / kThreads, splits, M);
  const size_t smem = (size_t)(D + 1) * tile * sizeof(float);
  float* dst = splits == 1 ? out : part;
  switch (D) {
    case 1: launch_partial<1>(grid, smem, stream, a, b, v, params, dst, Nt, Ni, D, per_split, tile); break;
    case 2: launch_partial<2>(grid, smem, stream, a, b, v, params, dst, Nt, Ni, D, per_split, tile); break;
    case 3: launch_partial<3>(grid, smem, stream, a, b, v, params, dst, Nt, Ni, D, per_split, tile); break;
    case 4: launch_partial<4>(grid, smem, stream, a, b, v, params, dst, Nt, Ni, D, per_split, tile); break;
    case 8: launch_partial<8>(grid, smem, stream, a, b, v, params, dst, Nt, Ni, D, per_split, tile); break;
    default: launch_partial<0>(grid, smem, stream, a, b, v, params, dst, Nt, Ni, D, per_split, tile); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int count = M * Nt;
  rbf_matvec_reduce<<<(count + 255) / 256, 256, 0, stream>>>(part, out,
                                                             splits, count);
  return (int)cudaGetLastError();
}

const char* rbf_matvec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
