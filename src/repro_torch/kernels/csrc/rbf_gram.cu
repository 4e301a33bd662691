// Tiled squared-exponential Gram panel for a fleet of sparse GP experts,
// sm_90a.
//
//   out[a, i, j] = sf2 * exp(-sum_d (z[a, i, d] - x[a, col0 + j, d])^2)
//                  (+ noise2 where i == col0 + j, with_noise only)
//
// for inducing inputs z (M, m, D) and agent inputs x (M, N, D), both
// pre-scaled by 1/lengthscale, and j < width. Columns past the agent's N
// points (col0 + j >= N) are written 0: the tail panel of a streamed
// Kmn = k(Z, X) contributes nothing to B = Kmn Knm or b = Kmn y. params
// (2,) = (sigma_f^2, noise^2) is read from device memory (no host sync).
// One launch covers every agent's (m, width) panel.
//
// Replaces the TPU kernel repro/kernels/rbf_gram.py:rbf_gram_pallas (body
// `_rbf_gram_kernel`), which the JAX package vmaps over agents and feeds
// one (m, 4096) panel at a time to the blocked Titsias statistics
// (repro/kernels/ops.py:kmn_stats).
//
// What bounds it on an H100: the (M, m, width) float32 output written once.
// At the fit panel (M 4, m 512, width 4096, D 2) that is 33.6 MB, about
// 0.010 ms at 3.35 TB/s, against 8.4 M exps, 0.002 ms on the SFUs, and
// 0.4 MB of inputs. So the design spends nothing on the inputs and keeps
// the stores coalesced:
//   * one column per thread, its point held in registers, 128 threads a
//     block, so each row of the tile is one 512-byte coalesced store;
//   * a block computes kRows rows of its columns from inducing points
//     staged once in shared memory and read as broadcasts;
//   * direct differences sum_d (z_d - x_d)^2 instead of the Pallas
//     kernel's ||z||^2 + ||x||^2 - 2zx expansion: at small D they cost the
//     same, and the expansion cancels catastrophically in float32 for near
//     points, which inducing points and their own data are;
//   * exp(-x) as exp2f(-x log2 e), one SFU ex2 per element.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;           // columns per block, one per thread
constexpr int kRows = 32;            // rows per block
constexpr float kLog2e = 1.4426950408889634f;

// DT > 0: D known at compile time (the point held in registers);
// DT == 0: any D, the point read from global memory (L1-cached).
template <int DT>
__global__ void __launch_bounds__(kCols)
rbf_gram_panel(const float* __restrict__ z, const float* __restrict__ x,
               const float* __restrict__ params, float* __restrict__ out,
               int m, int N, int D, int col0, int width, int with_noise) {
  extern __shared__ float sz[];      // (rows, dim) inducing points
  const int dim = DT > 0 ? DT : D;
  const int a = blockIdx.z;
  const int i0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - i0);
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int col = col0 + j;

  // the block's inducing points are one contiguous run of rows*dim floats
  const float* za = z + ((size_t)a * m + i0) * dim;
  for (int t = threadIdx.x; t < rows * dim; t += kCols) sz[t] = za[t];
  __syncthreads();
  if (j >= width) return;

  float* o = out + ((size_t)a * m + i0) * width + j;
  if (col >= N) {                    // past the agent's points: exact 0
    for (int r = 0; r < rows; ++r) o[(size_t)r * width] = 0.f;
    return;
  }
  const float* xa = x + ((size_t)a * N + col) * dim;
  float xr[DT > 0 ? DT : 1];
  if constexpr (DT > 0) {
#pragma unroll
    for (int d = 0; d < DT; ++d) xr[d] = xa[d];
  }
  const float sf2 = params[0];
  const float noise2 = params[1];
  for (int r = 0; r < rows; ++r) {
    float d2 = 0.f;
    if constexpr (DT > 0) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float diff = sz[r * DT + d] - xr[d];
        d2 = fmaf(diff, diff, d2);
      }
    } else {
      for (int d = 0; d < dim; ++d) {
        const float diff = sz[r * dim + d] - xa[d];
        d2 = fmaf(diff, diff, d2);
      }
    }
    float k = sf2 * exp2f(-kLog2e * d2);
    if (with_noise && i0 + r == col) k += noise2;
    o[(size_t)r * width] = k;
  }
}

template <int DT>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const float* z,
            const float* x, const float* params, float* out, int m, int N,
            int D, int col0, int width, int with_noise) {
  rbf_gram_panel<DT><<<grid, kCols, smem, stream>>>(
      z, x, params, out, m, N, D, col0, width, with_noise);
}

}  // namespace

extern "C" {

// Largest input dimension D whose kRows inducing points fit the default
// 48 KB of shared memory.
int rbf_gram_max_dim() { return 48 * 1024 / (int)sizeof(float) / kRows; }

// z (M, m, D), x (M, N, D), params (2,) = (sigma_f^2, noise^2), all float32
// and contiguous on the current device. Writes out (M, m, width): columns
// col0 .. col0 + width - 1 of each agent's k(z_a, x_a), zero past N.
// Returns the CUDA error code of the launch (0 on success).
int rbf_gram_launch(const float* z, const float* x, const float* params,
                    float* out, int M, int m, int N, int D, int col0,
                    int width, int with_noise, cudaStream_t stream) {
  if (M < 1 || m < 1 || width < 1 || D < 1 || D > rbf_gram_max_dim() ||
      col0 < 0)
    return cudaErrorInvalidValue;
  const dim3 grid((width + kCols - 1) / kCols, (m + kRows - 1) / kRows, M);
  const size_t smem = (size_t)kRows * D * sizeof(float);
  switch (D) {
    case 1: launch<1>(grid, smem, stream, z, x, params, out, m, N, D, col0, width, with_noise); break;
    case 2: launch<2>(grid, smem, stream, z, x, params, out, m, N, D, col0, width, with_noise); break;
    case 3: launch<3>(grid, smem, stream, z, x, params, out, m, N, D, col0, width, with_noise); break;
    case 4: launch<4>(grid, smem, stream, z, x, params, out, m, N, D, col0, width, with_noise); break;
    case 8: launch<8>(grid, smem, stream, z, x, params, out, m, N, D, col0, width, with_noise); break;
    default: launch<0>(grid, smem, stream, z, x, params, out, m, N, D, col0, width, with_noise); break;
  }
  return (int)cudaGetLastError();
}

const char* rbf_gram_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
