// One-pass trace-identity NLL gradient sums for a fleet of GP agents, sm_90a.
//
// For every agent m, over its whole N x N plane:
//
//   K    = sf2 * exp(-sum_d p_d d2u[d])       p_d = 1 / l_d^2
//   W    = inner * K
//   out[m, d]     = sum W * d2u[d]            d < D   (lengthscales)
//   out[m, D]     = sum W                             (sigma_f)
//   out[m, D + 1] = sum_i inner[i, i]                 (sigma_eps, the trace)
//
// d2u (M, D, N, N) is the once-per-fit unscaled diff^2 stack, inner
// (M, N, N) = C^-1 - alpha alpha^T of the current ADMM iteration, params
// (M, D + 1) = [p_1..p_D, sf2] per agent, read from device memory (no host
// sync). The caller applies the chain rule to log-theta.
//
// Replaces the TPU kernel repro/kernels/nll_grad.py:nll_grad_pallas (body
// `_nll_grad_kernel`), which the JAX package vmaps over agents on inputs
// zero-padded to 256-multiples, carrying partial rows across a sequential
// column axis in VMEM.
//
// What bounds it on an H100: every element of d2u and inner is read once
// and used once, 4 (D + 1) bytes per element against one exp and about
// 2D + 4 FP32 operations. At the training shape (M 4, N 8100, D 2) that is
// 3.15 GB: 0.94 ms at 3.35 TB/s, far above the 0.06 ms the exps need. So
// the design spends nothing on arithmetic tricks and everything on
// streaming the bytes once:
//   * no padding: bounds come from N, ragged planes need no copy;
//   * one launch for the whole fleet: grid (row blocks, agents), each block
//     takes rows b, b + B, b + 2B, ... of its agent's plane, with enough
//     blocks to fill the 132 SMs several times over at M = 4;
//   * inside a row, threads read consecutive columns (coalesced), as float4
//     when N % 4 == 0 (every row then starts 16-byte aligned), with
//     streaming loads (__ldcs) since nothing is read twice;
//   * K is rebuilt in registers and never stored;
//   * the trace is the global row == column test inside the agent's plane;
//   * each thread sums one row into fresh accumulators before adding it to
//     its running totals (short float32 chains), the block reduces through
//     warp shuffles and shared memory in a fixed order, and a second launch
//     sums the blocks' partial rows in order: no atomics, so two calls on
//     the same inputs give bitwise equal results.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 32;            // generic path: D up to this

// DT > 0: D fixed at compile time; DT == 0: any D <= kMaxD (loops keep
// compile-time bounds and test d < D, so arrays stay in registers).
template <int DT>
struct Acc {
  static constexpr int kD = DT > 0 ? DT : kMaxD;
  float s[kD + 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < kD + 2; ++k) s[k] = 0.f;
  }
};

template <int DT>
__device__ __forceinline__ void accumulate(Acc<DT>& a, const float* x,
                                           float in, const float* p,
                                           float sf2, int D, bool diag) {
  constexpr int kD = Acc<DT>::kD;
  float d2s = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d)
    if (DT > 0 || d < D) d2s = fmaf(p[d], x[d], d2s);
  const float w = in * (sf2 * expf(-d2s));
#pragma unroll
  for (int d = 0; d < kD; ++d)
    if (DT > 0 || d < D) a.s[d] = fmaf(w, x[d], a.s[d]);
  a.s[kD] += w;
  if (diag) a.s[kD + 1] += in;
}

template <int DT, bool VEC>
__global__ void __launch_bounds__(kThreads)
nll_grad_partial(const float* __restrict__ d2u,
                 const float* __restrict__ inner,
                 const float* __restrict__ params, float* __restrict__ part,
                 int N, int D) {
  constexpr int kD = Acc<DT>::kD;
  const int dim = DT > 0 ? DT : D;
  const int b = blockIdx.x, B = gridDim.x, m = blockIdx.y;
  const size_t plane = (size_t)N * N;
  const float* in_m = inner + (size_t)m * plane;
  const float* d2_m = d2u + (size_t)m * dim * plane;

  float p[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d)
    p[d] = (DT > 0 || d < dim) ? params[(size_t)m * (dim + 1) + d] : 0.f;
  const float sf2 = params[(size_t)m * (dim + 1) + dim];

  Acc<DT> tot, row;
  tot.zero();
  for (int r = b; r < N; r += B) {
    const size_t off = (size_t)r * N;
    row.zero();
    if constexpr (VEC) {
      const float4* in4 = reinterpret_cast<const float4*>(in_m + off);
      for (int c4 = threadIdx.x; c4 < N / 4; c4 += kThreads) {
        const float4 iv = __ldcs(in4 + c4);
        float4 xv[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d)
          if (DT > 0 || d < dim)
            xv[d] = __ldcs(reinterpret_cast<const float4*>(
                               d2_m + d * plane + off) + c4);
        const float ivs[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x[kD];
#pragma unroll
          for (int d = 0; d < kD; ++d) {
            const float4 v = xv[d];
            x[d] = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
          }
          accumulate<DT>(row, x, ivs[j], p, sf2, dim, 4 * c4 + j == r);
        }
      }
    } else {
      for (int c = threadIdx.x; c < N; c += kThreads) {
        float x[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d)
          x[d] = (DT > 0 || d < dim) ? __ldcs(d2_m + d * plane + off + c)
                                      : 0.f;
        accumulate<DT>(row, x, __ldcs(in_m + off + c), p, sf2, dim, c == r);
      }
    }
#pragma unroll
    for (int k = 0; k < kD + 2; ++k) tot.s[k] += row.s[k];
  }

  // block reduction in a fixed order: warp shuffles, then warp sums
  __shared__ float red[kWarps][kD + 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kD + 2; ++k) {
    float v = tot.s[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  // output slot k of D + 2: lengthscales 0..dim-1, then sum W, then trace
  if (threadIdx.x < dim + 2) {
    const int k = threadIdx.x;
    const int src = k < dim ? k : kD + (k - dim);
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][src];
    part[((size_t)m * B + b) * (dim + 2) + k] = s;
  }
}

// out[m, k] = sum_b part[m, b, k], in block order (deterministic).
__global__ void nll_grad_reduce(const float* __restrict__ part,
                                float* __restrict__ out, int M, int B,
                                int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * K) return;
  const int m = i / K, k = i - m * K;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[((size_t)m * B + b) * K + k];
  out[i] = s;
}

template <int DT>
void launch_partial(dim3 grid, bool vec, cudaStream_t stream,
                    const float* d2u, const float* inner,
                    const float* params, float* part, int N, int D) {
  // the generic path reads scalars: kMaxD float4 operands would not fit
  // in registers
  if constexpr (DT > 0) {
    if (vec) {
      nll_grad_partial<DT, true><<<grid, kThreads, 0, stream>>>(
          d2u, inner, params, part, N, D);
      return;
    }
  }
  nll_grad_partial<DT, false><<<grid, kThreads, 0, stream>>>(
      d2u, inner, params, part, N, D);
}

}  // namespace

extern "C" {

// d2u (M, D, N, N), inner (M, N, N), params (M, D + 1), all float32 and
// contiguous on the current device; part is scratch of M * blocks * (D + 2)
// floats; writes out (M, D + 2). vec != 0 takes float4 loads for D in
// {1, 2, 3, 4, 8} and needs N % 4 == 0 and 16-byte aligned d2u and inner. Returns the CUDA error code
// of the launches (0 on success).
int nll_grad_launch(const float* d2u, const float* inner,
                    const float* params, float* part, float* out, int M,
                    int N, int D, int blocks, int vec, cudaStream_t stream) {
  if (M < 1 || N < 1 || D < 1 || D > kMaxD || blocks < 1 ||
      (vec && N % 4 != 0))
    return cudaErrorInvalidValue;
  const dim3 grid(blocks, M);
  switch (D) {
    case 1: launch_partial<1>(grid, vec, stream, d2u, inner, params, part, N, D); break;
    case 2: launch_partial<2>(grid, vec, stream, d2u, inner, params, part, N, D); break;
    case 3: launch_partial<3>(grid, vec, stream, d2u, inner, params, part, N, D); break;
    case 4: launch_partial<4>(grid, vec, stream, d2u, inner, params, part, N, D); break;
    case 8: launch_partial<8>(grid, vec, stream, d2u, inner, params, part, N, D); break;
    default: launch_partial<0>(grid, vec, stream, d2u, inner, params, part, N, D); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int count = M * (D + 2);
  nll_grad_reduce<<<(count + 127) / 128, 128, 0, stream>>>(part, out, M,
                                                           blocks, D + 2);
  return (int)cudaGetLastError();
}

const char* nll_grad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
