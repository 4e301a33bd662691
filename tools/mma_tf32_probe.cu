// Throughput probe: mma.sync.m16n8k8 with TF32 operands and float32
// accumulators on sm_90a, alone and with the split of each B operand into
// hi and lo (cvt.rna.tf32.f32, a subtract, cvt) in registers, as the
// flash_attention kernel does per K and V fragment. Each warp runs `iters`
// rounds over 8 independent accumulators; nothing is read from memory
// inside the loop. Built and timed by tools/mma_tf32_probe.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// round to TF32, nearest, ties away, by integer ops: add half of the 13
// dropped bits to the magnitude and clear them (cvt.rna's result for a
// finite x)
__device__ __forceinline__ uint32_t tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the split of x into TF32 hi and lo by mode: 1 cvt.rna for both, 2
// integer rounding for both, 3 integer rounding for hi and cvt.rna for lo,
// 4 Veltkamp's split (hi = c - (c - x), c = 8193 x) with lo = x - hi
// left for the tensor core to truncate (nvcc contracts c - x into an FMA,
// so this split is not exact; it is timed only)
template <int kMode>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kMode == 1) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else if (kMode == 2) {
    hi = tf32_int(x);
    lo = tf32_int(x - __uint_as_float(hi));
  } else if (kMode == 3) {
    hi = tf32_int(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    const float c = x * 8193.f;
    const float h = c - (c - x);
    hi = __float_as_uint(h);
    lo = __float_as_uint(x - h);
  }
}

// split == 0: one MMA per accumulator and round (bare rate);
// split == 1..4: the B operand (two floats) split into hi and lo each
// round by that mode, then three MMAs (lo hi, hi lo, hi hi)
template <int kSplit>
__global__ void __launch_bounds__(256)
probe(const float* in, float* out, int iters) {
  extern __shared__ unsigned char pad[];   // only sets blocks per SM
  const int lane = threadIdx.x & 31;
  uint32_t ah[4], al[4];
  float b[8][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = in[lane * 4 + i];
    ah[i] = tf32(x);
    al[i] = tf32(x - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b[j][0] = in[128 + lane * 16 + 2 * j];
    b[j][1] = in[128 + lane * 16 + 2 * j + 1];
  }
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kSplit) {
        uint32_t h0, h1, l0, l1;
        split<kSplit>(b[j][0], h0, l0);
        split<kSplit>(b[j][1], h1, l1);
        mma(acc[j], al, h0, h1);
        mma(acc[j], ah, l0, l1);
        mma(acc[j], ah, h0, h1);
        b[j][0] *= 1.0000001f;             // a new operand each round
        b[j][1] *= 0.9999999f;
      } else {
        mma(acc[j], ah, __float_as_uint(b[j][0]), __float_as_uint(b[j][1]));
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// MMAs a launch issues
long long mma_probe_count(int blocks, int iters, int split) {
  return (long long)blocks * 8 * iters * 8 * (split ? 3 : 1);
}

int mma_probe_launch(const float* in, float* out, int blocks, int iters,
                     int split, int smem_bytes, cudaStream_t stream) {
  void (*const kernels[])(const float*, float*, int) = {
      probe<0>, probe<1>, probe<2>, probe<3>, probe<4>};
  if (split < 0 || split > 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernels[split], cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernels[split]<<<blocks, 256, smem_bytes, stream>>>(in, out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
