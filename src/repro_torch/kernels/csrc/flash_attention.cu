// FlashAttention-2 forward with GQA, causal and sliding-window masks,
// sm_90a.
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
//
// over the keys j that the mask admits: queries are right-aligned to the
// key timeline (q_pos = i + Sk - Sq, so Sq <= Sk), causal keeps
// k_pos <= q_pos, a window w keeps k_pos > q_pos - w. q (B, H, Sq, D),
// k and v (B, KH, Sk, D) with g = H / KH, float32 or bfloat16, contiguous;
// o (B, H, Sq, D) in q's type. Everything is computed in float32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body `_flash_kernel`), which walks a sequential
// grid axis over the key blocks and carries the running max, denominator
// and accumulator in VMEM scratch from one grid step to the next. Here a
// block of 128 threads owns 64 query rows of one (b, h) and loops over the
// key blocks itself; nothing crosses blocks, so there is no second pass and
// no atomic, and a result is bitwise repeatable.
//
// What bounds it on an H100: operations. At the prefill of internlm2-1.8b
// (B 4, H 16, KH 8, S 2,048, D 128, causal) the two products are
// 4 B H D S (S + 1) / 2 = 68.7 GFLOP, about 1.03 ms at the 67 TFLOP/s of
// float32 FMA on the CUDA cores, against 0.2 GB of q, k, v and o (0.06 ms
// at 3.35 TB/s). This first port runs both products as CUDA-core FMAs
// (a bf16 tensor-core design would be bound near 0.07 ms; that is the
// next redesign). What the design does about its bound:
//   * each thread holds an 8 x 4 tile of the 64 x 64 score block and an
//     8 x D/16 slice of the output accumulator in registers, so a float4
//     read from shared memory feeds 8 to 32 FMAs;
//   * the score loop reads K at a padded row stride (D + 4 floats), so the
//     eight threads of a 128-bit load phase hit distinct banks; Q and P
//     rows are read as broadcasts;
//   * key blocks wholly outside the causal/window band are skipped, and
//     the query blocks with the longest causal band start first;
//   * the scale and log2(e) are folded into Q as it is staged, and the
//     softmax uses exp2f: one SFU op a score.
// K and V share one shared-memory tile (K for the scores, then V for the
// product), so a block needs 83 KB at D = 128 and two blocks fit an SM.
//
// Masked scores are -inf. A row whose keys so far are all masked (the
// first blocks of a sliding window) subtracts 0 instead of its -inf
// running max, so its p and correction are exp2(-inf) = 0 and not
// inf - inf = NaN; the TPU kernel avoids the same NaN with a finite
// -1e30 sentinel. With Sq <= Sk every row has at least one admitted key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // key rows per tile
constexpr int kThreads = 128;            // 8 row groups x 16 lanes
constexpr int kRows = kBQ / (kThreads / 16);   // query rows per thread: 8
constexpr int kCols = kBK / 16;                // score columns per thread: 4
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK, "stage() moves kBK-row tiles of Q, K and V");

template <int D>
struct Tile {
  static constexpr int KS = D + 4;             // padded K/V row stride
  static constexpr int VW = D >= 64 ? 4 : 2;   // output columns per vector
  static constexpr int NV = D / (16 * VW);     // vectors per thread and row
  static constexpr int OC = NV * VW;           // output columns per thread
  static constexpr size_t kFloats = (size_t)kBQ * D + (size_t)kBK * KS +
                                    (size_t)kBQ * kBK;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// N (2 or 4) consecutive outputs of one row
template <int N>
__device__ __forceinline__ void store_out(float* p, const float (&x)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

template <int N>
__device__ __forceinline__ void store_out(__nv_bfloat16* p,
                                          const float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + e) =
        __floats2bfloat162_rn(x[e], x[e + 1]);
}

// rows x D elements of src (row stride D) into dst (row stride `stride`),
// as float32 times `mul`; rows at or past `valid` are zero.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int valid, float mul) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < kBK * V4; idx += kThreads) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      f = load4(src + (size_t)r * D + c);
      f.x *= mul; f.y *= mul; f.z *= mul; f.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int KH, int Sq,
          int Sk, int causal, int window, float qmul) {
  using Sh = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // (kBQ, D), scaled by qmul
  float* KVs = Qs + kBQ * D;               // (kBK, KS): K, then V
  float* Ps = KVs + kBK * Sh::KS;          // (kBQ, kBK) probabilities

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest band first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qb * kBQ;
  const int qrows = min(kBQ, Sq - q0);
  const int off = Sk - Sq;                 // right alignment
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = ty * kRows;               // this thread's first row

  const T* qp = q + ((size_t)(b * H + h) * Sq + q0) * D;
  const T* kp = k + (size_t)(b * KH + kvh) * Sk * D;
  const T* vp = v + (size_t)(b * KH + kvh) * Sk * D;

  stage<D>(Qs, D, qp, qrows, qmul);

  // the keys any row of this block may admit
  const int kend = causal ? min(Sk, q0 + qrows + off) : Sk;
  const int kbeg = window > 0 ? max(0, q0 + off - window + 1) : 0;

  float acc[kRows][Sh::OC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < Sh::OC; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = (kbeg / kBK) * kBK; k0 < kend; k0 += kBK) {
    const int krows = min(kBK, Sk - k0);
    __syncthreads();                       // last tile's P and V are used
    stage<D>(KVs, Sh::KS, kp + (size_t)k0 * D, krows, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            KVs + (tx + 16 * j) * Sh::KS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (r0 + i) * D + d);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mnew = fmaxf(m[i], mx);
      const float mref = mnew == -INFINITY ? 0.f : mnew;
      const float corr = exp2f(m[i] - mref);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = exp2f(s[i][j] - mref);
        sum += p;
        Ps[(r0 + i) * kBK + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + sum;
      m[i] = mnew;
#pragma unroll
      for (int e = 0; e < Sh::OC; ++e) acc[i][e] *= corr;
    }
    __syncthreads();                       // scores done with K; P written
    stage<D>(KVs, Sh::KS, vp + (size_t)k0 * D, krows, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (r0 + i) * kBK + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[Sh::OC];
        const float* vrow = KVs + (c + u) * Sh::KS;
#pragma unroll
        for (int n = 0; n < Sh::NV; ++n) {
          const int col = (n * 16 + tx) * Sh::VW;
          if constexpr (Sh::VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + col);
            vv[n * 4 + 0] = t.x; vv[n * 4 + 1] = t.y;
            vv[n * 4 + 2] = t.z; vv[n * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + col);
            vv[n * 2 + 0] = t.x; vv[n * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y
                        : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int e = 0; e < Sh::OC; ++e)
            acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

  // each of a row's 16 threads summed the p of its own columns
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float lt = l[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, w);
    const int r = q0 + r0 + i;
    if (r >= Sq) continue;
    const float inv = 1.f / lt;
    T* orow = o + ((size_t)(b * H + h) * Sq + r) * D;
#pragma unroll
    for (int n = 0; n < Sh::NV; ++n) {
      float x[Sh::VW];
#pragma unroll
      for (int e = 0; e < Sh::VW; ++e) x[e] = acc[i][n * Sh::VW + e] * inv;
      store_out<Sh::VW>(orow + (n * 16 + tx) * Sh::VW, x);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Sq, int Sk, int causal, int window,
           float qmul, cudaStream_t stream) {
  const size_t smem = Tile<D>::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, causal,
      window, qmul);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int KH, int Sq, int Sk, int causal, int window,
             float qmul, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, qmul, stream);
    case 64: return launch<64, T>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, qmul, stream);
    case 128: return launch<128, T>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, qmul, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 if the kernel is built for head dimension D.
int flash_attention_supports_dim(int D) {
  return D == 32 || D == 64 || D == 128;
}

// q (B, H, Sq, D), k and v (B, KH, Sk, D), o (B, H, Sq, D), contiguous on
// the current device, 16-byte aligned, all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1). window <= 0 means no window. Returns the CUDA
// error code of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KH, int Sq, int Sk,
                           int D, int bf16, int causal, int window,
                           float scale, cudaStream_t stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sq > Sk ||
      !flash_attention_supports_dim(D) || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float qmul = scale * kLog2e;
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, KH, Sq, Sk,
                                        causal, window, qmul, stream)
              : dispatch<float>(D, q, k, v, o, B, H, KH, Sq, Sk, causal,
                                window, qmul, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
