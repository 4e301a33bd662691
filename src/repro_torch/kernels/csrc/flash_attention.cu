// FlashAttention-2 forward with GQA, causal and sliding-window masks, on
// the tensor cores of sm_90a with float32 accuracy.
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
//
// over the keys j that the mask admits: queries are right-aligned to the
// key timeline (q_pos = i + Sk - Sq), causal keeps k_pos <= q_pos, a
// window w keeps k_pos > q_pos - w. The wrapper allows Sq > Sk (a negative
// offset Sk - Sq) only with neither: then kbeg = 0, kend = Sk, no tile is
// skipped, only the ragged last one is cut, and the per-key mask reduces
// to k_pos < Sk, so q_pos never enters (the whisper decoder's
// cross-attention, a prompt longer than its 1,500 frames). q (B, H, Sq, D),
// k and v (B, KH, Sk, D) with g = H / KH, float32 or bfloat16, contiguous;
// o (B, H, Sq, D) in q's type. Everything is computed in float32. With a
// non-null lse (B, H, Sq) float32 it also writes each row's log-sum-exp
// of its admitted scaled scores, ln sum_j exp(scale q . k_j), which the
// training backward (kernels/flash_attention.py: flash_attention_bwd, a
// port of repro/kernels/flash_jnp.py:_flash_bwd) recomputes p from; a
// null lse (serving) writes nothing more.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body `_flash_kernel`, products at its two
// dot_generals), which walks a sequential grid axis over the key blocks
// and carries the running max, denominator and accumulator in VMEM
// scratch from one grid step to the next. Here a block of 8 warps owns
// 128 query rows of one (b, h), 16 rows a warp, and loops over 64-key
// tiles itself; nothing crosses blocks, so there is no second pass and no
// atomic, and a result is bitwise repeatable.
//
// Products: split TF32 on the tensor cores ("3xTF32"). A float32 x splits
// into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and a product is
// lo*hi' + hi*lo' + hi*hi', each an mma.sync.m16n8k8 with TF32 operands
// and a float32 accumulator; the dropped lo*lo' and the rounding of lo
// cost about 3 * 2^-22 of |x x'|, a few float32 ulps. One TF32 pass alone
// keeps about 3 digits and is not used. bfloat16 inputs are exact in TF32
// (lo = 0), so their passes with a zero lo are dropped: q.k is one pass
// (hi*hi', the scale applied to the float32 scores), p.v two (p_lo*v and
// p_hi*v, p being float32).
//
// What bounds it on an H100: the tensor cores. At the prefill of
// internlm2-1.8b (B 4, H 16, KH 8, S 2,048, D 128, causal, float32) the
// two products are 4 B H D S (S + 1) / 2 = 68.7 GFLOP, three passes each:
// 0.417 ms at the 495 TFLOP/s of dense TF32 (0.032 ms of SFU exp2, 0.060 ms
// of bytes for q, k, v and o; 1.03 ms for the same products as CUDA-core
// float32 FMAs). mma.sync reaches about 320 TFLOP/s on this card
// (tools/mma_tf32_probe.py), 0.65 ms for the three passes; the rest of the
// time is the splitting, the softmax and the waits at the two barriers of
// each tile. What the design does about it:
//   * P stays in registers. The score accumulator holds, per lane, the
//     columns (2t, 2t+1) of an 8-key n-tile; those two values serve as the
//     A operand's columns t and t + 4 of the p.v product, so each n-tile's
//     keys are taken in the order kappa(c) = (c >> 1) + 4 (c & 1): score
//     column c of n-tile j is key 8 j + kappa(c), and V's rows are read in
//     the same order (B rows t and t + 4 are keys 8 j + t and 8 j + t + 4).
//     No shuffle and no shared-memory P.
//   * The reduction index d of q.k is permuted in groups of 16 (k-step
//     2s + i, column t is d = 16 s + 4 t + 2 i, column t + 4 is that + 1),
//     so a lane's K operand for two k-steps is one 16-byte load; V's output
//     columns are permuted so that a lane's B operand for four n-tiles is
//     one 16-byte load (n-tile n, column c is d = 32 (n >> 2) + 16 (c & 1)
//     + 4 (c >> 1) + (n & 3)) and the accumulator's rows store as float4s.
//     At the padded row stride D + 4 (float) both loads are free of bank
//     conflicts.
//   * K and V are split once a tile, in shared memory, by the threads that
//     copied them (hi in place, lo beside it): splitting each fragment in
//     every warp cost 8 times the work and set the time (1.5-1.8 ms).
//     Q is kept as float32 in the A operand's fragment order and split per
//     warp and tile (its hi and lo do not fit beside K's and V's).
//   * K and V arrive by cp.async into separate buffers, two barriers a
//     tile: tile j's V is in flight during tile j's scores, tile j + 1's K
//     during tile j's p.v.
//   * Key tiles wholly outside the causal/window band of the block are not
//     visited, and a warp skips a tile that masks all its rows; masks are
//     computed only on tiles that cut the band; the query blocks with the
//     longest causal band start first, across all heads.
//   * The scale and log2(e) multiply the float32 scores; the softmax uses
//     ex2.approx: one SFU op a score.
// Shared memory: Q, K's and V's hi and lo, 196 KB at D = 128 in float32
// (one block, 8 warps, an SM), 100 KB at D = 64; bf16 keeps K and V as
// they are (98 KB at D = 128).
//
// Masked scores are -inf. A row whose keys so far are all masked (the
// first tiles of a sliding window) subtracts 0 instead of its -inf
// running max, so its p and correction are exp2(-inf) = 0 and not
// inf - inf = NaN; the TPU kernel avoids the same NaN with a finite
// -1e30 sentinel. With Sq <= Sk, or with neither mask, every row has at
// least one admitted key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 128;                 // query rows per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kWarps = kBQ / 16;         // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kBK / 8;             // 8-key n-tiles of a score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, typename T>
struct Tile {
  static constexpr bool kSplit = std::is_same<T, float>::value;  // lo != 0
  static constexpr int KS = D + 16 / (int)sizeof(T);  // K/V row stride
  static constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16 B a row
  static constexpr int kCopies = kBK * kChunks / kThreads;  // per thread
  static constexpr size_t kQFloats = (size_t)kBQ * D;
  // Q; K and V (float32: their hi, then their lo)
  static constexpr size_t kBytes = 4 * kQFloats +
      (kSplit ? 4 : 2) * sizeof(T) * (size_t)kBK * KS;
  // blocks an SM that the register budget is set for: float32 needs more
  // than 128 registers a thread at every D (one block, no spill)
  static constexpr int kMinBlocks = kSplit || D == 128 ? 1 : 2;
  static_assert(kBK * kChunks % kThreads == 0, "whole copies per thread");
  static_assert(D % 32 == 0, "D is 32, 64 or 128");
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32, hi = cvt.rna(x) and lo = cvt.rna(x - hi). hi
// by two integer ops (add half of the 13 dropped bits to the magnitude,
// clear them: cvt.rna's result for a finite x, without the NaN test that
// ptxas emits for cvt); lo by cvt, so a NaN x (whose integer rounding may
// wrap) still gives a NaN lo and a NaN product
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = tf32(x - __uint_as_float(hi));
}

// 2^x on the SFU, one instruction: ex2.approx (relative error about
// 2^-22), results below 2^-126 flushed to 0 (a p that small is below the
// rounding of its row's sum, which is at least 1)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// d += a b: A 16 x 8 (row), B 8 x 8 (col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four consecutive elements as float32 (bf16 -> float32 is exact)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&lo);
  r.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// a tile of kBK rows of src (row stride D) into dst (row stride KS) by
// cp.async, copy `it` of a thread being row i / kChunks, 16-byte chunk
// i % kChunks with i = it * kThreads + threadIdx.x; rows at or past
// `valid` are zero-filled and not read
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int valid) {
  using Sh = Tile<D, T>;
  constexpr int per = 16 / (int)sizeof(T);
#pragma unroll
  for (int it = 0; it < Sh::kCopies; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / Sh::kChunks, c = (i % Sh::kChunks) * per;
    const bool ok = r < valid;
    cp_async16(dst + r * Sh::KS + c, src + (size_t)(ok ? r : 0) * D + c, ok);
  }
}

// split the float32 chunks this thread copied into hi (in place) and lo:
// once a tile, not once a warp
template <int D>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  using Sh = Tile<D, float>;
#pragma unroll
  for (int it = 0; it < Sh::kCopies; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int at = (i / Sh::kChunks) * Sh::KS + (i % Sh::kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + at);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// Q rows (row stride D; rows at or past `valid` are zero) as float32 in
// the A operand's fragment order: warp w, 16-column group s, half h (rows
// g or g + 8 of the warp), lane 4 g + t hold q[16 w + 8 h + g][16 s + 4 t
// + e] for e < 4 at (((w * D / 16 + s) * 2 + h) * 32 + 4 g + t) * 4 + e
template <int D, typename T>
__device__ __forceinline__ void stage_q(float* Qs, const T* src, int valid) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < kBQ * V4; i += kThreads) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      if constexpr (Tile<D, T>::kSplit)
        x = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D + c));
      else
        x = load4(src + (size_t)r * D + c);
    }
    const int slot =
        ((((r >> 4) * (D / 16) + (c >> 4)) * 2 + ((r >> 3) & 1)) * 32 +
         (r & 7) * 4 + ((c >> 2) & 3)) * 4;
    *reinterpret_cast<float4*>(Qs + slot) = x;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, Tile<D, T>::kMinBlocks)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int H, int KH, int Sq, int Sk, int causal,
          int window, float qmul) {
  using Sh = Tile<D, T>;
  constexpr int NO = D / 8;                // output n-tiles a warp
  constexpr int KV = kBK * Sh::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  T* Kh = reinterpret_cast<T*>(Qs + Sh::kQFloats);   // K, or its hi
  T* Vh = Kh + KV;                                   // V, or its hi
  T* Kl = Sh::kSplit ? Vh + KV : Kh;                 // float32: lo halves
  T* Vl = Sh::kSplit ? Vh + 2 * KV : Vh;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int qb = gridDim.y - 1 - blockIdx.y;   // longest band first
  const int kvh = h / (H / KH);
  const int q0 = qb * kBQ;
  const int qrows = min(kBQ, Sq - q0);
  const int off = Sk - Sq;                 // right alignment
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qlo = q0 + 16 * warp + off;    // q_pos of the warp's row 0
  const bool dead = 16 * warp >= qrows;    // no row of the warp is real

  const T* qp = q + ((size_t)(b * H + h) * Sq + q0) * D;
  const T* kp = k + (size_t)(b * KH + kvh) * Sk * D;
  const T* vp = v + (size_t)(b * KH + kvh) * Sk * D;

  // the key tiles any row of this block may admit
  const int kend = causal ? min(Sk, q0 + qrows + off) : Sk;
  const int kbeg = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int t0 = kbeg / kBK, t1 = (kend + kBK - 1) / kBK;

  load_tile<D>(Kh, kp + (size_t)t0 * kBK * D, Sk - t0 * kBK);
  cp_commit();
  stage_q<D>(Qs, qp, qrows);

  // this lane's operand offsets: Q fragments; K row 8 j + kappa(g),
  // columns 16 p + 4 t; V rows 8 j + t (+ 4), columns 32 c + 16 (g & 1)
  // + 4 (g >> 1)
  const float* qfrag = Qs + (size_t)warp * (D / 16) * 256 + lane * 4;
  const int kat = ((g >> 1) + 4 * (g & 1)) * Sh::KS + 4 * t;
  const int vat = t * Sh::KS + 16 * (g & 1) + 4 * (g >> 1);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = t0; tile < t1; ++tile) {
    const int k0 = tile * kBK;
    cp_wait<0>();                          // this thread's K copies are in
    if constexpr (Sh::kSplit) split_tile<D>(Kh, Kl);
    __syncthreads();                       // the tile's K (and Q) for all;
                                           // every warp is done with V
    load_tile<D>(Vh, vp + (size_t)k0 * D, Sk - k0);
    cp_commit();

    // whether the tile masks every row of the warp, or cuts its band
    const bool skip = dead || (causal && k0 > qlo + 15) ||
                      (window > 0 && k0 + kBK - 1 <= qlo - window);
    const bool cut = k0 + kBK > Sk || (causal && k0 + kBK - 1 > qlo) ||
                     (window > 0 && k0 <= qlo + 15 - window);
    float s[kNT][4];
    if (!skip) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        // rows g and g + 8, columns 16 p + 4 t .. + 3: k-step 2 p takes
        // elements 0, 1 as columns t, t + 4; k-step 2 p + 1 elements 2, 3
        const float4 x0 = load4(qfrag + p * 256);
        const float4 x1 = load4(qfrag + p * 256 + 128);
        uint32_t ah[2][4], al[2][4];
        if constexpr (Sh::kSplit) {
          split(x0.x, ah[0][0], al[0][0]);
          split(x1.x, ah[0][1], al[0][1]);
          split(x0.y, ah[0][2], al[0][2]);
          split(x1.y, ah[0][3], al[0][3]);
          split(x0.z, ah[1][0], al[1][0]);
          split(x1.z, ah[1][1], al[1][1]);
          split(x0.w, ah[1][2], al[1][2]);
          split(x1.w, ah[1][3], al[1][3]);
        } else {                           // bf16 q: exact in TF32
          ah[0][0] = __float_as_uint(x0.x); ah[0][1] = __float_as_uint(x1.x);
          ah[0][2] = __float_as_uint(x0.y); ah[0][3] = __float_as_uint(x1.y);
          ah[1][0] = __float_as_uint(x0.z); ah[1][1] = __float_as_uint(x1.z);
          ah[1][2] = __float_as_uint(x0.w); ah[1][3] = __float_as_uint(x1.w);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int at = kat + 8 * j * Sh::KS + 16 * p;
          if constexpr (Sh::kSplit) {
            const uint4 bh = *reinterpret_cast<const uint4*>(Kh + at);
            const uint4 bl = *reinterpret_cast<const uint4*>(Kl + at);
            mma(s[j], al[0], bh.x, bh.y);
            mma(s[j], ah[0], bl.x, bl.y);
            mma(s[j], ah[0], bh.x, bh.y);
            mma(s[j], al[1], bh.z, bh.w);
            mma(s[j], ah[1], bl.z, bl.w);
            mma(s[j], ah[1], bh.z, bh.w);
          } else {                         // bf16 k: one pass
            const float4 kv = load4(Kh + at);
            mma(s[j], ah[0], __float_as_uint(kv.x), __float_as_uint(kv.y));
            mma(s[j], ah[1], __float_as_uint(kv.z), __float_as_uint(kv.w));
          }
        }
      }

      // scale, mask, then the online softmax update of rows g and g + 8:
      // s[j][e] is row g + 8 (e >> 1), key k0 + 8 j + t + 4 (e & 1)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= qmul;
      if (cut) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + t + 4 * (e & 1);
            const int qpos = qlo + g + 8 * (e >> 1);
            const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            s[j][e] = ok ? s[j][e] : -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(m[r], mx);
        const float mref = mnew == -INFINITY ? 0.f : mnew;
        const float corr = ex2(m[r] - mref);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          s[j][2 * r] = ex2(s[j][2 * r] - mref);
          s[j][2 * r + 1] = ex2(s[j][2 * r + 1] - mref);
          sum += s[j][2 * r] + s[j][2 * r + 1];
        }
        l[r] = l[r] * corr + sum;
        m[r] = mnew;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * r] *= corr;
          acc[n][2 * r + 1] *= corr;
        }
      }
    }
    cp_wait<0>();                          // this thread's V copies are in
    if constexpr (Sh::kSplit) split_tile<D>(Vh, Vl);
    __syncthreads();                       // the tile's V for all; every
                                           // warp is done with K
    if (tile + 1 < t1) {
      load_tile<D>(Kh, kp + (size_t)(k0 + kBK) * D, Sk - k0 - kBK);
      cp_commit();
    }

    if (!skip) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // p of n-tile j as the A operand: columns t, t + 4 are keys
        // 8 j + t, 8 j + t + 4 (score columns 2 t, 2 t + 1)
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          const int at = vat + 8 * j * Sh::KS + 32 * c;   // key 8 j + t
          const int bt = at + 4 * Sh::KS;                 // key 8 j + t + 4
          if constexpr (Sh::kSplit) {
            const uint4 ha = *reinterpret_cast<const uint4*>(Vh + at);
            const uint4 hb = *reinterpret_cast<const uint4*>(Vh + bt);
            const uint4 la = *reinterpret_cast<const uint4*>(Vl + at);
            const uint4 lb = *reinterpret_cast<const uint4*>(Vl + bt);
            const uint32_t h0[4] = {ha.x, ha.y, ha.z, ha.w};
            const uint32_t h1[4] = {hb.x, hb.y, hb.z, hb.w};
            const uint32_t l0[4] = {la.x, la.y, la.z, la.w};
            const uint32_t l1[4] = {lb.x, lb.y, lb.z, lb.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              mma(acc[4 * c + e], pl, h0[e], h1[e]);
              mma(acc[4 * c + e], ph, l0[e], l1[e]);
              mma(acc[4 * c + e], ph, h0[e], h1[e]);
            }
          } else {                         // bf16 v: p_lo v + p_hi v
            const float4 va = load4(Vh + at);
            const float4 vb = load4(Vh + bt);
            const uint32_t b0[4] = {__float_as_uint(va.x), __float_as_uint(va.y),
                                    __float_as_uint(va.z), __float_as_uint(va.w)};
            const uint32_t b1[4] = {__float_as_uint(vb.x), __float_as_uint(vb.y),
                                    __float_as_uint(vb.z), __float_as_uint(vb.w)};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              mma(acc[4 * c + e], pl, b0[e], b1[e]);
              mma(acc[4 * c + e], ph, b0[e], b1[e]);
            }
          }
        }
      }
    }
  }

  // each of a row's 4 lanes summed the p of its own columns; accumulator
  // n-tile 4 c + e holds columns 32 c + 4 t + e (element 2 r) and
  // 32 c + 16 + 4 t + e (element 2 r + 1) of row g + 8 r
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= Sq) continue;
    // the row's running max m is in the kernel's log2 units (scores
    // scaled by qmul = scale log2 e) and lt = sum 2^(s - m): the natural
    // log-sum-exp is (m + log2 lt) ln 2; one lane of the row's four
    // writes it
    if (lse != nullptr && t == 0)
      lse[(size_t)(b * H + h) * Sq + row] = (m[r] + log2f(lt)) * kLn2;
    const float inv = 1.f / lt;
    T* orow = o + ((size_t)(b * H + h) * Sq + row) * D + 4 * t;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        store4(orow + 32 * c + 16 * u, acc[4 * c][2 * r + u] * inv,
               acc[4 * c + 1][2 * r + u] * inv,
               acc[4 * c + 2][2 * r + u] * inv,
               acc[4 * c + 3][2 * r + u] * inv);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int H, int KH, int Sq, int Sk, int causal,
           int window, float qmul, cudaStream_t stream) {
  const size_t smem = Tile<D, T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KH, Sq, Sk,
      causal, window, qmul);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KH, int Sq, int Sk, int causal,
             int window, float qmul, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, o, lse, B, H, KH, Sq, Sk, causal, window, qmul, stream);
    case 64: return launch<64, T>(q, k, v, o, lse, B, H, KH, Sq, Sk, causal, window, qmul, stream);
    case 128: return launch<128, T>(q, k, v, o, lse, B, H, KH, Sq, Sk, causal, window, qmul, stream);
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
// bfloat16 (bf16 == 1); lse null or (B, H, Sq) float32, contiguous.
// window <= 0 means no window. Sq > Sk only with causal == 0 and no
// window. Returns the CUDA error code of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int H, int KH,
                           int Sq, int Sk, int D, int bf16, int causal,
                           int window, float scale, cudaStream_t stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 ||
      (Sq > Sk && (causal || window > 0)) ||
      !flash_attention_supports_dim(D) || (long long)B * H > 0x7fffffff ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const float qmul = scale * kLog2e;
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, H, KH, Sq,
                                        Sk, causal, window, qmul, stream)
              : dispatch<float>(D, q, k, v, o, lse, B, H, KH, Sq, Sk,
                                causal, window, qmul, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
