// Shared pieces of the flash kernels, blocked-causal (flash_fwd.cu,
// flash_bwd.cu) and grid (flash_grid_fwd.cu, flash_grid_bwd.cu): element
// conversion, the rounding points of the Pallas kernels, 16-lane row
// reductions, the strided (b, h, s, d) views, row staging, the CUDA-core
// backward's products and row statistics, 16-bit rows and fragments, Hopper's
// asynchronous pieces (mbarriers, TMA tile loads, wgmma) and the host's
// tensor-map encoding. The TMA + wgmma mainloops are in
// flash_fwd_common.cuh (forward) and flash_bwd_common.cuh (backward).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <type_traits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;  // the reference's NEG_INF: finite, so exp2 gives 0, never NaN
constexpr int kThreads = 256;       // a 16 x 16 grid of (row group, column group)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and read back as fp32: the Pallas kernels' astype(input
// dtype) points (roped q/k, p before the PV product, ds)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// 2^x on the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, subnormal results flushed to zero). exp2f's full-range sequence
// costs several times more, and in the backward's p it is the bulk of the
// non-tensor work.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the 16 lanes that share one row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element strides of one (b, h, s, d) operand; d is unit-stride
struct View {
  long long b, h, s;
};

// rotate-half RoPE of the pair (x1, x2) = (x[i], x[i + d/2]) with (c, s) the
// row's table entries. Written with _rn intrinsics so nvcc contracts nothing
// into an FMA: each product and sum rounds as the plain PyTorch version's
// separate elementwise ops round.
__device__ __forceinline__ void rope(float x1, float x2, float c, float s, float& y1,
                                     float& y2) {
  y1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  y2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}
// the transpose (inverse) rotation, mapping gradients w.r.t. roped rows back
__device__ __forceinline__ void rope_t(float y1, float y2, float c, float s, float& x1,
                                       float& x2) {
  x1 = __fadd_rn(__fmul_rn(y1, c), __fmul_rn(y2, s));
  x2 = __fsub_rn(__fmul_rn(y2, c), __fmul_rn(y1, s));
}

// Stage `rows` rows of one (b, h) slice into shared memory as fp32 with row
// stride ld: rows past `s` are zeros. With tables, the rows are roped
// (tables scaled by `scale` first, as the reference scales its q tables) and
// rounded to T.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, long long ss,
                                           int row0, int rows, int s, int d,
                                           const float* cos, const float* sin, float scale,
                                           bool roped) {
  const int half = d / 2;
  if (roped) {
    for (int e = threadIdx.x; e < rows * half; e += kThreads) {
      const int r = e / half;
      const int i = e - r * half;
      const int row = row0 + r;
      float y1 = 0.f, y2 = 0.f;
      if (row < s) {
        const float x1 = to_f32(src[row * ss + i]);
        const float x2 = to_f32(src[row * ss + i + half]);
        float c = cos[(size_t)row * half + i];
        float sn = sin[(size_t)row * half + i];
        if (scale != 1.f) {
          c = __fmul_rn(c, scale);
          sn = __fmul_rn(sn, scale);
        }
        rope(x1, x2, c, sn, y1, y2);
        y1 = round_to<T>(y1);
        y2 = round_to<T>(y2);
      }
      dst[r * ld + i] = y1;
      dst[r * ld + i + half] = y2;
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const int row = row0 + r;
      dst[r * ld + c] = row < s ? to_f32(src[row * ss + c]) : 0.f;
    }
  }
}

// Scores and dp of one (q tile, k tile) pair of the CUDA-core backward, both
// from shared memory: sc[i][j] = qs[q] . ks[k], dp[i][j] = dos[q] . vs[k]
// for q rows ty + 16 i and k columns tx + 16 j.
template <int RI, int CJ>
__device__ __forceinline__ void scores_and_dp(const float* qs, const float* dos,
                                              const float* ks, const float* vs, int ld, int d,
                                              int ty, int tx, float (&sc)[RI][CJ],
                                              float (&dp)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      sc[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  for (int c = 0; c < d; ++c) {
    float qv[RI], dv[RI], kv[CJ], vv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = qs[(ty + 16 * i) * ld + c];
      dv[i] = dos[(ty + 16 * i) * ld + c];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      kv[j] = ks[(tx + 16 * j) * ld + c];
      vv[j] = vs[(tx + 16 * j) * ld + c];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
      }
  }
}

// lse * log2(e) and delta of `tile` rows from q0 into shared memory; `at`
// indexes the (b, h) slice of the contiguous (b, h, s) row statistics
__device__ __forceinline__ void stage_row_stats(const float* lse, const float* delta,
                                                size_t at, int s, int q0, int tile,
                                                float* lse2s, float* dels) {
  for (int r = threadIdx.x; r < tile; r += kThreads) {
    const int row = q0 + r;
    lse2s[r] = row < s ? lse[at + row] * kLog2e : 0.f;
    dels[r] = row < s ? delta[at + row] : 0.f;
  }
}

// Write `rows` rows of fp32 y (shared memory, row stride ld, already scaled)
// to global memory in T by strides, counter-rotated with the unscaled tables
// when `cos` is given (gradients w.r.t. roped rows back to the raw rows).
template <typename T>
__device__ __forceinline__ void write_rows(const float* ys, int ld, T* dst, long long ss,
                                           int row0, int rows, int s, int d, const float* cos,
                                           const float* sin) {
  const int half = d / 2;
  for (int e = threadIdx.x; e < rows * half; e += kThreads) {
    const int r = e / half;
    const int i = e - r * half;
    const int row = row0 + r;
    if (row >= s) continue;
    float x1 = ys[r * ld + i], x2 = ys[r * ld + i + half];
    if (cos != nullptr)
      rope_t(x1, x2, cos[(size_t)row * half + i], sin[(size_t)row * half + i], x1, x2);
    dst[row * ss + i] = from_f32<T>(x1);
    dst[row * ss + i + half] = from_f32<T>(x2);
  }
}

// p and ds of one tile pair of the CUDA-core backward into shared memory (ps
// may be null): rows q0 + ty + 16 i, columns k0 + tx + 16 j; masked (above
// the diagonal when causal) or out-of-range pairs are 0.
template <typename T, int TILE, int RI, int CJ>
__device__ __forceinline__ void probs_and_ds(const float (&sc)[RI][CJ],
                                             const float (&dp)[RI][CJ], const float* lse2s,
                                             const float* dels, int q0, int k0, int s,
                                             bool causal, int ty, int tx, float* ps, float* dss) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      float p = 0.f;
      if (row < s && col < s && (!causal || col <= row)) p = exp2f(sc[i][j] - lse2s[r]);
      if (ps != nullptr) ps[r * (TILE + 1) + c] = round_to<T>(p);
      dss[r * (TILE + 1) + c] = round_to<T>(__fmul_rn(p, __fsub_rn(dp[i][j], dels[r])));
    }
  }
}

// shared memory of the CUDA-core backward kernels: four TILE x (d+1) slabs,
// two TILE x (TILE+1) score tiles, two row statistics
template <int TILE>
size_t bwd_smem_floats(int d) {
  return 4 * (size_t)TILE * (d + 1) + 2 * (size_t)TILE * (TILE + 1) + 2 * (size_t)TILE;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// 16-bit rows and register fragments, bf16 or fp16 (the element type E of
// the TMA routes). The wgmma accumulators and register A operands (below)
// use the mma.sync m16n8k16 fragment layout: with g = lane / 4 and t =
// lane % 4, a thread holds C (16 x 8, fp32) elements (g, 2t) (g, 2t+1)
// (g+8, 2t) (g+8, 2t+1) and A (16 x 16) pairs (g, 2t..2t+1) (g+8, 2t..)
// (g, 2t+8..) (g+8, 2t+8..), each pair of E packed in one 32-bit register,
// the lower index low.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// What differs between the two element types: the packed pair, its
// round-to-nearest conversion from two floats (overflow goes to +-inf, as
// astype does: never a saturating one, so that an fp16 gradient that
// overflows reaches the loss scaler as an inf) and back, and the tensor
// maps' data type. The wgmma products pick their type string by E too.
template <typename E>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ Pair rn2(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 to2(Pair p) { return __bfloat1622float2(p); }
};
template <>
struct Elem<__half> {
  using Pair = __half2;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ Pair rn2(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 to2(Pair p) { return __half22float2(p); }
};

// (lo, hi) rounded to E and packed, lo in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  typename Elem<E>::Pair v = Elem<E>::rn2(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the TMA kernels move rows in 16-byte units: every base pointer 16-byte
// aligned and every (b, h, s) stride a multiple of 8 elements
__device__ __host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ __host__ __forceinline__ bool rows16(const View& v) {
  return v.b % 8 == 0 && v.h % 8 == 0 && v.s % 8 == 0;
}

// eight E (16 bytes) to fp32, and back rounded to E
template <typename E>
__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const typename Elem<E>::Pair* p = reinterpret_cast<const typename Elem<E>::Pair*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = Elem<E>::to2(p[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

template <typename E>
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  uint4 v;
  v.x = pack2<E>(x[0], x[1]);
  v.y = pack2<E>(x[2], x[3]);
  v.z = pack2<E>(x[4], x[5]);
  v.w = pack2<E>(x[6], x[7]);
  return v;
}

// a row of C fragments written as E pairs: out[row][8 n + 2t .. +1]
__device__ __forceinline__ void st_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void st_pair(__half* p, float lo, float hi) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(lo, hi);
}
// ... or as fp32 pairs (8-byte aligned: even columns of 16-byte aligned rows)
__device__ __forceinline__ void st_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// ---------------------------------------------------------------------------
// Hopper pieces: mbarriers, TMA tile loads, wgmma descriptors and products.
//
// Tiles that wgmma reads from shared memory use the 128-byte swizzle that a
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes: a tile of R rows of 64
// 16-bit columns is R rows of 128 bytes, the 16-byte unit u of row r stored at
// unit u ^ (r % 8), in atoms of 8 rows (1024 bytes); a row of 128 columns is
// two such column chunks, R * 128 bytes apart. Every tile starts 1024-byte
// aligned.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset, in a 128B-swizzled tile of `rows` rows, of the 16-byte unit
// that holds columns [col, col + 8) of row r (col a multiple of 8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int col, int rows) {
  return (uint32_t)((col >> 6) * rows * 128 + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and expect `bytes` of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed. A phase that never
// completes (a TMA load that faulted, a miscounted arrival) traps after
// ~2^34 cycles (about ten seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// make this thread's shared-memory writes visible to the async proxy (wgmma
// operands written by ordinary stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `threads` threads (a multiple of 32) on hardware barrier id
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// arrive at barrier id (of `threads` threads) without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// one box of a rank-4 tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand at `tile`:
// leading and stride byte offsets (lbo: between 64-element chunks along MN
// for an MN-major operand, unused for K-major; sbo: between 8-row atoms)
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);  // 1: 128B swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses to wgmma accumulators across the
// asynchronous region
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32, registers) = A (64 x 16) * B (16 x N) + (scale_d ? D : 0),
// A and B of the 16-bit type TY ("bf16" or "f16"; the accumulation is fp32
// either way). _SS: A and B from shared memory, both K-major. _RS: A from
// registers (the mma.sync A fragment of each warp's 16 rows), B from shared
// memory MN-major (transposed). Accumulator register 4j + e of a thread
// holds row 16 * (warp % 4) + lane / 4 (+ 8 for e >= 2), column 8j +
// 2 (lane % 4) + (e & 1): the mma.sync C fragment of each n8 block, warp by
// warp. The asm strings are literals, so each product is a macro of its
// type string, expanded once per element type below.
#define FLASH_WGMMA_N64_RS(TY)                                                                     \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"             \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                                                \
      "}\n"                                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),              \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

#define FLASH_WGMMA_N64_SS(TY)                                                                     \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"             \
      "}, %32, %33, p, 1, 1, 0, 0;\n"                                                              \
      "}\n"                                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),              \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])               \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define FLASH_WGMMA_N128_SS(TY)                                                                    \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"             \
      "}, %64, %65, p, 1, 1, 0, 0;\n"                                                              \
      "}\n"                                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),              \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),              \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),              \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),              \
        "+f"(d[62]), "+f"(d[63])                                                                   \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define FLASH_WGMMA_N128_RS(TY)                                                                    \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"             \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                                                \
      "}\n"                                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),              \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),              \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),              \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),              \
        "+f"(d[62]), "+f"(d[63])                                                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

// whether E is fp16 (else bf16): the products' type string (a constant, not
// a constexpr function, which device code may not call)
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;
template <typename E>
constexpr bool kIs16 = kIsF16<E> || std::is_same<E, __nv_bfloat16>::value;

// the products above by width N (scores: 64 or 128 columns; O, dq, dk, dv:
// head_dim 64 or 128) and element type E
template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma width");
  static_assert(kIs16<E>, "the TMA routes take bf16 or fp16");
  if constexpr (N == 64) {
    if constexpr (kIsF16<E>)
      FLASH_WGMMA_N64_SS("f16");
    else
      FLASH_WGMMA_N64_SS("bf16");
  } else {
    if constexpr (kIsF16<E>)
      FLASH_WGMMA_N128_SS("f16");
    else
      FLASH_WGMMA_N128_SS("bf16");
  }
}
template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma width");
  static_assert(kIs16<E>, "the TMA routes take bf16 or fp16");
  if constexpr (N == 64) {
    if constexpr (kIsF16<E>)
      FLASH_WGMMA_N64_RS("f16");
    else
      FLASH_WGMMA_N64_RS("bf16");
  } else {
    if constexpr (kIsF16<E>)
      FLASH_WGMMA_N128_RS("f16");
    else
      FLASH_WGMMA_N128_RS("bf16");
  }
}

#undef FLASH_WGMMA_N64_RS
#undef FLASH_WGMMA_N64_SS
#undef FLASH_WGMMA_N128_SS
#undef FLASH_WGMMA_N128_RS

// Columns 16 kk .. 16 kk + 15 of an accumulator of N columns rounded to E
// as the A fragment of a register-A product over them (the p / ds register
// reuse); pack_a does every kk.
template <typename E, int N>
__device__ __forceinline__ void pack_a_block(const float (&c)[N], uint32_t (&a)[4], int kk) {
  a[0] = pack2<E>(c[8 * kk], c[8 * kk + 1]);
  a[1] = pack2<E>(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack2<E>(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack2<E>(c[8 * kk + 6], c[8 * kk + 7]);
}
template <typename E, int N>
__device__ __forceinline__ void pack_a(const float (&c)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) pack_a_block<E>(c, a[kk], kk);
}
// keep A fragments a register-A wgmma reads live until its wait: the
// product reads them asynchronously, so the registers must not be reused
template <int K>
__device__ __forceinline__ void wgmma_hold_a(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// ---------------------------------------------------------------------------
// Host side: tensor maps for the TMA loads, encoded at each call through the
// runtime's driver entry point (no -lcuda).
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-4 map (d, s, heads, batch) over rows of the 16-bit type E (bf16 or
// fp16: two bytes an element either way) with element strides (ss, sh,
// sb), boxes of 64 columns x `rows` rows, 128B swizzle, rows past s read as
// zeros. A size-1 dim's stride is never read; it is given a valid one.
// False where the driver lacks the entry point or refuses the map.
template <typename E>
inline bool encode_bhsd(CUtensorMap* map, const void* base, int batch, int heads, int s, int d,
                        long long sb, long long sh, long long ss, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  if (heads == 1) sh = ss * s;
  if (batch == 1) sb = sh * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, Elem<E>::kMap, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the routes a C entry reports through its `route` argument
enum Route : int { kRouteCudaCore = 0, kRouteTma = 1 };

}  // namespace flash
