// Shared pieces of the flash kernels, blocked-causal (flash_fwd.cu,
// flash_bwd.cu) and grid (flash_grid_fwd.cu, flash_grid_bwd.cu): element
// conversion, the rounding points of the Pallas kernels, 16-lane row
// reductions, the strided (b, h, s, d) views, row staging, the CUDA-core
// backward's products and row statistics, and the tensor-core fragments.
#pragma once

#include <cuda_bf16.h>
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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and read back as fp32: the Pallas kernels' astype(input
// dtype) points (roped q/k, p before the PV product, ds)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

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
// Tensor-core pieces (bf16): mma.sync m16n8k16 with fp32 accumulation. With
// g = lane / 4 and t = lane % 4, a thread holds
//   A (16 x 16, row-major):  (g, 2t..2t+1) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..)
//   B (16 x 8, k x n):       (k = 2t..2t+1, n = g) (k = 2t+8..2t+9, n = g)
//   C (16 x 8, fp32):        (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1)
// each pair of bf16 packed in one 32-bit register, the lower index low.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 of shared memory (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0, int k0,
                                     int g, int t) {
  const bf16* p = tile + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// B fragments of n-tiles (n0, n0 + 8), k rows k0..k0+15, of a row-major
// (k x n) tile X with row stride ld, by ldmatrix .trans: b[0], b[1] for
// n-tile n0 and b[2], b[3] for n0 + 8. Lane l addresses row l % 8 of the
// 8 x 8 matrix l / 8 (k half (l / 8) % 2, n half l / 16); .trans hands lane
// (g, t) the pair X[k + 2t .. 2t + 1][n + g] each B fragment register holds.
__device__ __forceinline__ void ld_b_trans(uint32_t (&b)[4], const bf16* x, int ld, int k0,
                                           int n0, int lane) {
  const bf16* p = x + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// the A fragment of a 16 x 16 slice held as two fp32 C tiles (columns
// 0-7 in c0, 8-15 in c1), rounded to bf16: the FA2 register reuse of p / ds
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the tensor-core kernels move rows in 16-byte chunks: every base pointer
// 16-byte aligned and every (b, h, s) stride a multiple of 8 elements
__device__ __host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ __host__ __forceinline__ bool rows16(const View& v) {
  return v.b % 8 == 0 && v.h % 8 == 0 && v.s % 8 == 0;
}

// A block of 8 warps owns 16 rows per warp (kMmaRows) of the tile it
// accumulates for and walks the other operand in kMmaTile-row tiles: twice
// as many products per staged row as 64-row blocks.
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16 * kMmaWarps;  // rows a block owns
constexpr int kMmaTile = 64;              // rows of a walked tile

__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(p[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  uint4 v;
  v.x = pack_bf16(x[0], x[1]);
  v.y = pack_bf16(x[2], x[3]);
  v.z = pack_bf16(x[4], x[5]);
  v.w = pack_bf16(x[6], x[7]);
  return v;
}

// Stage one ROWS-row tile of a bf16 (b, h) slice into shared memory,
// row-major with row stride ld, in 16-byte chunks (rows are 16-byte aligned:
// see aligned16 / rows16); rows past `s` are zeros. With tables, the rows
// are roped (tables scaled by `scale` first) and rounded to bf16 once, as
// stage_rows does.
template <int D, int ROWS>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, const bf16* src, long long ss,
                                           int row0, int s, const float* cos, const float* sin,
                                           float scale, bool roped) {
  constexpr int HALF = D / 2;
  if (roped) {
    constexpr int CHUNKS = HALF / 8;  // 8-element chunks in each half of a row
    static_assert(ROWS * CHUNKS % kMmaThreads == 0, "tile does not split evenly");
#pragma unroll
    for (int it = 0; it < ROWS * CHUNKS / kMmaThreads; ++it) {
      const int e = threadIdx.x + it * kMmaThreads;
      const int r = e / CHUNKS, i0 = (e % CHUNKS) * 8, row = row0 + r;
      float y1[8], y2[8];
      if (row < s) {
        float x1[8], x2[8], c[8], sn[8];
        unpack8(*reinterpret_cast<const uint4*>(src + row * ss + i0), x1);
        unpack8(*reinterpret_cast<const uint4*>(src + row * ss + i0 + HALF), x2);
        const float4* cp = reinterpret_cast<const float4*>(cos + (size_t)row * HALF + i0);
        const float4* sp = reinterpret_cast<const float4*>(sin + (size_t)row * HALF + i0);
        const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
        c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
        c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
        sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
        sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (scale != 1.f) {
            c[k] = __fmul_rn(c[k], scale);
            sn[k] = __fmul_rn(sn[k], scale);
          }
          rope(x1[k], x2[k], c[k], sn[k], y1[k], y2[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) y1[k] = y2[k] = 0.f;
      }
      *reinterpret_cast<uint4*>(dst + r * ld + i0) = pack8(y1);
      *reinterpret_cast<uint4*>(dst + r * ld + i0 + HALF) = pack8(y2);
    }
  } else {
    constexpr int CHUNKS = D / 8;
    static_assert(ROWS * CHUNKS % kMmaThreads == 0, "tile does not split evenly");
#pragma unroll
    for (int it = 0; it < ROWS * CHUNKS / kMmaThreads; ++it) {
      const int e = threadIdx.x + it * kMmaThreads;
      const int r = e / CHUNKS, c0 = (e % CHUNKS) * 8, row = row0 + r;
      *reinterpret_cast<uint4*>(dst + r * ld + c0) =
          row < s ? *reinterpret_cast<const uint4*>(src + row * ss + c0) : make_uint4(0, 0, 0, 0);
    }
  }
}

// a row of C fragments written as bf16 pairs: out[row][8 n + 2t .. +1]
__device__ __forceinline__ void st_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
// ... or as fp32 pairs (8-byte aligned: even columns of 16-byte aligned rows)
__device__ __forceinline__ void st_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

__device__ __forceinline__ void zero_c(float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
}

}  // namespace flash
