// Fused RMSNorm and LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the four TPU kernels of galvatron_tpu/ops/fused_norm.py:
// `_rms_fwd_kernel` / `_rms_fwd`, `_rms_bwd_kernel` / `_rms_bwd`,
// `_ln_fwd_kernel` / `_ln_fwd` and `_ln_bwd_kernel` / `_ln_bwd`.
//
//   x, y, dy, dx  (n, H)   bf16, fp16 or fp32, contiguous rows, H % 128 == 0
//   g, b, dg, db  (H,)     fp32 (the master scale and bias and their gradients)
//   rstd, mu      (n, 1)   fp32 row statistics, written by the forward and
//                          read by the backward
//
//   RMSNorm    r = rsqrt(mean(x^2) + eps)            y  = (x * r) * g
//              dyg = dy * g, c = sum(dyg * x) / H    dx = r * dyg - (x * r^3) * c
//                                                    dg = sum_rows (dy * x) * r
//   LayerNorm  mu = mean(x), xc = x - mu
//              rstd = rsqrt(mean(xc^2) + eps)        y  = (xc * rstd) * g + b
//              xhat = xc * rstd, dxhat = dy * g
//              m1 = mean(dxhat), m2 = mean(dxhat * xhat)
//                                                    dx = rstd * ((dxhat - m1) - xhat * m2)
//                                                    dg = sum_rows dy * xhat
//                                                    db = sum_rows dy
//
// All arithmetic is fp32; y and dx are rounded once to x's dtype. The
// variance is the mean of the centred squares (a second pass over the row
// held in registers), never E[x^2] - mu^2. The elementwise results are
// written with the `_rn` intrinsics in the reference's order of operations,
// so nvcc contracts no multiply-add that the plain version rounds twice; only
// the row and column sums (whose order differs from any other
// implementation's anyway) accumulate with fused multiply-adds.
//
// Bound: bytes. A row is read once and written once and a handful of
// operations are done per element, far under the ~295 operations per byte
// the H100 needs before arithmetic is the limit. The design therefore spends
// everything on moving each byte once:
//
//   - one block of 256 threads works on one row at a time and walks the rows
//     blockIdx.x, blockIdx.x + gridDim.x, ...; the grid is what the card holds
//     resident at once (SMs x the kernel's occupancy), so all rows go through
//     in one wave;
//   - thread t owns the 16-byte vectors t, t + 256, ... of every row (8 bf16
//     or fp16, or 4 fp32 values each, neighbouring threads on neighbouring
//     addresses).
//     The row stays in registers between the reduction and the write, so no
//     byte is read twice; g (and b) for the thread's columns are loaded once
//     per block;
//   - row sums: warp shuffles, then one float per warp through shared
//     memory, added in a fixed order;
//   - the backward's column sums dg (and db) are deterministic, without
//     atomics: each thread keeps the partial sums of its own columns in
//     registers across all the rows its block walks, the block writes one
//     fp32 row of a (blocks, H) workspace, and a second small kernel in this
//     file sums the workspace over the blocks in a fixed order.
//
// A thread owns at most 32 columns, so H <= 8192; the launch functions
// return cudaErrorInvalidValue beyond that (the wrapper raises first).
//
// Not done yet (later work): several rows per block for narrow H (a 128-wide
// row keeps 16 of 256 threads busy), a cluster reduction in place of the
// workspace pass.
//
// C interface (bound with ctypes): every pointer and the stream are passed as
// void*, each launch function returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxColsPerThread = 32;

// 16 bytes of T to and from fp32
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                      __float_as_uint(in[3]));
  }
};

__device__ __forceinline__ float2 bf162_to_f32(uint32_t bits) {
  // low half is the element at the lower address
  return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u));
}

__device__ __forceinline__ uint32_t f32_to_bf162(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* out) {
    const float2 a = bf162_to_f32(raw.x), b = bf162_to_f32(raw.y);
    const float2 c = bf162_to_f32(raw.z), d = bf162_to_f32(raw.w);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
    out[4] = c.x; out[5] = c.y; out[6] = d.x; out[7] = d.y;
  }
  static __device__ __forceinline__ uint4 pack(const float* in) {
    return make_uint4(f32_to_bf162(in[0], in[1]), f32_to_bf162(in[2], in[3]),
                      f32_to_bf162(in[4], in[5]), f32_to_bf162(in[6], in[7]));
  }
};

__device__ __forceinline__ float2 half2_to_f32(uint32_t bits) {
  return __half22float2(*reinterpret_cast<const __half2*>(&bits));  // low half first
}

__device__ __forceinline__ uint32_t f32_to_half2(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Pack<__half> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* out) {
    const float2 a = half2_to_f32(raw.x), b = half2_to_f32(raw.y);
    const float2 c = half2_to_f32(raw.z), d = half2_to_f32(raw.w);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
    out[4] = c.x; out[5] = c.y; out[6] = d.x; out[7] = d.y;
  }
  static __device__ __forceinline__ uint4 pack(const float* in) {
    return make_uint4(f32_to_half2(in[0], in[1]), f32_to_half2(in[2], in[3]),
                      f32_to_half2(in[4], in[5]), f32_to_half2(in[6], in[7]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, the same value in every thread: the warps' sums go
// through `red` (kWarps floats) and are added in warp order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // `red` may be written again right away
  return s;
}

// E consecutive floats of a (H,) fp32 vector, 16 bytes at a time
template <int E>
__device__ __forceinline__ void load_f32(const float* __restrict__ src, float* out) {
#pragma unroll
  for (int j = 0; j < E; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + j);
    out[j] = v.x; out[j + 1] = v.y; out[j + 2] = v.z; out[j + 3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// Forward: y (and the row statistics) of RMSNorm or LayerNorm.
// VPT: 16-byte vectors a thread owns per row.
// ---------------------------------------------------------------------------
template <typename T, int VPT, bool kLayerNorm>
__global__ void __launch_bounds__(kThreads) fused_norm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    T* __restrict__ y, float* __restrict__ mu_out, float* __restrict__ rstd_out, int n,
    int hidden, float eps) {
  constexpr int E = Pack<T>::kElems;
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  const int nvec = hidden / E;
  const float fh = (float)hidden;

  float gr[VPT][E], br[VPT][E];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = tid + i * kThreads;
    if (v < nvec) {
      load_f32<E>(g + (size_t)v * E, gr[i]);
      if (kLayerNorm) load_f32<E>(b + (size_t)v * E, br[i]);
    }
  }

  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const uint4* xrow = reinterpret_cast<const uint4*>(x + (size_t)row * hidden);
    uint4* yrow = reinterpret_cast<uint4*>(y + (size_t)row * hidden);
    float xv[VPT][E];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = tid + i * kThreads;
      if (v < nvec) {
        const uint4 raw = xrow[v];
        Pack<T>::unpack(raw, xv[i]);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc = kLayerNorm ? acc + xv[i][e] : fmaf(xv[i][e], xv[i][e], acc);
      }
    }
    float mu = 0.f, rstd;
    if (kLayerNorm) {
      mu = __fdiv_rn(block_sum(acc, red), fh);
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (tid + i * kThreads < nvec) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            xv[i][e] = __fsub_rn(xv[i][e], mu);  // the centred row from here on
            sq = fmaf(xv[i][e], xv[i][e], sq);
          }
        }
      }
      rstd = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(sq, red), fh), eps));
    } else {
      rstd = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(acc, red), fh), eps));
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = tid + i * kThreads;
      if (v < nvec) {
        float out[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float scaled = __fmul_rn(__fmul_rn(xv[i][e], rstd), gr[i][e]);
          out[e] = kLayerNorm ? __fadd_rn(scaled, br[i][e]) : scaled;
        }
        yrow[v] = Pack<T>::pack(out);
      }
    }
    if (tid == 0) {
      rstd_out[row] = rstd;
      if (kLayerNorm) mu_out[row] = mu;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dx, and this block's partial column sums of dg (and db) into row
// blockIdx.x of the workspace: ws[0] is (gridDim.x, H) for dg, ws[1] the same
// for db (LayerNorm only).
// ---------------------------------------------------------------------------
template <typename T, int VPT, bool kLayerNorm>
__global__ void __launch_bounds__(kThreads) fused_norm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ mu_in,
    const float* __restrict__ rstd_in, const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ ws, int n, int hidden) {
  constexpr int E = Pack<T>::kElems;
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x;
  const int nvec = hidden / E;
  const float fh = (float)hidden;

  float gr[VPT][E], dg[VPT][E], db[VPT][E];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = tid + i * kThreads;
    if (v < nvec) load_f32<E>(g + (size_t)v * E, gr[i]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dg[i][e] = 0.f;
      db[i][e] = 0.f;
    }
  }

  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const uint4* xrow = reinterpret_cast<const uint4*>(x + (size_t)row * hidden);
    const uint4* dyrow = reinterpret_cast<const uint4*>(dy + (size_t)row * hidden);
    uint4* dxrow = reinterpret_cast<uint4*>(dx + (size_t)row * hidden);
    const float r = rstd_in[row];
    const float mu = kLayerNorm ? mu_in[row] : 0.f;
    uint4 xraw[VPT], dyraw[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = tid + i * kThreads;
      if (v < nvec) {
        xraw[i] = xrow[v];
        dyraw[i] = dyrow[v];
      }
    }
    // row sums: RMSNorm sum(dyg * x); LayerNorm sum(dxhat) and sum(dxhat * xhat)
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (tid + i * kThreads < nvec) {
        float xv[E], dyv[E];
        Pack<T>::unpack(xraw[i], xv);
        Pack<T>::unpack(dyraw[i], dyv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dyg = __fmul_rn(dyv[e], gr[i][e]);
          if (kLayerNorm) {
            s0 += dyg;
            s1 = fmaf(dyg, __fmul_rn(__fsub_rn(xv[e], mu), r), s1);
          } else {
            s1 = fmaf(dyg, xv[e], s1);
          }
        }
      }
    }
    const float c1 = __fdiv_rn(block_sum(s1, red[1]), fh);
    const float c0 = kLayerNorm ? __fdiv_rn(block_sum(s0, red[0]), fh) : 0.f;
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = tid + i * kThreads;
      if (v < nvec) {
        float xv[E], dyv[E], out[E];
        Pack<T>::unpack(xraw[i], xv);
        Pack<T>::unpack(dyraw[i], dyv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dyg = __fmul_rn(dyv[e], gr[i][e]);
          if (kLayerNorm) {
            const float xhat = __fmul_rn(__fsub_rn(xv[e], mu), r);
            out[e] = __fmul_rn(r, __fsub_rn(__fsub_rn(dyg, c0), __fmul_rn(xhat, c1)));
            dg[i][e] = __fadd_rn(dg[i][e], __fmul_rn(dyv[e], xhat));
            db[i][e] = __fadd_rn(db[i][e], dyv[e]);
          } else {
            out[e] = __fsub_rn(__fmul_rn(r, dyg), __fmul_rn(__fmul_rn(xv[e], r3), c1));
            dg[i][e] = __fadd_rn(dg[i][e], __fmul_rn(__fmul_rn(dyv[e], xv[e]), r));
          }
        }
        dxrow[v] = Pack<T>::pack(out);
      }
    }
  }

  float* dg_ws = ws + (size_t)blockIdx.x * hidden;
  float* db_ws = ws + ((size_t)gridDim.x + blockIdx.x) * hidden;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = tid + i * kThreads;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < E; j += 4) {
        *reinterpret_cast<float4*>(dg_ws + (size_t)v * E + j) =
            make_float4(dg[i][j], dg[i][j + 1], dg[i][j + 2], dg[i][j + 3]);
        if (kLayerNorm)
          *reinterpret_cast<float4*>(db_ws + (size_t)v * E + j) =
              make_float4(db[i][j], db[i][j + 1], db[i][j + 2], db[i][j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Column sums of the workspace: ws (parts, blocks, H) -> out0 (H,) [, out1
// (H,)]. A block of (32, 8) threads takes 32 columns; thread row j adds the
// workspace rows j, j + 8, ... in order, then the 8 partial sums are added in
// order: the same result on every run.
// ---------------------------------------------------------------------------
constexpr int kSumCols = 32;
constexpr int kSumRows = 8;

__global__ void __launch_bounds__(kSumCols * kSumRows) fused_norm_colsum_kernel(
    const float* __restrict__ ws, float* __restrict__ out0, float* __restrict__ out1,
    int blocks, int hidden) {
  __shared__ float part[kSumRows][kSumCols + 1];
  const int col = blockIdx.x * kSumCols + threadIdx.x;
  const float* src = ws + (size_t)blockIdx.y * blocks * hidden;
  float s = 0.f;
  if (col < hidden)
    for (int r = threadIdx.y; r < blocks; r += kSumRows) s += src[(size_t)r * hidden + col];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < hidden) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kSumRows; ++j) t += part[j][threadIdx.x];
    (blockIdx.y == 0 ? out0 : out1)[col] = t;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Columns a thread must own for this width, rounded up to a multiple of 8
// (the instantiated sizes: 8, 16, 24, 32), or 0 when the width is not taken.
template <typename T>
int cols_per_thread(int hidden) {
  constexpr int E = Pack<T>::kElems;
  if (hidden <= 0 || hidden % 128) return 0;
  const int nvec = hidden / E;
  const int vpt = (nvec + kThreads - 1) / kThreads;
  const int cols = (vpt * E + 7) / 8 * 8;
  return cols <= kMaxColsPerThread ? cols : 0;
}

// Blocks of `kernel` the card holds resident at once.
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int COLS, bool LN>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, void* y, void* mu,
                       void* rstd, int n, int hidden, float eps, cudaStream_t stream) {
  auto kernel = fused_norm_fwd_kernel<T, COLS / Pack<T>::kElems, LN>;
  static int resident = 0;  // per instantiation; the same on every card of one host
  if (resident == 0) resident = resident_blocks(kernel);
  if (resident == 0) return cudaErrorUnknown;
  const int grid = n < resident ? n : resident;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(mu), static_cast<float*>(rstd), n, hidden, eps);
  return cudaGetLastError();
}

template <typename T, int COLS, bool LN>
int bwd_resident() {
  static int resident = 0;
  if (resident == 0)
    resident = resident_blocks(fused_norm_bwd_kernel<T, COLS / Pack<T>::kElems, LN>);
  return resident;
}

template <typename T, int COLS, bool LN>
cudaError_t launch_bwd(const void* x, const void* g, const void* mu, const void* rstd,
                       const void* dy, void* dx, void* dg, void* db, void* ws, int blocks, int n,
                       int hidden, cudaStream_t stream) {
  if (blocks < 1 || blocks > n) return cudaErrorInvalidValue;
  fused_norm_bwd_kernel<T, COLS / Pack<T>::kElems, LN><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(ws), n, hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((hidden + kSumCols - 1) / kSumCols, LN ? 2 : 1);
  fused_norm_colsum_kernel<<<grid, dim3(kSumCols, kSumRows), 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(dg), static_cast<float*>(db), blocks,
      hidden);
  return cudaGetLastError();
}

// Run CALL(T, COLS, LN) for the instantiated column count, else OTHERWISE.
#define NORM_DISPATCH_COLS(T, LN, cols, CALL, OTHERWISE)      \
  switch (cols) {                                             \
    case 8: return (int)CALL(T, 8, LN);                       \
    case 16: return (int)CALL(T, 16, LN);                     \
    case 24: return (int)CALL(T, 24, LN);                     \
    case 32: return (int)CALL(T, 32, LN);                     \
    default: return (int)(OTHERWISE);                         \
  }

template <typename T, bool LN>
int dispatch_fwd(const void* x, const void* g, const void* b, void* y, void* mu, void* rstd,
                 int n, int hidden, float eps, cudaStream_t s) {
#define FWD_CALL(T_, C_, LN_) launch_fwd<T_, C_, LN_>(x, g, b, y, mu, rstd, n, hidden, eps, s)
  NORM_DISPATCH_COLS(T, LN, cols_per_thread<T>(hidden), FWD_CALL, cudaErrorInvalidValue)
#undef FWD_CALL
}

template <typename T, bool LN>
int dispatch_bwd(const void* x, const void* g, const void* mu, const void* rstd, const void* dy,
                 void* dx, void* dg, void* db, void* ws, int blocks, int n, int hidden,
                 cudaStream_t s) {
#define BWD_CALL(T_, C_, LN_) \
  launch_bwd<T_, C_, LN_>(x, g, mu, rstd, dy, dx, dg, db, ws, blocks, n, hidden, s)
  NORM_DISPATCH_COLS(T, LN, cols_per_thread<T>(hidden), BWD_CALL, cudaErrorInvalidValue)
#undef BWD_CALL
}

template <typename T, bool LN>
int dispatch_resident(int hidden) {
#define RES_CALL(T_, C_, LN_) bwd_resident<T_, C_, LN_>()
  NORM_DISPATCH_COLS(T, LN, cols_per_thread<T>(hidden), RES_CALL, 0)
#undef RES_CALL
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, y, dy, dx); g, b, dg,
// db, mu, rstd and the workspace are float32. Every launch function returns cudaGetLastError().

// Blocks of the backward kernel the card holds resident at once for this
// norm (0 RMSNorm, 1 LayerNorm), dtype and width: the caller launches
// min(rows, this) blocks and allocates that many workspace rows. 0 or less
// when the width or dtype is not taken.
int galvatron_fused_norm_bwd_blocks(int layernorm, int dtype, int hidden) {
  if (dtype == 0)
    return layernorm ? dispatch_resident<float, true>(hidden)
                     : dispatch_resident<float, false>(hidden);
  if (dtype == 1)
    return layernorm ? dispatch_resident<__nv_bfloat16, true>(hidden)
                     : dispatch_resident<__nv_bfloat16, false>(hidden);
  if (dtype == 2)
    return layernorm ? dispatch_resident<__half, true>(hidden)
                     : dispatch_resident<__half, false>(hidden);
  return 0;
}

int galvatron_rms_fwd(const void* x, const void* g, void* y, void* rstd, int dtype, int n,
                      int hidden, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float, false>(x, g, nullptr, y, nullptr, rstd, n, hidden, eps, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16, false>(x, g, nullptr, y, nullptr, rstd, n, hidden, eps, s);
  if (dtype == 2)
    return dispatch_fwd<__half, false>(x, g, nullptr, y, nullptr, rstd, n, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

int galvatron_ln_fwd(const void* x, const void* g, const void* b, void* y, void* mu, void* rstd,
                     int dtype, int n, int hidden, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fwd<float, true>(x, g, b, y, mu, rstd, n, hidden, eps, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16, true>(x, g, b, y, mu, rstd, n, hidden, eps, s);
  if (dtype == 2) return dispatch_fwd<__half, true>(x, g, b, y, mu, rstd, n, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

// ws: (blocks, hidden) float32 scratch. dg: (hidden,) float32.
int galvatron_rms_bwd(const void* x, const void* g, const void* rstd, const void* dy, void* dx,
                      void* dg, void* ws, int blocks, int dtype, int n, int hidden,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float, false>(x, g, nullptr, rstd, dy, dx, dg, nullptr, ws, blocks, n,
                                      hidden, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16, false>(x, g, nullptr, rstd, dy, dx, dg, nullptr, ws,
                                              blocks, n, hidden, s);
  if (dtype == 2)
    return dispatch_bwd<__half, false>(x, g, nullptr, rstd, dy, dx, dg, nullptr, ws, blocks, n,
                                       hidden, s);
  return (int)cudaErrorInvalidValue;
}

// ws: (2, blocks, hidden) float32 scratch. dg, db: (hidden,) float32.
int galvatron_ln_bwd(const void* x, const void* g, const void* mu, const void* rstd,
                     const void* dy, void* dx, void* dg, void* db, void* ws, int blocks,
                     int dtype, int n, int hidden, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float, true>(x, g, mu, rstd, dy, dx, dg, db, ws, blocks, n, hidden, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16, true>(x, g, mu, rstd, dy, dx, dg, db, ws, blocks, n,
                                             hidden, s);
  if (dtype == 2)
    return dispatch_bwd<__half, true>(x, g, mu, rstd, dy, dx, dg, db, ws, blocks, n, hidden, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
