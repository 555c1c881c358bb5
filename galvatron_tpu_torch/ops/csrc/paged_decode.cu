// Paged decode attention for Hopper (sm_90a), one query token per row.
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention(
// impl="pallas")` in galvatron_tpu/ops/flash_attention.py: FlashAttention-
// style online softmax over a row's K/V pages, found through its block table,
// with keys at positions > the row's query offset masked and pages wholly past
// the offset skipped.
//
//   q        (B, 1, n, d)              viewed as (B, kv, g, d), g = n / kv
//   k_pages  (num_blocks, bs, kv, d)   one layer of the serving block pool
//   v_pages  (num_blocks, bs, kv, d)
//   tables   (B, max_blocks) int32     logical block j of row b -> pool block
//   offsets  (B,) int32                absolute position of row b's query
//   out      (B, 1, n, d)              in q's dtype
//
// Math: q.k in fp32 times sm_scale; fp32 running max, denominator and
// numerator; the output is cast to the input dtype once at the end. Inputs
// are bf16 (the serving path) or fp32 (card-side parity with the CPU).
//
// Bound: bytes. A decode step reads every K and V row at positions
// [0, offset] once per (row, kv head): (offset + 1) * d * 2 * sizeof(T) bytes
// per (row, kv head), against 4 * g * d flops per token - a few flops per
// byte, far under the ~295 flop/byte the H100 needs before its tensor cores
// become the limit. The design therefore spends nothing on matrix units and
// everything on reading each K/V byte once:
//
//   - one thread block per (row, kv head), so the g query heads of a GQA
//     group share every K/V load (g = 1 for MHA);
//   - the block walks the row in tiles of 32 token positions (one per lane
//     in the softmax pass); each tile's K and V rows are staged in shared
//     memory with 16-byte loads, neighbouring threads on neighbouring
//     addresses, converted to fp32 once;
//   - warps take (head, token) score pairs with lanes across d; one warp per
//     head runs the online-softmax update with one lane per token; then all
//     threads update the (g, d) fp32 numerator held in shared memory.
//
// Not done yet (later work): splitting a long row across blocks
// (flash-decoding) for occupancy when B * kv is small, double-buffered
// cp.async / TMA staging, and wgmma for large g.
//
// C interface (bound with ctypes): every pointer and the stream are passed as
// void*, the function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // token positions per tile == lanes in a warp

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shared memory, in floats: q (g*d) | acc (g*d) | k tile (kTile*d) |
// v tile (kTile*d) | scores/probabilities (g*kTile) | m (g) | l (g) | alpha (g)
size_t smem_floats(int g, int d) {
  return 2 * (size_t)g * d + 2 * (size_t)kTile * d + (size_t)g * kTile + 3 * (size_t)g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ offsets,
    T* __restrict__ out, int kv, int g, int d, int block_size, int max_blocks,
    float sm_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + g * d;
  float* k_s = acc_s + g * d;
  float* v_s = k_s + kTile * d;
  float* p_s = v_s + kTile * d;
  float* m_s = p_s + g * kTile;
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = g * d;

  const size_t head_base = ((size_t)b * kv + kvh) * gd;  // q / out (b, kvh, :, :)
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = to_f32(q[head_base + i]);
    acc_s[i] = 0.f;
  }
  for (int h = tid; h < g; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }

  // keys past the table's reach do not exist (the TPU grid stops at
  // max_blocks); keys past the offset are masked, so the walk stops there
  const int last = min(offsets[b], max_blocks * block_size - 1);
  const int32_t* table = tables + (size_t)b * max_blocks;
  const size_t row_stride = (size_t)kv * d;         // token to token inside a page
  const size_t page_stride = (size_t)block_size * row_stride;
  constexpr int kVec = 16 / sizeof(T);              // elements per 16-byte load
  const int vecs_per_row = d / kVec;
  __syncthreads();

  for (int start = 0; start <= last; start += kTile) {
    const int ntok = min(kTile, last + 1 - start);

    // 1. stage this tile's K and V rows in shared memory as fp32
    for (int i = tid; i < ntok * vecs_per_row; i += kThreads) {
      const int t = i / vecs_per_row;
      const int c = i - t * vecs_per_row;
      const int pos = start + t;
      const size_t page = (size_t)table[pos / block_size];
      const size_t src = page * page_stride + (size_t)(pos % block_size) * row_stride +
                         (size_t)kvh * d + (size_t)c * kVec;
      const uint4 kraw = *reinterpret_cast<const uint4*>(k_pages + src);
      const uint4 vraw = *reinterpret_cast<const uint4*>(v_pages + src);
      const T* kt = reinterpret_cast<const T*>(&kraw);
      const T* vt = reinterpret_cast<const T*>(&vraw);
      float* kd = k_s + t * d + c * kVec;
      float* vd = v_s + t * d + c * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        kd[e] = to_f32(kt[e]);
        vd[e] = to_f32(vt[e]);
      }
    }
    __syncthreads();

    // 2. scores: one (head, token) pair per warp, lanes across d
    for (int pair = warp; pair < g * ntok; pair += kWarps) {
      const int h = pair / ntok;
      const int t = pair - h * ntok;
      const float* qh = q_s + h * d;
      const float* kt = k_s + t * d;
      float s = 0.f;
      for (int e = lane; e < d; e += 32) s = fmaf(qh[e], kt[e], s);
      s = warp_sum(s);
      if (lane == 0) p_s[h * kTile + t] = s * sm_scale;
    }
    __syncthreads();

    // 3. online softmax: one warp per head, one lane per token
    for (int h = warp; h < g; h += kWarps) {
      const float s = lane < ntok ? p_s[h * kTile + lane] : -INFINITY;
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < ntok ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      p_s[h * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + psum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // 4. numerator: acc = acc * alpha + p @ v, one (head, element) per thread
    for (int i = tid; i < gd; i += kThreads) {
      const int h = i / d;
      const int e = i - h * d;
      const float* ph = p_s + h * kTile;
      float a = acc_s[i] * alpha_s[h];
      for (int t = 0; t < ntok; ++t) a = fmaf(ph[t], v_s[t * d + e], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // a row with nothing to attend (offset < 0) writes zeros; the engine never
  // passes one
  for (int i = tid; i < gd; i += kThreads) {
    const float l = l_s[i / d];
    out[head_base + i] = from_f32<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tables,
                   const void* offsets, void* out, int batch, int kv, int g, int d,
                   int block_size, int max_blocks, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats(g, d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(kv, batch);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(offsets),
      static_cast<T*>(out), kv, g, d, block_size, max_blocks, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (the wrapper refuses
// shapes above the 227 KB a block may use).
long long galvatron_paged_decode_smem_bytes(int g, int d) {
  return (long long)(smem_floats(g, d) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
int galvatron_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                           const void* tables, const void* offsets, void* out, int dtype,
                           int batch, int kv, int g, int d, int block_size, int max_blocks,
                           float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pages, v_pages, tables, offsets, out, batch, kv, g, d,
                              block_size, max_blocks, sm_scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, tables, offsets, out, batch, kv,
                                      g, d, block_size, max_blocks, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
