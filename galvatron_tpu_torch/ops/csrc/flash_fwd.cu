// Blocked-causal flash attention forward with fused rotate-half RoPE, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_blocked` (galvatron_tpu/ops/
// flash_attention.py:272, launched by `_flash_fwd_blocked` at :450): causal
// self-attention of one (b, h) slice, q roped through tables pre-scaled by
// sm_scale * log2(e) and rounded to the input dtype, k roped through the
// unscaled tables and rounded, base-2 scores in fp32 with exp2, p rounded
// to the input dtype before the PV product, and the natural-log
// lse = m * ln2 + log(l).
//
//   q, k, v  (b, h | h / kv_rep, s, d)  any element strides, d unit-stride:
//            the stacked (b, 3, h, s, d) projection output goes in as three
//            views with no copy; head h reads kv head h / kv_rep (GQA)
//   cos/sin  (s, d/2) fp32, unscaled
//   out      (b, h, s, d) by strides, the input dtype
//   lse      (b, h, s) fp32, contiguous
//
// Not block by block: the TPU kernel ran one pallas_call per 1024-row q
// block with the k loop unrolled. Here one launch covers the whole call (two
// on the tensor-core path: the k pre-pass, then the main kernel), walking each
// (b, h, q tile)'s key tiles up to the diagonal with an fp32 online softmax
// kept in registers: a thread block per q tile on the CUDA cores, one
// persistent block per SM taking q tiles in turn on the tensor cores. Only
// the diagonal tile (and a ragged last tile) is masked. Of a (b, h)'s q
// tiles the longest rows run first.
//
// Bound: operations. At the main shape (b=8, h=32, s=2048, d=128, bf16) the
// two products take 4 * b * h * (s^2 / 2) * d = 2.75e11 operations against
// ~0.54 GB of traffic: 0.278 ms at 989 TFLOP/s vs 0.161 ms at 3.35 TB/s.
// So the products go to the tensor cores: for bf16 and fp16 at head_dim 64
// and 128 (the main paths) a k pre-pass, then a TMA ring feeding wgmma,
// warp-specialised: the mainloop shared with the grid forward
// (flash_fwd_common.cuh, GRID false), instantiated for each of the two
// element types (.bf16 or .f16 operands, fp32 accumulation; the fp16 rates
// and bytes are bf16's). Other head dims, fp32 inputs and pointers or
// strides off 16 bytes take a CUDA-core kernel (fp32 from shared memory, a
// 4 x 4 register tile of scores per thread), in fp32, bf16 or fp16.
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long, the route taken written through an int*,
// returns cudaGetLastError() after the launches. The tensor maps are encoded
// at each call through the runtime's driver entry point (no -lcuda), before
// any launch: where the driver refuses one, the call takes the CUDA-core
// kernel and reports that route.

#include "flash_fwd_common.cuh"

namespace {

using flash::kThreads;
using flash::View;

using FwdArgs = flash::fwd::Args;

template <int TILE>
size_t fwd_smem_floats(int d) {
  return 2 * (size_t)TILE * (d + 1) + (size_t)TILE * d + (size_t)TILE * (TILE + 1);
}

template <typename T, int TILE, int NJ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  constexpr int RI = TILE / 16;  // rows of a thread (score rows and output rows)
  constexpr int CJ = TILE / 16;  // score columns of a thread
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1, s = a.s;
  float* qs = smem;              // TILE x ld: roped, scaled, rounded q
  float* ks = qs + TILE * ld;    // TILE x ld: roped, rounded k
  float* vs = ks + TILE * ld;    // TILE x d
  float* ps = vs + TILE * d;     // TILE x (TILE + 1): p rounded to T

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.kv_rep;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * TILE;
  const T* qg = static_cast<const T*>(a.q) + b * a.vq.b + h * a.vq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  T* og = static_cast<T*>(a.out) + b * a.vo.b + h * a.vo.h;

  flash::stage_rows<T>(qs, ld, qg, a.vq.s, q0, TILE, s, d, a.cos, a.sin, a.lam, true);

  float m[RI], l[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int last_row = min(q0 + TILE, s) - 1;
  const int nkt = last_row / TILE + 1;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    flash::stage_rows<T>(ks, ld, kg, a.vk.s, k0, TILE, s, d, a.cos, a.sin, 1.f, true);
    flash::stage_rows<T>(vs, d, vg, a.vv.s, k0, TILE, s, d, nullptr, nullptr, 1.f, false);
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    const bool straddles = k0 + TILE - 1 > q0 || k0 + TILE > s;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        if (straddles && (col > row || col >= s)) sc[i][j] = flash::kMasked;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], flash::row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        rs += p;
        ps[r * (TILE + 1) + tx + 16 * j] = flash::round_to<T>(p);
      }
      rs = flash::row_sum(rs);
      const float alpha = exp2f(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < TILE; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * (TILE + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < d ? vs[kk * d + c] : 0.f;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) og[row * a.vo.s + c] = flash::from_f32<T>(acc[i][j] / lc);
    }
    if (tx == 0)
      a.lse[((size_t)b * a.heads + h) * s + row] = m[i] * flash::kLn2 + logf(lc);
  }
}

template <typename T, int TILE, int NJ>
cudaError_t launch(const FwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<TILE>(a.d) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, TILE, NJ>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.s + TILE - 1) / TILE, a.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tensor-core route for T = bf16 or fp16 (the mainloop instantiated
// for T), the CUDA-core kernel for fp32 and wherever can_tma or a tensor
// map says no.
template <typename T>
cudaError_t dispatch(const FwdArgs& a, void* kscratch, cudaStream_t stream, int* route) {
  namespace fw = flash::fwd;
  *route = flash::kRouteCudaCore;
  if constexpr (!std::is_same<T, float>::value) {
    if (fw::can_tma(a, kscratch)) {
      CUtensorMap tq, tk, tv;
      if (a.d == 128 ? fw::encode_maps<T, 128>(a, kscratch, &tq, &tk, &tv)
                     : fw::encode_maps<T, 64>(a, kscratch, &tq, &tk, &tv)) {
        *route = flash::kRouteTma;
        return a.d == 128 ? fw::launch<128, false, true, T, T>(a, kscratch, tq, tk, tv, stream)
                          : fw::launch<64, false, true, T, T>(a, kscratch, tq, tk, tv, stream);
      }
    }
  }
  if (a.d <= 64) return launch<T, 64, 4>(a, a.batch, stream);
  if (a.d <= 128) return launch<T, 64, 8>(a, a.batch, stream);
  return launch<T, 32, 16>(a, a.batch, stream);
}

}  // namespace

extern "C" {

// strides: q, k, v, out as (b, h, s) element strides, 12 values.
// k_scratch: (batch, heads / kv_rep, s, d) in q's dtype, contiguous, for
// roped k on the bf16 and fp16 paths at head_dim 64 / 128 (null elsewhere:
// the CUDA-core kernel). work: two int32, zero, the persistent kernel's item
// counter on those paths (the kernel leaves them zero again; null
// elsewhere). dtype: 0 = float32, 1 = bfloat16, 2 = float16. route: set to the route taken
// (flash::Route: 1 the TMA + wgmma kernel with its pre-pass, 0 the
// CUDA-core kernel). Returns cudaGetLastError() after the launches.
int galvatron_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        const void* cos, const void* sin, void* k_scratch, void* work,
                        const long long* strides, int dtype, int batch, int heads, int kv_rep,
                        int s, int d, float lam, void* stream, int* route) {
  if (d % 8 != 0 || d > 256 || d <= 0 || s <= 0 || kv_rep <= 0)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  View* views[4] = {&a.vq, &a.vk, &a.vv, &a.vo};
  for (int t = 0; t < 4; ++t) {
    views[t]->b = strides[3 * t];
    views[t]->h = strides[3 * t + 1];
    views[t]->s = strides[3 * t + 2];
  }
  a.batch = batch;
  a.heads = heads;
  a.kv_rep = kv_rep;
  a.s = s;
  a.d = d;
  a.causal = true;
  a.out_f32 = false;
  a.lam = lam;
  a.work = static_cast<int*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, nullptr, st, route);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, k_scratch, st, route);
  if (dtype == 2) return (int)dispatch<__half>(a, k_scratch, st, route);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
