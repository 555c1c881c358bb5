// Grid flash attention forward (causal or not, RoPE optional), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (galvatron_tpu/ops/flash_attention.py:
// 123, launched by `_flash_fwd` at :227), the reference's path for every
// attention call outside the blocked-causal RoPE envelope: models without
// RoPE (GPT/OPT, learned positions), non-causal encoders, RoPE shapes past
// the envelope, and ring attention's hops (fp32 `out_dtype`). It rounds where
// `_fwd_kernel` rounds, which is not where the blocked kernel does: q and k
// roped through the UNSCALED tables and rounded to the input dtype (only with
// RoPE), scores (q . k) in fp32 multiplied by sm_scale * log2(e) AFTER the
// product, p rounded to the input dtype before the PV product, and the
// natural-log lse = m * ln2 + log(max(l, 1e-30)).
//
//   q, k, v  (b, h | h / kv_rep, s, d)  any element strides, d unit-stride:
//            views of the stacked (b, s, 3, h, d) projection go in with no
//            copy; head h reads kv head h / kv_rep (GQA)
//   cos/sin  (s, d/2) fp32, unscaled, or null (no RoPE)
//   out      (b, h, s, d) by strides, the input dtype or fp32
//   lse      (b, h, s) fp32, contiguous
//
// Not block by block: the TPU grid walked (b, h, q block, k block) with the
// running (m, l, acc) in VMEM scratch across the sequential k steps. Here one
// launch covers the call (two with RoPE on the tensor cores: the k pre-pass,
// then the main kernel), and each (b, h, q tile: 128 rows on the tensor
// cores, 64 on the CUDA cores) walks key tiles with an fp32 online softmax in
// registers: a thread block per q tile on the CUDA cores, one persistent
// block per SM taking q tiles in turn on the tensor cores. Causal: tiles above the diagonal are
// never visited and only tiles straddling it (or the ragged end) are
// masked, the `_dispatch_causal` split; non-causal walks every tile, masking
// only the ragged end. Tiles whose rows are the longest run first.
//
// Bound: at the GPT-2 XL training shape (b=8, h=25, s=1024, d=64, causal,
// bf16) the two products take 4 * b * h * s(s+1)/2 * d = 2.7e10 operations,
// 0.027 ms at 989 TFLOP/s, against 106 MB of traffic, 0.032 ms at 3.35 TB/s:
// bytes, narrowly. bf16 at head_dim 64 and 128 runs the forward's Hopper
// mainloop shared with the blocked kernel (flash_fwd_common.cuh, GRID true):
// a TMA ring of 128-key tiles of k and v read straight from their strided
// views (k' from a pre-pass scratch with RoPE, each k row roped once per
// call; q by TMA too without RoPE), wgmma for S = q k^T and O += p v with p
// rounded to bf16 in registers, the two consumer warpgroups taking turns at
// S (pingpong); the scale is applied to S after the product, the mask is
// causal or none, and out is written in bf16 or fp32 by strides. fp32,
// fp16 (the same rounding points at fp16; out in fp16 or fp32), other head
// dims and operands a tensor map cannot take run a CUDA-core kernel with
// both flags at run time. The shared mainloop also has an fp16 instance
// (the blocked forward's), but this entry instantiates only the bf16 one:
// the TMA route is chosen on the type being bf16, not on its size, and the
// grid kernels at fp16 keep the CUDA-core route.
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long, the route taken written through an int*,
// returns cudaGetLastError() after the launches. The tensor maps are encoded
// before any launch: where the driver refuses one, the call takes the
// CUDA-core kernel and reports that route.

#include "flash_fwd_common.cuh"

namespace {

using flash::kThreads;
using flash::View;

using GridFwdArgs = flash::fwd::Args;

// the keys a q tile starting at q0 with `rows` rows visits: up to the
// diagonal when causal, else all of them
__device__ __forceinline__ int key_tiles(bool causal, int q0, int rows, int s, int tile) {
  return causal ? (min(q0 + rows, s) - 1) / tile + 1 : (s + tile - 1) / tile;
}

// ---------------------------------------------------------------------------
// CUDA cores (fp32, fp16, and bf16 off head_dim 64 / 128): a 16 x 16 grid
// of threads, each with a RI x CJ register tile of scores, TILE-row tiles
// staged in shared memory as fp32.
// ---------------------------------------------------------------------------

template <int TILE>
size_t fwd_smem_floats(int d) {
  return 2 * (size_t)TILE * (d + 1) + (size_t)TILE * d + (size_t)TILE * (TILE + 1);
}

template <typename T, typename OutT, int TILE, int NJ>
__global__ void __launch_bounds__(kThreads) flash_grid_fwd_kernel(GridFwdArgs a) {
  constexpr int RI = TILE / 16;  // rows of a thread (score rows and output rows)
  constexpr int CJ = TILE / 16;  // score columns of a thread
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1, s = a.s;
  float* qs = smem;            // TILE x ld: q (roped and rounded with RoPE)
  float* ks = qs + TILE * ld;  // TILE x ld: k (likewise)
  float* vs = ks + TILE * ld;  // TILE x d
  float* ps = vs + TILE * d;   // TILE x (TILE + 1): p rounded to T

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.kv_rep;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * TILE;
  const bool roped = a.cos != nullptr;
  const T* qg = static_cast<const T*>(a.q) + b * a.vq.b + h * a.vq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  OutT* og = static_cast<OutT*>(a.out) + b * a.vo.b + h * a.vo.h;

  flash::stage_rows<T>(qs, ld, qg, a.vq.s, q0, TILE, s, d, a.cos, a.sin, 1.f, roped);

  float m[RI], l[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nkt = key_tiles(a.causal, q0, TILE, s, TILE);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    flash::stage_rows<T>(ks, ld, kg, a.vk.s, k0, TILE, s, d, a.cos, a.sin, 1.f, roped);
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

    const bool straddles = (a.causal && k0 + TILE - 1 > q0) || k0 + TILE > s;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        sc[i][j] = __fmul_rn(sc[i][j], a.lam);
        if (straddles && ((a.causal && col > row) || col >= s)) sc[i][j] = flash::kMasked;
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
      if (c < d) og[row * a.vo.s + c] = flash::from_f32<OutT>(acc[i][j] / lc);
    }
    if (tx == 0)
      a.lse[((size_t)b * a.heads + h) * s + row] = m[i] * flash::kLn2 + logf(lc);
  }
}

template <typename T, typename OutT, int TILE, int NJ>
cudaError_t launch(const GridFwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<TILE>(a.d) * sizeof(float);
  auto kernel = flash_grid_fwd_kernel<T, OutT, TILE, NJ>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + TILE - 1) / TILE, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t dispatch_cuda_cores(const GridFwdArgs& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, OutT, 64, 4>(a, stream);
  if (a.d <= 128) return launch<T, OutT, 64, 8>(a, stream);
  return launch<T, OutT, 32, 16>(a, stream);
}

// the TMA route's kernel for the call's mask and out dtype (the k pre-pass
// first with RoPE)
template <int D>
cudaError_t launch_tma(const GridFwdArgs& a, void* kscratch, const CUtensorMap& tq,
                       const CUtensorMap& tk, const CUtensorMap& tv, cudaStream_t stream) {
  namespace fw = flash::fwd;
  using flash::bf16;
  if (a.causal)
    return a.out_f32 ? fw::launch<D, true, true, float, bf16>(a, kscratch, tq, tk, tv, stream)
                     : fw::launch<D, true, true, bf16, bf16>(a, kscratch, tq, tk, tv, stream);
  return a.out_f32 ? fw::launch<D, true, false, float, bf16>(a, kscratch, tq, tk, tv, stream)
                   : fw::launch<D, true, false, bf16, bf16>(a, kscratch, tq, tk, tv, stream);
}

template <typename T>
cudaError_t dispatch(const GridFwdArgs& a, void* kscratch, cudaStream_t stream, int* route) {
  namespace fw = flash::fwd;
  *route = flash::kRouteCudaCore;
  if (std::is_same<T, __nv_bfloat16>::value && fw::can_tma(a, kscratch)) {
    CUtensorMap tq, tk, tv;
    if (a.d == 128 ? fw::encode_maps<flash::bf16, 128>(a, kscratch, &tq, &tk, &tv)
                   : fw::encode_maps<flash::bf16, 64>(a, kscratch, &tq, &tk, &tv)) {
      *route = flash::kRouteTma;
      return a.d == 128 ? launch_tma<128>(a, kscratch, tq, tk, tv, stream)
                        : launch_tma<64>(a, kscratch, tq, tk, tv, stream);
    }
  }
  if (a.out_f32) return dispatch_cuda_cores<T, float>(a, stream);
  return dispatch_cuda_cores<T, T>(a, stream);
}

}  // namespace

extern "C" {

// strides: q, k, v, out as (b, h, s) element strides, 12 values. cos/sin:
// null without RoPE. k_scratch: bf16 (batch, heads / kv_rep, s, d),
// contiguous, for the k pre-pass of the bf16 route at head_dim 64 / 128 with
// RoPE (null elsewhere). work: two int32, zero, the persistent kernel's item
// counter on the bf16 route at head_dim 64 / 128 (the kernel leaves them
// zero again; null elsewhere). dtype: 0 = float32, 1 = bfloat16, 2 = float16
// (the CUDA-core kernel); out_f32: 1 writes out in fp32 whatever the input
// dtype. route: set to the route taken (flash::Route). Returns
// cudaGetLastError() after the launches.
int galvatron_flash_grid_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             const void* cos, const void* sin, void* k_scratch, void* work,
                             const long long* strides, int dtype, int out_f32, int causal,
                             int batch, int heads, int kv_rep, int s, int d, float lam,
                             void* stream, int* route) {
  if (d % 8 != 0 || d > 256 || d <= 0 || s <= 0 || kv_rep <= 0 ||
      (cos == nullptr) != (sin == nullptr))
    return (int)cudaErrorInvalidValue;
  GridFwdArgs a;
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
  a.causal = causal != 0;
  a.out_f32 = out_f32 != 0;
  a.lam = lam;
  a.work = static_cast<int*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, nullptr, st, route);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, k_scratch, st, route);
  if (dtype == 2) return (int)dispatch<__half>(a, nullptr, st, route);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
