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
// launch covers the call, one thread block per (b, h, q tile: 128 rows on the
// tensor cores, 64 on the CUDA cores), and the block walks 64-key tiles with
// an fp32 online softmax in registers. Causal: tiles above the diagonal are
// never visited and only tiles straddling it (or the ragged end) are masked,
// the `_dispatch_causal` split; non-causal walks every tile unmasked. Tiles
// whose rows are the longest run first (blockIdx.x reversed).
//
// Bound: at the GPT-2 XL training shape (b=8, h=25, s=1024, d=64, causal,
// bf16) the two products take 4 * b * h * s(s+1)/2 * d = 2.7e10 operations,
// 0.027 ms at 989 TFLOP/s, against 106 MB of traffic, 0.032 ms at 3.35 TB/s:
// bytes, narrowly. bf16 at head_dim 64 and 128 runs on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation, the scores kept in registers and p
// rounded to bf16 straight into the A fragments of the PV product), with
// CAUSAL and ROPE compile-time; fp32 and other head dims take a CUDA-core
// kernel with both as run-time flags. No TMA, wgmma or pipelined copy yet.
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long, returns cudaGetLastError() after the launch.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::View;

struct GridFwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const float* cos;  // null without RoPE
  const float* sin;
  View vq, vk, vv, vo;
  int heads, kv_rep, s, d;
  bool causal, out_f32;
  float lam;  // sm_scale * log2(e), applied after the q . k product
};

// the keys a q tile starting at q0 with `rows` rows visits: up to the
// diagonal when causal, else all of them
__device__ __forceinline__ int key_tiles(bool causal, int q0, int rows, int s, int tile) {
  return causal ? (min(q0 + rows, s) - 1) / tile + 1 : (s + tile - 1) / tile;
}

// ---------------------------------------------------------------------------
// CUDA cores (fp32, and bf16 off head_dim 64 / 128): a 16 x 16 grid of
// threads, each with a RI x CJ register tile of scores, TILE-row tiles staged
// in shared memory as fp32.
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (head_dim 64 or 128): one block of 8 warps per
// (b, h, 128-row q tile), each warp owning 16 rows, walking 64-key tiles.
// S = q k^T and O += p v are mma.sync m16n8k16 products with fp32
// accumulation; the scores stay in registers, are scaled by sm_scale *
// log2(e) there, and p is rounded to bf16 straight from them into the A
// fragments of the PV product. Tiles are staged row-major in 16-byte chunks
// (q and k roped on the way in with ROPE); v's B fragments come from
// ldmatrix .trans. A warp none of whose rows a causal tile reaches skips it.
// ---------------------------------------------------------------------------

using flash::kMmaRows;
using flash::kMmaThreads;
using flash::kMmaTile;

template <int D>
size_t mma_smem_bytes() {
  // q (kMmaRows), k and v (kMmaTile) tiles, row-major with row stride D + 8
  // (conflict-free rows)
  return ((size_t)kMmaRows + 2 * kMmaTile) * (D + 8) * sizeof(flash::bf16);
}

template <int D, bool CAUSAL, bool ROPE>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_grid_fwd_mma_kernel(GridFwdArgs a) {
  using flash::bf16;
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kMmaRows * LD;
  bf16* vs = ks + kMmaTile * LD;

  const int s = a.s;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.kv_rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * kMmaRows, r0 = warp * 16;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.vq.b + h * a.vq.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vv.b + kvh * a.vv.h;

  flash::stage_tile<D, kMmaRows>(qs, LD, qg, a.vq.s, q0, s, a.cos, a.sin, 1.f, ROPE);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) flash::zero_c(o[n]);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_a = q0 + r0 + g, row_b = row_a + 8;

  const int nkt = key_tiles(CAUSAL, q0, kMmaRows, s, kMmaTile);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kMmaTile;
    __syncthreads();
    flash::stage_tile<D, kMmaTile>(ks, LD, kg, a.vk.s, k0, s, a.cos, a.sin, 1.f, ROPE);
    flash::stage_tile<D, kMmaTile>(vs, LD, vg, a.vv.s, k0, s, nullptr, nullptr, 1.f, false);
    __syncthreads();
    if (CAUSAL && q0 + r0 + 15 < k0) continue;  // every key of the tile is above this warp's rows

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) flash::zero_c(sc[j]);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      flash::ld_a(qa, qs, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kp = ks + (8 * j + g) * LD + kk * 16 + 2 * t;
        flash::mma_bf16(sc[j], qa, flash::ld_pair(kp), flash::ld_pair(kp + 8));
      }
    }

    const bool straddles = (CAUSAL && k0 + kMmaTile - 1 > q0 + r0) || k0 + kMmaTile > s;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        sc[j][e] = __fmul_rn(sc[j][e], a.lam);
        if (straddles && ((CAUSAL && col > row) || col >= s)) sc[j][e] = flash::kMasked;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - m[e >> 1]);
        rs[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys at a time
      uint32_t pa[4];
      flash::c_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];
        flash::ld_b_trans(vb, vs, LD, kk * 16, 8 * n, lane);
        flash::mma_bf16(o[n], pa, vb[0], vb[1]);
        flash::mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  bf16* ob = static_cast<bf16*>(a.out) + b * a.vo.b + h * a.vo.h;
  float* of = static_cast<float*>(a.out) + b * a.vo.b + h * a.vo.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= s) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const long long at = row * a.vo.s + 8 * n + 2 * t;
      if (a.out_f32)
        flash::st_pair(of + at, o[n][2 * r] / lc, o[n][2 * r + 1] / lc);
      else
        flash::st_pair(ob + at, o[n][2 * r] / lc, o[n][2 * r + 1] / lc);
    }
    if (t == 0) a.lse[((size_t)b * a.heads + h) * s + row] = m[r] * flash::kLn2 + logf(lc);
  }
}

template <int D, bool CAUSAL, bool ROPE>
cudaError_t launch_mma(const GridFwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_grid_fwd_mma_kernel<D, CAUSAL, ROPE>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kMmaRows - 1) / kMmaRows, a.heads, batch);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mma(const GridFwdArgs& a, int batch, cudaStream_t stream) {
  const bool rope = a.cos != nullptr;
  if (a.causal)
    return rope ? launch_mma<D, true, true>(a, batch, stream)
                : launch_mma<D, true, false>(a, batch, stream);
  return rope ? launch_mma<D, false, true>(a, batch, stream)
              : launch_mma<D, false, false>(a, batch, stream);
}

template <typename T, typename OutT, int TILE, int NJ>
cudaError_t launch(const GridFwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<TILE>(a.d) * sizeof(float);
  auto kernel = flash_grid_fwd_kernel<T, OutT, TILE, NJ>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + TILE - 1) / TILE, a.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t dispatch_cuda_cores(const GridFwdArgs& a, int batch, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, OutT, 64, 4>(a, batch, stream);
  if (a.d <= 128) return launch<T, OutT, 64, 8>(a, batch, stream);
  return launch<T, OutT, 32, 16>(a, batch, stream);
}

bool can_mma(const GridFwdArgs& a) {
  using flash::aligned16;
  using flash::rows16;
  return (a.d == 64 || a.d == 128) && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.out) && aligned16(a.cos) && aligned16(a.sin) && rows16(a.vq) &&
         rows16(a.vk) && rows16(a.vv) && rows16(a.vo);
}

}  // namespace

extern "C" {

// strides: q, k, v, out as (b, h, s) element strides, 12 values. cos/sin:
// null without RoPE. dtype: 0 = float32, 1 = bfloat16; out_f32: 1 writes out
// in fp32 whatever the input dtype. Returns cudaGetLastError() after the
// launch.
int galvatron_flash_grid_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             const void* cos, const void* sin, const long long* strides,
                             int dtype, int out_f32, int causal, int batch, int heads,
                             int kv_rep, int s, int d, float lam, void* stream) {
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
  a.heads = heads;
  a.kv_rep = kv_rep;
  a.s = s;
  a.d = d;
  a.causal = causal != 0;
  a.out_f32 = out_f32 != 0;
  a.lam = lam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_cuda_cores<float, float>(a, batch, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (can_mma(a)) return (int)(a.d == 128 ? dispatch_mma<128>(a, batch, st)
                                          : dispatch_mma<64>(a, batch, st));
  if (a.out_f32) return (int)dispatch_cuda_cores<__nv_bfloat16, float>(a, batch, st);
  return (int)dispatch_cuda_cores<__nv_bfloat16, __nv_bfloat16>(a, batch, st);
}

}  // extern "C"
