// Blocked-causal flash attention backward with fused RoPE counter-rotation,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel_blocked` (galvatron_tpu/ops/
// flash_attention.py:514, launched by `_flash_bwd_blocked` at :655): given
// q, k, v, the forward's out and natural-log lse and the output gradient do,
//
//   delta = sum(do * out) per row                       (fp32)
//   p     = exp2(q_scaled . k_roped - lse * log2(e))    (recomputed, base 2)
//   dv   += p^T . do          (p rounded to the input dtype)
//   dp    = do . v^T
//   ds    = p * (dp - delta)  (rounded to the input dtype)
//   dk   += ds^T . q_scaled,  dk = rope^T(dk * ln2)       (unscaled tables)
//   dq   += ds . k_roped,     dq = rope^T(dq * sm_scale)  (unscaled tables)
//
// with q roped through tables pre-scaled by sm_scale * log2(e) and k through
// the unscaled ones, each rounded to the input dtype, as the reference does.
//
// Design. On the TPU one sequential grid step per (b, h) carried dq across k
// blocks in VMEM. Hopper blocks run in parallel with no order, so dq cannot
// be shared across k tiles without atomics. This file takes the split with
// a second pass, chosen over fp32 atomicAdd into a scratch buffer because it
// is deterministic (run-to-run identical gradients) and needs no scratch
// conversion pass; the price is recomputing the two score products in the dq
// pass (7 products per tile pair instead of 5):
//
//   1. flash_delta_kernel: delta per row, one warp per row, into an fp32
//      (b, h, s) buffer the wrapper allocates;
//   2. dk/dv pass: one block per (b, h, key tile), dk/dv accumulated in
//      registers over the 64-row q tiles at or below the diagonal, then dk
//      counter-rotated;
//   3. dq pass: one block per (b, h, query tile), dq accumulated over the
//      64-key tiles up to the diagonal, then counter-rotated.
//   A block owns 128 rows on the tensor cores and 64 on the CUDA cores.
//
// q/k/v/do/out are read and dq/dk/dv written by element strides, so the
// stacked (b, 3, h, s, d) residual and gradient need no copies. For GQA
// (kv_rep > 1) k/v are read at head h / kv_rep and dk/dv are written per
// query head; the caller sums them over the group, as `_flash_bwd_rule` does.
//
// Bound: operations. At the main shape (b=8, h=32, s=2048, d=128, bf16) the
// five products of the backward take 10 * b * h * (s^2 / 2) * d = 6.87e11
// operations, 0.695 ms at 989 TFLOP/s, against ~0.8 GB of traffic
// (0.24 ms at 3.35 TB/s). For bf16 at head_dim 64 and 128 (the main path)
// both passes run every product on the tensor cores (mma.sync m16n8k16,
// fp32 accumulation, p and ds rounded to bf16 straight from registers into
// A fragments); other head dims and fp32 take CUDA-core kernels. No TMA,
// wgmma or pipelined copy yet (ROADMAP §2.2).
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long, returns cudaGetLastError() after the last
// launch (or the first error).

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::View;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;
  const float* lse;
  const float* cos;
  const float* sin;
  void* dq;
  void* dk;
  void* dv;
  float* delta;
  View vq, vk, vv, vdo, vout, vdq, vdk, vdv;
  int heads, kv_rep, s, d;
  float lam;       // sm_scale * log2(e)
  float sm_scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(BwdArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= a.s) return;
  const T* dg = static_cast<const T*>(a.dout) + b * a.vdo.b + h * a.vdo.h + row * a.vdo.s;
  const T* og = static_cast<const T*>(a.out) + b * a.vout.b + h * a.vout.h + row * a.vout.s;
  float acc = 0.f;
  for (int c = lane; c < a.d; c += 32) acc = fmaf(flash::to_f32(dg[c]), flash::to_f32(og[c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) a.delta[((size_t)b * a.heads + h) * a.s + row] = acc;
}

// Scores and dp of one (q tile, k tile) pair, both from shared memory:
// sc[i][j] = qs[q] . ks[k], dp[i][j] = dos[q] . vs[k] for q rows ty + 16 i
// and k columns tx + 16 j.
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

// p and ds of one tile pair into shared memory (ps may be null): rows
// q0 + ty + 16 i, columns k0 + tx + 16 j; masked or out-of-range pairs are 0.
template <typename T, int TILE, int RI, int CJ>
__device__ __forceinline__ void probs_and_ds(const float (&sc)[RI][CJ],
                                             const float (&dp)[RI][CJ], const float* lse2s,
                                             const float* dels, int q0, int k0, int s, int ty,
                                             int tx, float* ps, float* dss) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      float p = 0.f;
      if (row < s && col <= row) p = exp2f(sc[i][j] - lse2s[r]);
      if (ps != nullptr) ps[r * (TILE + 1) + c] = flash::round_to<T>(p);
      dss[r * (TILE + 1) + c] = flash::round_to<T>(__fmul_rn(p, __fsub_rn(dp[i][j], dels[r])));
    }
  }
}

// lse * log2(e) and delta of one q tile into shared memory
__device__ __forceinline__ void stage_row_stats(const BwdArgs& a, int b, int h, int q0,
                                                int tile, float* lse2s, float* dels) {
  for (int r = threadIdx.x; r < tile; r += kThreads) {
    const int row = q0 + r;
    const size_t at = ((size_t)b * a.heads + h) * a.s + row;
    lse2s[r] = row < a.s ? a.lse[at] * flash::kLog2e : 0.f;
    dels[r] = row < a.s ? a.delta[at] : 0.f;
  }
}

// Counter-rotate `rows` rows of fp32 y (shared memory, row stride ld,
// already scaled) with the unscaled tables and write them to global memory
// in T by strides.
template <typename T>
__device__ __forceinline__ void write_rope_t(const float* ys, int ld, T* dst, long long ss,
                                             int row0, int rows, int s, int d,
                                             const float* cos, const float* sin) {
  const int half = d / 2;
  for (int e = threadIdx.x; e < rows * half; e += kThreads) {
    const int r = e / half;
    const int i = e - r * half;
    const int row = row0 + r;
    if (row >= s) continue;
    float x1, x2;
    flash::rope_t(ys[r * ld + i], ys[r * ld + i + half], cos[(size_t)row * half + i],
                  sin[(size_t)row * half + i], x1, x2);
    dst[row * ss + i] = flash::from_f32<T>(x1);
    dst[row * ss + i + half] = flash::from_f32<T>(x2);
  }
}

template <int TILE>
size_t bwd_smem_floats(int d) {
  // four TILE x (d+1) slabs, two TILE x (TILE+1) score tiles, two row stats
  return 4 * (size_t)TILE * (d + 1) + 2 * (size_t)TILE * (TILE + 1) + 2 * (size_t)TILE;
}

template <typename T, int TILE, int NJ>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(BwdArgs a) {
  constexpr int RI = TILE / 16, CJ = TILE / 16;
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1, s = a.s;
  float* ks = smem;
  float* vs = ks + TILE * ld;
  float* qs = vs + TILE * ld;
  float* dos = qs + TILE * ld;
  float* ps = dos + TILE * ld;
  float* dss = ps + TILE * (TILE + 1);
  float* lse2s = dss + TILE * (TILE + 1);
  float* dels = lse2s + TILE;

  const int kt = gridDim.x - 1 - blockIdx.x;  // the longest q walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.kv_rep;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * TILE;
  const T* qg = static_cast<const T*>(a.q) + b * a.vq.b + h * a.vq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  const T* dg = static_cast<const T*>(a.dout) + b * a.vdo.b + h * a.vdo.h;

  flash::stage_rows<T>(ks, ld, kg, a.vk.s, k0, TILE, s, d, a.cos, a.sin, 1.f, true);
  flash::stage_rows<T>(vs, ld, vg, a.vv.s, k0, TILE, s, d, nullptr, nullptr, 1.f, false);

  // dk / dv rows: keys k0 + ty + 16 i, columns tx + 16 j
  float dk[RI][NJ], dv[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }

  const int nqt = (s + TILE - 1) / TILE;
  for (int qt = kt; qt < nqt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // the previous tile's readers are done
    flash::stage_rows<T>(qs, ld, qg, a.vq.s, q0, TILE, s, d, a.cos, a.sin, a.lam, true);
    flash::stage_rows<T>(dos, ld, dg, a.vdo.s, q0, TILE, s, d, nullptr, nullptr, 1.f, false);
    stage_row_stats(a, b, h, q0, TILE, lse2s, dels);
    __syncthreads();

    float sc[RI][CJ], dp[RI][CJ];
    scores_and_dp<RI, CJ>(qs, dos, ks, vs, ld, d, ty, tx, sc, dp);
    probs_and_ds<T, TILE, RI, CJ>(sc, dp, lse2s, dels, q0, k0, s, ty, tx, ps, dss);
    __syncthreads();

    for (int qq = 0; qq < TILE; ++qq) {
      float pk[RI], dsk[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pk[i] = ps[qq * (TILE + 1) + ty + 16 * i];
        dsk[i] = dss[qq * (TILE + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float dov = c < d ? dos[qq * ld + c] : 0.f;
        const float qv = c < d ? qs[qq * ld + c] : 0.f;
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          dv[i][j] = fmaf(pk[i], dov, dv[i][j]);
          dk[i][j] = fmaf(dsk[i], qv, dk[i][j]);
        }
      }
    }
  }

  T* dvg = static_cast<T*>(a.dv) + b * a.vdv.b + h * a.vdv.h;
  T* dkg = static_cast<T*>(a.dk) + b * a.vdk.b + h * a.vdk.h;
  __syncthreads();  // qs is reused for dk * ln2
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = k0 + r;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= d) continue;
      qs[r * ld + c] = __fmul_rn(dk[i][j], flash::kLn2);
      if (row < s) dvg[row * a.vdv.s + c] = flash::from_f32<T>(dv[i][j]);
    }
  }
  __syncthreads();
  write_rope_t<T>(qs, ld, dkg, a.vdk.s, k0, TILE, s, d, a.cos, a.sin);
}

template <typename T, int TILE, int NJ>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  constexpr int RI = TILE / 16, CJ = TILE / 16;
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1, s = a.s;
  float* qs = smem;
  float* dos = qs + TILE * ld;
  float* ks = dos + TILE * ld;
  float* vs = ks + TILE * ld;
  float* dss = vs + TILE * ld;
  float* lse2s = dss + 2 * TILE * (TILE + 1);  // same layout size as dkdv
  float* dels = lse2s + TILE;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.kv_rep;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * TILE;
  const T* qg = static_cast<const T*>(a.q) + b * a.vq.b + h * a.vq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  const T* dg = static_cast<const T*>(a.dout) + b * a.vdo.b + h * a.vdo.h;

  flash::stage_rows<T>(qs, ld, qg, a.vq.s, q0, TILE, s, d, a.cos, a.sin, a.lam, true);
  flash::stage_rows<T>(dos, ld, dg, a.vdo.s, q0, TILE, s, d, nullptr, nullptr, 1.f, false);
  stage_row_stats(a, b, h, q0, TILE, lse2s, dels);

  float dq[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int last_row = min(q0 + TILE, s) - 1;
  const int nkt = last_row / TILE + 1;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    flash::stage_rows<T>(ks, ld, kg, a.vk.s, k0, TILE, s, d, a.cos, a.sin, 1.f, true);
    flash::stage_rows<T>(vs, ld, vg, a.vv.s, k0, TILE, s, d, nullptr, nullptr, 1.f, false);
    __syncthreads();

    float sc[RI][CJ], dp[RI][CJ];
    scores_and_dp<RI, CJ>(qs, dos, ks, vs, ld, d, ty, tx, sc, dp);
    probs_and_ds<T, TILE, RI, CJ>(sc, dp, lse2s, dels, q0, k0, s, ty, tx, nullptr, dss);
    __syncthreads();

    for (int kk = 0; kk < TILE; ++kk) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dss[(ty + 16 * i) * (TILE + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float kv = c < d ? ks[kk * ld + c] : 0.f;
#pragma unroll
        for (int i = 0; i < RI; ++i) dq[i][j] = fmaf(dsv[i], kv, dq[i][j]);
      }
    }
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.vdq.b + h * a.vdq.h;
  __syncthreads();  // ks is reused for dq * sm_scale
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ks[(ty + 16 * i) * ld + c] = __fmul_rn(dq[i][j], a.sm_scale);
    }
  __syncthreads();
  write_rope_t<T>(ks, ld, dqg, a.vdq.s, q0, TILE, s, d, a.cos, a.sin);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (head_dim 64 or 128), the same two passes: eight
// warps per block, each owning 16 rows of the block's 128-row tile (keys in
// the dk/dv pass, queries in the dq pass), a warp no row of which a walked
// tile can reach skipping its products; every product is an mma.sync
// m16n8k16 with fp32 accumulation, p and ds are rounded to bf16 straight
// from the score registers into A fragments. Every tile is staged row-major;
// operands read along the reduction dimension of a B fragment (do and q in
// the dk/dv pass, k in the dq pass) are loaded with ldmatrix .trans.
// ---------------------------------------------------------------------------

using flash::kMmaRows;
using flash::kMmaThreads;
using flash::kMmaTile;

template <int D>
size_t mma_smem_bytes() {
  // two owned (kMmaRows) and two walked (kMmaTile) row-major tiles with row
  // stride D + 8, and two fp32 row statistics of up to kMmaRows rows
  return (2 * (size_t)kMmaRows + 2 * kMmaTile) * (D + 8) * sizeof(flash::bf16) +
         2 * kMmaRows * sizeof(float);
}

__device__ __forceinline__ void zero_c(float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
}

// dk/dv pass: block (b, h, 128-key tile); warp w owns keys k0 + 16 w ..
// S^T = k q^T and dP^T = v do^T (A from the k / v tiles, B from row-major
// q / do), dv += P^T do and dk += dS^T q (B from do / q by ldmatrix .trans).
// The q tile is walked in two halves of 32 to bound the score registers.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dkdv_mma_kernel(BwdArgs a) {
  using flash::bf16;
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kMmaRows * LD;
  bf16* qs = vs + kMmaRows * LD;
  bf16* dos = qs + kMmaTile * LD;
  float* lse2s = reinterpret_cast<float*>(dos + kMmaTile * LD);
  float* dels = lse2s + kMmaRows;

  const int s = a.s;
  const int kt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.kv_rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = kt * kMmaRows, r0 = warp * 16;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.vq.b + h * a.vq.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  const bf16* dg = static_cast<const bf16*>(a.dout) + b * a.vdo.b + h * a.vdo.h;

  flash::stage_tile<D, kMmaRows>(ks, LD, kg, a.vk.s, k0, s, a.cos, a.sin, 1.f, true);
  flash::stage_tile<D, kMmaRows>(vs, LD, vg, a.vv.s, k0, s, nullptr, nullptr, 1.f, false);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    zero_c(dk[n]);
    zero_c(dv[n]);
  }
  const int key_a = k0 + r0 + g, key_b = key_a + 8;

  const int nqt = (s + kMmaTile - 1) / kMmaTile;
  for (int qtile = k0 / kMmaTile; qtile < nqt; ++qtile) {
    const int q0 = qtile * kMmaTile;
    __syncthreads();
    flash::stage_tile<D, kMmaTile>(qs, LD, qg, a.vq.s, q0, s, a.cos, a.sin, a.lam, true);
    flash::stage_tile<D, kMmaTile>(dos, LD, dg, a.vdo.s, q0, s, nullptr, nullptr, 1.f, false);
    stage_row_stats(a, b, h, q0, kMmaTile, lse2s, dels);
    __syncthreads();
    // warp-uniform: every query of the tile is above this warp's keys
    if (q0 + kMmaTile - 1 < k0 + r0) continue;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;  // first query column of this half
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zero_c(st[j]);
        zero_c(dpt[j]);
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        flash::ld_a(ka, ks, LD, r0, kk * 16, g, t);
        flash::ld_a(va, vs, LD, r0, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* qp = qs + (c0 + 8 * j + g) * LD + kk * 16 + 2 * t;
          const bf16* dp = dos + (c0 + 8 * j + g) * LD + kk * 16 + 2 * t;
          flash::mma_bf16(st[j], ka, flash::ld_pair(qp), flash::ld_pair(qp + 8));
          flash::mma_bf16(dpt[j], va, flash::ld_pair(dp), flash::ld_pair(dp + 8));
        }
      }
      // P^T and dS^T: element (key, query) with query column c0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + qc;
          const int key = e < 2 ? key_a : key_b;
          float p = 0.f;
          if (row < s && key <= row) p = exp2f(st[j][e] - lse2s[qc]);
          st[j][e] = p;
          dpt[j][e] = __fmul_rn(p, __fsub_rn(dpt[j][e], dels[qc]));
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // 16 queries at a time
        uint32_t pa[4], da[4];
        flash::c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        flash::c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t db[4], qb[4];
          flash::ld_b_trans(db, dos, LD, c0 + kk * 16, 8 * n, lane);
          flash::ld_b_trans(qb, qs, LD, c0 + kk * 16, 8 * n, lane);
          flash::mma_bf16(dv[n], pa, db[0], db[1]);
          flash::mma_bf16(dv[n + 1], pa, db[2], db[3]);
          flash::mma_bf16(dk[n], da, qb[0], qb[1]);
          flash::mma_bf16(dk[n + 1], da, qb[2], qb[3]);
        }
      }
    }
  }

  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.vdv.b + h * a.vdv.h;
  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.vdk.b + h * a.vdk.h;
  const int half_d = D / 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key_a : key_b;
    if (key >= s) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      flash::st_pair(dvg + key * a.vdv.s + 8 * n + 2 * t, dv[n][2 * r], dv[n][2 * r + 1]);
    // dk column c and c + D/2 sit in this thread's tiles n and n + D/16
#pragma unroll
    for (int n = 0; n < ND / 2; ++n) {
      float x1[2], x2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * n + 2 * t + e;
        flash::rope_t(__fmul_rn(dk[n][2 * r + e], flash::kLn2),
                      __fmul_rn(dk[n + ND / 2][2 * r + e], flash::kLn2),
                      a.cos[(size_t)key * half_d + i], a.sin[(size_t)key * half_d + i], x1[e],
                      x2[e]);
      }
      flash::st_pair(dkg + key * a.vdk.s + 8 * n + 2 * t, x1[0], x1[1]);
      flash::st_pair(dkg + key * a.vdk.s + half_d + 8 * n + 2 * t, x2[0], x2[1]);
    }
  }
}

// dq pass: block (b, h, 128-query tile); warp w owns queries q0 + 16 w ..
// S = q k^T and dP = do v^T (A from the q / do tiles, B from row-major k /
// v), dq += dS k (B from k by ldmatrix .trans).
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_mma_kernel(BwdArgs a) {
  using flash::bf16;
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kMmaRows * LD;
  bf16* ks = dos + kMmaRows * LD;
  bf16* vs = ks + kMmaTile * LD;
  float* lse2s = reinterpret_cast<float*>(vs + kMmaTile * LD);
  float* dels = lse2s + kMmaRows;

  const int s = a.s;
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.kv_rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qtile * kMmaRows, r0 = warp * 16;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.vq.b + h * a.vq.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  const bf16* dg = static_cast<const bf16*>(a.dout) + b * a.vdo.b + h * a.vdo.h;

  flash::stage_tile<D, kMmaRows>(qs, LD, qg, a.vq.s, q0, s, a.cos, a.sin, a.lam, true);
  flash::stage_tile<D, kMmaRows>(dos, LD, dg, a.vdo.s, q0, s, nullptr, nullptr, 1.f, false);
  stage_row_stats(a, b, h, q0, kMmaRows, lse2s, dels);

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) zero_c(dq[n]);
  const int row_a = q0 + r0 + g, row_b = row_a + 8;

  const int last_row = min(q0 + kMmaRows, s) - 1;
  const int nkt = last_row / kMmaTile + 1;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kMmaTile;
    __syncthreads();
    flash::stage_tile<D, kMmaTile>(ks, LD, kg, a.vk.s, k0, s, a.cos, a.sin, 1.f, true);
    flash::stage_tile<D, kMmaTile>(vs, LD, vg, a.vv.s, k0, s, nullptr, nullptr, 1.f, false);
    __syncthreads();
    if (q0 + r0 + 15 < k0) continue;  // every key of the tile is above this warp's rows

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;  // first key column of this half
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zero_c(sc[j]);
        zero_c(dp[j]);
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], da[4];
        flash::ld_a(qa, qs, LD, r0, kk * 16, g, t);
        flash::ld_a(da, dos, LD, r0, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* kp = ks + (c0 + 8 * j + g) * LD + kk * 16 + 2 * t;
          const bf16* vp = vs + (c0 + 8 * j + g) * LD + kk * 16 + 2 * t;
          flash::mma_bf16(sc[j], qa, flash::ld_pair(kp), flash::ld_pair(kp + 8));
          flash::mma_bf16(dp[j], da, flash::ld_pair(vp), flash::ld_pair(vp + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c0 + 8 * j + 2 * t + (e & 1);
          const int lr = r0 + g + (e < 2 ? 0 : 8);  // row within the tile
          const int row = q0 + lr;
          float p = 0.f;
          if (row < s && col <= row) p = exp2f(sc[j][e] - lse2s[lr]);
          dp[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], dels[lr]));
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // 16 keys at a time
        uint32_t da[4];
        flash::c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t kb[4];
          flash::ld_b_trans(kb, ks, LD, c0 + kk * 16, 8 * n, lane);
          flash::mma_bf16(dq[n], da, kb[0], kb[1]);
          flash::mma_bf16(dq[n + 1], da, kb[2], kb[3]);
        }
      }
    }
  }

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.vdq.b + h * a.vdq.h;
  const int half_d = D / 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= s) continue;
#pragma unroll
    for (int n = 0; n < ND / 2; ++n) {
      float x1[2], x2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * n + 2 * t + e;
        flash::rope_t(__fmul_rn(dq[n][2 * r + e], a.sm_scale),
                      __fmul_rn(dq[n + ND / 2][2 * r + e], a.sm_scale),
                      a.cos[(size_t)row * half_d + i], a.sin[(size_t)row * half_d + i], x1[e],
                      x2[e]);
      }
      flash::st_pair(dqg + row * a.vdq.s + 8 * n + 2 * t, x1[0], x1[1]);
      flash::st_pair(dqg + row * a.vdq.s + half_d + 8 * n + 2 * t, x2[0], x2[1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int TILE, int NJ>
cudaError_t launch(const BwdArgs& a, int batch, cudaStream_t stream) {
  const dim3 rows_grid((a.s + kThreads / 32 - 1) / (kThreads / 32), a.heads, batch);
  flash_delta_kernel<T><<<rows_grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = bwd_smem_floats<TILE>(a.d) * sizeof(float);
  const dim3 grid((a.s + TILE - 1) / TILE, a.heads, batch);
  auto dkdv = flash_dkdv_kernel<T, TILE, NJ>;
  if ((err = allow_smem(dkdv, smem)) != cudaSuccess) return err;
  dkdv<<<grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dq = flash_dq_kernel<T, TILE, NJ>;
  if ((err = allow_smem(dq, smem)) != cudaSuccess) return err;
  dq<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const BwdArgs& a, int batch, cudaStream_t stream) {
  const dim3 rows_grid((a.s + kThreads / 32 - 1) / (kThreads / 32), a.heads, batch);
  flash_delta_kernel<flash::bf16><<<rows_grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = mma_smem_bytes<D>();
  const dim3 grid((a.s + kMmaRows - 1) / kMmaRows, a.heads, batch);
  auto dkdv = flash_dkdv_mma_kernel<D>;
  if ((err = allow_smem(dkdv, smem)) != cudaSuccess) return err;
  dkdv<<<grid, kMmaThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dq = flash_dq_mma_kernel<D>;
  if ((err = allow_smem(dq, smem)) != cudaSuccess) return err;
  dq<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool can_mma(const BwdArgs& a) {
  using flash::aligned16;
  using flash::rows16;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.cos, a.sin, a.dq, a.dk, a.dv};
  const View* views[] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vdq, &a.vdk, &a.vdv};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  for (const View* v : views)
    if (!rows16(*v)) return false;
  return a.d == 64 || a.d == 128;
}

template <typename T>
cudaError_t dispatch(const BwdArgs& a, int batch, cudaStream_t stream) {
  if (sizeof(T) == 2 && can_mma(a))
    return a.d == 128 ? launch_mma<128>(a, batch, stream) : launch_mma<64>(a, batch, stream);
  if (a.d <= 64) return launch<T, 64, 4>(a, batch, stream);
  if (a.d <= 128) return launch<T, 64, 8>(a, batch, stream);
  return launch<T, 32, 16>(a, batch, stream);
}

}  // namespace

extern "C" {

// strides: q, k, v, do, out, dq, dk, dv as (b, h, s) element strides, 24
// values. delta: an fp32 (b, h, s) scratch buffer. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the last launch.
int galvatron_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const void* out, const void* lse, const void* cos, const void* sin,
                        void* dq, void* dk, void* dv, void* delta, const long long* strides,
                        int dtype, int batch, int heads, int kv_rep, int s, int d, float lam,
                        float sm_scale, void* stream) {
  if (d % 8 != 0 || d > 256 || d <= 0 || s <= 0 || kv_rep <= 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.out = out;
  a.lse = static_cast<const float*>(lse);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = static_cast<float*>(delta);
  View* views[8] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vout, &a.vdq, &a.vdk, &a.vdv};
  for (int t = 0; t < 8; ++t) {
    views[t]->b = strides[3 * t];
    views[t]->h = strides[3 * t + 1];
    views[t]->s = strides[3 * t + 2];
  }
  a.heads = heads;
  a.kv_rep = kv_rep;
  a.s = s;
  a.d = d;
  a.lam = lam;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, batch, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
