// Grid flash attention backward (causal or not, RoPE optional), for Hopper
// (sm_90a): a dk/dv kernel and a dq kernel.
//
// Replaces the TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel`
// (galvatron_tpu/ops/flash_attention.py:724 and :792, launched by
// `_flash_bwd_parts` at :881 and :914). Given q, k, v, the output gradient
// do and the caller's row statistics (the natural-log lse and delta =
// sum(do * out), which ring attention passes in combined over its hops):
//
//   s     = (q_r . k_r) * sm_scale * log2(e)   (q_r, k_r roped through the
//                                               unscaled tables and rounded
//                                               with RoPE, else q and k)
//   p     = exp2(s - lse * log2(e))            (masked above the diagonal
//                                               when causal)
//   dv   += p^T . do          (p rounded to the input dtype)
//   dp    = do . v^T
//   ds    = p * (dp - delta)  (rounded to the input dtype)
//   dk   += ds^T . q_r,  dk = rope^T(dk * sm_scale)
//   dq   += ds . k_r,    dq = rope^T(dq * sm_scale)
//
// sm_scale is applied once at the end (the reference's finalize), and the
// counter-rotation uses the unscaled tables. These are the grid kernels'
// rounding points, not the blocked ones' (there q carries the scale in its
// tables and dk is scaled by ln 2).
//
// Design. As in the reference, two kernels: dk/dv with one block per
// (b, h, key tile) walking the query tiles that reach it, dq with one block
// per (b, h, query tile) walking the key tiles it reaches. On the TPU each
// carried its sum across a sequential grid axis in VMEM; here each block
// keeps its sum in registers over an in-block loop, so both are
// deterministic with no atomics. For GQA (kv_rep > 1) k/v are read at head
// h / kv_rep and dk/dv are written per query head; the caller sums them over
// the group, as `_flash_bwd_rule` does. Every operand is read and written by
// element strides, so views of a stacked projection need no copies.
//
// Bound: at the GPT-2 XL training shape (b=8, h=25, s=1024, d=64, causal,
// bf16) the five products take 10 * b * h * s(s+1)/2 * d = 6.7e10
// operations, 0.068 ms at 989 TFLOP/s, against ~0.19 GB of traffic
// (0.056 ms at 3.35 TB/s): operations. For bf16 at head_dim 64 and 128:
//   - the dk/dv kernel is the backward's shared Hopper mainloop
//     (flash_bwd_common.cuh) with the grid's rounding points: a TMA ring
//     feeding wgmma, q / k / v / do read straight from their strided views;
//     with RoPE a pre-pass first ropes q and k through the unscaled tables
//     into scratches the wrapper allocates (each row roped once per call);
//   - the dq kernel runs every product on the tensor cores with mma.sync
//     m16n8k16 (fp32 accumulation, ds rounded to bf16 straight from
//     registers into A fragments), CAUSAL and ROPE compile-time.
// The two kernels recompute the score and dp products, so they issue 7
// products, not 5. fp32, other head dims and operands a tensor map cannot
// take run CUDA-core kernels with both flags at run time; the dk/dv entry
// encodes its tensor maps before any launch and reports its route.
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long; each entry returns cudaGetLastError() after
// its launches.

#include "flash_bwd_common.cuh"

namespace {

using flash::kThreads;
using flash::View;

struct GridBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b, h, s) fp32, natural log
  const float* delta;  // (b, h, s) fp32
  const float* cos;    // null without RoPE
  const float* sin;
  void* dq;
  void* dk;
  void* dv;
  View vq, vk, vv, vdo, vdq, vdk, vdv;
  int heads, kv_rep, s, d;
  bool causal;
  float lam;  // sm_scale * log2(e), applied after the q . k product
  float sm_scale;
};

// ---------------------------------------------------------------------------
// CUDA cores (fp32, and bf16 off head_dim 64 / 128): a 16 x 16 grid of
// threads, each with a RI x CJ register tile of scores and dp, TILE-row
// tiles staged in shared memory as fp32.
// ---------------------------------------------------------------------------

template <int RI, int CJ>
__device__ __forceinline__ void scale_scores(float (&sc)[RI][CJ], float lam) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) sc[i][j] = __fmul_rn(sc[i][j], lam);
}

template <typename T, int TILE, int NJ>
__global__ void __launch_bounds__(kThreads) flash_grid_dkdv_kernel(GridBwdArgs a) {
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
  const bool roped = a.cos != nullptr;
  const size_t stats = ((size_t)b * a.heads + h) * s;
  const T* qg = static_cast<const T*>(a.q) + b * a.vq.b + h * a.vq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  const T* dg = static_cast<const T*>(a.dout) + b * a.vdo.b + h * a.vdo.h;

  flash::stage_rows<T>(ks, ld, kg, a.vk.s, k0, TILE, s, d, a.cos, a.sin, 1.f, roped);
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
  for (int qt = a.causal ? kt : 0; qt < nqt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // the previous tile's readers are done
    flash::stage_rows<T>(qs, ld, qg, a.vq.s, q0, TILE, s, d, a.cos, a.sin, 1.f, roped);
    flash::stage_rows<T>(dos, ld, dg, a.vdo.s, q0, TILE, s, d, nullptr, nullptr, 1.f, false);
    flash::stage_row_stats(a.lse, a.delta, stats, s, q0, TILE, lse2s, dels);
    __syncthreads();

    float sc[RI][CJ], dp[RI][CJ];
    flash::scores_and_dp<RI, CJ>(qs, dos, ks, vs, ld, d, ty, tx, sc, dp);
    scale_scores(sc, a.lam);
    flash::probs_and_ds<T, TILE, RI, CJ>(sc, dp, lse2s, dels, q0, k0, s, a.causal, ty, tx, ps,
                                         dss);
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
  __syncthreads();  // qs is reused for dk * sm_scale
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = k0 + r;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= d) continue;
      qs[r * ld + c] = __fmul_rn(dk[i][j], a.sm_scale);
      if (row < s) dvg[row * a.vdv.s + c] = flash::from_f32<T>(dv[i][j]);
    }
  }
  __syncthreads();
  flash::write_rows<T>(qs, ld, dkg, a.vdk.s, k0, TILE, s, d, a.cos, a.sin);
}

template <typename T, int TILE, int NJ>
__global__ void __launch_bounds__(kThreads) flash_grid_dq_kernel(GridBwdArgs a) {
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
  const bool roped = a.cos != nullptr;
  const T* qg = static_cast<const T*>(a.q) + b * a.vq.b + h * a.vq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.vk.b + kvh * a.vk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vv.b + kvh * a.vv.h;
  const T* dg = static_cast<const T*>(a.dout) + b * a.vdo.b + h * a.vdo.h;

  flash::stage_rows<T>(qs, ld, qg, a.vq.s, q0, TILE, s, d, a.cos, a.sin, 1.f, roped);
  flash::stage_rows<T>(dos, ld, dg, a.vdo.s, q0, TILE, s, d, nullptr, nullptr, 1.f, false);
  flash::stage_row_stats(a.lse, a.delta, ((size_t)b * a.heads + h) * s, s, q0, TILE, lse2s,
                         dels);

  float dq[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int nkt = a.causal ? (min(q0 + TILE, s) - 1) / TILE + 1 : (s + TILE - 1) / TILE;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    flash::stage_rows<T>(ks, ld, kg, a.vk.s, k0, TILE, s, d, a.cos, a.sin, 1.f, roped);
    flash::stage_rows<T>(vs, ld, vg, a.vv.s, k0, TILE, s, d, nullptr, nullptr, 1.f, false);
    __syncthreads();

    float sc[RI][CJ], dp[RI][CJ];
    flash::scores_and_dp<RI, CJ>(qs, dos, ks, vs, ld, d, ty, tx, sc, dp);
    scale_scores(sc, a.lam);
    flash::probs_and_ds<T, TILE, RI, CJ>(sc, dp, lse2s, dels, q0, k0, s, a.causal, ty, tx,
                                         nullptr, dss);
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
  flash::write_rows<T>(ks, ld, dqg, a.vdq.s, q0, TILE, s, d, a.cos, a.sin);
}

// ---------------------------------------------------------------------------
// The dq kernel in bf16 on the tensor cores (head_dim 64 or 128): eight warps
// per block, each owning 16 rows of the block's 128 queries, a warp no row
// of which a causal tile can reach skipping its products; every product is
// an mma.sync m16n8k16 with fp32 accumulation, ds is rounded to bf16
// straight from the score registers into A fragments. Every tile is staged
// row-major; k, read along the reduction dimension of a B fragment, is
// loaded with ldmatrix .trans.
// ---------------------------------------------------------------------------

using flash::kMmaRows;
using flash::kMmaThreads;
using flash::kMmaTile;
using flash::zero_c;

template <int D>
size_t mma_smem_bytes() {
  // two owned (kMmaRows) and two walked (kMmaTile) row-major tiles with row
  // stride D + 8, and two fp32 row statistics of up to kMmaRows rows
  return (2 * (size_t)kMmaRows + 2 * kMmaTile) * (D + 8) * sizeof(flash::bf16) +
         2 * kMmaRows * sizeof(float);
}

// p and ds of one score / dp element (key `key`, query `row` at row-stats
// index `qi`): p = exp2(s * lam - lse2), masked above the diagonal when
// CAUSAL and past the end of the sequence; ds = p (dp - delta).
template <bool CAUSAL>
__device__ __forceinline__ void grid_p_ds(float& sc, float& dp, int row, int key, int s,
                                          int qi, const float* lse2s, const float* dels,
                                          float lam) {
  float p = 0.f;
  if (row < s && key < s && (!CAUSAL || key <= row)) p = exp2f(__fmul_rn(sc, lam) - lse2s[qi]);
  sc = p;
  dp = __fmul_rn(p, __fsub_rn(dp, dels[qi]));
}

// One row (r = 0: g, r = 1: g + 8) of a warp's ND accumulator tiles,
// scaled by `scale`, counter-rotated with ROPE (columns c and c + D/2 sit in
// tiles n and n + D/16) and written as bf16 pairs.
template <int D, bool ROPE>
__device__ __forceinline__ void write_scaled_row(flash::bf16* dst, const float (&acc)[D / 8][4],
                                                 int r, int t, int row, float scale,
                                                 const float* cos, const float* sin) {
  constexpr int ND = D / 8, HALF = D / 2;
  if constexpr (ROPE) {
#pragma unroll
    for (int n = 0; n < ND / 2; ++n) {
      float x1[2], x2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * n + 2 * t + e;
        flash::rope_t(__fmul_rn(acc[n][2 * r + e], scale),
                      __fmul_rn(acc[n + ND / 2][2 * r + e], scale), cos[(size_t)row * HALF + i],
                      sin[(size_t)row * HALF + i], x1[e], x2[e]);
      }
      flash::st_pair(dst + 8 * n + 2 * t, x1[0], x1[1]);
      flash::st_pair(dst + HALF + 8 * n + 2 * t, x2[0], x2[1]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      flash::st_pair(dst + 8 * n + 2 * t, __fmul_rn(acc[n][2 * r], scale),
                     __fmul_rn(acc[n][2 * r + 1], scale));
  }
}

// dq kernel: block (b, h, 128-query tile); warp w owns queries q0 + 16 w ..
// S = q k^T and dP = do v^T (A from the q / do tiles, B from row-major k /
// v), dq += dS k (B from k by ldmatrix .trans).
template <int D, bool CAUSAL, bool ROPE>
__global__ void __launch_bounds__(kMmaThreads) flash_grid_dq_mma_kernel(GridBwdArgs a) {
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

  flash::stage_tile<D, kMmaRows>(qs, LD, qg, a.vq.s, q0, s, a.cos, a.sin, 1.f, ROPE);
  flash::stage_tile<D, kMmaRows>(dos, LD, dg, a.vdo.s, q0, s, nullptr, nullptr, 1.f, false);
  flash::stage_row_stats(a.lse, a.delta, ((size_t)b * a.heads + h) * s, s, q0, kMmaRows, lse2s,
                         dels);

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) zero_c(dq[n]);
  const int row_a = q0 + r0 + g;

  const int nkt = CAUSAL ? (min(q0 + kMmaRows, s) - 1) / kMmaTile + 1
                         : (s + kMmaTile - 1) / kMmaTile;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kMmaTile;
    __syncthreads();
    flash::stage_tile<D, kMmaTile>(ks, LD, kg, a.vk.s, k0, s, a.cos, a.sin, 1.f, ROPE);
    flash::stage_tile<D, kMmaTile>(vs, LD, vg, a.vv.s, k0, s, nullptr, nullptr, 1.f, false);
    __syncthreads();
    if (CAUSAL && q0 + r0 + 15 < k0) continue;  // every key of the tile is above this warp's rows

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
          const int lr = r0 + g + (e < 2 ? 0 : 8);  // row within the tile
          grid_p_ds<CAUSAL>(sc[j][e], dp[j][e], q0 + lr, k0 + c0 + 8 * j + 2 * t + (e & 1), s,
                            lr, lse2s, dels, a.lam);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row < s)
      write_scaled_row<D, ROPE>(dqg + row * a.vdq.s, dq, r, t, row, a.sm_scale, a.cos, a.sin);
  }
}

// which of the two kernels a C entry launches
enum class Pass { kDkDv, kDq };

template <int D, bool CAUSAL, bool ROPE>
cudaError_t launch_dq_mma(const GridBwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_grid_dq_mma_kernel<D, CAUSAL, ROPE>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kMmaRows - 1) / kMmaRows, a.heads, batch);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dq_mma(const GridBwdArgs& a, int batch, cudaStream_t stream) {
  const bool rope = a.cos != nullptr;
  if (a.causal)
    return rope ? launch_dq_mma<D, true, true>(a, batch, stream)
                : launch_dq_mma<D, true, false>(a, batch, stream);
  return rope ? launch_dq_mma<D, false, true>(a, batch, stream)
              : launch_dq_mma<D, false, false>(a, batch, stream);
}

// The dk/dv kernel's four tensor maps, encoded before any launch: k and v
// (128-row boxes, the resident tiles) and q and do (W-row boxes, walked),
// k and q from the pre-pass scratches (contiguous) with RoPE, else from
// their views.
template <int D>
bool encode_dkv_maps(const GridBwdArgs& a, int batch, const void* qs, const void* ks,
                     CUtensorMap* m) {
  using flash::encode_bhsd;
  constexpr int W = flash::bwd::Cfg<D>::W, OWN = flash::bwd::kOwn;
  const int kvh = a.heads / a.kv_rep, s = a.s;
  const long long rh = (long long)s * D;  // a scratch head
  const bool roped = a.cos != nullptr;
  const bool k_ok = roped ? encode_bhsd(&m[0], ks, batch, kvh, s, D, rh * kvh, rh, D, OWN)
                          : encode_bhsd(&m[0], a.k, batch, kvh, s, D, a.vk.b, a.vk.h, a.vk.s, OWN);
  const bool q_ok = roped
                        ? encode_bhsd(&m[2], qs, batch, a.heads, s, D, rh * a.heads, rh, D, W)
                        : encode_bhsd(&m[2], a.q, batch, a.heads, s, D, a.vq.b, a.vq.h, a.vq.s, W);
  return k_ok && q_ok &&
         encode_bhsd(&m[1], a.v, batch, kvh, s, D, a.vv.b, a.vv.h, a.vv.s, OWN) &&
         encode_bhsd(&m[3], a.dout, batch, a.heads, s, D, a.vdo.b, a.vdo.h, a.vdo.s, W);
}

template <int D, bool CAUSAL, bool ROPE>
cudaError_t launch_dkv_tma(const GridBwdArgs& a, int batch, void* qs, void* ks,
                           const CUtensorMap* m, cudaStream_t stream) {
  namespace fb = flash::bwd;
  using flash::bf16;
  cudaError_t err;
  if (ROPE) {  // q and k roped through the unscaled tables, once each
    fb::PrepassArgs p{};
    p.q = static_cast<const bf16*>(a.q);
    p.k = static_cast<const bf16*>(a.k);
    p.vq = a.vq;
    p.vk = a.vk;
    p.cos = a.cos;
    p.sin = a.sin;
    p.qscale = 1.f;
    p.q_out = static_cast<bf16*>(qs);
    p.k_out = static_cast<bf16*>(ks);
    p.heads = a.heads;
    p.kvheads = a.heads / a.kv_rep;
    p.s = a.s;
    if ((err = fb::launch_prepass<D>(p, batch, stream)) != cudaSuccess) return err;
  }
  fb::Args g{};
  g.lse = a.lse;
  g.delta = a.delta;
  g.cos = a.cos;
  g.sin = a.sin;
  g.dk = a.dk;
  g.dv = a.dv;
  g.vdk = a.vdk;
  g.vdv = a.vdv;
  g.heads = a.heads;
  g.kv_rep = a.kv_rep;
  g.s = a.s;
  g.lam = a.lam;
  g.dk_scale = a.sm_scale;
  g.dq_scale = a.sm_scale;
  const long long blocks = (long long)((a.s + fb::kOwn - 1) / fb::kOwn) * a.heads * batch;
  return fb::launch_main(fb::dkdv_kernel<D, true, CAUSAL, ROPE>, fb::Cfg<D>::SMEM, blocks, m[0],
                         m[1], m[2], m[3], g, stream);
}

template <int D>
cudaError_t dispatch_dkv_tma(const GridBwdArgs& a, int batch, void* qs, void* ks,
                             const CUtensorMap* m, cudaStream_t stream) {
  const bool rope = a.cos != nullptr;
  if (a.causal)
    return rope ? launch_dkv_tma<D, true, true>(a, batch, qs, ks, m, stream)
                : launch_dkv_tma<D, true, false>(a, batch, qs, ks, m, stream);
  return rope ? launch_dkv_tma<D, false, true>(a, batch, qs, ks, m, stream)
              : launch_dkv_tma<D, false, false>(a, batch, qs, ks, m, stream);
}

template <Pass P, typename T, int TILE, int NJ>
cudaError_t launch(const GridBwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = flash::bwd_smem_floats<TILE>(a.d) * sizeof(float);
  auto kernel = P == Pass::kDkDv ? flash_grid_dkdv_kernel<T, TILE, NJ>
                                 : flash_grid_dq_kernel<T, TILE, NJ>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + TILE - 1) / TILE, a.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool can_mma(const GridBwdArgs& a) {
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

// the dk/dv kernel's TMA route: as can_mma, with the scratches the RoPE
// pre-pass writes
bool can_tma(const GridBwdArgs& a, const void* qs, const void* ks) {
  return can_mma(a) && (a.cos == nullptr || (qs != nullptr && ks != nullptr &&
                                             flash::aligned16(qs) && flash::aligned16(ks)));
}

template <Pass P, typename T>
cudaError_t dispatch(const GridBwdArgs& a, int batch, void* qs, void* ks, cudaStream_t stream,
                     int* route) {
  if (route != nullptr) *route = flash::kRouteCudaCore;
  if (sizeof(T) == 2 && P == Pass::kDkDv && can_tma(a, qs, ks)) {
    CUtensorMap m[4];
    if (a.d == 128 ? encode_dkv_maps<128>(a, batch, qs, ks, m)
                   : encode_dkv_maps<64>(a, batch, qs, ks, m)) {
      *route = flash::kRouteTma;
      return a.d == 128 ? dispatch_dkv_tma<128>(a, batch, qs, ks, m, stream)
                        : dispatch_dkv_tma<64>(a, batch, qs, ks, m, stream);
    }
  }
  if (sizeof(T) == 2 && P == Pass::kDq && can_mma(a))
    return a.d == 128 ? dispatch_dq_mma<128>(a, batch, stream)
                      : dispatch_dq_mma<64>(a, batch, stream);
  if (a.d <= 64) return launch<P, T, 64, 4>(a, batch, stream);
  if (a.d <= 128) return launch<P, T, 64, 8>(a, batch, stream);
  return launch<P, T, 32, 16>(a, batch, stream);
}

template <Pass P>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, const void* cos, const void* sin, void* dq, void* dk, void* dv,
        void* qs, void* ks, const long long* strides, int dtype, int causal, int batch,
        int heads, int kv_rep, int s, int d, float lam, float sm_scale, void* stream,
        int* route) {
  if (d % 8 != 0 || d > 256 || d <= 0 || s <= 0 || kv_rep <= 0 ||
      (cos == nullptr) != (sin == nullptr))
    return (int)cudaErrorInvalidValue;
  GridBwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  View* views[7] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vdq, &a.vdk, &a.vdv};
  for (int t = 0; t < 7; ++t) {
    views[t]->b = strides[3 * t];
    views[t]->h = strides[3 * t + 1];
    views[t]->s = strides[3 * t + 2];
  }
  a.heads = heads;
  a.kv_rep = kv_rep;
  a.s = s;
  a.d = d;
  a.causal = causal != 0;
  a.lam = lam;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<P, float>(a, batch, qs, ks, st, route);
  if (dtype == 1) return (int)dispatch<P, __nv_bfloat16>(a, batch, qs, ks, st, route);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// strides: q, k, v, do, dq, dk, dv as (b, h, s) element strides, 21 values.
// lse, delta: contiguous fp32 (b, h, s). cos/sin: null without RoPE. dtype:
// 0 = float32, 1 = bfloat16. The dk/dv entry writes dk and dv; q_scratch /
// k_scratch are bf16 contiguous (b, h, s, d) and (b, h / kv_rep, s, d) for
// the RoPE pre-pass of its bf16 route at head_dim 64 / 128 (null elsewhere),
// and route is set to the route taken (flash::Route). The dq entry writes
// dq. Each returns cudaGetLastError() after its launches.
int galvatron_flash_grid_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* cos,
                             const void* sin, void* dq, void* dk, void* dv, void* q_scratch,
                             void* k_scratch, const long long* strides, int dtype, int causal,
                             int batch, int heads, int kv_rep, int s, int d, float lam,
                             float sm_scale, void* stream, int* route) {
  return run<Pass::kDkDv>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, q_scratch, k_scratch,
                          strides, dtype, causal, batch, heads, kv_rep, s, d, lam, sm_scale,
                          stream, route);
}

int galvatron_flash_grid_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* cos,
                            const void* sin, void* dq, void* dk, void* dv,
                            const long long* strides, int dtype, int causal, int batch,
                            int heads, int kv_rep, int s, int d, float lam, float sm_scale,
                            void* stream) {
  return run<Pass::kDq>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, nullptr, nullptr,
                        strides, dtype, causal, batch, heads, kv_rep, s, d, lam, sm_scale,
                        stream, nullptr);
}

}  // extern "C"
