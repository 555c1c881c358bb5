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
// on the bf16 path: the k pre-pass, then the main kernel), one thread block
// per (b, h, q tile), walking key tiles up to the diagonal with an fp32
// online softmax kept in registers. Only the diagonal tile (and a ragged
// last tile) is masked. Of a (b, h)'s q tiles the longest rows run first.
//
// Bound: operations. At the main shape (b=8, h=32, s=2048, d=128, bf16) the
// two products take 4 * b * h * (s^2 / 2) * d = 2.75e11 operations against
// ~0.54 GB of traffic: 0.278 ms at 989 TFLOP/s vs 0.161 ms at 3.35 TB/s.
// So the products go to the tensor cores: for bf16 at head_dim 64 and 128
// (the main path) a TMA ring feeds wgmma, warp-specialised (below). Other
// head dims, fp32 inputs and pointers or strides off 16 bytes take a
// CUDA-core kernel (fp32 from shared memory, a 4 x 4 register tile of
// scores per thread).
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long, the route taken written through an int*,
// returns cudaGetLastError() after the launches. The tensor maps are encoded
// at each call through the runtime's driver entry point (no -lcuda), before
// any launch: where the driver refuses one, the call takes the CUDA-core
// kernel and reports that route.

#include "flash_common.cuh"

namespace {

using flash::kThreads;
using flash::View;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const float* cos;
  const float* sin;
  View vq, vk, vv, vo;
  int batch, heads, kv_rep, s, d;
  float lam;  // sm_scale * log2(e)
};

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

// ---------------------------------------------------------------------------
// bf16 at head_dim 64 or 128: a TMA ring and wgmma, warp-specialised.
//
// k is roped once per call: a pre-pass (flash_fwd_rope_k_kernel) writes
// k' = rope(k), rounded to bf16 as the reference rounds it, into a
// contiguous (b, kv heads, s, d) scratch the wrapper allocates. (Roping key
// tiles on the way into shared memory, each of the s/128 q tiles that visits
// a key tile roped it again and re-read the fp32 tables, twice k's bytes.)
//
// Then one block of 288 threads per (b, h, 128-row q tile), a (b, h)'s
// tiles side by side in the grid (they share k' and v through L2), longest
// rows first. Warp 8 is the producer: one lane keeps TMA loads of 128-key
// tiles of k' and v in flight, in a ring of 3 stages with full / empty
// mbarriers. v is read straight from its strided view through a rank-4
// tensor map (the stacked projection's s-stride is 3 h d elements); rows of
// a ragged last tile past s arrive as zeros and are masked. Warps 0-7 are
// two consumer warpgroups of 64 q rows each. A warpgroup ropes its own q
// rows (tables pre-scaled by sm_scale log2 e, rounded to bf16) into the
// 128B-swizzled q tile, then, per key tile: S = q k'^T by wgmma with both
// operands in shared memory; the online softmax on the fp32 accumulator in
// registers (only a tile that crosses the diagonal or s is masked); p
// rounded to bf16 straight into the A registers of O += p v, with v's tile
// MN-major, read transposed by its descriptor; then an arrive on the
// stage's empty barrier. The warpgroups take turns at
// the S product (pingpong), so one's softmax runs while the other's product
// is on the tensor cores. 128-key tiles keep the diagonal tile the last one
// for both warpgroups.
// ---------------------------------------------------------------------------

constexpr int kTmaRows = 128;                              // q rows a block owns
constexpr int kTmaConsumerWarps = 8;                       // two warpgroups of 64 rows
constexpr int kTmaThreads = (kTmaConsumerWarps + 1) * 32;  // and one producer warp
// hardware barrier ids: 1 + wg for a warpgroup's q staging, kTurn + wg for
// its turns at the S product (0 is __syncthreads)
constexpr int kTurn = 3;

template <int D>
struct TmaCfg {
  static constexpr int BN = 128;                       // keys of a tile
  // three stages, two tiles loading ahead of the one in use (d = 128: 32 KB
  // of q + 3 x 64 KB, 225 KB in all)
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = kTmaRows * D * 2;
  static constexpr int TILE_BYTES = BN * D * 2;        // one k' or v tile
  // + 1024 to align the tiles, + the mbarriers
  static constexpr size_t SMEM = 1024 + Q_BYTES + (size_t)STAGES * 2 * TILE_BYTES + 16 * STAGES;
  static_assert(SMEM <= 232448, "above the 227 KB a block may use");
  static_assert(BN == kTmaRows, "the diagonal tile must be the last for both warpgroups");
};

// k' = rope(k) rounded to bf16, contiguous (b, kv heads, s, D): one thread
// per 8 rotated pairs (x[i .. i+8), x[i + D/2 .. i + D/2 + 8)) of a row
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_rope_k_kernel(
    const flash::bf16* __restrict__ k, View vk, int kvheads, int s,
    const float* __restrict__ cos, const float* __restrict__ sin, flash::bf16* __restrict__ out,
    long long units) {
  constexpr int HALF = D / 2, U = HALF / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= units) return;
  const int i0 = (int)(idx % U) * 8;
  const long long rowid = idx / U;  // (b, kv head, row), row-major
  const int row = (int)(rowid % s);
  const long long bh = rowid / s;
  const int kh = (int)(bh % kvheads), b = (int)(bh / kvheads);
  const flash::bf16* src = k + b * vk.b + kh * vk.h + row * vk.s + i0;
  float x1[8], x2[8], c[8], sn[8], y1[8], y2[8];
  flash::unpack8(*reinterpret_cast<const uint4*>(src), x1);
  flash::unpack8(*reinterpret_cast<const uint4*>(src + HALF), x2);
  const float4* cp = reinterpret_cast<const float4*>(cos + (size_t)row * HALF + i0);
  const float4* sp = reinterpret_cast<const float4*>(sin + (size_t)row * HALF + i0);
  const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
  c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
  c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
  sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
  sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
#pragma unroll
  for (int e = 0; e < 8; ++e) flash::rope(x1[e], x2[e], c[e], sn[e], y1[e], y2[e]);
  flash::bf16* dst = out + rowid * D + i0;
  *reinterpret_cast<uint4*>(dst) = flash::pack8(y1);
  *reinterpret_cast<uint4*>(dst + HALF) = flash::pack8(y2);
}

// the ring's stage holding key tile kt: its k' tile, then its v tile
template <int D>
__device__ __forceinline__ const unsigned char* stage_of(const unsigned char* ring, int kt) {
  return ring + (size_t)(kt % TmaCfg<D>::STAGES) * 2 * TmaCfg<D>::TILE_BYTES;
}

// S = q k'^T of one key tile into sc (issued and committed, not waited for):
// q rows of this warpgroup and the k' tile, both K-major in shared memory
template <int D, int BN>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], const unsigned char* qwg,
                                        const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns of d at a time
    const int unit = (kk % 4) * 32;  // 16 columns: 32 bytes into chunk kk / 4's rows
    const uint64_t da = flash::wgmma_desc(qwg + (kk / 4) * kTmaRows * 128 + unit, 16, 1024);
    const uint64_t db = flash::wgmma_desc(ks + (kk / 4) * BN * 128 + unit, 16, 1024);
    flash::wgmma_ss<BN>(sc, da, db, kk > 0);
  }
  flash::wgmma_commit();
}

// O += p v of one key tile (issued and committed, not waited for): p from
// registers, v MN-major (keys are K, d is N; 64-column chunks BN * 128
// bytes apart)
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {  // 16 keys at a time
    const uint64_t dv = flash::wgmma_desc(vs + kk * 16 * 128, BN * 128, 1024);
    flash::wgmma_rs<D>(o, pa[kk], dv, 1);
  }
  flash::wgmma_commit();
}

// The online softmax of one key tile's scores (base 2) in sc: masks a tile
// that crosses the diagonal or s, updates the rows' m and l, leaves p in sc
// and the factor the running O must take in alpha. A thread holds rows
// row_a and row_b, columns k0 + 8j + 2t (+1).
template <int BN>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int r_lo, int row_a,
                                               int row_b, int t, int s) {
  const bool straddles = k0 + BN - 1 > r_lo || k0 + BN > s;
  float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    const int row = (i & 2) ? row_b : row_a;
    if (straddles && (col > row || col >= s)) sc[i] = flash::kMasked;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = alpha[r] * l[r] + rs[r];
  }
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const FwdArgs a) {
  using flash::bf16;
  using C = TmaCfg<D>;
  constexpr int BN = C::BN, STAGES = C::STAGES, CH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (flash::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + C::Q_BYTES;  // stage st: the k' tile, then the v tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)STAGES * 2 * C::TILE_BYTES);
  uint64_t* empty = full + STAGES;

  // a (b, h)'s q tiles are neighbours in the grid, longest rows first: the
  // blocks in flight together share their k' and v tiles through L2
  const int s = a.s;
  const int nqt = (s + kTmaRows - 1) / kTmaRows;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);
  const int bh = (int)(blockIdx.x / nqt);
  const int h = bh % a.heads, b = bh / a.heads, kvh = h / a.kv_rep;
  const int q0 = qt * kTmaRows;
  const int nkt = (min(q0 + kTmaRows, s) + BN - 1) / BN;  // key tiles up to the diagonal
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      flash::mbar_init(&full[i], 1);
      flash::mbar_init(&empty[i], kTmaConsumerWarps);
    }
    flash::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kTmaConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int kt = 0; kt < nkt; ++kt) {
        const int st = kt % STAGES;
        flash::mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);  // a new ring passes at once
        flash::mbar_expect_tx(&full[st], 2 * C::TILE_BYTES);
        unsigned char* tile = ring + (size_t)st * 2 * C::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          flash::tma_load_4d(tile + c * BN * 128, &tm_k, &full[st], 64 * c, kt * BN, kvh, b);
          flash::tma_load_4d(tile + C::TILE_BYTES + c * BN * 128, &tm_v, &full[st], 64 * c,
                             kt * BN, kvh, b);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns q rows [r_lo, r_lo + 64)
  const int wg = warp >> 2, wtid = threadIdx.x & 127;
  const int r_lo = q0 + 64 * wg;
  {
    constexpr int HALF = D / 2, U = HALF / 8;  // 8-element units in half a row
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.vq.b + h * a.vq.h;
#pragma unroll
    for (int it = 0; it < 64 * U / 128; ++it) {
      const int e = wtid + it * 128;
      const int r = 64 * wg + e / U, i0 = (e % U) * 8, row = q0 + r;
      float y1[8], y2[8];
      if (row < s) {
        float x1[8], x2[8];
        flash::unpack8(*reinterpret_cast<const uint4*>(qg + row * a.vq.s + i0), x1);
        flash::unpack8(*reinterpret_cast<const uint4*>(qg + row * a.vq.s + i0 + HALF), x2);
        const float* cp = a.cos + (size_t)row * HALF + i0;
        const float* sp = a.sin + (size_t)row * HALF + i0;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          flash::rope(x1[k], x2[k], __fmul_rn(cp[k], a.lam), __fmul_rn(sp[k], a.lam), y1[k],
                      y2[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) y1[k] = y2[k] = 0.f;
      }
      *reinterpret_cast<uint4*>(qs + flash::sw128_offset(r, i0, kTmaRows)) = flash::pack8(y1);
      *reinterpret_cast<uint4*>(qs + flash::sw128_offset(r, i0 + HALF, kTmaRows)) =
          flash::pack8(y2);
    }
  }
  flash::fence_proxy_async();  // the q tile is read by wgmma (the async proxy)
  flash::named_sync(1 + wg, 128);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const int t = lane & 3;
  const int row_a = r_lo + (warp & 3) * 16 + (lane >> 2), row_b = row_a + 8;
  const unsigned char* qwg = qs + wg * 64 * 128;  // this warpgroup's rows of chunk 0
  float sc[BN / 2];         // S, then p in fp32
  uint32_t pa[BN / 16][4];  // p rounded to bf16: the A fragments of O += p v

  // Pingpong: the warpgroups take turns at S = q k'^T (barriers kTurn + wg),
  // so one's softmax runs while the other's product is on the tensor cores.
  // Warpgroup 1 gives warpgroup 0 the first turn and takes no last one back,
  // so every barrier's arrivals match its waits.
  if (wg == 1) flash::named_arrive(kTurn, 256);
  for (int kt = 0; kt < nkt; ++kt) {
    flash::mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
    flash::named_sync(kTurn + wg, 256);  // this warpgroup's turn
    flash::wgmma_fence();
    issue_s<D, BN>(sc, qwg, stage_of<D>(ring, kt));
    flash::wgmma_wait<0>();
    flash::wgmma_hold(sc);
    if (wg == 0 || kt + 1 < nkt) flash::named_arrive(kTurn + 1 - wg, 256);  // the other's turn
    online_softmax<BN>(sc, m, l, alpha, kt * BN, r_lo, row_a, row_b, t, s);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    flash::pack_a<BN>(sc, pa);
    flash::wgmma_fence();
    issue_pv<D, BN>(o, pa, stage_of<D>(ring, kt) + C::TILE_BYTES);
    flash::wgmma_wait<0>();
    flash::wgmma_hold(o);
    if (lane == 0) flash::mbar_arrive(&empty[kt % STAGES]);  // this warp is done with it
  }

  bf16* og = static_cast<bf16*>(a.out) + b * a.vo.b + h * a.vo.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= s) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      flash::st_pair(og + row * a.vo.s + 8 * j + 2 * t, o[4 * j + 2 * r] / lc,
                     o[4 * j + 2 * r + 1] / lc);
    if (t == 0) a.lse[((size_t)b * a.heads + h) * s + row] = m[r] * flash::kLn2 + logf(lc);
  }
}

// Both tensor maps are encoded before anything is launched: a map the driver
// refuses (or a driver without the entry point) sends the call to the
// CUDA-core kernel with nothing run yet, and the route says so.
template <int D>
bool encode_maps(const FwdArgs& a, const void* kscratch, CUtensorMap* tk, CUtensorMap* tv) {
  const int kvheads = a.heads / a.kv_rep;
  const long long kh = (long long)a.s * D;  // the scratch is contiguous (b, kv heads, s, D)
  return flash::encode_bhsd(tk, kscratch, a.batch, kvheads, a.s, D, kh * kvheads, kh, D,
                            TmaCfg<D>::BN) &&
         flash::encode_bhsd(tv, a.v, a.batch, kvheads, a.s, D, a.vv.b, a.vv.h, a.vv.s,
                            TmaCfg<D>::BN);
}

template <int D>
cudaError_t launch_tma(const FwdArgs& a, void* kscratch, const CUtensorMap& tk,
                       const CUtensorMap& tv, cudaStream_t stream) {
  using C = TmaCfg<D>;
  const int kvheads = a.heads / a.kv_rep;
  const long long units = (long long)a.batch * kvheads * a.s * (D / 16);
  flash_fwd_rope_k_kernel<D><<<(unsigned)((units + 255) / 256), 256, 0, stream>>>(
      static_cast<const flash::bf16*>(a.k), a.vk, kvheads, a.s, a.cos, a.sin,
      static_cast<flash::bf16*>(kscratch), units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_tma_kernel<D>;
  err = flash::allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.s + kTmaRows - 1) / kTmaRows) * a.heads * a.batch;
  kernel<<<(unsigned)blocks, kTmaThreads, C::SMEM, stream>>>(tk, tv, a);
  return cudaGetLastError();
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

// the TMA path moves rows in 16-byte units: every base pointer 16-byte
// aligned and every (b, h, s) stride a multiple of 8 elements
bool can_tma(const FwdArgs& a, const void* kscratch) {
  using flash::aligned16;
  using flash::rows16;
  return (a.d == 64 || a.d == 128) && kscratch != nullptr && aligned16(kscratch) &&
         aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.out) &&
         aligned16(a.cos) && aligned16(a.sin) && rows16(a.vq) && rows16(a.vk) &&
         rows16(a.vv) && rows16(a.vo);
}

template <typename T>
cudaError_t dispatch(const FwdArgs& a, void* kscratch, cudaStream_t stream, int* route) {
  *route = flash::kRouteCudaCore;
  if (sizeof(T) == 2 && can_tma(a, kscratch)) {
    CUtensorMap tk, tv;
    if (a.d == 128 ? encode_maps<128>(a, kscratch, &tk, &tv)
                   : encode_maps<64>(a, kscratch, &tk, &tv)) {
      *route = flash::kRouteTma;
      return a.d == 128 ? launch_tma<128>(a, kscratch, tk, tv, stream)
                        : launch_tma<64>(a, kscratch, tk, tv, stream);
    }
  }
  if (a.d <= 64) return launch<T, 64, 4>(a, a.batch, stream);
  if (a.d <= 128) return launch<T, 64, 8>(a, a.batch, stream);
  return launch<T, 32, 16>(a, a.batch, stream);
}

}  // namespace

extern "C" {

// strides: q, k, v, out as (b, h, s) element strides, 12 values.
// k_scratch: bf16 (batch, heads / kv_rep, s, d), contiguous, for roped k on
// the bf16 path at head_dim 64 / 128 (null elsewhere: the CUDA-core kernel).
// dtype: 0 = float32, 1 = bfloat16. route: set to the route taken
// (flash::Route: 1 the TMA + wgmma kernel with its pre-pass, 0 the
// CUDA-core kernel). Returns cudaGetLastError() after the launches.
int galvatron_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        const void* cos, const void* sin, void* k_scratch,
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
  a.lam = lam;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, nullptr, st, route);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, k_scratch, st, route);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
