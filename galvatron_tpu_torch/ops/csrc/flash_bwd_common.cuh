// The flash backward's Hopper mainloops (head_dim 64 or 128), shared by
// the blocked backward (flash_bwd.cu, replacing `_bwd_kernel_blocked`: bf16
// and fp16) and the grid dk/dv and dq kernels (flash_grid_bwd.cu, replacing
// `_bwd_dkv_kernel` and `_bwd_dq_kernel`: bf16). The element type E (bf16
// or fp16) is a template argument, as in the forward's mainloop: it picks
// the conversions, the tensor maps' type and the wgmma type string.
//
//   prepass_kernel  q' = rope(q) through tables times `qscale` (blocked) or
//                   the unscaled tables (grid) and k' = rope(k), each
//                   rounded to E once into a contiguous scratch, and
//                   (blocked) delta = sum(do * out) per row in fp32. After
//                   it no tile is roped twice; the grid's dk/dv and dq
//                   kernels both read the one pre-pass's scratches.
//   dkdv_kernel     one block per (b, h, 128-key tile): S^T = k' q'^T and
//                   dP^T = v do^T, then dv += P^T do and dk += dS^T q',
//                   over the query tiles that reach the keys.
//   dq_kernel       one block per (b, h, 128-query tile): S = q' k'^T and
//                   dP = do v^T, then dq += dS k', over the key tiles the
//                   queries reach.
//
// Compile-time GRID picks the rounding points. Blocked (GRID false): q' was
// roped through tables pre-scaled by sm_scale log2(e), so p = 2^(S -
// lse log2 e); dk is scaled by ln 2 and dq by sm_scale, both counter-rotated
// with the unscaled tables. Grid (GRID true): q', k' roped through the
// unscaled tables (or raw q, k without ROPE), p = 2^(S sm_scale log2(e) -
// lse log2 e) with the scale applied after the product; dk and dq scaled by
// sm_scale, counter-rotated only with ROPE. In both, p and ds =
// p (dp - delta) are rounded to E before their products, as the
// reference rounds them; 2^x is the SFU's ex2.approx (the full-range exp2f
// cost the dk/dv kernel about a third of its time at the main shape).
//
// Shape of both main kernels: 256 threads, two warpgroups of 64 owned rows
// each, walked tiles of W rows (64 at head_dim 128, 128 at head_dim 64:
// half the steps, each with the same products as a step at 128). Thread 0
// also issues the TMA loads:
// the block's two resident 128-row tiles, then the walked tiles into a ring
// of kStages stages with full / empty mbarriers, refilling at the top of
// each step the stage the step before released. (A producer warp of its own
// would put three warps on one of the SM's four sub-partitions and cap
// every thread at 168 registers: too few for dk and dv beside the score and
// dp tiles.) Operands come straight from strided views (the stacked
// projection's q/k/v/do) or the pre-pass scratch through rank-4 tensor
// maps; rows past s arrive as zeros and are masked. Every product is a
// wgmma with fp32 accumulation in registers: the score-like products with
// both operands K-major in shared memory, the gradient products with p / ds
// rounded to E straight into register A fragments and the walked tile
// read MN-major (transposed) by its descriptor. A walked tile wholly above
// a warpgroup's rows (causal) is skipped by that warpgroup, never computed;
// tiles above the whole block's diagonal are never loaded. The sums stay in
// registers over an in-block loop, so dq, dk and dv are deterministic.
#pragma once

#include "flash_common.cuh"

namespace flash {
namespace bwd {

constexpr int kOwn = 128;  // rows a block owns: two warpgroups of 64
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "the TMA backward takes head_dim 64 or 128");
  // rows of a walked tile: the score and dp accumulators (W / 2 registers
  // each) sit beside dk and dv (D / 2 each): 64 + 128 at head_dim 128,
  // 128 + 64 at head_dim 64
  static constexpr int W = D == 128 ? 64 : 128;
  static constexpr int RES_BYTES = kOwn * D * 2;  // one resident tile
  static constexpr int WALK_BYTES = W * D * 2;    // one walked tile
  // + 1024 to align the tiles, two resident tiles, the ring, the walked
  // rows' statistics (two buffers a warpgroup) and the mbarriers
  static constexpr size_t SMEM = 1024 + 2 * (size_t)RES_BYTES +
                                 (size_t)kStages * 2 * WALK_BYTES + 2 * 2 * 2 * W * 4 +
                                 8 * (2 * kStages + 1);
  static_assert(SMEM <= 232448, "above the 227 KB a block may use");
};

// The block's shared memory: the resident A tile then the resident B tile
// (k' and v in the dk/dv kernel, q' and do in the dq kernel), the ring
// (stage st: its walked A tile, then its walked B tile), the dk/dv kernel's
// row statistics (warpgroup wg, step parity p: W values of lse log2 e then
// W of delta at stats + (2 wg + p) 2 W) and the barriers. Tiles are
// 128B-swizzled in 64-column chunks, 1024-byte aligned.
template <int D>
struct Smem {
  unsigned char* res;
  unsigned char* ring;
  float* stats;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* resbar;
  __device__ explicit Smem(unsigned char* raw) {
    using C = Cfg<D>;
    res = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    ring = res + 2 * C::RES_BYTES;
    stats = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * C::WALK_BYTES);
    full = reinterpret_cast<uint64_t*>(stats + 2 * 2 * 2 * C::W);
    empty = full + kStages;
    resbar = empty + kStages;
  }
  __device__ const unsigned char* walk(int st) const {
    return ring + (size_t)st * 2 * Cfg<D>::WALK_BYTES;
  }
};

// The four tensor maps of a main kernel: the resident tiles' (128-row
// boxes) and the walked tiles' (W-row boxes), each an A and a B operand.
struct Maps {
  const CUtensorMap* res_a;
  const CUtensorMap* res_b;
  const CUtensorMap* walk_a;
  const CUtensorMap* walk_b;
};

struct Args {
  const float* lse;    // (b, h, s) fp32, natural log
  const float* delta;  // (b, h, s) fp32
  const float* cos;    // (s, d/2) unscaled tables for the counter-rotation
  const float* sin;
  void* dq;
  void* dk;
  void* dv;
  View vdq, vdk, vdv;
  int heads, kv_rep, s;
  float lam;       // GRID: sm_scale * log2(e), applied to the scores
  float dk_scale;  // blocked: ln 2; grid: sm_scale
  float dq_scale;  // sm_scale
};

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* resbar) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    mbar_init(resbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// Thread 0's loads. `load_resident`: the two resident tiles (rows row0 ..
// row0 + 127 of head res_head) onto resbar. `fill`: walked tile `it` of the
// walk (W rows from (t0 + it) W, head walk_head) into its stage, once every
// warp has released the stage's previous tile (a first round passes at
// once).
template <int D>
__device__ __forceinline__ void load_resident(const Smem<D>& sm, const Maps& m, int row0,
                                              int res_head, int b) {
  using C = Cfg<D>;
  mbar_expect_tx(sm.resbar, 2 * C::RES_BYTES);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load_4d(sm.res + c * kOwn * 128, m.res_a, sm.resbar, 64 * c, row0, res_head, b);
    tma_load_4d(sm.res + C::RES_BYTES + c * kOwn * 128, m.res_b, sm.resbar, 64 * c, row0,
                res_head, b);
  }
}

template <int D>
__device__ __forceinline__ void fill(const Smem<D>& sm, const Maps& m, int it, int t0,
                                     int walk_head, int b) {
  using C = Cfg<D>;
  constexpr int W = C::W;
  const int st = it % kStages, r0 = (t0 + it) * W;
  mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
  mbar_expect_tx(&sm.full[st], 2 * C::WALK_BYTES);
  unsigned char* tile = sm.ring + (size_t)st * 2 * C::WALK_BYTES;
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load_4d(tile + c * W * 128, m.walk_a, &sm.full[st], 64 * c, r0, walk_head, b);
    tma_load_4d(tile + C::WALK_BYTES + c * W * 128, m.walk_b, &sm.full[st], 64 * c, r0,
                walk_head, b);
  }
}

// Thread 0 at the top of step `it`: the step before released its stage;
// refill it with the tile kStages - 1 ahead. (The wait keeps warpgroup 0
// within a step of warpgroup 1.)
template <int D>
__device__ __forceinline__ void refill(const Smem<D>& sm, const Maps& m, int it, int t0, int nt,
                                       int walk_head, int b) {
  if (threadIdx.x == 0 && it > 0 && it - 1 + kStages < nt)
    fill<D>(sm, m, it - 1 + kStages, t0, walk_head, b);
}

// Thread 0 before the first step: the resident tiles and a full ring.
template <int D>
__device__ __forceinline__ void prologue(const Smem<D>& sm, const Maps& m, int row0,
                                         int res_head, int t0, int nt, int walk_head, int b) {
  if (threadIdx.x != 0) return;
  load_resident<D>(sm, m, row0, res_head, b);
  for (int it = 0; it < kStages && it < nt; ++it) fill<D>(sm, m, it, t0, walk_head, b);
}

// acc (64 x N) = A . B^T over the D columns of the head dim (issued, not
// committed): A is this warpgroup's 64 rows of a resident tile (kOwn rows,
// K-major), B a walked tile of N rows (K-major).
template <typename E, int D, int N>
__device__ __forceinline__ void issue_nt(float (&acc)[N / 2], const unsigned char* a_rows,
                                         const unsigned char* b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int unit = (kk % 4) * 32;  // 16 columns: 32 bytes into chunk kk / 4's rows
    const uint64_t da = wgmma_desc(a_rows + (kk / 4) * kOwn * 128 + unit, 16, 1024);
    const uint64_t db = wgmma_desc(b_tile + (kk / 4) * N * 128 + unit, 16, 1024);
    wgmma_ss<E, N>(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += A . B (issued, not committed): A in registers over K
// walked rows (p or ds rounded to E), B the walked tile of those K rows
// read MN-major (64-column chunks K * 128 bytes apart).
template <typename E, int D, int K>
__device__ __forceinline__ void issue_tn(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                         const unsigned char* b_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<E, D>(acc, a[kk], wgmma_desc(b_tile + kk * 16 * 128, K * 128, 1024), 1);
}

// One row (r = 0: the thread's first row, r = 1: eight below) of a 64 x D
// accumulator scaled by `scale`, counter-rotated with ROPE (columns c and
// c + D/2 sit in registers 4n + 2r + e and 4(n + D/16) + 2r + e) through the
// unscaled tables at `row`, written as E pairs.
template <int D, bool ROPE, typename E>
__device__ __forceinline__ void write_row(E* dst, const float (&acc)[D / 2], int r, int t,
                                          int row, float scale, const float* cos,
                                          const float* sin) {
  constexpr int HALF = D / 2;
  if constexpr (ROPE) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float x1[2], x2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * n + 2 * t + e;
        rope_t(__fmul_rn(acc[4 * n + 2 * r + e], scale),
               __fmul_rn(acc[4 * (n + D / 16) + 2 * r + e], scale), cos[(size_t)row * HALF + i],
               sin[(size_t)row * HALF + i], x1[e], x2[e]);
      }
      st_pair(dst + 8 * n + 2 * t, x1[0], x1[1]);
      st_pair(dst + HALF + 8 * n + 2 * t, x2[0], x2[1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      st_pair(dst + 8 * j + 2 * t, __fmul_rn(acc[4 * j + 2 * r], scale),
              __fmul_rn(acc[4 * j + 2 * r + 1], scale));
  }
}

// p of one score element: 2^(s' - lse2) with s' = s lam (GRID) or s, zero
// where `keep` is false (then ds = p (dp - delta) is zero too)
template <bool GRID>
__device__ __forceinline__ float probability(float sc, bool keep, float lse2, float lam) {
  return keep ? ex2((GRID ? __fmul_rn(sc, lam) : sc) - lse2) : 0.f;
}

// do_i . v_i summed as prepass_kernel sums delta_i = do_i . out_i: per
// 8-column unit u of each half row an fmaf chain, then the partials in its
// shuffle tree's order; rows ra / rb of 128B-swizzled tiles a (rows_a rows)
// and b (rows_b rows). Where out_i is v_i itself (query 0, whose one key is
// itself, and any row whose p rounds to one-hot), the blocked dq kernel's
// dp_ii from here equals delta_i bit for bit, so ds_ii = p (dp_ii - delta_i)
// is 0, as it is in exact arithmetic; from the tensor cores, dp_ii is
// another fp32 sum and ds_ii keeps the difference of two summation orders,
// which is the whole of such a row's dq.
template <typename E, int D>
__device__ __forceinline__ float prepass_dot(const unsigned char* a, int ra, int rows_a,
                                             const unsigned char* b, int rb, int rows_b) {
  constexpr int HALF = D / 2, U = HALF / 8;
  float part[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    part[u] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x[8], y[8];
      const int c = half * HALF + 8 * u;
      unpack8<E>(*reinterpret_cast<const uint4*>(a + sw128_offset(ra, c, rows_a)), x);
      unpack8<E>(*reinterpret_cast<const uint4*>(b + sw128_offset(rb, c, rows_b)), y);
#pragma unroll
      for (int e = 0; e < 8; ++e) part[u] = fmaf(x[e], y[e], part[u]);
    }
  }
#pragma unroll
  for (int o = U / 2; o > 0; o >>= 1) {  // lane u adds lane u ^ o's partial
    float next[U];
#pragma unroll
    for (int u = 0; u < U; ++u) next[u] = part[u] + part[u ^ o];
#pragma unroll
    for (int u = 0; u < U; ++u) part[u] = next[u];
  }
  return part[0];
}

// A walked query tile's row statistics (rows q0 .. q0 + W - 1 of the
// (b, h) slice) as 2 W values, lse log2 e of each row then delta; value j
// of a warpgroup's thread wtid is entry wtid + 128 j; 0 past s.
template <int W>
__device__ __forceinline__ void row_stats(float (&v)[2 * W / 128], const float* lse,
                                          const float* delta, int q0, int wtid, int s) {
#pragma unroll
  for (int j = 0; j < 2 * W / 128; ++j) {
    const int e = wtid + 128 * j, row = q0 + e % W;
    v[j] = row >= s ? 0.f : e < W ? lse[row] * kLog2e : delta[row];
  }
}

// dk/dv: block (b, h, 128-key tile), a (b, h)'s key tiles side by side in
// the grid with the longest walk first. tm_k / tm_v: roped k and v, boxes
// of 128 rows (the resident tiles, kv head h / kv_rep); tm_q / tm_do: roped
// q (or q) and do, boxes of W rows (the walked query tiles, head h).
// Warpgroup wg owns keys k0 + 64 wg ..; a thread's accumulator rows are
// key_a and key_a + 8, its score columns the queries q0 + 8j + 2t (+1).
// Within a step, p is computed while dP^T is on the tensor cores; the
// step's lse and delta are staged in shared memory by the warpgroup.
template <int D, bool GRID, bool CAUSAL, bool ROPE, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do, const Args a) {
  using C = Cfg<D>;
  constexpr int W = C::W;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const Maps maps{&tm_k, &tm_v, &tm_q, &tm_do};
  const int s = a.s;
  const int nkt = (s + kOwn - 1) / kOwn;
  const int kt = (int)(blockIdx.x % nkt);
  const int bh = (int)(blockIdx.x / nkt);
  const int h = bh % a.heads, b = bh / a.heads;
  const int k0 = kt * kOwn;
  const int t0 = CAUSAL ? k0 / W : 0;  // query tiles wholly above the keys are never loaded
  const int nt = (s + W - 1) / W - t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stats = ((size_t)b * a.heads + h) * s;
  const float* lse = a.lse + stats;
  const float* delta = a.delta + stats;
  init_barriers(sm.full, sm.empty, sm.resbar);
  prologue<D>(sm, maps, k0, h / a.kv_rep, t0, nt, h, b);

  const int wg = warp >> 2, t = lane & 3;
  const int kw = k0 + 64 * wg;  // this warpgroup's first key
  const int key_a = kw + 16 * (warp & 3) + (lane >> 2), key_b = key_a + 8;
  const unsigned char* k_rows = sm.res + wg * 64 * 128;
  const unsigned char* v_rows = sm.res + C::RES_BYTES + wg * 64 * 128;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(sm.resbar, 0);

  const int wtid = threadIdx.x & 127;
  // the row statistics, loaded a step ahead so that their latency hides
  // behind a step's products
  constexpr int NS = 2 * W / 128;
  float stat_next[NS];
  row_stats<W>(stat_next, lse, delta, t0 * W, wtid, s);
  for (int it = 0; it < nt; ++it) {
    refill<D>(sm, maps, it, t0, nt, h, b);
    const int st = it % kStages, q0 = (t0 + it) * W;
    float stat[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) stat[j] = stat_next[j];
    if (it + 1 < nt) row_stats<W>(stat_next, lse, delta, q0 + W, wtid, s);
    // warpgroup-uniform: a query tile wholly above this warpgroup's keys
    // (causal) or keys all past s give p = 0
    const bool active = kw < s && (!CAUSAL || q0 + W - 1 >= kw);
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    if (active) {
      const unsigned char* q_tile = sm.walk(st);
      const unsigned char* do_tile = q_tile + C::WALK_BYTES;
      float* stats = sm.stats + (2 * wg + (it & 1)) * 2 * W;
      float sc[W / 2], dp[W / 2];
      wgmma_fence();
      issue_nt<E, D, W>(sc, k_rows, q_tile);  // S^T = k' q'^T
      wgmma_commit();
      issue_nt<E, D, W>(dp, v_rows, do_tile);  // dP^T = v do^T
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j) stats[wtid + 128 * j] = stat[j];
      named_sync(1 + wg, 128);  // the warpgroup's statistics are in
      wgmma_wait<1>();  // S^T; dP^T runs on while p is computed
      wgmma_hold(sc);
      const bool edge = (CAUSAL && q0 < kw + 64) || q0 + W > s || kw + 64 > s;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const int c = 8 * (i >> 2) + 2 * t + (i & 1), q = q0 + c;
        const int key = (i & 2) ? key_b : key_a;
        const bool keep = !edge || (q < s && key < s && (!CAUSAL || key <= q));
        sc[i] = probability<GRID>(sc[i], keep, stats[c], a.lam);
      }
      wgmma_wait<0>();  // dP^T
      wgmma_hold(dp);
      // ds = p (dp - delta), and both rounded into A fragments 16 queries at
      // a time, so the fp32 tiles free as the fragments fill
      uint32_t pa[W / 16][4], da[W / 16][4];
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kk + e;
          dp[i] = __fmul_rn(sc[i], __fsub_rn(dp[i], stats[W + 8 * (i >> 2) + 2 * t + (i & 1)]));
        }
        pack_a_block<E>(sc, pa[kk], kk);
        pack_a_block<E>(dp, da[kk], kk);
      }
      wgmma_fence();
      issue_tn<E, D, W>(dv, pa, do_tile);  // dv += P^T do
      issue_tn<E, D, W>(dk, da, q_tile);   // dk += dS^T q'
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dv);
      wgmma_hold(dk);
      wgmma_hold_a(pa);
      wgmma_hold_a(da);
    }
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with the stage
  }

  E* dvg = static_cast<E*>(a.dv) + b * a.vdv.b + h * a.vdv.h;
  E* dkg = static_cast<E*>(a.dk) + b * a.vdk.b + h * a.vdk.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key_a : key_b;
    if (key >= s) continue;
    write_row<D, false>(dvg + key * a.vdv.s, dv, r, t, key, 1.f, nullptr, nullptr);
    write_row<D, ROPE>(dkg + key * a.vdk.s, dk, r, t, key, a.dk_scale, a.cos, a.sin);
  }
}

// dq: block (b, h, 128-query tile), a (b, h)'s query tiles side by side in
// the grid with the longest walk first. tm_q / tm_do: roped q and do, boxes
// of 128 rows (the resident tiles, head h); tm_k / tm_v: roped k and v,
// boxes of W rows (the walked key tiles, kv head h / kv_rep). Warpgroup wg
// owns queries q0 + 64 wg ..; a thread's rows are row_a and row_a + 8, its
// score columns the keys k0 + 8j + 2t (+1); p is computed while dP is on
// the tensor cores. Both families take it: the blocked backward (GRID
// false) and the grid dq entry (GRID true, causal or not, q' and k' from
// the dk/dv call's pre-pass with RoPE, raw q and k without).
template <int D, bool GRID, bool CAUSAL, bool ROPE, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using C = Cfg<D>;
  constexpr int W = C::W;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const Maps maps{&tm_q, &tm_do, &tm_k, &tm_v};
  const int s = a.s;
  const int nqt = (s + kOwn - 1) / kOwn;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);
  const int bh = (int)(blockIdx.x / nqt);
  const int h = bh % a.heads, b = bh / a.heads;
  const int q0 = qt * kOwn;
  // key tiles up to the diagonal (causal) or all of them
  const int nt = ((CAUSAL ? min(q0 + kOwn, s) : s) + W - 1) / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_barriers(sm.full, sm.empty, sm.resbar);
  prologue<D>(sm, maps, q0, h, 0, nt, h / a.kv_rep, b);

  const int wg = warp >> 2, t = lane & 3;
  const int r_lo = q0 + 64 * wg;  // this warpgroup's first query
  const int row_a = r_lo + 16 * (warp & 3) + (lane >> 2), row_b = row_a + 8;
  const size_t stats = ((size_t)b * a.heads + h) * s;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    lse2[r] = row < s ? a.lse[stats + row] * kLog2e : 0.f;
    del[r] = row < s ? a.delta[stats + row] : 0.f;
  }
  const unsigned char* q_rows = sm.res + wg * 64 * 128;
  const unsigned char* do_rows = sm.res + C::RES_BYTES + wg * 64 * 128;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(sm.resbar, 0);

  for (int it = 0; it < nt; ++it) {
    refill<D>(sm, maps, it, 0, nt, h / a.kv_rep, b);
    const int st = it % kStages, k0 = it * W;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    // warpgroup-uniform: a key tile wholly above this warpgroup's queries
    // (causal) or queries all past s
    if (r_lo < s && (!CAUSAL || k0 <= r_lo + 63)) {
      const unsigned char* k_tile = sm.walk(st);
      const unsigned char* v_tile = k_tile + C::WALK_BYTES;
      float sc[W / 2], dp[W / 2];
      wgmma_fence();
      issue_nt<E, D, W>(sc, q_rows, k_tile);  // S = q' k'^T
      wgmma_commit();
      issue_nt<E, D, W>(dp, do_rows, v_tile);  // dP = do v^T
      wgmma_commit();
      wgmma_wait<1>();  // S; dP may still run while p is computed
      wgmma_hold(sc);
      const bool edge = (CAUSAL && k0 + W - 1 > r_lo) || k0 + W > s || r_lo + 64 > s;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1), r = (i >> 1) & 1;
        const int row = r ? row_b : row_a;
        const bool keep = !edge || (row < s && key < s && (!CAUSAL || key <= row));
        sc[i] = probability<GRID>(sc[i], keep, lse2[r], a.lam);
      }
      wgmma_wait<0>();  // dP
      wgmma_hold(dp);
      if constexpr (!GRID) {
        // the blocked backward's delta is the pre-pass's: on a tile that holds
        // this warpgroup's diagonal, dp_ii is summed as delta_i is
        // (prepass_dot), by the one lane of each row's quad that holds it; the
        // dk/dv kernel keeps the product's dp_ii (flash_bwd_tiles_plain does both)
        if (k0 + W > r_lo) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? row_b : row_a, off = row - k0;
            if (row >= s || off < 0 || off >= W || ((off & 7) >> 1) != t) continue;
            const float d = prepass_dot<E, D>(sm.res + C::RES_BYTES, row - q0, kOwn, v_tile,
                                              off, W);
#pragma unroll
            for (int i = 0; i < W / 2; ++i)
              if (((i >> 1) & 1) == r && 8 * (i >> 2) + (i & 1) == (off & ~6)) dp[i] = d;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < W / 2; ++i)
        dp[i] = __fmul_rn(sc[i], __fsub_rn(dp[i], del[(i >> 1) & 1]));
      uint32_t da[W / 16][4];
      pack_a<E, W>(dp, da);
      wgmma_fence();
      issue_tn<E, D, W>(dq, da, k_tile);  // dq += dS k'
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dq);
      wgmma_hold_a(da);
    }
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }

  E* dqg = static_cast<E*>(a.dq) + b * a.vdq.b + h * a.vdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row < s) write_row<D, ROPE>(dqg + row * a.vdq.s, dq, r, t, row, a.dq_scale, a.cos, a.sin);
  }
}

// ---------------------------------------------------------------------------
// The pre-pass: one thread per 8 rotated pairs (x[i .. i+8), x[i + D/2 ..
// i + D/2 + 8)) of a q row (units 0 .. q_units - 1), then of a k row.
// Blocked (GRID false): q's tables are scaled by qscale, and a q thread also
// sums do * out over its 16 columns; the D/16 threads of a row are
// neighbouring lanes, and a shuffle tree gives the row's delta. Grid: the
// unscaled tables for both, no delta (the caller gives it).
// ---------------------------------------------------------------------------

template <typename E>
struct PrepassArgs {
  const E* q;
  const E* k;
  const E* dout;  // blocked: do and out for delta
  const E* out;
  View vq, vk, vdo, vout;
  const float* cos;  // (s, D/2) unscaled
  const float* sin;
  float qscale;  // blocked: the q tables' factor, sm_scale log2(e)
  E* q_out;      // contiguous (b, h, s, D)
  E* k_out;      // contiguous (b, kv heads, s, D)
  float* delta;  // blocked: (b, h, s)
  int heads, kvheads, s;
  long long q_units, units;
};

template <int D, bool GRID, typename E>
__global__ void __launch_bounds__(256) prepass_kernel(const PrepassArgs<E> p) {
  constexpr int HALF = D / 2, U = HALF / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool is_q = idx < p.q_units;
  const long long u = is_q ? idx : idx - p.q_units;
  const long long rowid = u / U;  // (b, head, row), row-major
  float part = 0.f;
  if (idx < p.units) {
    const int i0 = (int)(u % U) * 8;
    const int row = (int)(rowid % p.s);
    const long long bh = rowid / p.s;
    const int nh = is_q ? p.heads : p.kvheads;
    const int hh = (int)(bh % nh), b = (int)(bh / nh);
    const View vx = is_q ? p.vq : p.vk;
    const E* src = (is_q ? p.q : p.k) + b * vx.b + hh * vx.h + row * vx.s + i0;
    const float scale = is_q && !GRID ? p.qscale : 1.f;
    float x1[8], x2[8], y1[8], y2[8];
    unpack8<E>(*reinterpret_cast<const uint4*>(src), x1);
    unpack8<E>(*reinterpret_cast<const uint4*>(src + HALF), x2);
    const float* cp = p.cos + (size_t)row * HALF + i0;
    const float* sp = p.sin + (size_t)row * HALF + i0;
    const float4 c0 = reinterpret_cast<const float4*>(cp)[0], c1 = reinterpret_cast<const float4*>(cp)[1];
    const float4 s0 = reinterpret_cast<const float4*>(sp)[0], s1 = reinterpret_cast<const float4*>(sp)[1];
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      rope(x1[e], x2[e], __fmul_rn(c[e], scale), __fmul_rn(sn[e], scale), y1[e], y2[e]);
    E* dst = (is_q ? p.q_out : p.k_out) + rowid * D + i0;
    *reinterpret_cast<uint4*>(dst) = pack8<E>(y1);
    *reinterpret_cast<uint4*>(dst + HALF) = pack8<E>(y2);
    if (!GRID && is_q) {
      const E* dg = p.dout + b * p.vdo.b + hh * p.vdo.h + row * p.vdo.s + i0;
      const E* og = p.out + b * p.vout.b + hh * p.vout.h + row * p.vout.s + i0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float dv[8], ov[8];
        unpack8<E>(*reinterpret_cast<const uint4*>(dg + half * HALF), dv);
        unpack8<E>(*reinterpret_cast<const uint4*>(og + half * HALF), ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(dv[e], ov[e], part);
      }
    }
  }
  if (!GRID) {  // every lane takes part in the shuffles
#pragma unroll
    for (int o = U / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (is_q && idx % U == 0) p.delta[rowid] = part;
  }
}

// Launch the pre-pass over every q and k row.
template <int D, bool GRID, typename E>
cudaError_t launch_prepass(PrepassArgs<E> p, int batch, cudaStream_t stream) {
  p.q_units = (long long)batch * p.heads * p.s * (D / 16);
  p.units = p.q_units + (long long)batch * p.kvheads * p.s * (D / 16);
  prepass_kernel<D, GRID, E><<<(unsigned)((p.units + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// Launch one of the main kernels on `blocks` blocks (128 owned rows of a
// (b, h) each) with its four tensor maps.
template <typename Kernel>
cudaError_t launch_main(Kernel kernel, size_t smem, long long blocks, const CUtensorMap& m0,
                        const CUtensorMap& m1, const CUtensorMap& m2, const CUtensorMap& m3,
                        const Args& a, cudaStream_t stream) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(m0, m1, m2, m3, a);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace flash
