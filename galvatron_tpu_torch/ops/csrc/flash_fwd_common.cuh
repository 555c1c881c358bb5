// The flash forward's Hopper mainloop (head_dim 64 or 128), shared by the
// blocked forward (flash_fwd.cu, replacing `_fwd_kernel_blocked`: bf16 and
// fp16) and the grid forward (flash_grid_fwd.cu, replacing `_fwd_kernel`:
// bf16). The element type E (bf16 or fp16) is a template argument: it picks
// the conversions, the tensor maps' type and the wgmma type string, and
// everything else (bytes, swizzle, descriptors, fp32 accumulation) is the
// same for both.
//
//   rope_k_kernel  k' = rope(k) through the unscaled tables, rounded to E
//                  once into a contiguous (b, kv heads, s, D) scratch: both
//                  references round k so. (Roping key tiles on the way into
//                  shared memory, each q tile that visits a key tile roped it
//                  again and re-read the fp32 tables, twice k's bytes.)
//   main_kernel    persistent, one block per SM taking (b, h, 128-query
//                  tile) items: per key tile S = q k^T and O += p v by
//                  wgmma, an fp32 online softmax.
//
// Compile-time GRID picks the rounding points. Blocked (GRID false, always
// causal, out in E): q roped through tables pre-scaled by sm_scale log2(e)
// and rounded to E, so S is base-2 already. Grid (GRID true): q roped
// through the unscaled tables and rounded with RoPE, raw q without; k' from
// the pre-pass with RoPE, raw k from its view without; S multiplied by
// sm_scale log2(e) AFTER the product; CAUSAL or not; out in bf16 or fp32
// (OutT, ring attention's per-hop outputs). In both, p is rounded to E
// before O += p v, out = O / max(l, 1e-30) and lse = m ln 2 + log(max(l,
// 1e-30)).
//
// Shape of the main kernel: 288 threads. Warp 8 is the producer: one lane
// takes items from a counter and keeps TMA loads of 128-key tiles of k and
// v in flight, in a ring of 3 stages with full / empty mbarriers that runs
// on across items (and, without RoPE, loads each item's q too). k and v are
// read straight from their strided views (or k' from the scratch) through
// rank-4 tensor maps (the stacked projection's s-stride is 3 h d elements);
// rows of a ragged last tile past s arrive as zeros and are masked. Warps
// 0-7 are two consumer warpgroups of 64 q rows each. Per item a warpgroup
// gets its q rows (TMA, or roped and rounded by its own threads) into the
// 128B-swizzled q tile, then, per key tile: S = q k^T by wgmma with both
// operands in shared memory; the online softmax on the fp32 accumulator in
// registers; p rounded to E straight into the A registers of O += p v,
// with v's tile MN-major, read transposed by its descriptor; then an arrive
// on the stage's empty barrier. The warpgroups take turns at the S product
// (pingpong), so one's softmax runs while the other's product is on the
// tensor cores. 128-key tiles keep the diagonal tile the last one for both
// warpgroups, and a non-causal walk gives both the same tiles, so the turns
// always pair up.
//
// What bounds it on this card: measured with clock64() around each phase
// (experiments/torch_fwd_variants.py, diag_clock), the walk is bound by the
// softmax's instructions and the SFU's exponentials, not by the products or
// the ring: hence the exponentials on ex2.approx, the mask tested only on
// tiles that need it, and the row max and sum as independent partials.
#pragma once

#include "flash_common.cuh"

namespace flash {
namespace fwd {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;        // (b, h, s) fp32, contiguous
  const float* cos;  // (s, d/2) fp32, unscaled; null: no RoPE (grid only)
  const float* sin;
  View vq, vk, vv, vo;
  int batch, heads, kv_rep, s, d;
  bool causal;   // grid: the mask (the blocked forward is causal)
  bool out_f32;  // grid: out in fp32 whatever the input dtype
  float lam;     // sm_scale * log2(e): blocked, in q's tables; grid, after the product
  int* work;     // the TMA route: two int32, zero between calls on a stream
};

constexpr int kRows = 128;                           // q rows a block owns
constexpr int kConsumerWarps = 8;                    // two warpgroups of 64 rows
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // and one producer warp
constexpr int kBN = 128;                             // keys of a tile
// hardware barrier ids: 1 + wg for a warpgroup's q staging, kTurn + wg for
// its turns at the S product (0 is __syncthreads)
constexpr int kTurn = 3;

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "the TMA forward takes head_dim 64 or 128");
  static constexpr int BN = kBN;
  // three stages, two tiles loading ahead of the one in use (d = 128: 32 KB
  // of q + 3 x 64 KB, 225 KB in all)
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = kRows * D * 2;
  static constexpr int TILE_BYTES = BN * D * 2;  // one k or v tile
  // + 1024 to align the tiles, + the mbarriers (full and empty a stage, q
  // full and empty a warpgroup) and the published items
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)STAGES * 2 * TILE_BYTES + 8 * (2 * STAGES + 4) + 4 * STAGES;
  static_assert(SMEM <= 232448, "above the 227 KB a block may use");
  static_assert(BN == kRows, "the diagonal tile must be the last for both warpgroups");
};

// k' = rope(k) rounded to E, contiguous (b, kv heads, s, D): one thread
// per 8 rotated pairs (x[i .. i+8), x[i + D/2 .. i + D/2 + 8)) of a row.
// GRID changes nothing in the work: it names the family a launch belongs to
// in a profile, as the main kernels' GRID does.
template <int D, bool GRID, typename E>
__global__ void __launch_bounds__(256) rope_k_kernel(const E* __restrict__ k, View vk,
                                                     int kvheads, int s,
                                                     const float* __restrict__ cos,
                                                     const float* __restrict__ sin,
                                                     E* __restrict__ out, long long units) {
  constexpr int HALF = D / 2, U = HALF / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= units) return;
  const int i0 = (int)(idx % U) * 8;
  const long long rowid = idx / U;  // (b, kv head, row), row-major
  const int row = (int)(rowid % s);
  const long long bh = rowid / s;
  const int kh = (int)(bh % kvheads), b = (int)(bh / kvheads);
  const E* src = k + b * vk.b + kh * vk.h + row * vk.s + i0;
  float x1[8], x2[8], y1[8], y2[8];
  unpack8<E>(*reinterpret_cast<const uint4*>(src), x1);
  unpack8<E>(*reinterpret_cast<const uint4*>(src + HALF), x2);
  const float4* cp = reinterpret_cast<const float4*>(cos + (size_t)row * HALF + i0);
  const float4* sp = reinterpret_cast<const float4*>(sin + (size_t)row * HALF + i0);
  const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) rope(x1[e], x2[e], c[e], sn[e], y1[e], y2[e]);
  E* dst = out + rowid * D + i0;
  *reinterpret_cast<uint4*>(dst) = pack8<E>(y1);
  *reinterpret_cast<uint4*>(dst + HALF) = pack8<E>(y2);
}

// published items a block keeps: the producer runs at most STAGES key
// tiles, so at most STAGES items, ahead of the consumers
constexpr int kSlots = 3;
static_assert(kSlots >= Cfg<64>::STAGES && kSlots >= Cfg<128>::STAGES, "too few item slots");

// the ring's stage holding key tile kt (counted across items): its k tile,
// then its v tile
template <int D>
__device__ __forceinline__ const unsigned char* stage_of(const unsigned char* ring, int kt) {
  return ring + (size_t)(kt % Cfg<D>::STAGES) * 2 * Cfg<D>::TILE_BYTES;
}

// S = q k^T of one key tile into sc (issued and committed, not waited for):
// q rows of this warpgroup and the k tile, both K-major in shared memory
template <typename E, int D, int BN>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], const unsigned char* qwg,
                                        const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns of d at a time
    const int unit = (kk % 4) * 32;  // 16 columns: 32 bytes into chunk kk / 4's rows
    const uint64_t da = wgmma_desc(qwg + (kk / 4) * kRows * 128 + unit, 16, 1024);
    const uint64_t db = wgmma_desc(ks + (kk / 4) * BN * 128 + unit, 16, 1024);
    wgmma_ss<E, BN>(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += p v of one key tile (issued and committed, not waited for): p from
// registers, v MN-major (keys are K, d is N; 64-column chunks BN * 128
// bytes apart)
template <typename E, int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {  // 16 keys at a time
    const uint64_t dv = wgmma_desc(vs + kk * 16 * 128, BN * 128, 1024);
    wgmma_rs<E, D>(o, pa[kk], dv, 1);
  }
  wgmma_commit();
}

// The online softmax of one key tile's scores in sc: with GRID the scores
// are scaled by lam first (base 2); masks a tile that crosses the diagonal
// (CAUSAL) or s; updates the rows' m and l, leaves p in sc and the factor
// the running O must take in alpha. A thread holds rows row_a and row_b,
// columns k0 + 8j + 2t (+1). The walk is bound by this function's
// instructions (two warpgroups share an SM sub-partition's issue slot), so
// the mask is tested only on a tile that needs it, and the row max and sum
// run as four independent partials a row, not one chain of 32.
template <int BN, bool GRID, bool CAUSAL>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int r_lo, int row_a,
                                               int row_b, int t, int s, float lam) {
  if (GRID) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = __fmul_rn(sc[i], lam);
  }
  if ((CAUSAL && k0 + BN - 1 > r_lo) || k0 + BN > s) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = (i & 2) ? row_b : row_a;
      if ((CAUSAL && col > row) || col >= s) sc[i] = kMasked;
    }
  }
  // element i of a thread belongs to row (i >> 1) & 1; partial (i >> 2) & 3
  float mx[2][4], rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[r][j] = -INFINITY;
      rs[r][j] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], v);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
    rs[(i >> 1) & 1][(i >> 2) & 3] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    l[r] = alpha[r] * l[r] + v;
  }
}

// Stage warpgroup wg's 64 q rows (q0 + 64 wg ..) into the swizzled q tile:
// roped through the tables times qscale and rounded to E with tables,
// copied without; rows past s are zeros.
template <typename E, int D>
__device__ __forceinline__ void stage_q(unsigned char* qs, const Args& a, int b, int h, int q0,
                                        int wg, int wtid, float qscale) {
  constexpr int HALF = D / 2, U = HALF / 8;  // 8-element units in half a row
  const E* qg = static_cast<const E*>(a.q) + b * a.vq.b + h * a.vq.h;
#pragma unroll
  for (int it = 0; it < 64 * U / 128; ++it) {
    const int e = wtid + it * 128;
    const int r = 64 * wg + e / U, i0 = (e % U) * 8, row = q0 + r;
    uint4 y1 = make_uint4(0, 0, 0, 0), y2 = y1;
    if (row < a.s) {
      const uint4 u1 = *reinterpret_cast<const uint4*>(qg + row * a.vq.s + i0);
      const uint4 u2 = *reinterpret_cast<const uint4*>(qg + row * a.vq.s + i0 + HALF);
      if (a.cos != nullptr) {
        float x1[8], x2[8], f1[8], f2[8];
        unpack8<E>(u1, x1);
        unpack8<E>(u2, x2);
        const float* cp = a.cos + (size_t)row * HALF + i0;
        const float* sp = a.sin + (size_t)row * HALF + i0;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          rope(x1[k], x2[k], __fmul_rn(cp[k], qscale), __fmul_rn(sp[k], qscale), f1[k], f2[k]);
        y1 = pack8<E>(f1);
        y2 = pack8<E>(f2);
      } else {
        y1 = u1;
        y2 = u2;
      }
    }
    *reinterpret_cast<uint4*>(qs + sw128_offset(r, i0, kRows)) = y1;
    *reinterpret_cast<uint4*>(qs + sw128_offset(r, i0 + HALF, kRows)) = y2;
  }
}

// Work item w of a call: the (b, h, 128-query tile) with a (b, h)'s tiles
// side by side, longest walk first (items in flight together share their k
// and v tiles through L2), and its key tiles: up to the diagonal (causal) or
// all of them.
template <bool CAUSAL>
struct Item {
  int b, h, kvh, q0, nkt;
  __device__ __forceinline__ Item(int w, const Args& a, int nqt) {
    const int qt = nqt - 1 - w % nqt, bh = w / nqt;
    h = bh % a.heads;
    b = bh / a.heads;
    kvh = h / a.kv_rep;
    q0 = qt * kRows;
    nkt = ((CAUSAL ? min(q0 + kRows, a.s) : a.s) + kBN - 1) / kBN;
  }
};

// Persistent: one block per SM takes items from a counter (a.work[0], the
// next item; a.work[1], the blocks done: the last block to finish zeroes
// both for the next call on the stream). The producer lane fetches an item,
// publishes it in a shared slot and loads its q (by TMA, without RoPE) and
// its k and v tiles into the ring, which runs on across items; an item
// past the last is published with a plain arrive on its ring stage, and the
// consumers stop there. So the next item's loads overlap this item's last
// tiles and epilogue, and no block pays a launch, a barrier set-up or a
// cold pipeline per item.
template <int D, bool GRID, bool CAUSAL, typename OutT, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    main_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Args a) {
  static_assert(GRID || CAUSAL, "the blocked forward is causal");
  static_assert(GRID || std::is_same<OutT, E>::value, "the blocked forward writes out in E");
  using C = Cfg<D>;
  constexpr int BN = C::BN, STAGES = C::STAGES, CH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + C::Q_BYTES;  // stage st: the k tile, then the v tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)STAGES * 2 * C::TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;  // a warpgroup's q rows landed (TMA q)
  uint64_t* qempty = qfull + 2;      // ... and were read by its last S of an item
  int* slot = reinterpret_cast<int*>(qempty + 2);  // kSlots published items

  const int s = a.s;
  const int nqt = (s + kRows - 1) / kRows;
  const int items = nqt * a.heads * a.batch;
  const bool q_by_tma = a.cos == nullptr;  // no RoPE: q goes into shared memory as it is
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    for (int wg = 0; wg < 2; ++wg) {
      mbar_init(&qfull[wg], 1);
      mbar_init(&qempty[wg], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      int g = 0;  // ring position: key tiles loaded so far, across items
      for (int n = 0;; ++n) {
        const int w = atomicAdd(&a.work[0], 1);
        const int st = g % STAGES;
        mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);  // a new ring passes at once
        slot[n % kSlots] = w;
        if (w >= items) {  // past the last item: release the consumers and stop
          mbar_arrive(&full[st]);
          break;
        }
        const Item<CAUSAL> it(w, a, nqt);
        for (int kt = 0; kt < it.nkt; ++kt, ++g) {
          const int stg = g % STAGES;
          if (kt > 0) mbar_wait(&empty[stg], ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[stg], 2 * C::TILE_BYTES);
          unsigned char* tile = ring + (size_t)stg * 2 * C::TILE_BYTES;
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            tma_load_4d(tile + c * BN * 128, &tm_k, &full[stg], 64 * c, kt * BN, it.kvh, it.b);
            tma_load_4d(tile + C::TILE_BYTES + c * BN * 128, &tm_v, &full[stg], 64 * c,
                        kt * BN, it.kvh, it.b);
          }
          // the item's q after its first key tile, once each warpgroup's last
          // S of the item before is done with the q rows
          for (int wg = 0; kt == 0 && q_by_tma && wg < 2; ++wg) {
            mbar_wait(&qempty[wg], (n & 1) ^ 1);
            mbar_expect_tx(&qfull[wg], 64 * D * 2);
#pragma unroll
            for (int c = 0; c < CH; ++c)
              tma_load_4d(qs + c * kRows * 128 + wg * 64 * 128, &tm_q, &qfull[wg], 64 * c,
                          it.q0 + 64 * wg, it.h, it.b);
          }
        }
      }
      // every block's last fetch is done when the last block gets here (the
      // fence orders this block's last fetch before its count)
      __threadfence();
      if (atomicAdd(&a.work[1], 1) == (int)gridDim.x - 1) {
        a.work[0] = 0;
        a.work[1] = 0;
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64) of
  // each item
  const int wg = warp >> 2, wtid = threadIdx.x & 127;
  const int t = lane & 3;
  const unsigned char* qwg = qs + wg * 64 * 128;  // this warpgroup's rows of chunk 0
  float o[D / 2];
  float sc[BN / 2];         // S, then p in fp32
  uint32_t pa[BN / 16][4];  // p rounded to E: the A fragments of O += p v

  // Pingpong: the warpgroups take turns at S = q k^T (barriers kTurn + wg),
  // so one's softmax runs while the other's product is on the tensor cores.
  // Warpgroup 1 gives warpgroup 0 the first turn; after the last item
  // warpgroup 0 takes the turn warpgroup 1 gave back after its last S, so
  // every barrier's arrivals match its waits.
  if (wg == 1) named_arrive(kTurn, 256);
  int g = 0;
  for (int n = 0;; ++n) {
    mbar_wait(&full[g % STAGES], (g / STAGES) & 1);  // the item's first tile (or the end)
    const int w = slot[n % kSlots];
    if (w >= items) break;
    const Item<CAUSAL> it(w, a, nqt);
    const int r_lo = it.q0 + 64 * wg;
    const int row_a = r_lo + (warp & 3) * 16 + (lane >> 2), row_b = row_a + 8;
    if (q_by_tma) {
      mbar_wait(&qfull[wg], n & 1);
    } else {
      stage_q<E, D>(qs, a, it.b, it.h, it.q0, wg, wtid, GRID ? 1.f : a.lam);
      fence_proxy_async();  // the q tile is read by wgmma (the async proxy)
      named_sync(1 + wg, 128);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    for (int kt = 0; kt < it.nkt; ++kt, ++g) {
      const unsigned char* stage = stage_of<D>(ring, g);
      if (kt > 0) mbar_wait(&full[g % STAGES], (g / STAGES) & 1);
      named_sync(kTurn + wg, 256);  // this warpgroup's turn
      wgmma_fence();
      issue_s<E, D, BN>(sc, qwg, stage);
      wgmma_wait<0>();
      wgmma_hold(sc);
      named_arrive(kTurn + 1 - wg, 256);  // the other's turn
      if (q_by_tma && kt + 1 == it.nkt && lane == 0) mbar_arrive(&qempty[wg]);  // q rows free
      online_softmax<BN, GRID, CAUSAL>(sc, m, l, alpha, kt * BN, r_lo, row_a, row_b, t, s,
                                       a.lam);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_a<E, BN>(sc, pa);
      wgmma_fence();
      issue_pv<E, D, BN>(o, pa, stage + C::TILE_BYTES);
      wgmma_wait<0>();
      wgmma_hold(o);
      if (lane == 0) mbar_arrive(&empty[g % STAGES]);  // this warp is done with the stage
    }

    OutT* og = static_cast<OutT*>(a.out) + it.b * a.vo.b + it.h * a.vo.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row_a : row_b;
      if (row >= s) continue;
      // O / max(l, 1e-30) as O times one reciprocal: within an fp32 ulp of
      // the quotient, for a division a row instead of one an element
      const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        st_pair(og + row * a.vo.s + 8 * j + 2 * t, o[4 * j + 2 * r] * inv,
                o[4 * j + 2 * r + 1] * inv);
      if (t == 0) a.lse[((size_t)it.b * a.heads + it.h) * s + row] = m[r] * kLn2 + logf(lc);
    }
  }
  if (wg == 0) named_sync(kTurn, 256);  // warpgroup 1's arrival after its last S
}

// The TMA path moves rows in 16-byte units: every base pointer 16-byte
// aligned and every (b, h, s) stride a multiple of 8 elements; with RoPE the
// k pre-pass needs its scratch.
inline bool can_tma(const Args& a, const void* kscratch) {
  const void* ptrs[] = {a.q, a.k, a.v, a.out, a.cos, a.sin, kscratch};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return (a.d == 64 || a.d == 128) && (a.cos == nullptr || kscratch != nullptr) &&
         a.work != nullptr && rows16(a.vq) && rows16(a.vk) && rows16(a.vv) && rows16(a.vo);
}

// The tensor maps, encoded before anything is launched: a map the driver
// refuses (or a driver without the entry point) sends the call to the
// CUDA-core kernel with nothing run yet, and the route says so. With RoPE k
// comes from the pre-pass scratch (contiguous) and q is staged by the
// consumers (tq is unused); without, k from its view and q by TMA in
// 64-row boxes, a warpgroup's rows. E is the operands' element type.
template <typename E, int D>
bool encode_maps(const Args& a, const void* kscratch, CUtensorMap* tq, CUtensorMap* tk,
                 CUtensorMap* tv) {
  constexpr int BN = Cfg<D>::BN;
  const int kvheads = a.heads / a.kv_rep;
  const long long kh = (long long)a.s * D;  // a scratch head
  const bool qk_ok =
      a.cos != nullptr
          ? encode_bhsd<E>(tk, kscratch, a.batch, kvheads, a.s, D, kh * kvheads, kh, D, BN)
          : encode_bhsd<E>(tk, a.k, a.batch, kvheads, a.s, D, a.vk.b, a.vk.h, a.vk.s, BN) &&
                encode_bhsd<E>(tq, a.q, a.batch, a.heads, a.s, D, a.vq.b, a.vq.h, a.vq.s, 64);
  return qk_ok && encode_bhsd<E>(tv, a.v, a.batch, kvheads, a.s, D, a.vv.b, a.vv.h, a.vv.s, BN);
}

// streaming multiprocessors of the current device: the persistent grid
inline int num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// With RoPE the k pre-pass into the scratch, then the main kernel on one
// block per SM (at most one per item); operands of the element type E.
template <int D, bool GRID, bool CAUSAL, typename OutT, typename E>
cudaError_t launch(const Args& a, void* kscratch, const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err;
  if (a.cos != nullptr) {
    const int kvheads = a.heads / a.kv_rep;
    const long long units = (long long)a.batch * kvheads * a.s * (D / 16);
    rope_k_kernel<D, GRID, E><<<(unsigned)((units + 255) / 256), 256, 0, stream>>>(
        static_cast<const E*>(a.k), a.vk, kvheads, a.s, a.cos, a.sin, static_cast<E*>(kscratch),
        units);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  auto kernel = main_kernel<D, GRID, CAUSAL, OutT, E>;
  if ((err = allow_smem(kernel, C::SMEM)) != cudaSuccess) return err;
  const long long items = (long long)((a.s + kRows - 1) / kRows) * a.heads * a.batch;
  const int sms = num_sms();
  if (sms == 0) return cudaErrorInvalidDevice;
  kernel<<<(unsigned)(items < sms ? items : sms), kThreads, C::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace flash
