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
// be shared across k tiles without atomics. The backward takes the split
// with a second pass, chosen over fp32 atomics (run-to-run different sums)
// and over an ordered cross-block accumulation (a block spinning on blocks
// that may not be resident): dq, dk and dv are deterministic, bitwise the
// same from call to call; the price is recomputing the two score products
// in the dq pass (7 products per tile pair instead of 5).
//
// bf16 and fp16 at head_dim 64 and 128 (the main paths), three launches per
// call, all on Hopper's TMA + wgmma (flash_bwd_common.cuh, instantiated for
// each element type: .bf16 or .f16 operands, fp32 accumulation):
//   1. the pre-pass: q' = rope(q, tables x sm_scale log2 e) and
//      k' = rope(k), rounded to the input dtype once into contiguous
//      scratches the wrapper allocates, and delta per row into an fp32
//      (b, h, s) buffer;
//   2. dk/dv: one block per (b, h, 128-key tile), dk/dv accumulated in
//      registers over the query tiles at or below the diagonal, then dk
//      scaled by ln 2 and counter-rotated;
//   3. dq: one block per (b, h, 128-query tile), dq accumulated over the
//      key tiles up to the diagonal, then scaled by sm_scale and
//      counter-rotated.
// fp32, other head dims, and operands a tensor map cannot take (pointers or
// strides off 16 bytes, a driver that refuses the map) take CUDA-core
// kernels of the same three passes: delta, dk/dv and dq over 64-row tiles
// staged as fp32. The tensor maps are encoded before anything is launched,
// and the C entry reports which route ran.
//
// q/k/v/do/out are read and dq/dk/dv written by element strides, so the
// stacked (b, 3, h, s, d) residual and gradient need no copies. For GQA
// (kv_rep > 1) k/v are read at head h / kv_rep and dk/dv are written per
// query head; the caller sums them over the group, as `_flash_bwd_rule` does.
//
// Bound: operations. At the main shape (b=8, h=32, s=2048, d=128, bf16) the
// five products of the backward take 10 * b * h * (s^2 / 2) * d = 6.87e11
// operations, 0.695 ms at 989 TFLOP/s, against ~0.8 GB of traffic
// (0.24 ms at 3.35 TB/s); the seven this design issues, 0.97 ms.
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long, the route written through an int*, returns
// cudaGetLastError() after the last launch (or the first error).

#include "flash_bwd_common.cuh"

namespace {

using flash::allow_smem;
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
    flash::stage_row_stats(a.lse, a.delta, ((size_t)b * a.heads + h) * s, s, q0, TILE, lse2s,
                           dels);
    __syncthreads();

    float sc[RI][CJ], dp[RI][CJ];
    flash::scores_and_dp<RI, CJ>(qs, dos, ks, vs, ld, d, ty, tx, sc, dp);
    flash::probs_and_ds<T, TILE, RI, CJ>(sc, dp, lse2s, dels, q0, k0, s, true, ty, tx, ps,
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
  flash::write_rows<T>(qs, ld, dkg, a.vdk.s, k0, TILE, s, d, a.cos, a.sin);
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
  flash::stage_row_stats(a.lse, a.delta, ((size_t)b * a.heads + h) * s, s, q0, TILE, lse2s,
                         dels);

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
    flash::scores_and_dp<RI, CJ>(qs, dos, ks, vs, ld, d, ty, tx, sc, dp);
    flash::probs_and_ds<T, TILE, RI, CJ>(sc, dp, lse2s, dels, q0, k0, s, true, ty, tx,
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

template <typename T, int TILE, int NJ>
cudaError_t launch(const BwdArgs& a, int batch, cudaStream_t stream) {
  const dim3 rows_grid((a.s + kThreads / 32 - 1) / (kThreads / 32), a.heads, batch);
  flash_delta_kernel<T><<<rows_grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = flash::bwd_smem_floats<TILE>(a.d) * sizeof(float);
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

// The TMA route's eight tensor maps over rows of E, encoded before any
// launch: k', v (128-row boxes) and q', do (W-row boxes) for the dk/dv
// kernel, then q', do (128) and k', v (W) for the dq kernel. The scratches
// are contiguous (b, h | kv heads, s, D).
template <typename E, int D>
bool encode_maps(const BwdArgs& a, int batch, const void* qs, const void* ks, CUtensorMap* m) {
  using flash::encode_bhsd;
  constexpr int W = flash::bwd::Cfg<D>::W, OWN = flash::bwd::kOwn;
  const int kvh = a.heads / a.kv_rep, s = a.s;
  const long long rh = (long long)s * D;  // a scratch head
  bool ok = true;
  for (int pass = 0; pass < 2; ++pass) {  // 0: dk/dv (k, v resident), 1: dq (q, do resident)
    const int kv_rows = pass == 0 ? OWN : W, q_rows = pass == 0 ? W : OWN;
    CUtensorMap* mk = m + (pass == 0 ? 0 : 6);
    CUtensorMap* mq = m + (pass == 0 ? 2 : 4);
    ok = ok && encode_bhsd<E>(mk, ks, batch, kvh, s, D, rh * kvh, rh, D, kv_rows) &&
         encode_bhsd<E>(mk + 1, a.v, batch, kvh, s, D, a.vv.b, a.vv.h, a.vv.s, kv_rows) &&
         encode_bhsd<E>(mq, qs, batch, a.heads, s, D, rh * a.heads, rh, D, q_rows) &&
         encode_bhsd<E>(mq + 1, a.dout, batch, a.heads, s, D, a.vdo.b, a.vdo.h, a.vdo.s, q_rows);
  }
  return ok;
}

// The three launches of the TMA route, operands of the element type E.
template <typename E, int D>
cudaError_t launch_tma(const BwdArgs& a, int batch, void* qs, void* ks, const CUtensorMap* m,
                       cudaStream_t stream) {
  namespace fb = flash::bwd;
  fb::PrepassArgs<E> p{};
  p.q = static_cast<const E*>(a.q);
  p.k = static_cast<const E*>(a.k);
  p.dout = static_cast<const E*>(a.dout);
  p.out = static_cast<const E*>(a.out);
  p.vq = a.vq;
  p.vk = a.vk;
  p.vdo = a.vdo;
  p.vout = a.vout;
  p.cos = a.cos;
  p.sin = a.sin;
  p.qscale = a.lam;
  p.q_out = static_cast<E*>(qs);
  p.k_out = static_cast<E*>(ks);
  p.delta = a.delta;
  p.heads = a.heads;
  p.kvheads = a.heads / a.kv_rep;
  p.s = a.s;
  cudaError_t err = fb::launch_prepass<D, false>(p, batch, stream);
  if (err != cudaSuccess) return err;

  fb::Args g{};
  g.lse = a.lse;
  g.delta = a.delta;
  g.cos = a.cos;
  g.sin = a.sin;
  g.dq = a.dq;
  g.dk = a.dk;
  g.dv = a.dv;
  g.vdq = a.vdq;
  g.vdk = a.vdk;
  g.vdv = a.vdv;
  g.heads = a.heads;
  g.kv_rep = a.kv_rep;
  g.s = a.s;
  g.lam = a.lam;
  g.dk_scale = flash::kLn2;
  g.dq_scale = a.sm_scale;
  const long long blocks = (long long)((a.s + fb::kOwn - 1) / fb::kOwn) * a.heads * batch;
  constexpr size_t smem = fb::Cfg<D>::SMEM;
  err = fb::launch_main(fb::dkdv_kernel<D, false, true, true, E>, smem, blocks, m[0], m[1],
                        m[2], m[3], g, stream);
  if (err != cudaSuccess) return err;
  return fb::launch_main(fb::dq_kernel<D, false, true, true, E>, smem, blocks, m[4], m[5], m[6],
                         m[7], g, stream);
}

// the TMA path moves rows in 16-byte units: every base pointer 16-byte
// aligned and every (b, h, s) stride a multiple of 8 elements
bool can_tma(const BwdArgs& a, const void* qs, const void* ks) {
  using flash::aligned16;
  using flash::rows16;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.out, a.cos, a.sin, a.dq, a.dk, a.dv, qs, ks};
  const View* views[] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vout, &a.vdq, &a.vdk, &a.vdv};
  for (const void* p : ptrs)
    if (p == nullptr || !aligned16(p)) return false;
  for (const View* v : views)
    if (!rows16(*v)) return false;
  return a.d == 64 || a.d == 128;
}

// The TMA route for T = bf16 or fp16 (the mainloops instantiated for T),
// the CUDA-core kernels for fp32 and wherever can_tma or a tensor map says
// no.
template <typename T>
cudaError_t dispatch(const BwdArgs& a, int batch, void* qs, void* ks, cudaStream_t stream,
                     int* route) {
  *route = flash::kRouteCudaCore;
  if constexpr (!std::is_same<T, float>::value) {
    if (can_tma(a, qs, ks)) {
      CUtensorMap m[8];
      if (a.d == 128 ? encode_maps<T, 128>(a, batch, qs, ks, m)
                     : encode_maps<T, 64>(a, batch, qs, ks, m)) {
        *route = flash::kRouteTma;
        return a.d == 128 ? launch_tma<T, 128>(a, batch, qs, ks, m, stream)
                          : launch_tma<T, 64>(a, batch, qs, ks, m, stream);
      }
    }
  }
  if (a.d <= 64) return launch<T, 64, 4>(a, batch, stream);
  if (a.d <= 128) return launch<T, 64, 8>(a, batch, stream);
  return launch<T, 32, 16>(a, batch, stream);
}

}  // namespace

extern "C" {

// strides: q, k, v, do, out, dq, dk, dv as (b, h, s) element strides, 24
// values. delta: an fp32 (b, h, s) scratch buffer. q_scratch / k_scratch:
// contiguous (b, h, s, d) and (b, h / kv_rep, s, d) in q's dtype for the
// pre-pass's roped rows on the bf16 and fp16 paths at head_dim 64 / 128
// (null elsewhere). dtype: 0 = float32, 1 = bfloat16, 2 = float16. route:
// set to the route taken (flash::Route).
// Returns cudaGetLastError() after the last launch.
int galvatron_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const void* out, const void* lse, const void* cos, const void* sin,
                        void* dq, void* dk, void* dv, void* delta, void* q_scratch,
                        void* k_scratch, const long long* strides, int dtype, int batch,
                        int heads, int kv_rep, int s, int d, float lam, float sm_scale,
                        void* stream, int* route) {
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
  if (dtype == 0) return (int)dispatch<float>(a, batch, nullptr, nullptr, st, route);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, batch, q_scratch, k_scratch, st, route);
  if (dtype == 2) return (int)dispatch<__half>(a, batch, q_scratch, k_scratch, st, route);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
