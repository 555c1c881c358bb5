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
// (0.056 ms at 3.35 TB/s): operations. For bf16 at head_dim 64 and 128 both
// kernels are the backward's shared Hopper mainloop (flash_bwd_common.cuh)
// with the grid's rounding points (GRID true): a TMA ring feeding wgmma, q /
// k / v / do read straight from their strided views; with RoPE the dk/dv
// call first ropes q and k through the unscaled tables into scratches the
// wrapper allocates, and the dq call reads the same scratches (each row
// roped once per backward). The two kernels recompute the score and dp
// products, so they issue 7 products, not 5. fp32, fp16 (p and ds rounded
// to fp16 where the bf16 route rounds them to bf16; with RoPE q and k
// rotated in the kernel, as fp32 does), other head dims and operands a
// tensor map cannot take run CUDA-core kernels with both flags at run time;
// each entry encodes its tensor maps before any launch and reports its
// route. The shared mainloops also have fp16 instances (the blocked
// backward's), but these entries instantiate only the bf16 ones: the TMA
// route is chosen on the type being bf16, not on its size, and the grid
// kernels at fp16 keep the CUDA-core route.
//
// C interface (bound with ctypes): pointers and the stream as void*, strides
// in a host array of long long, the route taken written through an int*;
// each entry returns cudaGetLastError() after its launches.

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
// CUDA cores (fp32, fp16, and bf16 off head_dim 64 / 128): a 16 x 16 grid
// of threads, each with a RI x CJ register tile of scores and dp, TILE-row
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

// which of the two kernels a C entry launches
enum class Pass { kDkDv, kDq };

// A main kernel's four tensor maps, encoded before any launch, in its
// argument order: dk/dv takes k and v (128-row boxes, resident) then q and
// do (W-row boxes, walked); dq takes q and do (128, resident) then k and v
// (W, walked). With RoPE, k and q come from the pre-pass scratches
// (contiguous), else from their views.
template <Pass P, int D>
bool encode_maps(const GridBwdArgs& a, int batch, const void* qs, const void* ks,
                 CUtensorMap* m) {
  using flash::bf16;
  using flash::encode_bhsd;
  constexpr int W = flash::bwd::Cfg<D>::W, OWN = flash::bwd::kOwn;
  constexpr bool DKV = P == Pass::kDkDv;
  constexpr int kv_rows = DKV ? OWN : W, q_rows = DKV ? W : OWN;
  CUtensorMap* mk = m + (DKV ? 0 : 2);  // k, then v
  CUtensorMap* mq = m + (DKV ? 2 : 0);  // q, then do
  const int kvh = a.heads / a.kv_rep, s = a.s;
  const long long rh = (long long)s * D;  // a scratch head
  const bool roped = a.cos != nullptr;
  const bool k_ok =
      roped ? encode_bhsd<bf16>(mk, ks, batch, kvh, s, D, rh * kvh, rh, D, kv_rows)
            : encode_bhsd<bf16>(mk, a.k, batch, kvh, s, D, a.vk.b, a.vk.h, a.vk.s, kv_rows);
  const bool q_ok =
      roped ? encode_bhsd<bf16>(mq, qs, batch, a.heads, s, D, rh * a.heads, rh, D, q_rows)
            : encode_bhsd<bf16>(mq, a.q, batch, a.heads, s, D, a.vq.b, a.vq.h, a.vq.s, q_rows);
  return k_ok && q_ok &&
         encode_bhsd<bf16>(mk + 1, a.v, batch, kvh, s, D, a.vv.b, a.vv.h, a.vv.s, kv_rows) &&
         encode_bhsd<bf16>(mq + 1, a.dout, batch, a.heads, s, D, a.vdo.b, a.vdo.h, a.vdo.s,
                           q_rows);
}

// The TMA route of one entry: dk/dv with RoPE first ropes q and k through
// the unscaled tables into the scratches (each row once per call), then its
// kernel; dq reads what that pre-pass wrote and ropes nothing.
template <Pass P, int D, bool CAUSAL, bool ROPE>
cudaError_t launch_tma(const GridBwdArgs& a, int batch, void* qs, void* ks,
                       const CUtensorMap* m, cudaStream_t stream) {
  namespace fb = flash::bwd;
  using flash::bf16;
  cudaError_t err;
  if (P == Pass::kDkDv && ROPE) {
    fb::PrepassArgs<bf16> p{};
    p.q = static_cast<const bf16*>(a.q);
    p.k = static_cast<const bf16*>(a.k);
    p.vq = a.vq;
    p.vk = a.vk;
    p.cos = a.cos;
    p.sin = a.sin;
    p.q_out = static_cast<bf16*>(qs);
    p.k_out = static_cast<bf16*>(ks);
    p.heads = a.heads;
    p.kvheads = a.heads / a.kv_rep;
    p.s = a.s;
    if ((err = fb::launch_prepass<D, true, bf16>(p, batch, stream)) != cudaSuccess) return err;
  }
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
  g.dk_scale = a.sm_scale;
  g.dq_scale = a.sm_scale;
  const long long blocks = (long long)((a.s + fb::kOwn - 1) / fb::kOwn) * a.heads * batch;
  if (P == Pass::kDkDv)
    return fb::launch_main(fb::dkdv_kernel<D, true, CAUSAL, ROPE, bf16>, fb::Cfg<D>::SMEM,
                           blocks, m[0], m[1], m[2], m[3], g, stream);
  return fb::launch_main(fb::dq_kernel<D, true, CAUSAL, ROPE, bf16>, fb::Cfg<D>::SMEM, blocks,
                         m[0], m[1], m[2], m[3], g, stream);
}

template <Pass P, int D>
cudaError_t dispatch_tma(const GridBwdArgs& a, int batch, void* qs, void* ks,
                         const CUtensorMap* m, cudaStream_t stream) {
  const bool rope = a.cos != nullptr;
  if (a.causal)
    return rope ? launch_tma<P, D, true, true>(a, batch, qs, ks, m, stream)
                : launch_tma<P, D, true, false>(a, batch, qs, ks, m, stream);
  return rope ? launch_tma<P, D, false, true>(a, batch, qs, ks, m, stream)
              : launch_tma<P, D, false, false>(a, batch, qs, ks, m, stream);
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

// The TMA route moves rows in 16-byte units: every base pointer 16-byte
// aligned and every (b, h, s) stride a multiple of 8 elements; with RoPE it
// takes the scratches the pre-pass writes (the dq entry is given them only
// where the dk/dv call took this route and so wrote them).
bool can_tma(const GridBwdArgs& a, const void* qs, const void* ks) {
  using flash::aligned16;
  using flash::rows16;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.cos, a.sin, a.dq, a.dk, a.dv, qs, ks};
  const View* views[] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vdq, &a.vdk, &a.vdv};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  for (const View* v : views)
    if (!rows16(*v)) return false;
  return (a.d == 64 || a.d == 128) && (a.cos == nullptr || (qs != nullptr && ks != nullptr));
}

template <Pass P, typename T>
cudaError_t dispatch(const GridBwdArgs& a, int batch, void* qs, void* ks, cudaStream_t stream,
                     int* route) {
  *route = flash::kRouteCudaCore;
  if (std::is_same<T, __nv_bfloat16>::value && can_tma(a, qs, ks)) {
    CUtensorMap m[4];
    if (a.d == 128 ? encode_maps<P, 128>(a, batch, qs, ks, m)
                   : encode_maps<P, 64>(a, batch, qs, ks, m)) {
      *route = flash::kRouteTma;
      return a.d == 128 ? dispatch_tma<P, 128>(a, batch, qs, ks, m, stream)
                        : dispatch_tma<P, 64>(a, batch, qs, ks, m, stream);
    }
  }
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
  if (dtype == 2) return (int)dispatch<P, __half>(a, batch, nullptr, nullptr, st, route);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// strides: q, k, v, do, dq, dk, dv as (b, h, s) element strides, 21 values.
// lse, delta: contiguous fp32 (b, h, s). cos/sin: null without RoPE. dtype:
// 0 = float32, 1 = bfloat16, 2 = float16 (the CUDA-core kernels). q_scratch /
// k_scratch: bf16 contiguous (b, h, s, d) and (b, h / kv_rep, s, d) for the
// RoPE pre-pass of the bf16 route at head_dim 64 / 128 (null elsewhere): the
// dk/dv entry writes them,
// the dq entry reads them, so the dq entry is given them only after a dk/dv
// call on the same inputs took that route. The dk/dv entry writes dk and dv,
// the dq entry dq; route is set to the route taken (flash::Route). Each
// returns cudaGetLastError() after its launches.
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
                            const void* sin, void* dq, void* dk, void* dv, void* q_scratch,
                            void* k_scratch, const long long* strides, int dtype, int causal,
                            int batch, int heads, int kv_rep, int s, int d, float lam,
                            float sm_scale, void* stream, int* route) {
  return run<Pass::kDq>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, q_scratch, k_scratch,
                        strides, dtype, causal, batch, heads, kv_rep, s, d, lam, sm_scale,
                        stream, route);
}

}  // extern "C"
