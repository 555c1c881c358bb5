// Paged decode attention for Hopper (sm_90a), one query token per row, split
// across blocks (flash-decoding) with an asynchronous copy ring.
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention(
// impl="pallas")` in galvatron_tpu/ops/flash_attention.py: online softmax
// over a row's K/V pages, found through its block table, with keys at
// positions > the row's query offset masked and pages wholly past the offset
// skipped.
//
//   q        (B, 1, n, d)              viewed as (B, kv, g, d), g = n / kv
//   k_pages  (num_blocks, bs, kv, d)   one layer of the serving block pool
//   v_pages  (num_blocks, bs, kv, d)
//   tables   (B, max_blocks) int32     logical block j of row b -> pool block
//   offsets  (B,) int32                absolute position of row b's query
//   work     fp32 workspace            (B, kv, splits, g, d) numerators, then
//                                      (B, kv, splits, g, 2) (max, denominator)
//   out      (B, 1, n, d)              in q's dtype
//
// Math: q.k in fp32 times sm_scale (kept in base-2 units, times log2 e, so
// the softmax runs on exp2); fp32 running max, denominator and numerator; the
// output is cast to the input dtype once at the end. Inputs are bf16 (the
// serving path), fp16 (the reference's kernel takes any float dtype) or fp32
// (card-side parity with the CPU).
//
// Bound: bytes. A decode step reads every K and V row at positions
// [0, offset] once per (row, kv head), against 4 * g * d operations per
// token: at g <= 8 that is at most 8 operations a byte, far under the ~295
// the H100 needs before its tensor cores become the limit. Tensor cores buy
// nothing here, so the design spends nothing on them and everything on
// keeping enough bytes in flight:
//
//   - each row is split across blocks (grid (kv head [x head chunk], row,
//     split)). The split plan comes from shapes only (the wrapper's
//     `_paged_splits`: about four blocks an SM, at least 128 positions a
//     split), never from the offsets, which stay on the card. A block walks
//     its split's positions up to the row's offset and writes a partial
//     (max, denominator, numerator[g, d]) in fp32; a split wholly past the
//     offset writes an empty partial (max -inf, denominator 0) and exits;
//   - inside a block each of four warps owns its own 8-token tiles (tile
//     w, w + 4, ...). A warp streams its tiles' K and V rows, in the input
//     dtype, into its own 3-stage ring of shared memory with 16-byte cp.async
//     copies (tokens past the offset are zero-filled, never read). Its lanes
//     lie across d; it keeps its own running (max, denominator, numerator)
//     for the g heads in registers. The only barrier per tile is the warp's
//     own: no block-wide barrier until the warps merge once, through shared
//     memory, at the end of the split;
//   - a second kernel, one thread per output element, combines the
//     partials in fixed split order (deterministic) and writes the output;
//     a row whose every split is empty (offset < 0) writes zeros.
//
// Not done (later work): wgmma for GQA groups of g >= 8 heads, where the
// score and PV products would begin to matter.
//
// C interface (bound with ctypes): every pointer and the stream are passed as
// void*; the function returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTok = 8;        // tokens of one warp tile
constexpr int kStages = 3;     // warp tiles in a warp's ring
constexpr int kMaxHeads = 8;   // query heads one block carries (a GQA group chunk)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NE consecutive elements (one lane's share of a row) as fp32, by one or two
// vector loads: rows are 16-byte aligned and a lane's share starts at a
// multiple of NE elements
template <int NE>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[NE]) {
  if constexpr (NE == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NE; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  }
}
// NE consecutive 16-bit elements as packed pairs (NE / 2 words), by one
// vector load
template <int NE>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NE / 2]) {
  if constexpr (NE == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NE == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}
template <int NE>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[NE]) {
  uint32_t w[NE / 2];
  load_words<NE>(p, w);
#pragma unroll
  for (int i = 0; i < NE / 2; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <int NE>
__device__ __forceinline__ void load_vec(const __half* p, float (&x)[NE]) {
  uint32_t w[NE / 2];
  load_words<NE>(p, w);
#pragma unroll
  for (int i = 0; i < NE / 2; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__host__ __device__ __forceinline__ size_t row_bytes(int d, int esz) {
  return (size_t)d * esz;
}

// shared memory, in bytes: each warp's ring of kStages x (K, V) x kTok rows
// in the input dtype, then the merge area: per warp G x d numerators and
// G (max, denominator) pairs, fp32
size_t smem_bytes(int esz, int heads, int d) {
  return (size_t)kWarps * kStages * 2 * kTok * row_bytes(d, esz) +
         (size_t)kWarps * heads * (d + 2) * sizeof(float);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* offsets;
  float* part_acc;  // (B, kv, splits, g, d)
  float* part_ml;   // (B, kv, splits, g, 2)
  void* out;
  int kv, g, d, block_size, max_blocks, splits, split_len, head_chunks;
  float scale2;  // sm_scale * log2(e)
};

// One block per (kv head, head chunk) x row x split. G: query heads a block
// carries (the group, or a chunk of 8 of it); NE: elements of d a lane owns.
template <typename T, int G, int NE>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x / a.head_chunks;
  const int h0 = (blockIdx.x - kvh * a.head_chunks) * G;  // first head of this chunk
  const int gc = min(G, a.g - h0);                         // heads in this chunk
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d;

  // keys past the table's reach do not exist (the TPU grid stops at
  // max_blocks); keys past the offset are masked, so the walk stops there
  const int last = min(a.offsets[b], a.max_blocks * a.block_size - 1);
  const int st = split * a.split_len;
  const int en = min(st + a.split_len, last + 1);  // this block's positions: [st, en)
  const size_t part = ((size_t)b * a.kv + kvh) * a.splits + split;  // (b, kvh, split)
  float* pacc = a.part_acc + (part * a.g + h0) * d;
  float* pml = a.part_ml + (part * a.g + h0) * 2;
  if (st >= en) {  // wholly past the offset: an empty partial
    for (int i = tid; i < gc * d; i += kThreads) pacc[i] = 0.f;
    for (int h = tid; h < gc; h += kThreads) {
      pml[2 * h] = -INFINITY;
      pml[2 * h + 1] = 0.f;
    }
    return;
  }

  const int e0 = lane * NE;  // this lane's elements: [e0, e0 + NE)
  const bool lane_on = e0 < d;
  float qf[G][NE], acc[G][NE], m[G], l[G];
  const T* qg = static_cast<const T*>(a.q) + (((size_t)b * a.kv + kvh) * a.g + h0) * d;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < NE; ++i) qf[h][i] = acc[h][i] = 0.f;
    if (h < gc && lane_on) load_vec<NE>(qg + (size_t)h * d + e0, qf[h]);
  }

  // this warp's ring: kStages x (K rows, V rows) of kTok tokens each
  const size_t rb = row_bytes(d, sizeof(T));
  unsigned char* ring = smem + (size_t)warp * kStages * 2 * kTok * rb;
  const int32_t* table = a.tables + (size_t)b * a.max_blocks;
  const size_t row_stride = (size_t)a.kv * d;  // token to token inside a page, elements
  const size_t page_stride = (size_t)a.block_size * row_stride;
  const T* kbase = static_cast<const T*>(a.k) + (size_t)kvh * d;
  const T* vbase = static_cast<const T*>(a.v) + (size_t)kvh * d;
  const int chunks = (int)(rb / 16);  // 16-byte copies per row
  const int ntiles = (en - st + kTok - 1) / kTok;
  const int mine = warp < ntiles ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  // a tile's copies are (token, 16-byte unit) pairs, 32 a step: this lane's
  // first pair, and how far one step moves it
  const int t_first = lane / chunks, u_first = lane - t_first * chunks;
  const int t_step = 32 / chunks, u_step = 32 - t_step * chunks;

  // the pool block of token `lane` of this warp's i-th tile (lanes < kTok),
  // loaded one tile ahead of its copies so the table read's latency hides
  // behind a tile's arithmetic
  auto load_page = [&](int i) -> int {
    const int pos = st + (warp + i * kWarps) * kTok + lane;
    return lane < kTok && i < mine && pos < en ? table[pos / a.block_size] : 0;
  };
  auto issue = [&](int i, int page) {  // this warp's i-th tile into ring stage i % kStages
    unsigned char* ks = ring + (size_t)(i % kStages) * 2 * kTok * rb;
    unsigned char* vs = ks + kTok * rb;
    // lane t < kTok: its token's row, in elements from the pool's start (-1
    // past the offset: zero-filled)
    const int pos = st + (warp + i * kWarps) * kTok + min(lane, kTok - 1);
    const long long row =
        pos < en ? (long long)page * page_stride + (long long)(pos % a.block_size) * row_stride
                 : -1;
    int t = t_first, u = u_first;
    for (int c0 = 0; c0 < kTok * chunks; c0 += 32) {  // uniform trip count: the shuffle
      const long long src = __shfl_sync(0xffffffffu, row, min(t, kTok - 1));  // needs all
      if (c0 + lane < kTok * chunks) {
        const size_t at = (size_t)t * rb + (size_t)u * 16;
        const size_t from = src < 0 ? 0 : (size_t)src * sizeof(T) + (size_t)u * 16;
        cp_async16(ks + at, reinterpret_cast<const unsigned char*>(kbase) + from, src >= 0);
        cp_async16(vs + at, reinterpret_cast<const unsigned char*>(vbase) + from, src >= 0);
      }
      t += t_step;
      u += u_step;
      if (u >= chunks) {
        u -= chunks;
        ++t;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) issue(i, load_page(i));
    cp_async_commit();  // one group per slot, empty or not, so the counting holds
  }
  int pages = load_page(kStages - 1);
  for (int i = 0; i < mine; ++i) {
    cp_async_wait_ring();  // this lane's copies of tile i have landed
    __syncwarp();          // ... and every lane's; all lanes are done with tile i - 1
    if (i + kStages - 1 < mine) issue(i + kStages - 1, pages);
    cp_async_commit();
    pages = load_page(i + kStages);

    const int p0 = st + (warp + i * kWarps) * kTok;
    const unsigned char* ks = ring + (size_t)(i % kStages) * 2 * kTok * rb;
    const unsigned char* vs = ks + kTok * rb;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= gc) break;
      float s[kTok];
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
        float kf[NE];
        float dot = 0.f;
        if (lane_on) {
          load_vec<NE>(reinterpret_cast<const T*>(ks + t * rb) + e0, kf);
#pragma unroll
          for (int e = 0; e < NE; ++e) dot = fmaf(qf[h][e], kf[e], dot);
        }
        s[t] = dot;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
        s[t] = p0 + t < en ? warp_sum(s[t]) * a.scale2 : -INFINITY;
        mx = fmaxf(mx, s[t]);
      }
      // the tile's first token is always < en, so m_new is finite
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2f(m[h] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
        s[t] = exp2f(s[t] - m_new);
        psum += s[t];
      }
      l[h] = l[h] * alpha + psum;
      m[h] = m_new;
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[h][e] *= alpha;
#pragma unroll
        for (int t = 0; t < kTok; ++t) {
          float vf[NE];
          load_vec<NE>(reinterpret_cast<const T*>(vs + t * rb) + e0, vf);
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[h][e] = fmaf(s[t], vf[e], acc[h][e]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // merge the warps' running states once, through shared memory
  float* macc = reinterpret_cast<float*>(smem + (size_t)kWarps * kStages * 2 * kTok * rb);
  float* mml = macc + (size_t)kWarps * G * d;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h >= gc) break;
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < NE; ++e) macc[((size_t)warp * G + h) * d + e0 + e] = acc[h][e];
    }
    if (lane == 0) {
      mml[(warp * G + h) * 2] = m[h];
      mml[(warp * G + h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < gc * d; i += kThreads) {
    const int h = i / d, e = i - h * d;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, mml[(w * G + h) * 2]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mml[(w * G + h) * 2];
      if (mw == -INFINITY) continue;  // a warp that had no tile
      const float c = exp2f(mw - mm);
      ll = fmaf(mml[(w * G + h) * 2 + 1], c, ll);
      aa = fmaf(macc[((size_t)w * G + h) * d + e], c, aa);
    }
    pacc[(size_t)h * d + e] = aa;
    if (e == 0) {
      pml[2 * h] = mm;
      pml[2 * h + 1] = ll;
    }
  }
}

// One thread per output element (row, kv head, head, d): the partials of
// every split, combined in split order, divided by the denominator, cast once.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(Args a, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int g = a.g, d = a.d, splits = a.splits;
  const int rh = i / d, e = i - rh * d;  // rh: (row, kv head, head) flattened
  const int h = rh % g;
  const size_t base = (size_t)(rh / g) * splits;  // (row, kv head, split 0)
  const float* ml = a.part_ml + (base * g + h) * 2;
  const float* acc = a.part_acc + (base * g + h) * d + e;
  float mm = -INFINITY;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp) mm = fmaxf(mm, ml[(size_t)sp * g * 2]);
  float ll = 0.f, aa = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp) {
    const float ms = ml[(size_t)sp * g * 2];
    const float c = ms == -INFINITY ? 0.f : exp2f(ms - mm);  // an empty split adds nothing
    ll = fmaf(ml[(size_t)sp * g * 2 + 1], c, ll);
    aa = fmaf(acc[(size_t)sp * g * d], c, aa);
  }
  // a row with nothing to attend (offset < 0) writes zeros; the engine
  // never passes one
  static_cast<T*>(a.out)[i] = from_f32<T>(ll > 0.f ? aa / ll : 0.f);
}

int heads_per_block(int g) {
  int G = 1;
  while (G < g && G < kMaxHeads) G *= 2;
  return G;
}

template <typename T, int G, int NE>
cudaError_t launch_split(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), G, a.d);
  auto kernel = paged_decode_split_kernel<T, G, NE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.kv * a.head_chunks, batch, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t dispatch_ne(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 64) return launch_split<T, G, 2>(a, batch, stream);
  if (a.d <= 128) return launch_split<T, G, 4>(a, batch, stream);
  return launch_split<T, G, 8>(a, batch, stream);
}

template <typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  cudaError_t err;
  switch (heads_per_block(a.g)) {
    case 1: err = dispatch_ne<T, 1>(a, batch, stream); break;
    case 2: err = dispatch_ne<T, 2>(a, batch, stream); break;
    case 4: err = dispatch_ne<T, 4>(a, batch, stream); break;
    default: err = dispatch_ne<T, 8>(a, batch, stream); break;
  }
  if (err != cudaSuccess) return err;
  const int total = batch * a.kv * a.g * a.d;
  paged_decode_combine_kernel<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one split block needs, in bytes (the wrapper refuses
// shapes above the 227 KB a block may use). dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.
long long galvatron_paged_decode_smem_bytes(int dtype, int g, int d) {
  return (long long)smem_bytes(dtype == 0 ? 4 : 2, heads_per_block(g), d);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. `work` holds batch * kv *
// splits * g * (d + 2) floats. Rows are split into `splits` ranges of `split_len`
// positions. Returns cudaGetLastError() after the launches.
int galvatron_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                           const void* tables, const void* offsets, void* work, void* out,
                           int dtype, int batch, int kv, int g, int d, int block_size,
                           int max_blocks, int splits, int split_len, float sm_scale,
                           void* stream) {
  if (d % 8 != 0 || d > 256 || d <= 0 || g <= 0 || splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < (long long)block_size * max_blocks)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.tables = static_cast<const int32_t*>(tables);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.part_acc = static_cast<float*>(work);
  a.part_ml = a.part_acc + (size_t)batch * kv * splits * g * d;
  a.out = out;
  a.kv = kv;
  a.g = g;
  a.d = d;
  a.block_size = block_size;
  a.max_blocks = max_blocks;
  a.splits = splits;
  a.split_len = split_len;
  a.head_chunks = (g + kMaxHeads - 1) / kMaxHeads;
  a.scale2 = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, batch, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, batch, s);
  if (dtype == 2) return (int)launch<__half>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
