// Native dynamic-programming core for the layer-strategy search.
//
// TPU-native counterpart of the reference's pybind11 DP kernel
// (reference: csrc/dp_core.cpp:22-94): the inner knapsack-over-memory loop
//   f[v][s] = intra(i, s) + min_si { f_prev[v - mem(i, s)][si] + inter(si, s) }
// over layers i, per-chip memory budget v (integer MB units), and strategies
// s, with backtracking of the chosen strategy per layer.
//
// Exposed through a plain C ABI (loaded with ctypes — no pybind11 in this
// environment; see galvatron_tpu/search/native.py). A NumPy fallback with
// identical semantics lives in galvatron_tpu/search/dynamic_programming.py.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr double kInf = std::numeric_limits<double>::infinity();
}

extern "C" {

// Returns the minimal total time cost (or +inf if infeasible).
//   L: number of layers; V: memory budget in integer units; S: strategy count
//   mem:   L*S   int32   per-layer memory units for strategy s
//   intra: L*S   double  per-layer intra cost (time) for strategy s
//   inter: S*S   double  transition cost from prev-layer strategy si to s
//   res:   L     int32   output — chosen strategy per layer (-1 if infeasible)
//   mem_used: 1  int32   output — memory units used by the optimum
double galvatron_dp_core(
    int32_t L, int32_t V, int32_t S,
    const int32_t* mem, const double* intra, const double* inter,
    int32_t* res, int32_t* mem_used) {
  if (L <= 0 || V < 0 || S <= 0) return kInf;
  const int64_t VS = static_cast<int64_t>(V + 1) * S;

  std::vector<double> f_prev(VS, kInf), f_cur(VS, kInf);
  // choice[i][v*S + s]: argmin over si at layer i (int8 fits S <= 127;
  // int16 for safety)
  std::vector<int16_t> choice(static_cast<int64_t>(L) * VS, -1);

  // layer 0: f[v][s] = intra[0][s] if mem[0][s] <= v
  for (int32_t s = 0; s < S; ++s) {
    const int32_t m = mem[s];
    if (m > V) continue;
    for (int32_t v = m; v <= V; ++v) f_prev[static_cast<int64_t>(v) * S + s] = intra[s];
  }

  for (int32_t i = 1; i < L; ++i) {
    std::fill(f_cur.begin(), f_cur.end(), kInf);
    int16_t* ch_i = choice.data() + static_cast<int64_t>(i) * VS;
    for (int32_t s = 0; s < S; ++s) {
      const int32_t m = mem[static_cast<int64_t>(i) * S + s];
      const double ic = intra[static_cast<int64_t>(i) * S + s];
      if (ic >= kInf) continue;
      for (int32_t v = m; v <= V; ++v) {
        const double* fp = f_prev.data() + static_cast<int64_t>(v - m) * S;
        double best = kInf;
        int16_t best_si = -1;
        for (int32_t si = 0; si < S; ++si) {
          const double cand = fp[si] + inter[static_cast<int64_t>(si) * S + s];
          if (cand < best) { best = cand; best_si = static_cast<int16_t>(si); }
        }
        if (best < kInf) {
          f_cur[static_cast<int64_t>(v) * S + s] = best + ic;
          ch_i[static_cast<int64_t>(v) * S + s] = best_si;
        }
      }
    }
    std::swap(f_prev, f_cur);
  }

  // pick optimum at the full budget (f is monotone-relaxed implicitly since
  // every (v, s) with mem fitting was filled for all v >= mem)
  double best = kInf;
  int32_t best_s = -1, best_v = -1;
  for (int32_t v = 0; v <= V; ++v) {
    for (int32_t s = 0; s < S; ++s) {
      const double c = f_prev[static_cast<int64_t>(v) * S + s];
      if (c < best) { best = c; best_s = s; best_v = v; }
    }
  }
  for (int32_t i = 0; i < L; ++i) res[i] = -1;
  if (mem_used) *mem_used = 0;
  if (best_s < 0) return kInf;

  // backtrack
  int32_t v = best_v, s = best_s;
  if (mem_used) *mem_used = best_v;
  for (int32_t i = L - 1; i >= 0; --i) {
    res[i] = s;
    if (i > 0) {
      const int16_t si = choice[static_cast<int64_t>(i) * VS + static_cast<int64_t>(v) * S + s];
      v -= mem[static_cast<int64_t>(i) * S + s];
      s = si;
    }
  }
  return best;
}

}  // extern "C"
