"""Model profiler: per-layer compute time and memory (the port's counterpart
of ``galvatron_tpu/profiling/model.py``; reference: galvatron/core/
profiler.py:194-401, which launches train_dist.py at two layer counts and
differences the results).

The layer-difference method runs the port's real train step
(``parallel/hybrid.build_runtime``, one device, the trivial strategy) at two
layer counts L1 < L2:

  per-layer fwd ms  = (iter(L2) - iter(L1)) / (L2 - L1) / bsz / 3
  per-layer act MB  = (act_bytes(L2) - act_bytes(L1)) / (L2 - L1) / bsz / 1e6

(the /3 removes the backward's ~2x share of a training step). ``act_bytes``
is the memory a forward keeps for its backward: on the card the CUDA
allocator's bytes held after the forward (loss computed, graph alive) minus
the bytes held before it; on the CPU, which has no allocator to read, the
bytes of the tensors autograd saves for the backward
(``torch.autograd.graph.saved_tensors_hooks``). Parameter, boundary and
"other" sizes are analytic (``search/theoretical.py``), as in the JAX
package, and the JSONs have its schema.

The profile runs in one process on one device: the per-tp activation curve
is the analytic 1/tp of the JAX package on a one-device host, and the
vocab-parallel fit covers vocab_tp = 1. A ViT ('cls') is profiled on its
pixel ‖ label rows (``modeling.batch_row_width``) and its layers' sequence
is its patches; its 'other' terms stay analytic (no vocabulary fit), as in
the JAX package. An encoder-decoder gets two layer types from a three-point
sweep (:func:`_profile_encdec_model`), a Swin pyramid one type per stage
from a (K + 1)-point sweep of layer pairs (:func:`_profile_swin_model`).
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from galvatron_tpu_torch.core.optim import AdamConfig, tree_leaves
from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy
from galvatron_tpu_torch.device import resolve_device
from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.models.modeling import ModelConfig
from galvatron_tpu_torch.search.cost_model import ProfiledLayerType, ProfiledModelCosts
from galvatron_tpu_torch.models.modeling import swin_geometry, vision_layer_cfg
from galvatron_tpu_torch.search.theoretical import (
    layer_param_count,
    moe_expert_params,
    other_param_count,
)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_strategy_ms(
    cfg: ModelConfig,
    hp: HybridParallelConfig,
    bsz: int,
    seq: Optional[int] = None,
    iters: int = 4,
    device=None,
    windows: int = 1,
) -> float:
    """Milliseconds per training iteration of ``hp`` through the runtime's
    own ``train_step`` (this process's world): two warm-up steps first (the
    first pays the kernels' build and cuBLAS's heuristics), then ``iters``
    steps timed as one window — CUDA events on the card, the host clock
    around a read-back loss on the CPU — synchronised once at its end. With
    ``windows`` > 1 the median of that many such windows, one after the
    other on the same runtime."""
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    device = resolve_device(device)
    seq = seq or cfg.max_seq_len
    rt = build_runtime(cfg, hp, adam=AdamConfig(lr=1e-4), global_batch_size=bsz,
                       seq_len=seq, device=device)
    batch = torch.zeros((bsz, modeling.batch_row_width(cfg, seq)), dtype=torch.long)
    state = rt.init_state(0)
    for _ in range(2):
        state, loss = rt.train_step(state, batch)
    float(loss)
    _sync(device)
    times = []
    for _ in range(windows):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                state, loss = rt.train_step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                state, loss = rt.train_step(state, batch)
            float(loss)
            times.append((time.perf_counter() - t0) / iters * 1000.0)
    return float(statistics.median(times))


def _mp_of(cfg: ModelConfig) -> str:
    return {torch.bfloat16: "bf16", torch.float16: "fp16"}.get(cfg.dtype, "fp32")


def _trivial_plan(cfg: ModelConfig, vocab_tp: int = 1) -> HybridParallelConfig:
    return HybridParallelConfig(
        pp=1, layer_strategies=[LayerStrategy()] * cfg.total_layers, chunks=1,
        vocab_tp=vocab_tp, mixed_precision=_mp_of(cfg), mlp_recompute=cfg.mlp_recompute,
    )


def _iter_time_ms(cfg: ModelConfig, bsz: int, seq: int, device, iters: int = 4,
                  windows: int = 1) -> float:
    """One-device trivial-strategy iteration time: the per-layer basis
    (tp=1, ddp, chunks=1)."""
    return measure_strategy_ms(cfg, _trivial_plan(cfg), bsz, seq, iters, device=device,
                               windows=windows)


def profile_vocab_costs(
    cfg: ModelConfig,
    bsz: int,
    vocab_tps: Optional[Sequence[int]] = None,
    seq: Optional[int] = None,
    iters: int = 4,
    device=None,
) -> Tuple[dict, dict, str]:
    """The embedding + head + loss cost per vocab_tp as (slope ms/sample,
    const ms/iteration, precision), measured on a ZERO-LAYER model at two
    batch sizes (bsz, 2·bsz), as the JAX package does. The runtime spans
    this process's whole world, so the one degree it can measure is the
    world size (vt = 1 on one device); the search prices the others
    analytically."""
    seq = seq or cfg.max_seq_len
    mp = _mp_of(cfg)
    world = _world()
    cfg0 = cfg.replace(num_layers=0)
    slope, const = {}, {}
    for vt in vocab_tps or [world]:
        if vt != world or cfg.vocab_size % vt:
            continue
        hp = _trivial_plan(cfg0, vocab_tp=vt)
        t1 = measure_strategy_ms(cfg0, hp, bsz, seq, iters, device=device)
        t2 = measure_strategy_ms(cfg0, hp, 2 * bsz, seq, iters, device=device)
        m = max(0.0, (t2 - t1) / bsz)  # ms per sample-per-device
        slope[int(vt)] = float(m)
        const[int(vt)] = float(max(0.0, t1 - m * bsz))
    return slope, const, mp


def _saved_bytes(fn: Callable[[], torch.Tensor], params) -> int:
    """Bytes of the distinct storages autograd saves for the backward while
    ``fn`` runs, the parameters' own excluded (the CPU's measure)."""
    own = {p.untyped_storage().data_ptr() for p in tree_leaves(params)}
    seen: Dict[int, int] = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def _act_bytes(cfg: ModelConfig, bsz: int, seq: int, device: torch.device) -> int:
    """The memory one forward of the loss keeps for its backward (see the
    module docstring): allocator bytes on the card, saved-tensor bytes on
    the CPU."""
    params = modeling.init_model_params(cfg, 0, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = torch.zeros((bsz, modeling.batch_row_width(cfg, seq)), dtype=torch.long,
                        device=device)
    if device.type == "cuda":
        _sync(device)
        before = torch.cuda.memory_allocated(device)
        loss = modeling.lm_loss(params, batch, cfg)
        _sync(device)
        held = torch.cuda.memory_allocated(device) - before
        del loss
        return int(held)
    return _saved_bytes(lambda: modeling.lm_loss(params, batch, cfg), params)


def act_measure(device) -> str:
    """Which activation measure ``profile_model`` takes on ``device``."""
    return ("CUDA allocator bytes held after the forward"
            if torch.device(device).type == "cuda" else
            "bytes autograd saves for the backward (saved_tensors_hooks)")


# adaptive layer counts: profile at the model's depth (L/2, L) up to this
# many layers, because the marginal layer cost is not constant in L; beyond
# it the difference method extrapolates (the JAX package's cap)
_PROFILE_MAX_LAYERS = 12


def _default_layernums(total_layers: int) -> Tuple[int, int]:
    l2 = max(2, min(total_layers, _PROFILE_MAX_LAYERS))
    return max(1, l2 // 2), l2


def _act_fallback_mb(cfg: ModelConfig, S: int) -> float:
    """Analytic activation fallback (bf16) where the two layer counts give
    no positive difference."""
    return S * cfg.hidden_size * (10 + 4 * cfg.ffn / cfg.hidden_size) * 2 / 1e6


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


#: timing windows of each point of the expert-time fit (their median): one
#: window of a small MoE model is launch-bound and host-noise prone
_FIT_WINDOWS = 5


def _expert_time_fraction(cfg: ModelConfig, bsz: int, seq: int, depth: int, fwd_ms: float,
                          device: torch.device) -> Optional[float]:
    """The MEASURED share of an MoE layer's time that expert parallelism
    splits: a two-point fit of the layer time over the expert FFN width,
    t(f) = a + b·f, share b·f / t (the intercept a is the routing,
    sinkhorn and dispatch, which do not split by ep). Both points are timed
    at the same ``depth``, the full width and a quarter of it, so all that
    lies outside the layers cancels in their difference:
    b = Δt / (depth · 3·bsz · Δf); each point is the median of
    ``_FIT_WINDOWS`` windows. (The reference fits b from the per-layer
    differences at two depths, four single windows: on the card that
    difference of differences is noise-bound, PERF.md.) A degenerate fit
    (no positive slope) or a failed run leaves None: the search then prices
    EP by the parameter fraction (the reference's fallback)."""
    try:
        f1 = cfg.ffn
        f2 = max(256, (f1 // 4 + 255) // 256 * 256)
        if f2 >= f1:
            return None
        t_full = _iter_time_ms(cfg.replace(num_layers=depth), bsz, seq, device,
                               windows=_FIT_WINDOWS)
        _free(device)
        t_small = _iter_time_ms(cfg.replace(num_layers=depth, ffn_dim=f2), bsz, seq, device,
                                windows=_FIT_WINDOWS)
        _free(device)
        slope = (t_full - t_small) / depth / bsz / 3.0 / (f1 - f2)
        return float(min(slope * f1 / fwd_ms, 0.99)) if slope > 0 else None
    except Exception:  # noqa: BLE001 — the reference's fallback to the proxy
        return None


def _save(costs: ProfiledModelCosts, out_prefix: Optional[str]) -> None:
    if out_prefix:
        from galvatron_tpu_torch.utils.config_utils import save_profiled_model

        save_profiled_model(costs, f"{out_prefix}_computation.json",
                            f"{out_prefix}_memory.json")


def _profile_encdec_model(cfg: ModelConfig, bsz: int, layernums: Tuple[int, int],
                          measure_time: bool, out_prefix: Optional[str],
                          device: torch.device) -> ProfiledModelCosts:
    """An encoder-decoder's profile (the JAX package's
    ``_profile_encdec_model``): TWO layer types from a three-point sweep,
    (E, D) = (l1, l1), (l1, l2), (l2, l1) — the decoder count varied at a
    fixed encoder count, then the encoder count at a fixed decoder count
    (the reference's multi-layer-type layer-number lists). The decoder
    type carries the cross-attention's parameters; without timing the
    reference's fixed (1.0, 1.5, 0.1) ms stand in."""
    l1, l2 = layernums
    if not 1 <= l1 < l2:
        raise ValueError(f"layernums must satisfy 1 <= min < max, got ({l1}, {l2})")
    S_e, S_d = cfg.enc_seq, cfg.max_seq_len
    points = {"11": cfg.replace(num_layers=l1, enc_layers=l1),
              "12": cfg.replace(num_layers=l2, enc_layers=l1),
              "21": cfg.replace(num_layers=l1, enc_layers=l2)}
    if measure_time:
        t = {}
        for name, c in points.items():
            t[name] = _iter_time_ms(c, bsz, S_d, device)
            _free(device)
        dec_ms = max(1e-4, (t["12"] - t["11"]) / (l2 - l1) / bsz / 3.0)
        enc_ms = max(1e-4, (t["21"] - t["11"]) / (l2 - l1) / bsz / 3.0)
        other_ms = max(0.0, (t["11"] - (enc_ms + dec_ms) * 3.0 * bsz * l1) / bsz / 3.0)
    else:
        enc_ms, dec_ms, other_ms = 1.0, 1.5, 0.1
    b = {}
    for name, c in points.items():
        b[name] = _act_bytes(c, bsz, S_d, device)
        _free(device)

    def act_of(b_hi, b_lo, S_type):
        if b_hi > b_lo:
            return (b_hi - b_lo) / (l2 - l1) / bsz / 1e6
        return _act_fallback_mb(cfg, S_type)

    def layer_type(fwd, act_mb, S_type, cross):
        return ProfiledLayerType(
            fwd_ms_per_sample=float(fwd),
            parameter_mb=float(layer_param_count(cfg, cross=cross) * 4 / 1e6),
            activation_mb_per_sample={t: float(act_mb / t) for t in (1, 2, 4, 8)
                                      if cfg.hidden_size % t == 0},
            boundary_activation_mb_per_sample=float(S_type * cfg.hidden_size * 2 / 1e6),
        )

    enc_lt = layer_type(enc_ms, act_of(b["21"], b["11"], S_e), S_e, cross=False)
    dec_lt = layer_type(dec_ms, act_of(b["12"], b["11"], S_d), S_d, cross=True)
    layer_types = {i: enc_lt for i in range(cfg.enc_layers)}
    layer_types.update({cfg.enc_layers + i: dec_lt for i in range(cfg.num_layers)})
    print(f"profile: enc-dec layer counts ({l1}, {l2}) on {device}; activation measure: "
          f"{act_measure(device)}", flush=True)
    costs = ProfiledModelCosts(
        layer_types=layer_types,
        other_param_mb=float(other_param_count(cfg) * 4 / 1e6),
        other_act_mb_per_sample=float(S_d * cfg.vocab_size * 4 / 1e6),
        other_fwd_ms_per_sample=float(other_ms),
        hidden_size=cfg.hidden_size,
    )
    _save(costs, out_prefix)
    return costs


def _profile_swin_model(cfg: ModelConfig, bsz: int, measure_time: bool,
                        out_prefix: Optional[str], device: torch.device) -> ProfiledModelCosts:
    """A Swin pyramid's profile (the JAX package's ``_profile_swin_model``):
    one layer type per stage from a (K + 1)-point sweep, a base pyramid of
    one layer PAIR a stage, then one more pair in stage k with the others
    fixed (pairs, since Swin alternates plain and shifted windows); without
    timing the reference's fixed (1.0, 0.1) ms stand in."""
    K = len(cfg.swin_depths)

    def with_depths(d):
        return cfg.replace(num_layers=sum(d), swin_depths=tuple(d))

    cfg_base = with_depths((2,) * K)
    var_cfgs = [with_depths(tuple(4 if j == k else 2 for j in range(K))) for k in range(K)]
    if measure_time:
        t_base = _iter_time_ms(cfg_base, bsz, None, device)
        _free(device)
        t_var = []
        for c in var_cfgs:
            t_var.append(_iter_time_ms(c, bsz, None, device))
            _free(device)
        sec_ms = [max(1e-4, (t - t_base) / 2.0 / bsz / 3.0) for t in t_var]
        other_ms = max(0.0, (t_base - sum(sec_ms) * 2.0 * 3.0 * bsz) / bsz / 3.0)
    else:
        sec_ms, other_ms = [1.0] * K, 0.1
    b_base = _act_bytes(cfg_base, bsz, 0, device)
    _free(device)
    b_var = []
    for c in var_cfgs:
        b_var.append(_act_bytes(c, bsz, 0, device))
        _free(device)
    starts = modeling.swin_stage_starts(cfg)
    sec_lts = []
    for k in range(K):
        h, w, c_k, _ = swin_geometry(cfg, k)
        lcfg = vision_layer_cfg(cfg, starts[k])
        act_mb = ((b_var[k] - b_base) / 2.0 / bsz / 1e6 if b_var[k] > b_base
                  else _act_fallback_mb(lcfg, h * w))
        sec_lts.append(ProfiledLayerType(
            fwd_ms_per_sample=float(sec_ms[k]),
            parameter_mb=float(layer_param_count(lcfg) * 4 / 1e6),
            activation_mb_per_sample={t: float(act_mb / t) for t in (1, 2, 4, 8)
                                      if c_k % t == 0},
            boundary_activation_mb_per_sample=float(h * w * c_k * 2 / 1e6),
        ))
    print(f"profile: Swin pair sweep over {K} stages on {device}; activation measure: "
          f"{act_measure(device)}", flush=True)
    costs = ProfiledModelCosts(
        layer_types={i: sec_lts[modeling.swin_stage_of(cfg, i)[0]]
                     for i in range(cfg.num_layers)},
        other_param_mb=float(other_param_count(cfg) * 4 / 1e6),
        # the patch embedding's output dominates "other" activations
        other_act_mb_per_sample=float(cfg.n_patches * cfg.hidden_size * 2 / 1e6),
        other_fwd_ms_per_sample=float(other_ms),
        hidden_size=cfg.hidden_size,
    )
    _save(costs, out_prefix)
    return costs


def profile_model(
    cfg: ModelConfig,
    bsz: int = 8,
    seq: Optional[int] = None,
    layernums: Optional[Tuple[int, int]] = None,
    measure_time: bool = True,
    out_prefix: Optional[str] = None,
    device=None,
) -> ProfiledModelCosts:
    """Difference-method profile (reference: process_profiled_data,
    core/profiler.py:243-401); writes reference-schema JSONs with
    ``out_prefix``. ``layernums=None`` picks (L//2, L) capped at
    ``_PROFILE_MAX_LAYERS``; a CUDA out-of-memory error at the adaptive
    counts halves them (printed) — the only error caught. Explicit
    ``layernums`` are never changed. An MoE model also gets its expert-time
    fraction (:func:`_expert_time_fraction`) and the expert-parameter
    fraction and all-to-all volume the search prices EP with."""
    if _world() != 1:
        raise ValueError("profile_model runs in one process on one device "
                         f"(this world has {_world()} ranks)")
    device = resolve_device(device)
    modeling.check_supported(cfg)
    if cfg.enc_layers > 0:
        if seq is not None:
            raise ValueError(
                "seq does not apply to enc-dec profiles (two sequence "
                "lengths); set cfg.enc_seq / cfg.max_seq_len instead"
            )
        return _profile_encdec_model(cfg, bsz, layernums or (2, 4), measure_time, out_prefix,
                                     device)
    if cfg.swin_depths:
        if seq is not None or layernums is not None:
            raise ValueError(
                "seq/layernums do not apply to swin profiles (the pyramid "
                "fixes per-section resolutions; the sweep varies section "
                "depths)"
            )
        return _profile_swin_model(cfg, bsz, measure_time, out_prefix, device)
    seq = modeling.layer_seq(cfg, seq)
    adaptive = layernums is None
    l1, l2 = layernums or _default_layernums(cfg.total_layers)
    if not 1 <= l1 < l2:
        raise ValueError(f"layernums must satisfy 1 <= min < max, got ({l1}, {l2})")

    t_cache: Dict[int, float] = {}
    b_cache: Dict[int, int] = {}

    def measure(ln: int) -> None:
        c = cfg.replace(num_layers=ln)
        if measure_time and ln not in t_cache:
            t_cache[ln] = _iter_time_ms(c, bsz, seq, device)
            _free(device)
        if ln not in b_cache:
            b_cache[ln] = _act_bytes(c, bsz, seq, device)
            _free(device)

    while True:
        oom = False
        try:
            measure(l1)
            measure(l2)
        except torch.cuda.OutOfMemoryError:
            # only the adaptive basis falls back; the exception (whose
            # traceback holds the failed attempt's tensors) is gone once
            # this block ends, before the cache is emptied below
            if not adaptive or l2 <= 2:
                raise
            oom = True
        if not oom:
            break
        _free(device)
        n2 = max(2, l2 // 2)
        print(f"profile: out of memory at layer counts ({l1}, {l2}); dropping to "
              f"({max(1, n2 // 2)}, {n2})", flush=True)
        l2, l1 = n2, max(1, n2 // 2)
    if measure_time:
        t1, t2 = t_cache[l1], t_cache[l2]
        fwd_ms = max(1e-4, (t2 - t1) / (l2 - l1) / bsz / 3.0)
        other_ms = max(0.0, (t1 - fwd_ms * 3.0 * bsz * l1) / bsz / 3.0)
    else:
        fwd_ms, other_ms = 1.0, 0.1
    moe_tfrac = (_expert_time_fraction(cfg, bsz, seq, l2, fwd_ms, device)
                 if measure_time and cfg.moe_experts > 0 else None)
    b1, b2 = b_cache[l1], b_cache[l2]
    act_mb = (b2 - b1) / (l2 - l1) / bsz / 1e6 if b2 > b1 else _act_fallback_mb(cfg, seq)
    act_curve = {1: float(act_mb)}
    for t in (2, 4, 8):
        act_curve[t] = float(act_mb / t)
    print(f"profile: layer counts ({l1}, {l2}) on {device}; activation measure: "
          f"{act_measure(device)}", flush=True)
    p_layer = layer_param_count(cfg)
    # MoE: the expert-stack parameter fraction and the dispatch + combine
    # volume (bf16, each way): structural facts the measurement cannot see
    moe_frac, moe_a2a = 0.0, 0.0
    if cfg.moe_experts > 0:
        moe_frac = moe_expert_params(cfg) / p_layer
        moe_a2a = 2.0 * seq * cfg.hidden_size * 2 / 1e6

    costs = ProfiledModelCosts(
        layer_types={
            0: ProfiledLayerType(
                fwd_ms_per_sample=float(fwd_ms),
                parameter_mb=float(p_layer * 4 / 1e6),
                activation_mb_per_sample=act_curve,
                boundary_activation_mb_per_sample=float(seq * cfg.hidden_size * 2 / 1e6),
                moe_expert_param_fraction=float(moe_frac),
                moe_a2a_mb_per_sample=float(moe_a2a),
                moe_expert_time_fraction=moe_tfrac,
            )
        },
        other_param_mb=float(other_param_count(cfg) * 4 / 1e6),
        # fp32 logits; a ViT's patch embedding (its class logits are tiny),
        # the term the JAX package's Swin profile and analytic costs use
        other_act_mb_per_sample=float(seq * cfg.hidden_size * 2 / 1e6 if cfg.image_size
                                      else seq * cfg.vocab_size * 4 / 1e6),
        other_fwd_ms_per_sample=float(other_ms),
        hidden_size=cfg.hidden_size,
    )
    # the vocab fit costs two zero-layer runs; measured on the card, as the
    # JAX package measures it on an accelerator and not on its CPU
    # simulation; a 'cls' model keeps the analytic terms, as there
    if measure_time and device.type == "cuda" and cfg.objective != "cls":
        vslope, vconst, vmp = profile_vocab_costs(cfg, bsz, seq=seq, device=device)
        costs.measured_vocab_slope_ms = vslope
        costs.measured_vocab_const_ms = vconst
        costs.measured_vocab_mp = vmp
        _free(device)
    _save(costs, out_prefix)
    return costs
