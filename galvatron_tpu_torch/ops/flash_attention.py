"""Flash attention for training, decode attention over a contiguous cache
and over the paged K/V pool.

Counterpart of ``galvatron_tpu/ops/flash_attention.py``: the blocked-causal
forward with fused RoPE (``_fwd_kernel_blocked``) and the combined backward
(``_bwd_kernel_blocked``), the grid forward (``_fwd_kernel``) and the grid
backward (``_bwd_dkv_kernel`` + ``_bwd_dq_kernel``) that serve every other
shape (no RoPE, non-causal, outside the blocked envelope), behind
``flash_attention_qkv`` / ``flash_attention_hm`` / ``flash_attention``,
their dispatch gates, ``decode_attention`` and ``paged_decode_attention`` /
``_paged_decode_kernel``.

Each kernel has three pieces, side by side:

- a plain PyTorch version of the kernel's function, rounding where the
  Pallas kernel rounds (:func:`flash_fwd_blocked_plain`,
  :func:`flash_bwd_blocked_plain`, :func:`flash_fwd_grid_plain`,
  :func:`flash_bwd_grid_plain`, :func:`paged_decode_attention_plain`).
  The CPU tests use it; on the card it is what the kernel is compared with;
- a wrapper (:func:`flash_fwd`, :func:`flash_bwd`, :func:`flash_grid_fwd`,
  :func:`flash_grid_bwd_parts`, :func:`paged_decode_attention`): a CPU
  tensor goes to the plain version, a CUDA tensor launches the hand-written
  Hopper kernel in ``csrc/`` or raises. There is no fall back from the card
  to the plain version;
- a launch counter on the wrapper (``flash_fwd.launches``,
  ``flash_grid_bwd_parts.dkv_launches``, ...), a plain integer incremented
  where the kernel is launched and nowhere else; beside it, where a kernel
  has a TMA route, a count per route (``flash_fwd.routes``,
  ``flash_bwd.routes``, ``flash_grid_fwd.routes``,
  ``flash_grid_bwd_parts.dkv_routes`` / ``.dq_routes``: ``tma`` or
  ``cuda_core``, as the C entry reports it), so the fast route cannot
  vanish unnoticed; the grid kernels also count their launches by shape and
  mask (``flash_grid_fwd.modes``, ``flash_grid_bwd_parts.dkv_modes`` /
  ``.dq_modes``, keyed ``"b,h,s,causal"`` or ``"b,h,s,unmasked"``), so a
  ring's past hops count apart from its diagonal ones; and every wrapper
  counts its launches by operand dtype (``flash_fwd.dtypes``,
  ``flash_grid_fwd.dtypes``, ``flash_grid_bwd_parts.dkv_dtypes`` /
  ``.dq_dtypes``, ``paged_decode_attention.dtypes``: ``str(torch.dtype)``).

Every kernel takes fp32, bf16 and fp16, as the reference's take any float
dtype, rounding at fp16 where the bf16 instances round at bf16. The TMA
routes by kernel family (:func:`_tma_blocked`, :func:`_tma_grid`):

- the blocked pair (``flash_fwd``, ``flash_bwd``): bf16 and fp16 at head_dim
  64 / 128, the shared mainloops instantiated for each element type
  (``.bf16`` or ``.f16`` operands, fp32 accumulation);
- the grid kernels (``flash_grid_fwd``, ``flash_grid_bwd_parts``): bf16 at
  head_dim 64 / 128; fp16 runs their CUDA-core instances, as do
  ``paged_decode_attention`` (no TMA route) and every kernel at fp32 or at
  another head dim.

The forwards on a TMA route run one shared Hopper mainloop
(``csrc/flash_fwd_common.cuh``): with RoPE a pre-pass ropes k once per call
into a scratch the wrapper allocates (:func:`rope_k_plain` is its plain
twin), then a TMA-fed ``wgmma`` kernel walks 128-key tiles
(:func:`flash_fwd_tiles_plain` is the plain twin of the grid kernel's
walk). The backwards on a TMA route (``flash_bwd`` and the grid dk/dv and
dq kernels) run another (``csrc/flash_bwd_common.cuh``): a pre-pass ropes q
and k once per call into scratches the wrapper allocates
(:func:`flash_bwd_prepass_plain` is its plain twin), then TMA-fed
``wgmma`` kernels walk the tiles (:func:`flash_bwd_tiles_plain` is the
plain twin of their decomposition).

The training entries are ``torch.autograd.Function``s, as the reference's
are ``jax.custom_vjp``s: :class:`FlashQKV` over the stacked (b, 3, h, s, d)
projection and :class:`FlashHM` over separate head-major q/k/v (GQA); each
takes the blocked kernels where the reference's gates do and the grid
kernels elsewhere.

For the paged op, in detail:

- :func:`paged_decode_attention_plain`: the plain PyTorch version of the
  kernel's function (gather the pages, upcast to fp32, mask, softmax,
  accumulate, cast). The CPU tests use it; on the card it is what the
  kernel is compared with.
- :func:`paged_decode_attention`: the wrapper. A CPU tensor goes to the
  plain version; a CUDA tensor launches the hand-written Hopper kernel
  ``csrc/paged_decode.cu`` or raises. There is no fall back from the card
  to the plain version.
- ``paged_decode_attention.launches``: a plain integer, incremented where
  the wrapper launches the kernel and nowhere else, so a run can show that
  its decode steps went through the kernel (one count per call: the split
  kernel and its combine).
- :func:`_paged_splits`, the kernel's split plan (shapes only), and
  :func:`paged_decode_split_plain`, a plain twin of its split-and-combine
  arithmetic that the tests hold to the reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from galvatron_tpu_torch.ops import _build

#: shared memory one thread block may use on Hopper (227 KB)
_MAX_SMEM_BYTES = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the dtypes every kernel takes, as the reference's take any float dtype
#: (the TMA routes: :func:`_tma_blocked`, :func:`_tma_grid`)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: The routes a C entry reports, by index (``flash::Route`` in
#: ``csrc/flash_common.cuh``): the CUDA-core kernels (fp32, other head dims,
#: operands a tensor map cannot take) or the TMA + wgmma kernels. Each
#: wrapper with a TMA route counts its calls by route in ``.routes``, beside
#: ``.launches``.
ROUTES = ("cuda_core", "tma")

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # log2(e)
LN2 = 0.6931471805599453  # 1/log2(e)

# ---------------------------------------------------------------------------
# Dispatch gates, copied with their constants from the reference so a shape
# takes the blocked path here exactly when it does there. The reference
# sizes its s·d envelopes from a VMEM budget (GALVATRON_FLASH_VMEM_MB,
# default 64 MB); the port keeps the envelopes that default gives.
# ---------------------------------------------------------------------------

_VMEM_EFF_MB = 64


def _seq_envelope(mb_per_sxd, candidates, floor, budget_mb=None):
    """Largest s·d envelope whose estimated charge (1.1× safety) fits the
    budget; the floor is the envelope proven under a 16 MB budget, and a
    budget below even that disables the blocked path (0)."""
    budget = _VMEM_EFF_MB if budget_mb is None else budget_mb
    for sxd in candidates + (floor,):
        if budget >= mb_per_sxd * sxd * 1.1:
            return sxd
    return 0


_FWD_MB_PER_SXD = 24.0 / (8192 * 128)
_BLOCKED_MAX_SEQ_X_DIM = _seq_envelope(_FWD_MB_PER_SXD, (8192 * 128,), 4096 * 128)
_BLOCKED_MAX_UNROLL = 8
_BWD_BQ_SUB = 256
_BWD_BK = 512
_BWD_MB_PER_SXD = 21.4 / (4096 * 128)
_BWD_MAX_SEQ_X_DIM = _seq_envelope(_BWD_MB_PER_SXD, (8192 * 128, 4096 * 128), 2048 * 128)


def flash_tileable(s: int, block: int = 1024) -> bool:
    """True when a (…, s, …) shape takes a kernel path (no einsum
    fallback): the one tileability predicate of the reference."""
    return s % min(block, s) == 0


def _use_blocked(s, d, causal, rope, block_q, block_k) -> bool:
    return (
        causal
        and rope is not None
        and block_q == block_k
        and s % block_q == 0
        and s * d <= _BLOCKED_MAX_SEQ_X_DIM
        and s // block_q <= _BLOCKED_MAX_UNROLL
    )


def _bwd_blocks(block_q):
    """(bk, bq_sub) of the reference's combined backward for ``block_q``."""
    bk = min(_BWD_BK, block_q)
    return bk, min(_BWD_BQ_SUB, bk)


def _use_blocked_bwd(s, d, causal, rope, block_q, block_k) -> bool:
    bk, bq_sub = _bwd_blocks(block_q)
    return (
        _use_blocked(s, d, causal, rope, block_q, block_k)
        and s * d <= _BWD_MAX_SEQ_X_DIM
        and s % bk == 0
        and bk % bq_sub == 0
    )


def flash_qkv_supported(s: int, d: int, causal: bool, rope, block_q: int = 1024) -> bool:
    """Whether the stacked-qkv blocked path applies (modeling's gate)."""
    return _use_blocked(s, d, causal, rope, min(block_q, s), min(block_q, s))


# ---------------------------------------------------------------------------
# Blocked-causal forward / backward: plain versions
# ---------------------------------------------------------------------------


def _rope_f32(x, c, s):
    """Rotate-half RoPE of (..., s, d) rows against (s, d/2) fp32 tables,
    in fp32 (the reference's ``_rope_rows``)."""
    xf = x.float()
    d2 = xf.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rope_t_f32(y, c, s):
    """The transpose rotation (``_rope_rows_t``): gradients w.r.t. roped
    rows back to gradients w.r.t. the raw rows."""
    d2 = y.shape[-1] // 2
    y1, y2 = y[..., :d2], y[..., d2:]
    return torch.cat([y1 * c + y2 * s, y2 * c - y1 * s], dim=-1)


def rope_k_plain(k, cos, sin):
    """The TMA forward's k pre-pass in plain PyTorch: k (b, kv heads, s, d)
    roped through the unscaled tables and rounded to k's dtype (the
    reference's ``_rope_rows(k, ck, sk).astype(k.dtype)``), contiguous."""
    return _rope_f32(k, cos, sin).to(k.dtype).contiguous()


def rope_q_scaled_plain(q, cos, sin, sm_scale):
    """q (b, h, s, d) roped through tables pre-scaled by sm_scale·log2e (one
    fp32 product each) and rounded to q's dtype, contiguous: the reference's
    ``_rope_rows(q, cos·lam, sin·lam).astype(q.dtype)``, the blocked kernels'
    q operand."""
    lam = sm_scale * LOG2E
    return _rope_f32(q, cos * lam, sin * lam).to(q.dtype).contiguous()


def flash_bwd_prepass_plain(q, k, do, out, cos, sin, sm_scale):
    """The TMA backward's pre-pass in plain PyTorch: (q', k', delta) with
    q' = :func:`rope_q_scaled_plain`, k' = :func:`rope_k_plain` and the fp32
    ``delta = Σ do·out`` per row, (b, h, s). ``csrc/flash_bwd_common.cuh``
    writes the same three into the scratches the kernels then read."""
    delta = (do.float() * out.float()).sum(dim=-1)
    return rope_q_scaled_plain(q, cos, sin, sm_scale), rope_k_plain(k, cos, sin), delta


def _causal_keep(s: int, device):
    r = torch.arange(s, device=device)
    return r[:, None] >= r[None, :]


def flash_fwd_blocked_plain(q, k, v, cos, sin, sm_scale, kv_rep: int = 1):
    """The blocked-causal forward in plain PyTorch. q (b, h, s, d); k/v
    (b, h / kv_rep, s, d); cos/sin (s, d/2) fp32. Returns (out in q's
    dtype, fp32 lse (b, h, s, 1)).

    Rounds where ``_fwd_kernel_blocked`` rounds: q roped in fp32 through
    tables pre-scaled by sm_scale·log2e and cast to the input dtype, k roped
    through the unscaled tables and cast, base-2 scores in fp32, p cast to
    the input dtype before the PV product, ``lse = m·ln2 + log(l)``. The
    softmax runs over the whole row at once (the kernels walk it in tiles;
    only p's rounding point relative to the running max differs)."""
    dt = q.dtype
    qs = rope_q_scaled_plain(q, cos, sin, sm_scale).float()
    kr = rope_k_plain(k, cos, sin).float()
    vf = v.float()
    if kv_rep > 1:
        kr = kr.repeat_interleave(kv_rep, dim=1)
        vf = vf.repeat_interleave(kv_rep, dim=1)
    s2 = qs @ kr.transpose(-1, -2)
    s2 = s2.masked_fill(~_causal_keep(q.shape[2], q.device), NEG_INF)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = ((p.to(dt).float() @ vf) / l).to(dt)
    return out, m * LN2 + torch.log(l)


def flash_bwd_blocked_plain(q, k, v, do, out, lse, cos, sin, sm_scale):
    """The combined blocked-causal backward in plain PyTorch, all of q/k/v
    at h heads (GQA callers broadcast k/v first). Returns (dq, dk, dv) in
    q's dtype.

    Rounds where ``_bwd_kernel_blocked`` rounds: p recomputed from lse in
    base 2, ``dv = p(input dtype)ᵀ·do``, ``ds = p·(dp − delta)`` cast to the
    input dtype, ``dk = rope_t(LN2 · dsᵀ·q_scaled)`` and ``dq = rope_t(
    sm_scale · ds·k_roped)``, both counter-rotated with the unscaled
    tables."""
    dt = q.dtype
    qs = rope_q_scaled_plain(q, cos, sin, sm_scale).float()
    kr = rope_k_plain(k, cos, sin).float()
    dof = do.float()
    s2 = qs @ kr.transpose(-1, -2)
    s2 = s2.masked_fill(~_causal_keep(q.shape[2], q.device), NEG_INF)
    p = torch.exp2(s2 - lse.reshape(*lse.shape[:3], 1).float() * LOG2E)
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dk = _rope_t_f32((ds.transpose(-1, -2) @ qs) * LN2, cos, sin)
    dq = _rope_t_f32((ds @ kr) * sm_scale, cos, sin)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_bwd_plain(q, k, v, do, out, lse, cos, sin, sm_scale, kv_rep: int = 1, grads=None):
    """:func:`flash_bwd`'s plain route, with its signature: k/v broadcast to
    h heads, :func:`flash_bwd_blocked_plain`, and the results copied into
    ``grads`` when given."""
    if kv_rep > 1:
        k = k.repeat_interleave(kv_rep, dim=1)
        v = v.repeat_interleave(kv_rep, dim=1)
    res = flash_bwd_blocked_plain(q, k, v, do, out, lse, cos, sin, sm_scale)
    return _into(grads, res)


def _into(grads, res):
    """``res`` copied into the given output tensors, or ``res`` itself."""
    if grads is None:
        return res
    for dst, src in zip(grads, res):
        dst.copy_(src)
    return grads


# ---------------------------------------------------------------------------
# Grid forward / backward: plain versions
# ---------------------------------------------------------------------------


def _grid_keep(s: int, causal: bool, device):
    """The grid kernels' mask: causal below the diagonal, none otherwise."""
    return _causal_keep(s, device) if causal else None


def _grid_operands(q, k, rope):
    """q and k as the grid kernels multiply them: roped through the
    unscaled tables and rounded to the input dtype when ``rope`` is given,
    then read as fp32."""
    if rope is not None:
        q = _rope_f32(q, *rope).to(q.dtype)
        k = _rope_f32(k, *rope).to(k.dtype)
    return q.float(), k.float()


def _grid_scores(qf, kf, sm_scale, causal):
    """Base-2 scores ``(q·kᵀ) · sm_scale·log2e``, the scale after the
    product (``_fwd_kernel``), masked with -1e30 above the diagonal."""
    s2 = (qf @ kf.transpose(-1, -2)) * (sm_scale * LOG2E)
    keep = _grid_keep(qf.shape[2], causal, qf.device)
    return s2 if keep is None else s2.masked_fill(~keep, NEG_INF)


def flash_fwd_grid_plain(q, k, v, rope, sm_scale, causal, kv_rep: int = 1, out_dtype=None):
    """The grid forward in plain PyTorch. q (b, h, s, d); k/v
    (b, h / kv_rep, s, d); ``rope`` None or (cos, sin) (s, d/2) fp32.
    Returns (out in ``out_dtype`` or q's dtype, fp32 lse (b, h, s, 1)).

    Rounds where ``_fwd_kernel`` rounds, which is not where the blocked
    kernel does: q and k roped through the unscaled tables and cast to the
    input dtype, scores scaled by sm_scale·log2e after the fp32 product, p
    cast to the input dtype before the PV product, ``lse = m·ln2 +
    log(max(l, 1e-30))``. Non-causal runs unmasked. The softmax takes the
    whole row at once."""
    dt = q.dtype
    qf, kf = _grid_operands(q, k, rope)
    vf = v.float()
    if kv_rep > 1:
        kf = kf.repeat_interleave(kv_rep, dim=1)
        vf = vf.repeat_interleave(kv_rep, dim=1)
    s2 = _grid_scores(qf, kf, sm_scale, causal)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = ((p.to(dt).float() @ vf) / l).to(out_dtype or dt)
    return out, m * LN2 + torch.log(l)


#: rows of the query blocks and key tiles of the TMA forward (``kRows`` and
#: ``Cfg<D>::BN`` of ``csrc/flash_fwd_common.cuh``)
_FWD_TILE = 128


def flash_fwd_tiles_plain(q, k, v, rope, sm_scale, causal, kv_rep: int = 1, out_dtype=None):
    """The grid forward's TMA kernel in plain PyTorch, a test twin of
    ``csrc/flash_fwd_common.cuh`` with GRID true: per 128-query block, the
    online softmax over 128-key tiles in the kernel's order (causal: up to
    the block's last query; otherwise all of them, the last one ragged at an
    s no tile divides), at ``_fwd_kernel``'s rounding points: q and k roped
    through the unscaled tables and cast to the input dtype when ``rope`` is
    given, scores ``(q·kᵀ)·sm_scale·log2e`` in fp32 with the scale after the
    product, p cast to the input dtype before the PV product against the
    running max, ``out = acc / max(l, 1e-30)`` in ``out_dtype`` or q's dtype
    and ``lse = m·ln2 + log(max(l, 1e-30))``. Shapes and returns as
    :func:`flash_fwd_grid_plain`."""
    dt = q.dtype
    b, h, s, d = q.shape
    qf, kf = _grid_operands(q, k, rope)
    vf = v.float()
    if kv_rep > 1:
        kf = kf.repeat_interleave(kv_rep, dim=1)
        vf = vf.repeat_interleave(kv_rep, dim=1)
    lam = sm_scale * LOG2E
    pos = torch.arange(s, device=q.device)
    out = torch.empty(b, h, s, d, dtype=out_dtype or dt, device=q.device)
    lse = torch.empty(b, h, s, 1, device=q.device)
    for q0 in range(0, s, _FWD_TILE):
        q1 = min(q0 + _FWD_TILE, s)
        m = torch.full((b, h, q1 - q0, 1), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, q1 - q0, d, device=q.device)
        for k0 in range(0, q1 if causal else s, _FWD_TILE):
            k1 = min(k0 + _FWD_TILE, s)
            sc = (qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)) * lam
            if causal:
                sc = sc.masked_fill(pos[q0:q1, None] < pos[None, k0:k1], NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp2(sc - m_new)
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p.to(dt).float() @ vf[:, :, k0:k1]
            m = m_new
        lc = l.clamp_min(1e-30)
        out[:, :, q0:q1] = (acc / lc).to(out.dtype)
        lse[:, :, q0:q1] = m * LN2 + torch.log(lc)
    return out, lse


def flash_bwd_grid_plain(q, k, v, do, lse, delta, rope, sm_scale, causal):
    """The grid backward (``_flash_bwd_parts``) in plain PyTorch, all of
    q/k/v at h heads; lse and ``delta = Σ do·out`` (both fp32 (b, h, s, 1))
    come from the caller. Returns (dq, dk, dv) in q's dtype.

    Rounds where ``_bwd_dkv_kernel`` / ``_bwd_dq_kernel`` round: p
    recomputed in base 2 from the grid scores and lse, ``dv = p(input
    dtype)ᵀ·do``, ``ds = p·(dp − delta)`` cast to the input dtype,
    ``dk = rope_t(sm_scale · dsᵀ·q_roped)`` and ``dq = rope_t(sm_scale ·
    ds·k_roped)`` (no rotation without ``rope``)."""
    dt = q.dtype
    qf, kf = _grid_operands(q, k, rope)
    dof = do.float()
    s2 = _grid_scores(qf, kf, sm_scale, causal)
    p = torch.exp2(s2 - lse.float() * LOG2E)
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta.float())).to(dt).float()
    dk = (ds.transpose(-1, -2) @ qf) * sm_scale
    dq = (ds @ kf) * sm_scale
    if rope is not None:
        dk = _rope_t_f32(dk, *rope)
        dq = _rope_t_f32(dq, *rope)
    return dq.to(dt), dk.to(dt), dv.to(dt)


#: rows one block of the TMA backward kernels owns (two warpgroups of 64,
#: ``kOwn`` of ``csrc/flash_bwd_common.cuh``)
_BWD_OWN = 128


def _bwd_walk(d: int) -> int:
    """Rows of the tiles the TMA backward kernels walk at head_dim ``d``
    (``Cfg<D>::W`` of ``csrc/flash_bwd_common.cuh``)."""
    return 64 if d == 128 else 128


def flash_bwd_tiles_plain(q_op, k_op, v, do, lse, delta, sm_scale, causal=True, grid=False,
                          rope=None, walk=None):
    """The TMA backward kernels' decomposition in plain PyTorch, a test twin
    of ``csrc/flash_bwd_common.cuh``. ``q_op`` / ``k_op`` are the operands
    as the kernels multiply them (the pre-pass's q', k', or raw q and k for
    the grid without RoPE), all of q/k/v/do at h heads; lse and delta fp32
    (b, h, s, 1). dk/dv are summed per 128-key block over ``walk``-row query
    tiles in the kernel's order (causal: from the tile holding the block's
    first key), dq per 128-query block over ``walk``-key tiles up to the
    block's last query; pairs past s or above the diagonal are masked. The
    blocked scores (``grid`` False) come from q' that carries the scale, the
    grid ones are scaled by sm_scale·log2e after the product. p and ds are
    rounded to the input dtype before their products; dk is then scaled by
    ln 2 (blocked) or sm_scale (grid), dq by sm_scale, both counter-rotated
    through ``rope`` (unscaled tables) when given. The blocked dq kernel
    (only: not the dk/dv kernel, nor the grid's) sums each diagonal dp_ii
    as the pre-pass sums delta_i, do_i · v_i in place of the product's
    entry, so query 0's ds (whose exact value is 0: out_0 is v_0) is 0 here
    as there. Returns (dq, dk, dv) in the input dtype."""
    dt = q_op.dtype
    b, h, s, d = q_op.shape
    walk = walk or _bwd_walk(d)
    qf, kf, vf, dof = (t.float() for t in (q_op, k_op, v, do))
    lse2 = lse.float().reshape(b, h, s, 1) * LOG2E
    dl = delta.float().reshape(b, h, s, 1)
    pos = torch.arange(s, device=q_op.device)

    def p_ds(q0, q1, k0, k1, diag=False):
        sc = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)
        if grid:
            sc = sc * (sm_scale * LOG2E)
        p = torch.exp2(sc - lse2[:, :, q0:q1])
        if causal:
            p = p.masked_fill(pos[q0:q1, None] < pos[None, k0:k1], 0.0)
        dp = dof[:, :, q0:q1] @ vf[:, :, k0:k1].transpose(-1, -2)
        lo, hi = max(q0, k0), min(q1, k1)
        if diag and lo < hi:  # the diagonal in the pre-pass's delta order
            i = pos[lo:hi]
            dp[:, :, i - q0, i - k0] = (dof[:, :, lo:hi] * vf[:, :, lo:hi]).sum(dim=-1)
        ds = p * (dp - dl[:, :, q0:q1])
        return p.to(dt).float(), ds.to(dt).float()

    dq, dk, dv = (torch.zeros(b, h, s, d, device=q_op.device) for _ in range(3))
    for k0 in range(0, s, _BWD_OWN):
        k1 = min(k0 + _BWD_OWN, s)
        for q0 in range((k0 // walk) * walk if causal else 0, s, walk):
            q1 = min(q0 + walk, s)
            p, ds = p_ds(q0, q1, k0, k1)
            dv[:, :, k0:k1] += p.transpose(-1, -2) @ dof[:, :, q0:q1]
            dk[:, :, k0:k1] += ds.transpose(-1, -2) @ qf[:, :, q0:q1]
    for q0 in range(0, s, _BWD_OWN):
        q1 = min(q0 + _BWD_OWN, s)
        for k0 in range(0, q1 if causal else s, walk):
            p, ds = p_ds(q0, q1, k0, min(k0 + walk, s), diag=not grid)
            dq[:, :, q0:q1] += ds @ kf[:, :, k0:min(k0 + walk, s)]
    dk = dk * (sm_scale if grid else LN2)
    dq = dq * sm_scale
    if rope is not None:
        dk, dq = _rope_t_f32(dk, *rope), _rope_t_f32(dq, *rope)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_grid_bwd_parts_plain(q, k, v, do, lse, delta, rope, sm_scale, causal,
                               kv_rep: int = 1, grads=None):
    """:func:`flash_grid_bwd_parts`'s plain route, with its signature: k/v
    broadcast to h heads, :func:`flash_bwd_grid_plain`, and the results
    copied into ``grads`` when given."""
    if kv_rep > 1:
        k = k.repeat_interleave(kv_rep, dim=1)
        v = v.repeat_interleave(kv_rep, dim=1)
    return _into(grads, flash_bwd_grid_plain(q, k, v, do, lse, delta, rope, sm_scale, causal))


#: How far a bf16 flash kernel may lie from its plain version, as measured
#: by :func:`bf16_parity_excess` (in units of the row's rms): forward
#: (out) and backward (dq, dk, dv). Set at 2-3x the largest readings of the
#: tensor-core kernels at the training shape on an H100 (0.012 forward,
#: 0.031 backward, dq's tail; ``chip_smoke.py`` phase 3 prints them), where
#: the plain versions with one key tile dropped read 0.9 and more.
BF16_PARITY_TOL = {"fwd": 2 ** -5, "bwd": 2 ** -4}


#: fp16 results are held to the same bands, the excess measured past one fp16
#: ulp: what the bands bound is how far the two fp32 computations differ
#: before the rounding (summation order, rows that cancel), which a finer
#: storage type does not shrink. The largest reading is dq's at query 0,
#: whose exact value is 0: the plain version keeps the difference of two fp32
#: summation orders there (up to 0.042 of the floored row scale at the
#: training shape on an H100), the tensor-core kernels give 0 exactly (their
#: dq kernel sums the diagonal dp as the pre-pass sums delta). Forward 0.0013;
#: the dropped-tile control > 1.
FP16_PARITY_TOL = dict(BF16_PARITY_TOL)


def bf16_parity_excess(got, ref):
    """:func:`parity_excess` of a bf16 result (7 explicit mantissa bits)."""
    return parity_excess(got, ref, 7)


def fp16_parity_excess(got, ref):
    """:func:`parity_excess` of an fp16 result (10 explicit mantissa bits)."""
    return parity_excess(got, ref, 10)


def parity_excess(got, ref, mantissa_bits: int):
    """How far a bf16 (or fp16) kernel result ``got`` lies from its plain
    version's ``ref`` beyond the rounding both do: the largest (|got − ref|
    − ulp(ref)) over the rms of ref's row (the last dim), 0 when every
    element is within one ulp of the type (``mantissa_bits`` explicit bits).
    What follows is said of bf16; fp16's roundings are 2^-3 of its.

    Both round an fp32 value to bf16, which alone leaves them up to one ulp
    apart. What the excess measures is how far the two fp32 values differ,
    and that scales with the row, not with the element: the forward rounds
    p to bf16 against the running row max where the plain version rounds
    against the final one (each p off by up to an ulp, ~2^-8 of itself,
    so ``out`` by ~2^-8 of the row's scale at most); the backward rounds a
    ds the other way where fp32 summation order moves it across a rounding
    boundary. A kernel that skips a 64-key tile for a row of n keys moves
    that row by ~sqrt(64 / n) of its scale, far above either.

    A row whose true value cancels to zero (query 0's dq: its one key is
    itself, so ds = 0) keeps only fp32 noise; its scale is floored at 2^-10
    of the whole tensor's rms."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - mantissa_bits)
    floor = r.square().mean().sqrt().clamp_min(1e-30) * 2 ** -10
    rms = torch.maximum(r.square().mean(dim=-1, keepdim=True).sqrt(), floor)
    return max(0.0, (((got.float() - r).abs() - ulp) / rms).max().item())


# ---------------------------------------------------------------------------
# Blocked-causal forward / backward: wrappers
# ---------------------------------------------------------------------------


def _check_flash_operands(name, tensors, cos, sin, d):
    """The kernels' contract, on every device: one dtype (bf16, fp16 or fp32),
    head_dim % 8 == 0 and <= 256, one device, unit-stride head dims, and
    contiguous fp32 (s, d/2) rope tables unless ``cos`` is None (no RoPE)."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(
            f"the {name} kernel takes bf16, fp16 or fp32 operands of one dtype, got "
            f"{sorted({str(t.dtype) for t in tensors})}"
        )
    if d % 8 or d > 256:
        raise ValueError(f"the {name} kernel takes head_dim % 8 == 0 and <= 256, got {d}")
    tables = () if cos is None else (cos, sin)
    if any(t.device != dev for t in tensors + tables):
        raise ValueError(f"{name}: every operand and the rope tables must share one device")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name}: the head dim of every operand must be unit-stride")
    s = tensors[0].shape[2]
    for t in tables:
        if t.dtype != torch.float32 or tuple(t.shape) != (s, d // 2) or not t.is_contiguous():
            raise ValueError(f"{name}: rope tables must be contiguous fp32 ({s}, {d // 2})")


def _check_row_stats(name, b, h, s, **stats):
    for key, t in stats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s, 1) or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous fp32 ({b}, {h}, {s}, 1)")


def _check_kv(q, k, v, kv_rep):
    b, h, s, d = q.shape
    if k.shape != (b, h // kv_rep, s, d) or v.shape != k.shape or h % kv_rep:
        raise ValueError(f"k/v must be ({b}, {h}/{kv_rep}, {s}, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")


def _strides(*tensors):
    """(b, h, s) element strides of each (b, h, s, d) operand, flattened."""
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_fwd(q, k, v, cos, sin, sm_scale, kv_rep: int = 1):
    """Blocked-causal forward with fused RoPE: (out (b, h, s, d), fp32 lse
    (b, h, s, 1)). q (b, h, s, d), k/v (b, h / kv_rep, s, d), any strides
    with a unit-stride head dim (views of the stacked projection go in
    without a copy). CPU tensors run :func:`flash_fwd_blocked_plain`; CUDA
    tensors launch ``csrc/flash_fwd.cu``, whose ``out`` is laid out
    (b, s, h, d) in memory so the output projection reads it as is; the
    route the call took is counted in ``flash_fwd.routes``."""
    b, h, s, d = q.shape
    _check_kv(q, k, v, kv_rep)
    _check_flash_operands("flash_fwd", (q, k, v), cos, sin, d)
    if q.device.type == "cpu":
        return flash_fwd_blocked_plain(q, k, v, cos, sin, sm_scale, kv_rep)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    # roped k for the tensor-core path, written by the kernel's pre-pass
    tma = _tma_blocked(q)
    k_roped = torch.empty(k.shape, dtype=k.dtype, device=k.device) if tma else None
    launch = _entry("galvatron_flash_fwd")
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), _ptr(k_roped), _ptr(_work_counter(q, tma)),
            _strides(q, k, v, out), _DTYPE_CODE[q.dtype], b, h, kv_rep, s, d,
            float(sm_scale * LOG2E),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(route),
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    flash_fwd.routes[ROUTES[route.value]] += 1
    flash_fwd.dtypes[str(q.dtype)] += 1
    return out, lse


flash_fwd.launches = 0
flash_fwd.routes = dict.fromkeys(ROUTES, 0)
#: launches by operand dtype (``str(torch.dtype)``)
flash_fwd.dtypes = dict.fromkeys(map(str, _DTYPES), 0)


def flash_bwd(q, k, v, do, out, lse, cos, sin, sm_scale, kv_rep: int = 1,
              grads: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
    """Combined blocked-causal backward: (dq, dk, dv), each (b, h, s, d) in
    q's dtype; dk/dv are per query head (GQA callers sum them over the
    group). ``grads`` optionally gives the three outputs to write (e.g. the
    slots of a stacked dqkv). CPU tensors run :func:`flash_bwd_plain`; CUDA
    tensors launch ``csrc/flash_bwd.cu`` (one count per call in
    ``flash_bwd.launches``, the route in ``flash_bwd.routes``); two calls on
    the same inputs give the same bits."""
    b, h, s, d = q.shape
    _check_flash_operands("flash_bwd", (q, k, v, do, out), cos, sin, d)
    _check_row_stats("flash_bwd", b, h, s, lse=lse)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, out, lse, cos, sin, sm_scale, kv_rep, grads)
    dq, dk, dv = _grad_outputs("flash_bwd", q, grads)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    # roped q and k for the TMA path, written by the kernels' pre-pass
    q_roped, k_roped = _roped_scratch(q, k, _tma_blocked(q))
    launch = _entry("galvatron_flash_bwd")
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(),
            lse.data_ptr(), cos.data_ptr(), sin.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _ptr(q_roped), _ptr(k_roped),
            _strides(q, k, v, do, out, dq, dk, dv), _DTYPE_CODE[q.dtype], b, h, kv_rep, s, d,
            float(sm_scale * LOG2E), float(sm_scale), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(route),
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    flash_bwd.launches += 1
    flash_bwd.routes[ROUTES[route.value]] += 1
    flash_bwd.dtypes[str(q.dtype)] += 1
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.routes = dict.fromkeys(ROUTES, 0)
flash_bwd.dtypes = dict.fromkeys(map(str, _DTYPES), 0)


def _tma_blocked(q):
    """Whether q's dtype and head dim are those of the blocked pair's TMA
    routes (``flash_fwd`` / ``flash_bwd``: bf16 or fp16 at head_dim 64 or
    128); the C entry checks the rest (alignment, strides, the tensor maps)
    and reports the route it took."""
    return q.dtype in (torch.bfloat16, torch.float16) and q.shape[3] in (64, 128)


def _tma_grid(q):
    """Whether q's dtype and head dim are those of the grid kernels' TMA
    routes (``flash_grid_fwd`` / ``flash_grid_bwd_parts``: bf16 at head_dim
    64 or 128; fp16 takes their CUDA-core kernels); the C entries check the
    rest and report the route they took."""
    return q.dtype == torch.bfloat16 and q.shape[3] in (64, 128)


_WORK = {}


def _work_counter(q, tma: bool):
    """The persistent TMA forward's item counter for the current stream on
    q's device: two int32 (the next item, the blocks done), zero between
    calls, since the last block of each call zeroes them again. Calls on one
    stream never overlap, so one counter a stream serves them all; None when
    ``tma`` (the caller family's predicate on q) is false."""
    if not tma:
        return None
    key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
    if key not in _WORK:
        _WORK[key] = torch.zeros(2, dtype=torch.int32, device=q.device)
    return _WORK[key]


def _roped_scratch(q, k, tma: bool):
    """(q', k') scratches for a backward's TMA route, ``tma`` being the
    caller family's predicate on q: contiguous like q and like k, in their
    dtype, written by the kernels' pre-pass; (None, None) when ``tma`` is
    false."""
    if not tma:
        return None, None
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=k.device))


def _argtypes(n_ptrs: int, n_ints: int, n_floats: int):
    """ctypes argument types of a flash C entry: ``n_ptrs`` pointers, the
    strides array, ``n_ints`` ints, ``n_floats`` floats, the stream and the
    int* the entry reports its route through."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * n_ints + [ctypes.c_float] * n_floats
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


#: The flash C entries: name -> (source in ``csrc/``, ctypes argument types).
#: A list that does not match the C signature corrupts pointers silently on
#: the card; a CPU test parses each ``extern "C"`` signature against it.
_ENTRIES = {
    "galvatron_flash_fwd": ("flash_fwd", _argtypes(9, 6, 1)),
    "galvatron_flash_bwd": ("flash_bwd", _argtypes(14, 6, 2)),
    "galvatron_flash_grid_fwd": ("flash_grid_fwd", _argtypes(9, 8, 1)),
    "galvatron_flash_grid_dkv": ("flash_grid_bwd", _argtypes(13, 7, 2)),
    "galvatron_flash_grid_dq": ("flash_grid_bwd", _argtypes(13, 7, 2)),
}


def _entry(name: str):
    """The ctypes function of the C entry ``name``, its source built and
    loaded at first use."""
    lib, argtypes = _ENTRIES[name]
    fn = getattr(_build.load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _grad_outputs(name, q, grads):
    """The (dq, dk, dv) tensors a backward kernel writes: ``grads`` when
    given (e.g. the slots of a stacked dqkv), else new ones like q."""
    if grads is None:
        return tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    if any(g.shape != q.shape or g.dtype != q.dtype or g.stride(-1) != 1 for g in grads):
        raise ValueError(f"{name}: grads must match q's shape and dtype, unit-stride head dim")
    return grads


# ---------------------------------------------------------------------------
# Grid forward / backward: wrappers
# ---------------------------------------------------------------------------


def _tables(rope):
    """(cos, sin) of ``rope``, or (None, None) without RoPE."""
    return (None, None) if rope is None else rope


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count_mode(modes: dict, q, causal: bool):
    """One launch at q's (b, h, s) in its mask mode, into ``modes``."""
    b, h, s, _ = q.shape
    key = f"{b},{h},{s},{'causal' if causal else 'unmasked'}"
    modes[key] = modes.get(key, 0) + 1


def flash_grid_fwd(q, k, v, rope, sm_scale, causal: bool, kv_rep: int = 1, out_dtype=None):
    """Grid forward (``_flash_fwd``): (out (b, h, s, d), fp32 lse
    (b, h, s, 1)). q (b, h, s, d), k/v (b, h / kv_rep, s, d), any strides
    with a unit-stride head dim; ``rope`` None or (cos, sin); ``out_dtype``
    None (q's dtype) or fp32 (ring attention's per-hop outputs). CPU tensors
    run :func:`flash_fwd_grid_plain`; CUDA tensors launch
    ``csrc/flash_grid_fwd.cu``, whose ``out`` is laid out (b, s, h, d) in
    memory so the output projection reads it as is; the route the call took
    is counted in ``flash_grid_fwd.routes``."""
    b, h, s, d = q.shape
    _check_kv(q, k, v, kv_rep)
    cos, sin = _tables(rope)
    _check_flash_operands("flash_grid_fwd", (q, k, v), cos, sin, d)
    if out_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f"flash_grid_fwd: out_dtype must be None, {q.dtype} or fp32")
    if q.device.type == "cpu":
        return flash_fwd_grid_plain(q, k, v, rope, sm_scale, causal, kv_rep, out_dtype)
    out_dtype = out_dtype or q.dtype
    out = torch.empty((b, s, h, d), dtype=out_dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    # roped k for the bf16 TMA route with RoPE, written by the kernel's pre-pass
    tma = _tma_grid(q)
    k_roped = (torch.empty(k.shape, dtype=k.dtype, device=k.device)
               if rope is not None and tma else None)
    launch = _entry("galvatron_flash_grid_fwd")
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _ptr(cos), _ptr(sin), _ptr(k_roped), _ptr(_work_counter(q, tma)),
            _strides(q, k, v, out), _DTYPE_CODE[q.dtype],
            int(out_dtype == torch.float32), int(causal), b, h, kv_rep, s, d,
            float(sm_scale * LOG2E), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(route),
        )
    if err != 0:
        raise RuntimeError(f"flash_grid_fwd kernel launch failed: CUDA error {err}")
    flash_grid_fwd.launches += 1
    flash_grid_fwd.routes[ROUTES[route.value]] += 1
    flash_grid_fwd.dtypes[str(q.dtype)] += 1
    _count_mode(flash_grid_fwd.modes, q, causal)
    return out, lse


flash_grid_fwd.launches = 0
flash_grid_fwd.routes = dict.fromkeys(ROUTES, 0)
flash_grid_fwd.dtypes = dict.fromkeys(map(str, _DTYPES), 0)
flash_grid_fwd.modes = {}


def flash_grid_bwd_parts(q, k, v, do, lse, delta, rope, sm_scale, causal: bool,
                         kv_rep: int = 1,
                         grads: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
    """Grid backward given the row statistics (``_flash_bwd_parts``): lse
    and ``delta = Σ do·out``, both contiguous fp32 (b, h, s, 1), may be
    global ones (ring attention). Returns (dq, dk, dv), each (b, h, s, d) in
    q's dtype; dk/dv are per query head (GQA callers sum them over the
    group). ``grads`` optionally gives the three outputs to write. CPU
    tensors run :func:`flash_bwd_grid_plain`; CUDA tensors launch the dk/dv
    kernel, then the dq kernel, of ``csrc/flash_grid_bwd.cu``, each counted
    once a call (``.dkv_launches``, ``.dq_launches``) and by its route
    (``.dkv_routes``, ``.dq_routes``). With RoPE on the bf16 TMA route the
    dk/dv call's pre-pass ropes q and k once into scratches allocated here,
    and the dq kernel reads them."""
    b, h, s, d = q.shape
    _check_kv(q, k, v, kv_rep)
    cos, sin = _tables(rope)
    _check_flash_operands("flash_grid_bwd", (q, k, v, do), cos, sin, d)
    _check_row_stats("flash_grid_bwd", b, h, s, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_grid_bwd_parts_plain(q, k, v, do, lse, delta, rope, sm_scale, causal,
                                          kv_rep, grads)
    dq, dk, dv = _grad_outputs("flash_grid_bwd", q, grads)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(cos), _ptr(sin), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    rest = (_strides(q, k, v, do, dq, dk, dv), _DTYPE_CODE[q.dtype], int(causal), b, h, kv_rep,
            s, d, float(sm_scale * LOG2E), float(sm_scale))
    # roped q and k for the bf16 TMA route with RoPE: the dk/dv call's
    # pre-pass writes them, the dq call reads them
    q_roped, k_roped = _roped_scratch(q, k, rope is not None and _tma_grid(q))
    dkv_route, dq_route = ctypes.c_int(-1), ctypes.c_int(-1)
    dkv, dqk = _entry("galvatron_flash_grid_dkv"), _entry("galvatron_flash_grid_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = dkv(*ptrs, _ptr(q_roped), _ptr(k_roped), *rest, stream, ctypes.byref(dkv_route))
        if err != 0:
            raise RuntimeError(f"flash_grid_bwd dkv kernel launch failed: CUDA error {err}")
        flash_grid_bwd_parts.dkv_launches += 1
        flash_grid_bwd_parts.dkv_routes[ROUTES[dkv_route.value]] += 1
        flash_grid_bwd_parts.dkv_dtypes[str(q.dtype)] += 1
        _count_mode(flash_grid_bwd_parts.dkv_modes, q, causal)
        if ROUTES[dkv_route.value] != "tma":  # no pre-pass ran: nothing to read
            q_roped = k_roped = None
        err = dqk(*ptrs, _ptr(q_roped), _ptr(k_roped), *rest, stream, ctypes.byref(dq_route))
        if err != 0:
            raise RuntimeError(f"flash_grid_bwd dq kernel launch failed: CUDA error {err}")
        flash_grid_bwd_parts.dq_launches += 1
        flash_grid_bwd_parts.dq_routes[ROUTES[dq_route.value]] += 1
        flash_grid_bwd_parts.dq_dtypes[str(q.dtype)] += 1
        _count_mode(flash_grid_bwd_parts.dq_modes, q, causal)
    return dq, dk, dv


flash_grid_bwd_parts.dkv_launches = 0
flash_grid_bwd_parts.dq_launches = 0
flash_grid_bwd_parts.dkv_routes = dict.fromkeys(ROUTES, 0)
flash_grid_bwd_parts.dq_routes = dict.fromkeys(ROUTES, 0)
flash_grid_bwd_parts.dkv_dtypes = dict.fromkeys(map(str, _DTYPES), 0)
flash_grid_bwd_parts.dq_dtypes = dict.fromkeys(map(str, _DTYPES), 0)
flash_grid_bwd_parts.dkv_modes = {}
flash_grid_bwd_parts.dq_modes = {}


# ---------------------------------------------------------------------------
# Autograd entries (the reference's custom_vjp pairs)
# ---------------------------------------------------------------------------


def _unit_stride(t):
    """An incoming gradient may be an expanded view (stride 0 on the
    head dim, e.g. from ``out.sum()``); the kernels need a unit-stride head
    dim and take any other strides."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _grid_bwd(q, k, v, do, out, lse, rope, sm_scale, causal, kv_rep=1, grads=None):
    """``_flash_bwd``: delta = Σ do·out in fp32 (a torch reduction, as the
    reference computes it outside Pallas), then the grid dk/dv and dq
    kernels."""
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True).contiguous()
    return flash_grid_bwd_parts(q, k, v, do, lse, delta, rope, sm_scale, causal, kv_rep, grads)


class FlashQKV(torch.autograd.Function):
    """Stacked entry (``_flash_qkv``): the forward reads q/k/v as views of
    the (b, 3, h, s, d) projection output, saves (qkv, out, lse) and the
    backward writes a stacked dqkv with qkv's own strides, so neither side
    copies. The backward takes the grid kernels where the blocked backward's
    gate fails, as ``_flash_qkv_bwd_rule`` does."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, sm_scale, block_q):
        out, lse = flash_fwd(qkv[:, 0], qkv[:, 1], qkv[:, 2], cos, sin, sm_scale)
        ctx.save_for_backward(qkv, out, lse, cos, sin)
        ctx.sm_scale, ctx.block_q = sm_scale, block_q
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse, cos, sin = ctx.saved_tensors
        do = _unit_stride(do)
        dqkv = torch.empty_like(qkv)  # keeps qkv's strides
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        grads = (dqkv[:, 0], dqkv[:, 1], dqkv[:, 2])
        s, d = qkv.shape[3], qkv.shape[4]
        if _use_blocked_bwd(s, d, True, (cos, sin), ctx.block_q, ctx.block_q):
            flash_bwd(q, k, v, do, out, lse, cos, sin, ctx.sm_scale, grads=grads)
        else:
            _grid_bwd(q, k, v, do, out, lse, (cos, sin), ctx.sm_scale, True, grads=grads)
        return dqkv, None, None, None, None


class FlashHM(torch.autograd.Function):
    """Head-major entry (``_flash``): k/v may carry h / kv_rep heads; the
    forward maps head h to kv head h // kv_rep, the backward computes dk/dv
    per query head and sums them over the group (``_flash_bwd_rule``).
    Blocked kernels where the reference's gates take them
    (``_fwd_dispatch``, ``_use_blocked_bwd``), grid kernels elsewhere."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, sm_scale, causal, block_q, block_k):
        kv_rep = q.shape[1] // k.shape[1]
        rope = None if cos is None else (cos, sin)
        if _use_blocked(q.shape[2], q.shape[3], causal, rope, block_q, block_k):
            out, lse = flash_fwd(q, k, v, cos, sin, sm_scale, kv_rep)
        else:
            out, lse = flash_grid_fwd(q, k, v, rope, sm_scale, causal, kv_rep)
        ctx.save_for_backward(q, k, v, out, lse, cos, sin)
        ctx.sm_scale, ctx.causal, ctx.kv_rep = sm_scale, causal, kv_rep
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, cos, sin = ctx.saved_tensors
        rope = None if cos is None else (cos, sin)
        do = _unit_stride(do)
        s, d = q.shape[2], q.shape[3]
        if _use_blocked_bwd(s, d, ctx.causal, rope, *ctx.blocks):
            dq, dk, dv = flash_bwd(q, k, v, do, out, lse, cos, sin, ctx.sm_scale, ctx.kv_rep)
        else:
            dq, dk, dv = _grid_bwd(q, k, v, do, out, lse, rope, ctx.sm_scale, ctx.causal,
                                   ctx.kv_rep)
        if ctx.kv_rep > 1:
            b, h, s, d = dk.shape
            dk = dk.reshape(b, h // ctx.kv_rep, ctx.kv_rep, s, d).sum(dim=2)
            dv = dv.reshape(b, h // ctx.kv_rep, ctx.kv_rep, s, d).sum(dim=2)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_qkv(qkv, sm_scale=None, block_q: int = 1024, rope=None):
    """Stacked head-major entry: ``qkv`` is the fused projection's
    (b, 3, h, s, d) output (any strides with a unit-stride head dim),
    causal with fused RoPE only; returns (b, h, s, d). Callers gate on
    :func:`flash_qkv_supported`; a shape outside it raises ``ValueError``."""
    s, d = qkv.shape[3], qkv.shape[4]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    block_q = min(block_q, s)
    if rope is None or not _use_blocked(s, d, True, rope, block_q, block_q):
        raise ValueError(f"flash_attention_qkv at s={s}, d={d} is outside the blocked-causal "
                         "RoPE envelope: gate on flash_qkv_supported")
    return FlashQKV.apply(qkv, rope[0], rope[1], float(sm_scale), block_q)


def flash_attention_hm(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                       block_q: int = 1024, block_k: int = 1024, rope=None):
    """Head-major entry: q (b, h, s, d), k/v (b, kv_heads, s, d) with
    h % kv_heads == 0 (GQA-native); returns (b, h, s, d). Untileable shapes
    fall back through :func:`flash_attention`'s einsum path, as in the
    reference."""
    b, h, s, d = q.shape
    if h % k.shape[1]:
        raise ValueError(f"heads {h} not divisible by kv_heads {k.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if not flash_tileable(s, block_q) or not flash_tileable(s, block_k):
        rep = h // k.shape[1]
        if rep > 1:  # the (B, S, H, D) fallback expects repeated K/V
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, sm_scale=sm_scale, block_q=block_q,
                              block_k=block_k, rope=rope)
        return out.transpose(1, 2)
    cos, sin = _tables(rope)
    return FlashHM.apply(q, k, v, cos, sin, float(sm_scale), bool(causal), block_q, block_k)


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024, rope=None):
    """(B, S, n, d) entry (the reference's ``flash_attention``); GQA callers
    repeat k/v first. One query row goes to :func:`decode_attention`
    (causal and full masks coincide); an untileable s to the einsum path,
    honouring the caller's mask and scale; everything else to the kernels
    through :class:`FlashHM`."""
    b, s, n, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if s == 1:
        if rope is not None:
            q, k = (_rope_f32(t, rope[0][:, None], rope[1][:, None]).to(t.dtype) for t in (q, k))
        return decode_attention(q, k, v, q_offset=k.shape[1] - 1, sm_scale=sm_scale)
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if not flash_tileable(s, block_q) or not flash_tileable(s, block_k):
        if rope is not None:
            q, k = (_rope_f32(t, rope[0][:, None], rope[1][:, None]).to(t.dtype) for t in (q, k))
        # the einsum path divides by sqrt(d): pre-scale q to express sm_scale
        q = q * torch.tensor(sm_scale * math.sqrt(d), dtype=q.dtype)
        return _einsum_attention(q, k, v, causal)
    cos, sin = _tables(rope)
    out = FlashHM.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), cos, sin,
                        float(sm_scale), bool(causal), block_q, block_k)
    return out.transpose(1, 2)


def _einsum_attention(q, k, v, causal: bool):
    """The reference's ``attention_xla`` over (B, S, n, d) with n heads on
    all three: scores in fp32 over sqrt(d), the -1e30 causal mask, softmax,
    probabilities cast to q's dtype before the PV product."""
    s, d = q.shape[1], q.shape[3]
    scores = torch.einsum("bqnh,bknh->bnqk", q, k).float() / math.sqrt(d)
    if causal:
        scores = scores.masked_fill(~_causal_keep(s, q.device), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def decode_attention(q, k, v, q_offset=0, sm_scale=None):
    """Single-query attention for a contiguous KV cache (the reference's
    ``decode_attention``). q: (B, 1, n, d); k/v: (B, S, kv, d). GQA-native:
    the group dim rides inside the einsum (kv-major, like ``_repeat_kv``).
    Scores in fp32 with the -1e30 mask, probabilities cast to q's dtype
    before the PV product, as the reference does."""
    b, q_len, n, d = q.shape
    if q_len != 1:
        raise ValueError(f"decode_attention requires q_len == 1, got {q_len}")
    kv = k.shape[2]
    g = n // kv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q[:, 0].reshape(b, kv, g, d)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k).float() * sm_scale
    offsets = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    allowed = torch.arange(k.shape[1], device=q.device)[None] <= offsets
    scores = scores.masked_fill(~allowed[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v)
    return out.reshape(b, 1, n, d)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, q_offset,
                                 sm_scale=None):
    """The kernel's function in plain PyTorch: gather each row's pages
    through its table, upcast to fp32, mask keys at positions > the row's
    offset with -1e30, softmax, accumulate in fp32, cast to q's dtype.
    Shapes as :func:`paged_decode_attention`."""
    b, _, n, d = q.shape
    _, block_size, kv, _ = k_pages.shape
    max_blocks = block_tables.shape[1]
    g = n // kv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, max_blocks * block_size, kv, d).float()
    v = v_pages[tables].reshape(b, max_blocks * block_size, kv, d).float()
    qg = q[:, 0].reshape(b, kv, g, d).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k) * sm_scale
    offsets = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    allowed = torch.arange(k.shape[1], device=q.device)[None] <= offsets
    scores = scores.masked_fill(~allowed[:, None, None, :], -1e30)
    out = torch.einsum("bkgs,bskh->bkgh", torch.softmax(scores, dim=-1), v)
    return out.reshape(b, 1, n, d).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, q_offset,
                           sm_scale=None):
    """One-query decode attention over a paged K/V pool.

    q: (B, 1, n, d); k_pages/v_pages: (num_blocks, block_size, kv, d), one
    layer of the serving pool; block_tables: (B, max_blocks) int32 mapping
    row b's logical block j to a pool block; q_offset: (B,) int32 absolute
    query positions (>= 0). Returns (B, 1, n, d) in q's dtype.

    The kernel's contract holds on every device: bf16, fp16 or fp32 q/k/v of
    one dtype, int32 tables and offsets, contiguous tensors, d a multiple of 8
    and at most 256; anything else raises. CPU tensors then run the plain
    version; CUDA tensors launch the kernel."""
    b, q_len, n, d = q.shape
    if q_len != 1:
        raise ValueError(f"paged_decode_attention requires q_len == 1, got {q_len}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(
            f"k_pages/v_pages must both be (num_blocks, block_size, kv, {d}); "
            f"got {tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )
    _, block_size, kv, _ = k_pages.shape
    if n % kv:
        raise ValueError(f"{n} query heads are not a multiple of {kv} kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, max_blocks), got {tuple(block_tables.shape)}")
    if not torch.is_tensor(q_offset) or tuple(q_offset.shape) != (b,):
        raise ValueError(f"q_offset must be a ({b},) tensor")
    tensors = (q, k_pages, v_pages, block_tables, q_offset)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k_pages, v_pages, block_tables and q_offset must share one device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"the paged_decode kernel takes bf16, fp16 or fp32 q/k/v of one dtype, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if block_tables.dtype != torch.int32 or q_offset.dtype != torch.int32:
        raise TypeError("block_tables and q_offset must be int32")
    if d % 8 or d > 256:
        raise ValueError(f"the paged_decode kernel takes head_dim % 8 == 0 and <= 256, got {d}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged_decode kernel takes contiguous tensors only")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_tables, q_offset, sm_scale
        )
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q, k_pages and v_pages must be 16-byte aligned")
    g = n // kv
    dcode = _DTYPE_CODE[q.dtype]
    launch, smem_bytes = _kernel()
    if smem_bytes(dcode, g, d) > _MAX_SMEM_BYTES:
        raise ValueError(
            f"group of {g} query heads at head_dim {d} needs {smem_bytes(dcode, g, d)} "
            f"bytes of shared memory, above the {_MAX_SMEM_BYTES} a block may use"
        )
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    max_blocks = block_tables.shape[1]
    head_chunks = -(-g // _PAGED_MAX_HEADS)
    splits, split_len = _paged_splits(b, kv * head_chunks, max_blocks * block_size,
                                      _num_sms(q.device))
    work = torch.empty(b * kv * splits * g * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), q_offset.data_ptr(), work.data_ptr(), out.data_ptr(),
            dcode, b, kv, g, d, block_size, max_blocks, splits, split_len,
            float(sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    paged_decode_attention.dtypes[str(q.dtype)] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.dtypes = dict.fromkeys(map(str, _DTYPES), 0)

#: query heads one split block carries; a larger GQA group is cut in chunks
_PAGED_MAX_HEADS = 8
#: the split plan's aims: about this many blocks an SM, at least this many
#: positions a split (a block's fixed costs: its q, its partial, its merge)
_PAGED_BLOCKS_PER_SM = 4
_PAGED_MIN_SPLIT = 128
_PAGED_TILE = 8  # tokens of one warp tile in csrc/paged_decode.cu
_SM_COUNT = {}


def _num_sms(device) -> int:
    """Streaming multiprocessors of ``device``, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _paged_splits(b: int, kv: int, max_positions: int, num_sms: int) -> Tuple[int, int]:
    """(splits, positions per split) of the paged kernel: split ``s`` covers
    positions [s·len, min((s+1)·len, max_positions)). From shapes only — the
    offsets stay on the card, so reading them would put a host sync into
    every decode layer. ``kv`` counts the blocks one split needs across
    heads (kv heads x head chunks). Aims at ``_PAGED_BLOCKS_PER_SM`` blocks
    an SM with no split under ``_PAGED_MIN_SPLIT`` positions; the length is
    a whole number of warp tiles and no split is empty by construction."""
    want = -(-_PAGED_BLOCKS_PER_SM * num_sms // (b * kv))
    cap = max_positions // _PAGED_MIN_SPLIT
    splits = max(1, min(want, cap))
    split_len = -(-max_positions // splits)
    split_len = -(-split_len // _PAGED_TILE) * _PAGED_TILE
    return -(-max_positions // split_len), split_len


def paged_decode_split_plain(q, k_pages, v_pages, block_tables, q_offset,
                             splits: Tuple[int, int], sm_scale=None):
    """The kernel's split-and-combine arithmetic in plain PyTorch, fp32:
    per split (``splits`` = (count, length), a :func:`_paged_splits` plan)
    the partial (max, denominator, numerator) of base-2 scores over the
    split's positions at or below the row's offset, an empty split giving
    (-inf, 0, 0); then the partials combined in split order and divided.
    Returns (B, 1, n, d) fp32. A test twin of ``csrc/paged_decode.cu``."""
    b, _, n, d = q.shape
    _, block_size, kv, _ = k_pages.shape
    max_pos = block_tables.shape[1] * block_size
    g = n // kv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    count, length = splits
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, max_pos, kv, d).float()
    v = v_pages[tables].reshape(b, max_pos, kv, d).float()
    qg = q[:, 0].reshape(b, kv, g, d).float()
    s2 = torch.einsum("bkgh,bskh->bkgs", qg, k) * (sm_scale * LOG2E)
    last = q_offset.long().clamp(max=max_pos - 1)
    keep = torch.arange(max_pos, device=q.device)[None] <= last[:, None]
    s2 = s2.masked_fill(~keep[:, None, None, :], -math.inf)
    parts = []
    for i in range(count):
        lo, hi = i * length, min((i + 1) * length, max_pos)
        si = s2[..., lo:hi]
        m = si.amax(dim=-1, keepdim=True)
        p = torch.exp2(si - m.clamp_min(NEG_INF))  # all masked: exp2(-inf) = 0
        acc = torch.einsum("bkgs,bskh->bkgh", p, v[:, lo:hi])
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    mm = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    ll = torch.zeros_like(mm)
    aa = torch.zeros_like(parts[0][2])
    for m, l_, acc in parts:  # split order, empty splits skipped
        c = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - mm))
        ll = ll + l_ * c
        aa = aa + acc * c
    out = torch.where(ll > 0, aa / ll.clamp_min(1e-30), torch.zeros_like(aa))
    return out.reshape(b, 1, n, d)


def _kernel():
    """(launch, smem_bytes) ctypes functions of the built library."""
    lib = _build.load("paged_decode")
    launch = lib.galvatron_paged_decode
    launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    launch.restype = ctypes.c_int
    smem = lib.galvatron_paged_decode_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return launch, smem
