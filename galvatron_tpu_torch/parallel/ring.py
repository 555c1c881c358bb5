"""Ring attention: context parallelism over a ring of ranks (the port's
counterpart of ``galvatron_tpu/parallel/ring.py``).

A layer with ``cp > 1`` holds the sequence in contiguous blocks, one per
rank of its CP group, in the group's order (``mesh.batch_spec`` /
``RankMesh.seq_slice``): ring position ``idx`` holds positions
``idx·S/cp … (idx+1)·S/cp``. K/V blocks travel round the ring, each rank
sending to the next member (``comm.ring_shift``); after ``step`` hops a rank
holds the block of position ``(idx − step) mod cp``. Every rank makes every
hop, including those whose block it then has no use for: a rank that skipped
an exchange would stall the ring.

Two per-hop paths, chosen as the reference chooses them (:func:`_flash_block_size`):

- **the grid flash kernels** (:class:`_RingFlash`, when the local sequence
  tiles): hop 0 runs ``flash_grid_fwd`` causally on the rank's own block, a
  hop whose block lies in the past runs it unmasked, a block in the future
  launches nothing; each hop writes an fp32 output and its lse, and the
  hops fold by their lse into the output and the GLOBAL lse. The backward
  is a second ring pass: ``flash_grid_bwd_parts`` on each block with that
  global lse and ``delta = Σ do·out`` (fp32), so the per-block gradients are
  independent; dq, dk and dv accumulate in fp32, dk/dv travel with their
  K/V block, and one last hop brings them home. On a past block p = exp(s −
  lse) does not sum to 1 over the block; that is correct. On CUDA tensors
  the wrappers launch the kernels or raise, on CPU tensors they run the
  plain versions, as everywhere in the port.
- **the einsum ring** (:func:`_ring_attn_local`) for a local sequence that
  does not tile: plain PyTorch in fp32 with the global causal mask, as the
  reference's is plain XLA; autograd carries the K/V shifts back round the
  ring (``comm.ring_shift_grad``).

K/V reach the ring repeated to the query heads (:func:`ring_decoder_layer`),
and the ring order is the contiguous one (no load balancing), as in the
reference.
"""

from __future__ import annotations

import math

import torch

from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.ops import flash_attention as fa
from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel.mesh import Group

NEG_INF = -1e30


def _past(owner: int, idx: int) -> bool:
    """Whether the K/V block of ring position ``owner`` lies wholly before
    the queries of position ``idx``: it is then attended unmasked, and a
    later block not at all."""
    return owner < idx


def _lse_combine(m, l, acc, o_b, lse_b):
    """Fold a block's normalized output into the running (max, sum, acc):
    o_b's unnormalized row sum is exp(lse_b), so blocks combine by lse like
    partial softmaxes."""
    m_new = torch.maximum(m, lse_b)
    alpha = torch.exp(m - m_new)
    w_b = torch.exp(lse_b - m_new)
    return m_new, l * alpha + w_b, acc * alpha + o_b * w_b


def _ring_flash_fwd(q, k, v, group: Group, sm_scale: float):
    """q/k/v (B, n, S/cp, d), this rank's block. Returns (out in q's dtype,
    the global fp32 lse (B, n, S/cp, 1)). Hop 0 is the diagonal block,
    locally causal; each later hop moves K/V first and then computes. A
    future hop's block would fold in as zeros with lse -1e30, which leaves
    the running sums as they are bit for bit, so it is not folded."""
    cp, idx = group.size, group.index
    o0, lse0 = fa.flash_grid_fwd(q, k, v, None, sm_scale, True, out_dtype=torch.float32)
    # the fold of hop 0 into (-1e30, 0, 0): exactly (lse0, 1, o0)
    m, l, acc = lse0, torch.ones_like(lse0), o0
    for step in range(1, cp):
        k, v = comm.ring_shift([k, v], group)
        if _past((idx - step) % cp, idx):
            o_b, lse_b = fa.flash_grid_fwd(q, k, v, None, sm_scale, False,
                                           out_dtype=torch.float32)
            m, l, acc = _lse_combine(m, l, acc, o_b, lse_b)
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), m + torch.log(l)


class _RingFlash(torch.autograd.Function):
    """The flash ring (the reference's ``_ring_flash`` custom VJP): the
    forward saves (q, k, v, out, global lse); the backward is the second
    ring pass."""

    @staticmethod
    def forward(ctx, q, k, v, group, sm_scale):
        out, lse = _ring_flash_fwd(q, k, v, group, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.sm_scale = group, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, sm = ctx.group, ctx.sm_scale
        cp, idx = group.size, group.index
        do = fa._unit_stride(do)
        delta = (do.float() * out.float()).sum(dim=-1, keepdim=True).contiguous()
        dq, dk, dv = (g.float() for g in fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, None,
                                                                  sm, True))
        for step in range(1, cp):
            # dk/dv ride the ring with their K/V block
            k, v, dk, dv = comm.ring_shift([k, v, dk, dv], group)
            if _past((idx - step) % cp, idx):
                dq_b, dk_b, dv_b = fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, None, sm,
                                                           False)
                dq = dq + dq_b.float()
                dk = dk + dk_b.float()
                dv = dv + dv_b.float()
        dk, dv = comm.ring_shift([dk, dv], group)  # home
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _ring_attn_local(q, k, v, group: Group, sm_scale: float):
    """The einsum ring: q/k/v (B, S/cp, n, d) local, sequence in ring
    order; online softmax in fp32 over every block with the global causal
    mask (a future block's scores are all masked); autograd carries the
    shifts. Returns (B, S/cp, n, d) in q's dtype."""
    cp, idx = group.size, group.index
    b, s, n, d = q.shape
    q32 = q.float()
    rows = idx * s + torch.arange(s, device=q.device)  # global q positions

    def accum(m, l, acc, k_cur, v_cur, owner):
        cols = owner * s + torch.arange(s, device=q.device)
        scores = torch.einsum("bqnh,bknh->bnqk", q32, k_cur.float()) * sm_scale
        scores = scores.masked_fill(~(rows[:, None] >= cols[None, :]), NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        return (m_new, alpha * l + p.sum(dim=-1),
                alpha[..., None] * acc + torch.einsum("bnqk,bknh->bnqh", p, v_cur.float()))

    m = torch.full((b, n, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, s, d), dtype=torch.float32, device=q.device)
    m, l, acc = accum(m, l, acc, k, v, idx)
    for step in range(1, cp):
        k, v = comm.ring_shift_grad([k, v], group)
        m, l, acc = accum(m, l, acc, k, v, (idx - step) % cp)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _flash_block_size(s_local: int) -> int:
    """Largest power-of-two tile <= 1024 dividing the local sequence; 0 if the
    shape doesn't tile (callers fall back to the einsum ring)."""
    for block in (1024, 512, 256, 128, 64, 32, 16, 8):
        if s_local % block == 0:
            return block
    return 0


def ring_attention(q, k, v, group: Group, sm_scale=None):
    """Causal attention over the whole sequence for this rank's block: q/k/v
    (B, S/cp, n, d), n heads on all three, the block of ring position
    ``group.index``; returns (B, S/cp, n, d). The batch and head dims are
    whatever this rank holds of them (its DP rows, its TP heads). Through
    the grid flash kernels when the local sequence tiles, else the einsum
    ring."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _flash_block_size(q.shape[1]):
        return _ring_attn_local(q, k, v, group, sm_scale)
    out = _RingFlash.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), group,
                           float(sm_scale))
    return out.transpose(1, 2)


def rope_rows(cos_sin, group: Group, s_local: int):
    """The rows of the (S, hd/2) RoPE tables at this rank's global positions
    ``idx·S/cp …``: a CP layer ropes its block where it lies in the
    sequence, not at positions 0 … S/cp."""
    if cos_sin is None:
        return None
    rows = slice(group.index * s_local, (group.index + 1) * s_local)
    return cos_sin[0][rows], cos_sin[1][rows]


def ring_decoder_layer(x, p, cfg, group: Group, cos_sin=None, tp=None):
    """A decoder layer whose attention core is the ring (the reference's
    ``ring_decoder_layer``): x (B, S/cp, h) this rank's block (replicated
    over ``tp``'s ranks, a ``TPRegion`` without SP); ``cos_sin`` the tables
    of the whole sequence. K/V are repeated to the query heads before the
    ring."""

    def core(q, k, v):
        n = q.shape[2]
        k = modeling._repeat_kv(k, n // k.shape[2])
        v = modeling._repeat_kv(v, n // v.shape[2])
        return ring_attention(q, k, v, group)

    return modeling.core_decoder_layer(x, p, cfg, core, rope_rows(cos_sin, group, x.shape[1]), tp)
