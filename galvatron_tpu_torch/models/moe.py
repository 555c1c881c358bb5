"""Switch-style Mixture-of-Experts MLP with expert parallelism (the port's
counterpart of ``galvatron_tpu/models/moe.py``).

A top-1 router with sinkhorn load balancing in training and the raw-logit
argmax at inference, a static per-expert capacity C, and tokens past an
expert's capacity dropped (they pass through on the residual path). The
values are the reference's; the dataflow is not:

- **Index dispatch.** The reference builds a (T, E, C) one-hot and contracts
  it twice by einsum. Here every kept token has one slot ``e·C + c`` of the
  (E, C, h) expert buffer, and the two moves are an ``index_copy`` into the
  buffer and an ``index_select`` out of it, scaled by the gate. Each einsum
  term is a single product with zeros, so the result is the same to the last
  bit in fp32 and, in bf16, one rounding of ``bf16(gate)·ye``, as there.
- **Global routing.** The reference's ``moe_block`` sees the micro-batch's
  global arrays: the sinkhorn normalises over every token of the micro-batch
  on all data ranks, ``C = moe_capacity(T_global, ...)`` and a token's slot is
  its rank in a cumulative sum over the global token order (row-major over
  (rows, sequence)). Under a multi-rank plan (:class:`MoEContext`) each rank
  gathers the (T, E) fp32 router logits of its token group (no gradient),
  runs the same routing on the whole micro-batch and keeps its own tokens'
  assignments; the gate stays differentiable through the local logits.
- **Expert parallelism.** With an EP group of more than one rank, member j
  holds experts ``[j·E/ep, (j+1)·E/ep)``. Each rank sends its kept tokens to
  the members that hold their experts (``comm.moe_dispatch``, one
  all-to-all of ``ep`` padded chunks of its T_loc rows), the members run their
  experts' FFN on the slots those tokens fill, and the outputs come back by
  the reverse move (``comm.moe_combine``). Every member computes the same
  routing, so sender and receiver agree on each row's slot without another
  message. An expert replica then sees only its EP group's tokens: the
  runtime sums expert gradients over the replica group
  (``parallel/hybrid.py``).

The block's pieces run under ``torch.profiler.record_function`` ranges
(``moe.routing``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
``moe.all_to_all``), so a profile can split a step's MoE time.

Under tensor parallelism each expert's FFN columns (w1, w3) and rows (w2) are
split over the TP group (``moe_annotations``): the block's output is a
partial sum that the caller's TP exit reduces, and so is the gate's gradient
(the runtime sums the router's gradient over the TP group).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from galvatron_tpu_torch.parallel import comm

Params = Dict[str, Any]


def sinkhorn(logits: torch.Tensor, n_iters: int = 8) -> torch.Tensor:
    """Sinkhorn-normalised routing scores (a balanced assignment), with the
    reference's fixed iteration count, ``1e-8`` terms and product order."""
    cost = torch.exp(logits - logits.max())
    T, E = cost.shape
    d1 = torch.ones((E,), dtype=cost.dtype, device=cost.device)
    for _ in range(n_iters):
        d0 = 1.0 / (T * (cost @ d1 + 1e-8))
        d1 = 1.0 / (E * (d0 @ cost + 1e-8))
    d0 = 1.0 / (T * (cost @ d1 + 1e-8))
    return cost * d0[:, None] * d1[None, :]


def moe_capacity(num_tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Static per-expert token capacity, padded to a multiple of 8 (the pad
    decides which tokens are dropped, so it is part of the function)."""
    c = int(np.ceil(num_tokens / num_experts * capacity_factor))
    return max(8, (c + 7) // 8 * 8)


@dataclass
class Routing:
    """Top-1 assignments of T tokens: ``expert`` (T,) int64, ``slot`` (T,)
    the token's position in its expert's buffer, ``kept`` (T,) bool (slot <
    capacity) and ``gate`` (T,) fp32, the sigmoid of the raw logit at the
    chosen expert."""

    expert: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    gate: torch.Tensor


def route_top1(logits: torch.Tensor, capacity: int, *, sinkhorn_iters: int = 8,
               train: bool = True) -> Routing:
    """Top-1 switch routing with capacity limiting: the sinkhorn-balanced
    scores in training, the raw logits at inference (sinkhorn over a tiny
    batch degenerates to uniform scores). Argmax takes the first index on
    ties (``jnp.argmax``'s rule); positions come from a cumulative sum in
    token order. The gate is differentiable through ``logits``; the choice
    is not."""
    lf = logits.float()
    with torch.no_grad():
        scores = sinkhorn(lf.detach(), sinkhorn_iters) if train else lf.detach()
        expert = torch.argmax(scores, dim=-1)
        onehot = F.one_hot(expert, lf.shape[1])
        slot = (onehot.cumsum(0) - 1).gather(1, expert[:, None])[:, 0]
        kept = slot < capacity
    gate = torch.sigmoid(lf.gather(1, expert[:, None])[:, 0])
    return Routing(expert, slot, kept, gate)


def init_moe_params(cfg, uniform, normal) -> Params:
    """Router + stacked expert FFN weights (E leading dim), drawn by the
    caller's ``uniform(shape, fan_in)`` (±1/sqrt(fan_in)) and
    ``normal(*shape)`` (·0.02); no biases, even under ``use_bias`` (the
    reference's)."""
    h, f, e = cfg.hidden_size, cfg.ffn, cfg.moe_experts
    p: Params = {"router": {"w": normal(h, e)}, "w1": uniform((e, h, f), h),
                 "w2": uniform((e, f, h), f)}
    if cfg.act_fn == "swiglu":
        p["w3"] = uniform((e, h, f), h)
    return p


def moe_annotations(cfg) -> Params:
    """'ep' splits the expert dim over the expert-parallel axes; within an
    expert the FFN dims carry Megatron's 'tp' column / row split; 'fsdp'
    dims ZeRO-shard over the data axes outside the EP axes. The router
    stays replicated (the reference's)."""
    a: Params = {"router": {"w": (None, None)}, "w1": ("ep", "fsdp", "tp"),
                 "w2": ("ep", "tp", "fsdp")}
    if cfg.act_fn == "swiglu":
        a["w3"] = ("ep", "fsdp", "tp")
    return a


def expert_ffn(xe: torch.Tensor, p: Params, act_fn: str) -> torch.Tensor:
    """The experts' FFN on an (E, C, h) buffer: SwiGLU over w1 / w3, and
    tanh-GELU for every other activation (the reference's)."""
    g = torch.bmm(xe, p["w1"].to(xe.dtype))
    if act_fn == "swiglu":
        hmid = F.silu(g) * torch.bmm(xe, p["w3"].to(xe.dtype))
    else:
        hmid = F.gelu(g, approximate="tanh")
    return torch.bmm(hmid, p["w2"].to(xe.dtype))


def _scatter(x: torch.Tensor, dest: torch.Tensor, n: int) -> torch.Tensor:
    buf = x.new_zeros((n + 1, x.shape[1])).index_copy_(0, dest, x)
    return buf[:n]


def _gather(buf: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    return torch.cat([buf, buf.new_zeros((1, buf.shape[1]))]).index_select(0, src)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dest, n):
        ctx.save_for_backward(dest)
        return _scatter(x, dest, n)

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        return _gather(g, dest), None, None


class _Collect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, src):
        ctx.save_for_backward(src)
        ctx.n = buf.shape[0]
        return _gather(buf, src)

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        return _scatter(g, src, ctx.n), None


def dispatch(x: torch.Tensor, dest: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` (T, h) into an (n, h) buffer at ``dest`` (T,); a row
    whose ``dest`` is ``n`` is dropped, and a position no row names stays
    zero. Every position below n is named at most once, so the move and its
    backward (:func:`collect` of the gradient) are copies, exact and
    deterministic."""
    return _Dispatch.apply(x, dest, n)


def collect(buf: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Rows ``src`` (T,) of ``buf`` (n, h); ``src == n`` reads a zero row.
    The adjoint of :func:`dispatch`: the backward scatters each row's
    gradient back to its position."""
    return _Collect.apply(buf, src)


@dataclass
class MoEContext:
    """What a multi-rank MoE layer needs from the runtime: its token group
    (the ranks whose tokens together make the micro-batch: the layer's DP
    axes, and its CP axes), ``order`` (G, T_loc) the global token indices of
    each member's local tokens in their local order, its EP group and the
    members' rows of ``order`` (``ep_rows``, in EP group order)."""

    token_group: Any
    order: torch.Tensor
    ep_group: Any = None
    ep_rows: Optional[torch.Tensor] = None

    @property
    def ep(self) -> int:
        return 1 if self.ep_group is None else self.ep_group.size

    def global_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The micro-batch's (T_global, E) logits in global token order."""
        gathered = comm.gather_logits(logits, self.token_group)
        out = torch.empty_like(gathered)
        out[self.order.reshape(-1).to(gathered.device)] = gathered
        return out

    def mine(self) -> torch.Tensor:
        """The global indices of this rank's tokens, in local order."""
        return self.order[self.token_group.index]


def moe_block(x: torch.Tensor, p: Params, cfg, train: bool = True,
              ctx: Optional[MoEContext] = None) -> torch.Tensor:
    """The switch-MoE MLP on a (B, S, h) activation. Without ``ctx`` (or
    with a token group of one rank and no EP) the tokens are the whole
    micro-batch; with it, see the module docstring."""
    b, s, h = x.shape
    T = b * s
    E = cfg.moe_experts
    xt = x.reshape(T, h)
    multi = ctx is not None and (ctx.token_group is not None and ctx.token_group.size > 1
                                 or ctx.ep > 1)
    with record_function("moe.routing"):
        logits = xt.float() @ p["router"]["w"].float()  # (T, E)
        glog = ctx.global_logits(logits.detach()) if multi else logits
        C = moe_capacity(glog.shape[0], E, cfg.moe_capacity_factor)
        r = route_top1(glog, C, sinkhorn_iters=cfg.moe_sinkhorn_iters, train=train)
        if not multi:
            expert, slot, kept, gate = r.expert, r.slot, r.kept, r.gate
        else:
            mine = ctx.mine().to(x.device)
            expert, slot, kept = r.expert[mine], r.slot[mine], r.kept[mine]
            gate = torch.sigmoid(logits.gather(1, expert[:, None])[:, 0])
    if not multi or ctx.ep == 1:
        dest = torch.where(kept, expert * C + slot, torch.full_like(slot, E * C))
        with record_function("moe.dispatch"):
            xe = dispatch(xt, dest, E * C).view(E, C, h)
        with record_function("moe.experts"):
            ye = expert_ffn(xe, p, cfg.act_fn)
        with record_function("moe.combine"):
            y = collect(ye.reshape(E * C, h), dest)
    else:
        y = _expert_parallel(xt, r, expert, kept, ctx, p, cfg, C)
    with record_function("moe.combine"):
        return (y * gate.to(x.dtype)[:, None]).reshape(b, s, h)


def _expert_parallel(xt, r: Routing, expert, kept, ctx: MoEContext, p: Params, cfg, C: int):
    """The EP path of :func:`moe_block`: the un-gated expert outputs of this
    rank's tokens (T_loc, h), zero for dropped ones."""
    T, h = xt.shape
    ep, me = ctx.ep, ctx.ep_group.index
    el = cfg.moe_experts // ep  # experts per member
    with record_function("moe.routing"):
        # sender: each kept token to the member holding its expert, packed
        # in local order into that member's chunk of T rows
        to = expert // el
        going = F.one_hot(to, ep).bool() & kept[:, None]  # (T, ep)
        pos = (going.long().cumsum(0) - 1).gather(1, to[:, None])[:, 0]
        send = torch.where(kept, to * T + pos, torch.full_like(pos, ep * T))
        # receiver: member q's chunk holds q's tokens routed here, in q's order
        rows = ctx.ep_rows.to(xt.device)  # (ep, T) global token indices
        eq, cq, kq = r.expert[rows], r.slot[rows], r.kept[rows]
        here = kq & (eq // el == me)
        at = torch.arange(ep, device=xt.device)[:, None] * T + here.long().cumsum(1) - 1
        dummy = el * C
        slot_of_row = torch.full((ep * T + 1,), dummy, dtype=torch.long, device=xt.device)
        slot_of_row.scatter_(0, torch.where(here, at, ep * T).reshape(-1),
                             torch.where(here, (eq - me * el) * C + cq, dummy).reshape(-1))
        slot_of_row = slot_of_row[:ep * T]
    with record_function("moe.dispatch"):
        sent = dispatch(xt, send, ep * T)
    with record_function("moe.all_to_all"):
        recv = comm.moe_dispatch(sent, ctx.ep_group)
    with record_function("moe.dispatch"):
        xe = dispatch(recv, slot_of_row, dummy).view(el, C, h)
    with record_function("moe.experts"):
        ye = expert_ffn(xe, p, cfg.act_fn)
    with record_function("moe.combine"):
        back = collect(ye.reshape(el * C, h), slot_of_row)
    with record_function("moe.all_to_all"):
        back = comm.moe_combine(back, ctx.ep_group)
    with record_function("moe.combine"):
        return collect(back, send)

