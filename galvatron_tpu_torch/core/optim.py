"""AdamW with fp32 master weights and explicit state (the port's copy of
``galvatron_tpu/core/optim.py``).

The state is ``{"mu", "nu", "count"}``: two fp32 moment trees mirroring the
parameter tree and a host step count. The update is the reference's, term
for term and in the same order (global-norm clip, bias correction,
decoupled weight decay, optional ``LRSchedule``), but applied IN PLACE to
the parameter and moment tensors: one update of a 1 B-parameter model then
allocates per-tensor temporaries instead of two more full copies. Under
fp16, :func:`apply_update_with_scaler` skips the whole update on overflow
and advances the dynamic loss scale.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch


class AdamConfig(NamedTuple):
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    # optional LRSchedule (core/schedules.py): lr = lr_schedule(step)
    lr_schedule: Optional[Any] = None


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the reference's order (jax.tree.leaves: dict keys sorted,
    lists in order), so sums over leaves add in the same order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def init_opt_state(params) -> Dict[str, Any]:
    return {"mu": _zeros_like_tree(params), "nu": _zeros_like_tree(params), "count": 0}


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamConfig,
                 grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step in fp32 master precision, in place: ``params`` and
    the moments of ``opt_state`` are updated, ``opt_state["count"]`` is
    advanced. ``grads`` is a tree (or a leaf list in the reference's order)
    of fp32 gradients. ``grad_norm`` is the norm ``grad_clip`` clips by
    when the leaves are shards of a larger gradient (the hybrid runtime's
    sum over every rank, each replica counted once); by default it is the
    leaves' own :func:`global_norm`. Returns (params, opt_state)."""
    p_leaves = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    mu, nu = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
    count = opt_state["count"] + 1
    cnt = _f32(count)
    scale = None
    if cfg.grad_clip is not None:
        gn = global_norm(g_leaves) if grad_norm is None else grad_norm
        scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gn, 1e-12), max=1.0)
    # bias corrections in fp32, as the reference computes b ** count.astype(f32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1), cnt)
    b2c = 1.0 - torch.pow(_f32(cfg.b2), cnt)
    if cfg.lr_schedule is not None:
        lr = cfg.lr_schedule(cnt - 1.0)  # 0-based step index
    else:
        lr = cfg.lr
    for p, g, m, v in zip(p_leaves, g_leaves, mu, nu):
        g = g.float() if scale is None else g.float() * scale  # one leaf at a time
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            step = step + lr * cfg.weight_decay * p.float()
        p.copy_(p.float() - step)
    opt_state["count"] = count
    return params, opt_state


def apply_update_with_scaler(state, loss, grads, adam: AdamConfig, scaler_cfg,
                             finite: Optional[bool] = None, params=None,
                             grad_norm: Optional[torch.Tensor] = None) -> bool:
    """The fp16 train-state transition, in place (the reference's
    ``apply_update_with_scaler``): the AdamW update runs only when the
    step's gradients (and loss) are finite, so on overflow ``params``,
    ``mu``, ``nu`` and ``count`` all stay as they were; ``state["scaler"]``
    advances either way (``core/schedules.scaler_update``). ``grads`` must
    be unscaled already. ``finite`` is the verdict when the caller decided
    it over every rank (the hybrid runtime's one all-reduce); by default it
    is taken from ``grads`` and ``loss``. ``params`` (default
    ``state["params"]``) and ``grad_norm`` go to :func:`adamw_update`. The
    caller advances ``state["step"]``. Returns the verdict."""
    from galvatron_tpu_torch.core.schedules import all_finite, scaler_update

    if finite is None:
        finite = bool(all_finite(tree_leaves(grads))) and bool(torch.isfinite(loss).all())
    if finite:
        adamw_update(state["params"] if params is None else params, grads, state["opt"], adam,
                     grad_norm=grad_norm)
    state["scaler"] = scaler_update(state["scaler"], finite, scaler_cfg)
    return finite
