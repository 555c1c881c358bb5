"""Single-device training runtime (the port's counterpart of
``build_runtime`` in ``galvatron_tpu/parallel/hybrid.py`` at pp=1 on one
device, with ``_make_layer_hook``'s per-layer recompute).

``build_runtime`` returns a :class:`Runtime` whose ``train_step(state,
batch)`` runs forward + backward (with sum-form micro-batch accumulation
when ``chunks > 1``) and the AdamW update on fp32 master weights. The state
``{"params", "opt", "step"}`` is updated IN PLACE (the reference's jitted
step donates it); ``train_step`` returns the same dict and the loss as a
0-d device tensor, so the caller decides when to synchronise. Per-layer
DP/ZeRO/TP/SP/PP, strategy JSON and collectives are not ported yet
(ROADMAP.md §1).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import torch
from torch.utils.checkpoint import checkpoint

from galvatron_tpu_torch.core.optim import AdamConfig, adamw_update, init_opt_state, tree_leaves
from galvatron_tpu_torch.device import resolve_device
from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.models.modeling import ModelConfig

#: --global_checkpoint values → per-layer recompute mode
CKPT_MODES = {0: "none", 1: "full", 2: "selective"}
_PRECISION = {"fp32": torch.float32, "bf16": torch.bfloat16}


@dataclass
class Runtime:
    cfg: ModelConfig
    device: torch.device
    chunks: int
    ckpt: str
    train_step: Callable
    eval_loss: Callable
    init_state: Callable
    state_from: Callable


@functools.lru_cache(maxsize=8)
def _rope_tables(cfg: ModelConfig, seq: int, device: torch.device):
    return modeling.rope_tables(cfg, seq, device)


def _make_layer_hook(cfg: ModelConfig, ckpt: str):
    """Per-layer execution: 'full' recomputes the whole layer in the
    backward (saving only its input; the nested MLP policy is switched off
    there, as the reference does), 'selective' only the attention core."""
    layer_cfg = cfg.replace(mlp_recompute="off") if ckpt == "full" else cfg

    def hook(i: int, x, lp):
        cos_sin = None
        if layer_cfg.pos_embed == "rope":
            cos_sin = _rope_tables(layer_cfg, x.shape[1], x.device)

        def run(x_):
            return modeling.decoder_layer(x_, lp, layer_cfg, cos_sin,
                                          remat_attn=ckpt == "selective")

        if ckpt == "full" and torch.is_grad_enabled():
            return checkpoint(run, x, use_reentrant=False)
        return run(x)

    return hook


def _trainable(tree):
    """The tree's tensors as autograd leaves requiring grad. ``detach``
    shares storage, so the in-place updates still land in the caller's
    tensors; a non-leaf (e.g. a ``.to(device)`` of a tensor that requires
    grad) would otherwise never receive a ``.grad``."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable(v) for v in tree]
    return tree.detach().requires_grad_(True)


def build_runtime(
    cfg: ModelConfig,
    adam: AdamConfig = AdamConfig(),
    global_batch_size: int = 8,
    seq_len: int = 2048,
    chunks: int = 1,
    ckpt: Union[str, int] = "none",
    mixed_precision: str = "bf16",
    device=None,
) -> Runtime:
    """The train/eval step for one model config on one device, on
    (global_batch_size, seq_len + 1) token batches. ``ckpt``:
    'none' | 'full' | 'selective' (or the --global_checkpoint integer);
    ``mixed_precision``: 'fp32' | 'bf16' sets the compute dtype (weights
    stay fp32 masters). ``device`` defaults to ``cuda`` and raises without a
    card unless 'cpu' is asked for."""
    device = resolve_device(device)
    modeling.check_supported(cfg)
    if mixed_precision == "fp16":
        raise NotImplementedError(
            "--mixed_precision fp16 (dynamic loss scaling) is not ported yet "
            "(ROADMAP.md §1); use bf16 or fp32"
        )
    if mixed_precision not in _PRECISION:
        raise ValueError(f"unknown mixed_precision {mixed_precision!r}")
    cfg = cfg.replace(dtype=_PRECISION[mixed_precision])
    ckpt = CKPT_MODES.get(ckpt, ckpt)
    if ckpt not in ("none", "full", "selective"):
        raise ValueError(f"unknown ckpt mode {ckpt!r}")
    chunks = max(1, int(chunks))
    if global_batch_size % chunks:
        raise ValueError(f"global batch {global_batch_size} not divisible by chunks {chunks}")
    hook = _make_layer_hook(cfg, ckpt)

    def _batch(batch) -> torch.Tensor:
        if tuple(batch.shape) != (global_batch_size, seq_len + 1):
            raise ValueError(f"batch must be ({global_batch_size}, {seq_len + 1}) tokens, "
                             f"got {tuple(batch.shape)}")
        return torch.as_tensor(batch).to(device=device, dtype=torch.long)

    def train_step(state: Dict[str, Any], batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        batch = _batch(batch)
        if chunks == 1:
            loss = modeling.lm_loss(params, batch, cfg, layer_hook=hook)
            loss.backward()
        else:
            # sum-form accumulation: (nll_sum, token_count) per micro-batch,
            # gradients of the sums accumulated in fp32, then one division,
            # so the result is the global token-mean however the ignored
            # tokens fall across chunks
            tot_s = torch.zeros((), dtype=torch.float32, device=device)
            tot_n = torch.zeros((), dtype=torch.long, device=device)
            for mb in batch.reshape(chunks, batch.shape[0] // chunks, *batch.shape[1:]):
                s, n = modeling.lm_loss_sum(params, mb, cfg, layer_hook=hook)
                s.backward()
                tot_s += s.detach()
                tot_n += n
            denom = torch.clamp_min(tot_n, 1).float()
            loss = tot_s / denom
            for p in leaves:
                p.grad.div_(denom)
        adamw_update(params, [p.grad for p in leaves], state["opt"], adam)
        for p in leaves:
            p.grad = None
        state["step"] += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_loss(state, batch):
        return modeling.lm_loss(state["params"], _batch(batch), cfg, layer_hook=hook)

    def state_from(params):
        """A fresh train state over ``params`` (fp32 master tensors on the
        runtime's device)."""
        for t in tree_leaves(params):
            if t.device != device or t.dtype != cfg.param_dtype:
                raise ValueError(
                    f"state_from needs {cfg.param_dtype} parameters on {device}, got "
                    f"{t.dtype} on {t.device}"
                )
        return {"params": _trainable(params), "opt": init_opt_state(params), "step": 0}

    def init_state(seed: int):
        return state_from(modeling.init_model_params(cfg, seed, device))

    return Runtime(cfg=cfg, device=device, chunks=chunks, ckpt=ckpt,
                   train_step=train_step, eval_loss=eval_loss, init_state=init_state,
                   state_from=state_from)
