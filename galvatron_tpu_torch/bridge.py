"""Weights between the JAX package and the port.

``params_from_jax`` takes the JAX package's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``, or a checkpoint's leaves) and returns
the port's tree of tensors on ``device``, with the same names and layouts:
``x @ W`` everywhere, the blocked ``(h, 3, n·hd)`` or interleaved
``(h, kv·group)`` fused QKV, so nothing is transposed. A BERT tree is the
GPT one (its token table tied to the head); a ViT tree has the patch
projection and its positions (``embed.proj``, ``embed.pos``), the final norm
and the class head (``head.w``) in place of the token table. Matmul weights,
the embeddings and the projection biases are cast to the compute dtype once
(``modeling.cast_params``); norm scales and biases stay fp32.
``params_from_jax`` accepts what training accepts
(``modeling.check_supported``). ``params_to_numpy`` is the way back.

``shard_params`` cuts a full tree (numpy) into one rank's pieces under a
hybrid plan, pipelines included (the layout ``parallel/hybrid.py``
trains), and ``gather_params`` puts every rank's pieces back into one tree,
to compare a multi-rank run with the JAX parameters.

``state_from_jax`` and ``state_to_jax`` carry the whole train state (params,
Adam ``mu`` / ``nu`` / ``count``, ``step`` and the fp16 scaler) between the
JAX package's ``portable_flat_state`` leaves, flattened by
``jax.tree_util.keystr`` (numpy), and the port's portable flat leaves
(``core/checkpoint.py``): the same names, shapes and dtypes, so the
conversion is name for name.

This module takes numpy and imports no JAX, so the port stays free of it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.models.modeling import ModelConfig, Params


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree_of_numpy: Params, cfg: ModelConfig, device) -> Params:
    modeling.check_supported(cfg)
    params = _tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree_of_numpy
    )
    return modeling.cast_params(params, cfg)


def params_to_numpy(params: Params) -> Params:
    """Tensors → numpy (bf16 upcast to fp32, which numpy has no type for)."""
    return _tree_map(
        lambda t: (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy(),
        params,
    )


def _plans(cfg: ModelConfig, hp, world: int):
    from galvatron_tpu_torch.parallel import hybrid
    from galvatron_tpu_torch.parallel.mesh import RankMesh

    mesh = RankMesh(world, hp.pp)
    return mesh, hybrid.model_leaf_plans(cfg, hp, mesh, hybrid.param_shapes(cfg))


def _held(tree, cfg: ModelConfig, hp, stage: int):
    """The part of a full tree that a pipeline stage holds."""
    from galvatron_tpu_torch.parallel import pipeline

    return pipeline.held_tree(tree, pipeline.device_layers(cfg.num_layers, hp, stage),
                              stage == 0, stage == hp.pp - 1,
                              cfg.tie_word_embeddings and hp.pp > 1)


def shard_params(full_tree: Params, cfg: ModelConfig, hp, rank: int, world: int) -> Params:
    """``rank``'s pieces (numpy) of a full numpy parameter tree under the
    plan ``hp`` on ``world`` ranks: the part its pipeline stage holds
    (``pipeline.held_tree``; everything at pp = 1), its TP shard of every
    parameter there, and its DP shard of zero3 ones."""
    from galvatron_tpu_torch.parallel import hybrid

    mesh, plans = _plans(cfg, hp, world)
    stage = mesh.stage(rank)
    return hybrid.shard_tree(_held(full_tree, cfg, hp, stage), _held(plans, cfg, hp, stage),
                             mesh, rank)


def gather_params(rank_trees: Sequence[Params], cfg: ModelConfig, hp, world: int) -> Params:
    """The full numpy tree from every rank's pieces (``rank_trees[r]`` of
    rank r, numpy): each stage's part from its own ranks (replicas take the
    lowest rank's copy; a tied table held by the first and the last stage is
    taken once, from the first)."""
    from galvatron_tpu_torch.parallel import hybrid, pipeline
    from galvatron_tpu_torch.parallel.mesh import RankMesh
    from galvatron_tpu_torch.parallel.sharding import unshard

    mesh, plans = _plans(cfg, hp, world)
    if len(rank_trees) != world:
        raise ValueError(f"{len(rank_trees)} rank trees for a world of {world}")
    stage_mesh = RankMesh(mesh.per_stage)
    full: dict = {"layers": [None] * cfg.num_layers}
    for stage in range(hp.pp):
        part = hybrid.zip_map(
            lambda lp, *pieces: unshard(pieces[:-1], lp.layout, lp.shape, stage_mesh, lp.pairs),
            _held(plans, cfg, hp, stage), *[rank_trees[r] for r in mesh.stage_ranks(stage)])
        for n, i in enumerate(pipeline.device_layers(cfg.num_layers, hp, stage)):
            full["layers"][i] = part["layers"][n]
        for key in part:
            full.setdefault(key, part[key])
    return full


def flat_state_from_jax(leaves: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's flat state leaves (``{keystr: numpy}``) as the
    port's portable flat leaves: CPU tensors of their own memory, names,
    shapes and dtypes unchanged."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in leaves.items()}


def flat_state_to_numpy(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's portable flat leaves as the JAX package's (numpy; bf16
    upcast to fp32, which numpy has no type for)."""
    return {k: (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()
            for k, t in flat.items()}


def state_from_jax(leaves: Dict[str, np.ndarray], runtime) -> Dict[str, Any]:
    """A train state of ``runtime`` (this rank's pieces under its plan)
    from the JAX package's ``portable_flat_state`` leaves."""
    from galvatron_tpu_torch.core.checkpoint import restore_from_flat_leaves

    return restore_from_flat_leaves(runtime, flat_state_from_jax(leaves))


def state_to_jax(state: Dict[str, Any], runtime) -> Optional[Dict[str, np.ndarray]]:
    """``state``'s portable flat leaves as the JAX package names them
    (numpy); collective over the world, rank 0 gets them, the others None."""
    from galvatron_tpu_torch.core.checkpoint import portable_flat_state

    flat = portable_flat_state(state, runtime)
    return None if flat is None else flat_state_to_numpy(flat)
