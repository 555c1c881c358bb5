"""The port's ranks, groups, batch layout and sharding rules against the JAX
package's mesh on the 8-device CPU simulation (no processes): for every TP
degree and layout the TP and DP rank groups equal the ``MeshAxes`` device
groups, ``batch_rows`` / ``seq_slice`` put each row and position where
``jax.device_put`` under the activation spec (and the loader's global batch
spec) puts it, and ``param_layout`` equals ``param_spec`` leaf by leaf for
the LLaMA and GPT trees under each strategy of ``tests/test_hybrid_runtime.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from galvatron_tpu.core import strategy as js
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.parallel import hybrid as jhybrid
from galvatron_tpu.parallel import mesh as jmesh_mod
from galvatron_tpu.parallel.mesh import build_mesh, global_batch_spec
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.core import strategy as ts
from galvatron_tpu_torch.core.optim import tree_leaves
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.parallel import hybrid as thybrid
from galvatron_tpu_torch.parallel.mesh import RankMesh, build_axes, data_parallel_degree
from galvatron_tpu_torch.parallel.sharding import param_layout, shard, unshard
import _torch_threads  # noqa: F401

WORLD = 8
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
             max_seq_len=32)
GPT = dict(pos_embed="learned", norm_type="layernorm", act_fn="gelu", tie_word_embeddings=True,
           use_bias=True)


def _strategies(m):
    """``tests/test_hybrid_runtime.py``'s STRATEGIES, built from module ``m``
    (the JAX package's strategy module or the port's copy)."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy
    return {
        "pure_dp": U(4, tp=1, mixed_precision="fp32", vocab_tp=1),
        "tp2": U(4, tp=2, mixed_precision="fp32", vocab_tp=2),
        "tp4_sp": U(4, tp=4, sp=True, mixed_precision="fp32", vocab_tp=4),
        "tp2_strided": U(4, tp=2, tp_consec=False, mixed_precision="fp32", vocab_tp=1),
        "zero3": U(4, tp=1, dp_type="zero3", mixed_precision="fp32", vocab_tp=1,
                   embed_dp_type="zero3"),
        "zero2": U(4, tp=1, dp_type="zero2", mixed_precision="fp32", vocab_tp=1),
        "ckpt": U(4, tp=2, ckpt=True, mixed_precision="fp32", vocab_tp=2),
        "ckpt_selective": U(4, tp=2, ckpt="selective", mixed_precision="fp32", vocab_tp=2),
        "accum2": U(4, tp=1, mixed_precision="fp32", vocab_tp=1, chunks=2),
        "hetero": m.HybridParallelConfig(
            pp=1, layer_strategies=[L(tp=1, dp_type="zero3"), L(tp=2, dp_type="ddp", ckpt=True),
                                    L(tp=4, sp=True, dp_type="ddp"),
                                    L(tp=2, tp_consec=False, dp_type="zero2")],
            vocab_tp=2, mixed_precision="fp32"),
    }


@pytest.fixture(scope="module")
def jmesh():
    return build_mesh(pp=1)


def _jax_groups(mesh, axes_names):
    """Every group of devices over ``axes_names`` (in shard-index order)."""
    ids = np.vectorize(lambda d: d.id)(mesh.devices)[0]  # drop the pp axis
    names = list(mesh.axis_names[1:])
    if not axes_names:
        return sorted([[int(i)] for i in ids.reshape(-1)])
    pos = [names.index(a) for a in axes_names]
    rest = [i for i in range(len(names)) if i not in pos]
    g = np.transpose(ids, rest + pos).reshape(-1, 2 ** len(pos))
    return sorted(g.tolist())


@pytest.mark.parametrize("consec", [True, False])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tp_and_dp_groups_equal_the_jax_mesh(jmesh, tp, consec):
    mesh, jaxes = jmesh
    rm = RankMesh(WORLD)
    assert rm.axes.data_axes == jaxes.data_axes
    t_ax, d_ax = rm.axes.tp_axes(tp, consec), rm.axes.dp_axes(tp, consec)
    assert (t_ax, d_ax) == (jaxes.tp_axes(tp, consec), jaxes.dp_axes(tp, consec))
    assert data_parallel_degree(rm.axes, ts.LayerStrategy(tp=tp, tp_consec=consec)) == \
        jmesh_mod.data_parallel_degree(jaxes, js.LayerStrategy(tp=tp, tp_consec=consec))
    for axes in (t_ax, d_ax):
        jgroups = _jax_groups(mesh, axes)
        assert sorted(rm.partition(axes)) == jgroups
        for r in range(WORLD):
            g = rm.group(r, axes)
            assert g in jgroups and g == sorted(g)  # torch orders a group's ranks
            assert g[rm.index(r, axes)] == r


def _ts_strategy(s):
    return ts.LayerStrategy(tp=s.tp, tp_consec=s.tp_consec, dp_type=s.dp_type, sp=s.sp)


LAYOUT_STRATEGIES = [js.LayerStrategy(tp=t, tp_consec=c, sp=sp)
                     for t in (1, 2, 4, 8) for c in (True, False) for sp in (False, True)
                     if not (t == 1 and (sp or not c))]


@pytest.mark.parametrize("s", LAYOUT_STRATEGIES, ids=lambda s: js.form_strategy(s))
def test_batch_rows_and_seq_slice_match_the_jax_placement(jmesh, s):
    mesh, jaxes = jmesh
    rm = RankMesh(WORLD)
    rows, seq = 16, 32
    tokens = np.arange(rows * seq * 2).reshape(rows, seq, 2)
    arr = jax.device_put(tokens, NamedSharding(mesh, jhybrid.activation_spec(jaxes, s)))
    seen = set()
    for shard_ in arr.addressable_shards:
        r = shard_.device.id
        want = tokens[rm.batch_rows(r, _ts_strategy(s), rows), rm.seq_slice(r, _ts_strategy(s), seq)]
        np.testing.assert_array_equal(np.asarray(shard_.data), want)
        seen.add(r)
    assert seen == set(range(WORLD))


def test_global_batch_rows_match_the_loader_placement(jmesh):
    """The loader's batch spec (all data axes) is a tp=1 layer's rows."""
    mesh, jaxes = jmesh
    rm = RankMesh(WORLD)
    batch = np.arange(16 * 33).reshape(16, 33)
    arr = jax.device_put(batch, NamedSharding(mesh, global_batch_spec(jaxes)))
    for shard_ in arr.addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard_.data), batch[rm.batch_rows(shard_.device.id, ts.LayerStrategy(), 16)])


def test_uneven_rows_are_refused():
    rm = RankMesh(WORLD)
    with pytest.raises(ValueError, match="do not split evenly"):
        rm.batch_rows(0, ts.LayerStrategy(), 4)


def _cfgs(family):
    extra = GPT if family == "gpt" else {}
    return (jm.ModelConfig(dtype=jnp.float32, **SHAPE, **extra),
            tm.ModelConfig(dtype=torch.float32, **SHAPE, **extra))


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_annotations_and_shapes_equal_the_jax_tree(family):
    jcfg, tcfg = _cfgs(family)
    jshape = jax.eval_shape(lambda: jm.init_model_params(jax.random.key(0), jcfg))
    tshape = thybrid.param_shapes(tcfg)
    assert jax.tree.map(lambda a: tuple(a.shape), jshape) == tshape
    assert jm.model_annotations(jcfg) == tm.model_annotations(tcfg)


def _entries(spec):
    """A PartitionSpec's entries as axis tuples (it writes one axis bare)."""
    return tuple((e,) if isinstance(e, str) else (tuple(e) if e is not None else None)
                 for e in spec)


@pytest.mark.parametrize("name", list(_strategies(js)))
@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_param_layout_equals_param_spec_leaf_by_leaf(jmesh, family, name):
    mesh, jaxes = jmesh
    jcfg, tcfg = _cfgs(family)
    jhp, thp = _strategies(js)[name], _strategies(ts)[name]
    jshape = jax.eval_shape(lambda: jm.init_model_params(jax.random.key(0), jcfg))
    plans = thybrid.model_leaf_plans(tcfg, thp, RankMesh(WORLD), thybrid.param_shapes(tcfg))
    for opt in (False, True):
        specs = jhybrid.model_param_specs(jshape, jcfg, jhp, jaxes, for_opt_state=opt)
        jl = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
        tl = tree_leaves(plans)
        assert len(jl) == len(tl)
        for spec, lp in zip(jl, tl):
            assert _entries(spec) == (lp.opt_layout if opt else lp.layout), (name, lp.annot)


def test_param_layout_refuses_a_rank_mismatch():
    with pytest.raises(ValueError, match="rank mismatch"):
        param_layout((4, 4), ("tp",), build_axes(WORLD), ts.LayerStrategy(tp=2))


def test_paired_tp_shards_hold_matching_swiglu_columns():
    """SwiGLU's fused [w1 | w3] splits each projection over TP, so a rank's
    piece is [its w1 columns | the same w3 columns]."""
    rm, f = RankMesh(WORLD), 8
    w = np.arange(3 * 2 * f).reshape(3, 2 * f)
    layout = (None, ("x1", "x2"))  # dim 1 over tp=4 on consecutive ranks
    for r in range(WORLD):
        i = rm.index(r, ("x1", "x2"))
        piece = shard(w, layout, rm, r, pairs=(1, 2))
        np.testing.assert_array_equal(piece, np.concatenate(
            [w[:, i * 2:(i + 1) * 2], w[:, f + i * 2:f + (i + 1) * 2]], axis=1))
    pieces = [shard(w, layout, rm, r, pairs=(1, 2)) for r in range(WORLD)]
    np.testing.assert_array_equal(unshard(pieces, layout, w.shape, rm, pairs=(1, 2)), w)


@pytest.mark.parametrize("name", list(_strategies(ts)))
@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_bridge_shard_then_gather_is_the_identity(family, name):
    _, tcfg = _cfgs(family)
    hp = _strategies(ts)[name]
    full = bridge.params_to_numpy(tm.init_model_params(tcfg, 3, "cpu"))
    pieces = [bridge.shard_params(full, tcfg, hp, r, WORLD) for r in range(WORLD)]
    back = bridge.gather_params(pieces, tcfg, hp, WORLD)
    for a, b in zip(tree_leaves(back), tree_leaves(full)):
        np.testing.assert_array_equal(a, b)
    # a rank holds less than the whole model exactly when something is split
    split = any(lp.layout != (None,) * len(lp.layout) for lp in tree_leaves(
        thybrid.model_leaf_plans(tcfg, hp, RankMesh(WORLD), thybrid.param_shapes(tcfg))))
    sizes = [sum(a.size for a in tree_leaves(p)) for p in pieces]
    assert (max(sizes) < sum(a.size for a in tree_leaves(full))) == split
