"""ALiBi positions (the Baichuan-13B scheme) in the port against the JAX
package at fp32 on the CPU.

The slopes equal ``modeling.alibi_slopes`` for power-of-two and other head
counts; the loss and every gradient of a model equal the JAX
``lm_loss``'s within 1e-5 (whatever ``attn_impl`` says: ALiBi always takes
the einsum attention), packed rows included; packed rows need no
per-segment positions (a segment's logits equal its document's alone);
the three cache forwards (contiguous, slot-wise, paged) give the JAX
logits within 1e-5 and greedy generation the JAX tokens, the paged decode
steps on the einsum route; the serving engine's slot and paged backends
give ``generate_np``'s tokens. One 8-rank gloo world trains the ALiBi model
under tp 2 and 4 (consecutive and strided), SP, ZeRO-3, a mixed plan, pp 2
under 1F1B, packed rows and an MoE layer, each held to the JAX package's
3-step losses within 2e-4 and gathered parameters within 1e-4 (its
``build_runtime`` on the 8-device simulation for the mixed plan, its
single-device trajectory for the rest; an element whose first gradient is
within fp32 rounding of zero is held to steps x lr, as
``tests/test_torch_pipeline.py`` holds it); a control that gives every TP
rank the first n/tp slopes must fail. A CP layer on an ALiBi model is refused.
``cli search`` / ``check-plan`` at baichuan-13b give the JAX package's
JSON, and ``cli profile`` runs a baichuan-13b layer.

Run as a script (``python tests/test_torch_alibi.py worker CASES OUT``)
this file is one rank of the world; that path imports no JAX.
"""

import json
import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# fp32 on both sides, matmuls summed in other orders
ATOL = 1e-5
WORLD = 8
STEPS = 3
BATCH, SEQ = 16, 32
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_hybrid_runtime.py's rtol / atol
PARAM_ATOL = 1e-4  # test_torch_training.py's TRAJ_PARAM_ATOL
# tests/test_torch_pipeline.py's AdamW rule: an element whose first gradient
# is within fp32 rounding of zero (below this share of its tensor's largest)
# takes a first step of up to ~lr either way, whatever order the sums ran
# in; it is held to STEPS x LR, and such elements stay under NOISE_SHARE of
# a tensor
ROUNDING_OF_ZERO = 1e-5
NOISE_SHARE = 1e-3
WORLD_TIMEOUT_S = 600
# 12 heads: not a power of two, so the slopes take the interleaved branch
SHAPE = dict(vocab_size=128, hidden_size=96, num_layers=4, num_heads=12, ffn_dim=128,
             max_seq_len=SEQ, pos_embed="alibi")


def _cfgs(**kw):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    shape = dict(SHAPE, **kw)
    return jm.ModelConfig(dtype=jnp.float32, **shape), tm.ModelConfig(dtype=torch.float32,
                                                                       **shape)


def _params(jcfg, seed=0):
    """The JAX init (numpy leaves) with the norm scales redrawn from a seed."""
    import jax

    from galvatron_tpu.models import modeling as jm

    rng = np.random.RandomState(seed + 100)

    def redraw(path, a):
        if jax.tree_util.keystr(path).endswith("'scale']"):
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))
    return jax.tree_util.tree_map_with_path(redraw, params)


def _packed_rows(rng, b, vocab):
    """(b, 2·(SEQ+1)) packed rows: tokens ‖ non-decreasing segment ids of
    two or three documents and a zero-padded tail."""
    rows = []
    width = SEQ + 1
    for _ in range(b):
        cuts = sorted(rng.choice(np.arange(4, width - 3), 2, replace=False))
        seg = np.zeros(width, np.int64)
        seg[:cuts[0]], seg[cuts[0]:cuts[1]] = 1, 2
        seg[cuts[1]:width - rng.randint(0, 4)] = 3
        rows.append(np.concatenate([rng.randint(0, vocab, width), seg]))
    return np.stack(rows)


@pytest.mark.parametrize("n", [4, 8, 12, 40])
def test_alibi_slopes_match_jax(n):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    assert np.array_equal(tm.alibi_slopes(n), jm.alibi_slopes(n))
    cfg = tm.ModelConfig(num_heads=n, hidden_size=8 * n, pos_embed="alibi")
    got = tm.alibi_tensor(cfg, "cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(jnp.asarray(jm.alibi_slopes(n))))
    assert tm.alibi_tensor(cfg.replace(pos_embed="rope"), "cpu") is None


def _loss_and_grads_case(packed, attn_impl):
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs(pack_sequences=packed)
    tcfg = tcfg.replace(attn_impl=attn_impl, mlp_recompute="off")
    jp = _params(jcfg)
    rng = np.random.RandomState(1)
    batch = (_packed_rows(rng, 4, 128) if packed
             else rng.randint(0, 128, (4, SEQ + 1)).astype(np.int64))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(p, jnp.asarray(batch), jcfg)))(jax.tree.map(jnp.asarray, jp))
    tp = bridge.params_from_jax(jp, tcfg, "cpu")
    leaves = {}

    def track(tree, path=""):
        if isinstance(tree, dict):
            return {k: track(v, f"{path}['{k}']") for k, v in tree.items()}
        if isinstance(tree, list):
            return [track(v, f"{path}[{i}]") for i, v in enumerate(tree)]
        leaves[path] = tree.requires_grad_(True)
        return tree

    track(tp)
    tloss = tm.lm_loss(tp, torch.from_numpy(batch), tcfg)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= ATOL
    flat = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(flat) == sorted(leaves)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), flat[k], atol=ATOL, rtol=0, err_msg=k)


def test_packed_rows_need_no_per_segment_positions():
    """ALiBi depends only on k − q and the segment mask cuts across
    segments: each segment's logits in a packed row equal the forward of
    that document alone, within 1e-5 (checked, not assumed)."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs()
    tp = bridge.params_from_jax(_params(jcfg), tcfg, "cpu")
    rows = _packed_rows(np.random.RandomState(7), 2, 128)
    packed = tm.forward(tp, torch.from_numpy(np.concatenate(
        [rows[:, :SEQ], rows[:, SEQ + 1:-1]], axis=1)), tcfg.replace(pack_sequences=True))
    with torch.no_grad():
        for r in range(2):
            tokens, seg = rows[r, :SEQ], rows[r, SEQ + 1:-1]
            for s in (1, 2, 3):
                idx = np.nonzero(seg == s)[0]
                alone = tm.forward(tp, torch.from_numpy(tokens[idx][None]), tcfg)[0]
                np.testing.assert_allclose(packed[r, idx].detach().numpy(), alone.numpy(),
                                           atol=ATOL, rtol=0)


def test_context_parallelism_on_alibi_is_refused():
    """The reference's ring and Ulysses layers carry no ALiBi bias (they
    would drop it), so ``build_runtime`` refuses a cp > 1 layer on an ALiBi
    model, naming the reason; the same plan on a RoPE model passes the
    check."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy
    from galvatron_tpu_torch.parallel import hybrid

    _, tcfg = _cfgs()
    for impl in ("ring", "a2a"):
        hp = HybridParallelConfig(
            layer_strategies=[LayerStrategy(cp=2, cp_impl=impl)] + [LayerStrategy()] * 3,
            mixed_precision="fp32")
        with pytest.raises(NotImplementedError, match="carry no ALiBi bias"):
            hybrid.build_runtime(tcfg, hp, global_batch_size=BATCH, seq_len=SEQ, device="cpu")
        hybrid.check_cp(tcfg.replace(pos_embed="rope"), hp, SEQ)


# ---------------------------------------------------------------------------
# the search, the plan checker and the profiler at baichuan-13b
# ---------------------------------------------------------------------------

#: a search at baichuan-13b's shape that finds a plan in seconds (ZeRO-3 over 8)
SEARCH_FLAGS = ["--model_size", "baichuan-13b", "--num_devices", "8", "--search_space", "sdp",
                "--analytic_costs", "1", "--settle_bsz", "16", "--memory_constraint_gb", "40"]


def test_cli_search_and_check_plan_at_baichuan13b_match_jax(tmp_path, capsys):
    """``cli search --model_size baichuan-13b`` (analytic costs) emits the
    JAX package's plan JSON, and ``cli check-plan`` of it reports what the
    JAX checker reports."""
    from galvatron_tpu.cli import main as j_main
    from galvatron_tpu_torch import cli

    a, b = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert j_main(["search", *SEARCH_FLAGS, "--output_config_path", a]) == 0
    assert cli.main(["search", *SEARCH_FLAGS, "--device", "cpu",
                     "--output_config_path", b]) == 0
    with open(a) as f, open(b) as g:
        assert json.load(g) == json.load(f)
    capsys.readouterr()
    assert j_main(["check-plan", a, "--strict", "1"]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["check-plan", b, "--strict", "1"]) == 0
    tout = capsys.readouterr().out
    assert tout.replace(b, a) == jout


# ---------------------------------------------------------------------------
# the 8-rank world (no JAX in a rank)
# ---------------------------------------------------------------------------


def _strategies(m):
    """name → (model shape change, plan) built from strategy module ``m``."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy
    return {
        "tp2": ({}, U(4, tp=2, mixed_precision="fp32", vocab_tp=2)),
        "tp4": ({}, U(4, tp=4, mixed_precision="fp32", vocab_tp=4)),
        "tp4_strided": ({}, U(4, tp=4, tp_consec=False, mixed_precision="fp32", vocab_tp=1)),
        "tp2_strided_sp": ({}, U(4, tp=2, tp_consec=False, sp=True, mixed_precision="fp32",
                                 vocab_tp=2)),
        "zero3": ({}, U(4, tp=1, dp_type="zero3", mixed_precision="fp32", vocab_tp=1,
                        embed_dp_type="zero3")),
        "hetero": ({}, m.HybridParallelConfig(
            pp=1, layer_strategies=[L(tp=2, sp=True, dp_type="zero3"),
                                    L(tp=4, tp_consec=False, ckpt="selective"),
                                    L(tp=1, dp_type="zero2", ckpt=True),
                                    L(tp=4, sp=True)],
            vocab_tp=2, mixed_precision="fp32")),
        "pp2_1f1b": ({}, m.HybridParallelConfig(
            pp=2, chunks=2, pipeline_type="pipedream_flush",
            layer_strategies=[L(tp=2)] * 4, vocab_tp=2, mixed_precision="fp32")),
        "packed_tp2_sp": (dict(pack_sequences=True), U(4, tp=2, sp=True, mixed_precision="fp32",
                                                       vocab_tp=2)),
        "moe_tp2": (dict(moe_experts=4), U(4, tp=2, mixed_precision="fp32", vocab_tp=2)),
    }


#: the cases of :func:`_strategies`, in order
CASE_NAMES = ("tp2", "tp4", "tp4_strided", "tp2_strided_sp", "zero3", "hetero", "pp2_1f1b",
              "packed_tp2_sp", "moe_tp2")
#: the case whose JAX reference is ``build_runtime`` on the 8-device simulation
GSPMD_CASE = "hetero"
CONTROL = "control_tp4_first_slopes"


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    real = modeling.alibi_local
    try:
        for case in cases:
            cfg = ModelConfig(dtype=torch.float32, **case["shape"])
            hp = HybridParallelConfig.from_json_dict(case["plan"])
            # the control: every TP rank the slopes of the first n/tp heads
            modeling.alibi_local = ((lambda s, tp: s[:len(s) // tp.size]) if case["control"]
                                    else real)
            rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                                      global_batch_size=BATCH, seq_len=SEQ, device="cpu")
            local = bridge.shard_params(case["params"], cfg, hp, rank, world)
            state = rt.state_from(hybrid.zip_map(
                lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
            losses = []
            for b in case["batches"]:
                state, loss = rt.train_step(state, torch.from_numpy(b))
                losses.append(float(loss))
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump({"losses": losses,
                             "params": bridge.params_to_numpy(state["params"])}, f)
    finally:
        modeling.alibi_local = real
        dist.destroy_process_group()


def _batches(shape, seed):
    rng = np.random.RandomState(seed)
    if shape.get("pack_sequences"):
        return [_packed_rows(rng, BATCH, SHAPE["vocab_size"]) for _ in range(STEPS)]
    return [rng.randint(0, SHAPE["vocab_size"], (BATCH, SEQ + 1)).astype(np.int64)
            for _ in range(STEPS)]


def _jax_reference(name, shape, jhp, params, batches):
    """(losses, final params, first-step gradients) of the JAX package:
    ``build_runtime`` on the 8-device simulation for GSPMD_CASE, its
    single-device trajectory for the rest."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig, adamw_update, init_opt_state
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.parallel.hybrid import build_runtime

    cfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    adam = AdamConfig(lr=LR, grad_clip=1.0)
    p = jax.tree.map(jnp.asarray, params)
    losses = []
    step = jax.jit(jax.value_and_grad(lambda q, b: jm.lm_loss(q, b, cfg)))
    g0 = jax.tree.map(np.asarray, step(p, jnp.asarray(batches[0]))[1])
    if name == GSPMD_CASE:
        rt = build_runtime(cfg, jhp, adam=adam, global_batch_size=BATCH, seq_len=SEQ)
        state = rt.init_state_from(p)
        for b in batches:
            state, loss = rt.train_step(state, jnp.asarray(b))
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, state["params"]), g0
    opt = init_opt_state(p)
    for b in batches:
        loss, grads = step(p, jnp.asarray(b))
        p, opt = adamw_update(p, grads, opt, adam)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p), g0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from galvatron_tpu.core import strategy as js
    from galvatron_tpu_torch.core import strategy as ts
    from galvatron_tpu_torch.parallel.launch import launch_local

    d = tmp_path_factory.mktemp("torch_alibi_world")
    jst, tst = _strategies(js), _strategies(ts)
    assert tuple(tst) == CASE_NAMES
    cases, table = [], {}
    for i, name in enumerate(list(tst) + [CONTROL]):
        src = "tp4" if name == CONTROL else name
        change, thp = tst[src]
        shape = dict(SHAPE, **change)
        jcfg, _ = _cfgs(**change)
        params = _params(jcfg)
        batches = _batches(shape, seed=i if name != CONTROL else list(tst).index(src))
        table[name] = (shape, jst[src][1], thp, params, batches)
        cases.append(dict(name=name, shape=shape, plan=thp.to_json_dict(), params=params,
                          batches=batches, control=name == CONTROL))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()  # the JAX references are computed while the world trains
    refs = {name: _jax_reference(name, *row[:2], *row[3:])
            for name, row in table.items() if name != CONTROL}
    run.join()
    refs[CONTROL] = refs["tp4"]
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return table, refs, results, out["ranks"]


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _check(name, table, refs, results):
    import jax

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models.modeling import ModelConfig

    shape, _, thp, _, _ = table[name]
    jlosses, jparams, jgrads = refs[name]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    cfg = ModelConfig(dtype=torch.float32, **shape)
    full = bridge.gather_params([g["params"] for g in got], cfg, thp, WORLD)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j), g in zip(tree_leaves(full), flat, jax.tree.leaves(jgrads)):
        key = jax.tree_util.keystr(path)
        noise = np.abs(g) <= ROUNDING_OF_ZERO * np.abs(g).max()
        np.testing.assert_allclose(t[~noise], j[~noise], atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(t[noise], j[noise], atol=STEPS * LR, rtol=0, err_msg=key)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key


@pytest.mark.parametrize("name", CASE_NAMES)
def test_alibi_trains_like_the_jax_package(world, name):
    table, refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check(name, table, refs, results)


def test_control_first_slopes_on_every_tp_rank_fails(world):
    """Every TP rank given the slopes of heads 0..n/tp-1 instead of its
    own: the same check must fail (the slicing is load-bearing)."""
    table, refs, results, ranks = world
    assert CONTROL in results, _world_failure(ranks)
    with pytest.raises(AssertionError):
        _check(CONTROL, table, refs, results)


def test_every_rank_of_the_world_exited_cleanly(world):
    _, _, _, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "worker":
        _worker(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} worker CASES OUT")
