"""The shared half of the encoder-decoder world tests
(``tests/test_torch_encdec_world.py``, ``tests/test_torch_encdec_search.py``):
the tiny T5 of ``tests/test_encdec.py``, its plans, the JAX package's
single-device AdamW trajectory, and the rank worker of an 8-rank gloo world
that trains the port under each plan.

Run as a script (``python tests/_encdec_common.py worker CASES OUT``) this
file is one rank of the world; that path imports no JAX.
"""

import functools
import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
STEPS = 2
LR = 1e-3
EVAL_TOL = 3e-5  # tests/test_encdec.py's eval parity
LOSS_TOL = 5e-5  # tests/test_encdec.py's trajectory parity
CHUNKS_TOL = 2e-4  # tests/test_encdec.py's any-chunks parity
PARAM_ATOL = 1e-4
ROUNDING_OF_ZERO = 1e-5
NOISE_SHARE = 1e-3
WORLD_TIMEOUT_S = 600
# tests/test_encdec.py's T5
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=16, enc_layers=2, enc_seq=16, pos_embed="learned", norm_type="rms",
             act_fn="gelu", tie_word_embeddings=True)


def t5_shape(**kw):
    return dict(SHAPE, **kw)


def search_costs(m, E, D):
    """tests/test_encdec.py's two synthetic layer types (strategy module
    ``m``: either package's ``cost_model``)."""
    enc = m.ProfiledLayerType(
        fwd_ms_per_sample=1.0, parameter_mb=40.0,
        activation_mb_per_sample={1: 20.0, 2: 10.0, 4: 5.0},
        boundary_activation_mb_per_sample=2.0)
    dec = m.ProfiledLayerType(
        fwd_ms_per_sample=2.5, parameter_mb=70.0,
        activation_mb_per_sample={1: 40.0, 2: 20.0, 4: 10.0},
        boundary_activation_mb_per_sample=2.0)
    return m.ProfiledModelCosts(
        layer_types={i: (enc if i < E else dec) for i in range(E + D)},
        other_param_mb=30.0, other_act_mb_per_sample=4.0, other_fwd_ms_per_sample=0.2)


def hardware(m):
    return m.ProfiledHardware(
        allreduce_bw={"2_1": 150.0, "2_0": 30.0, "4_1": 140.0, "8_1": 120.0},
        p2p_bw={2: 50.0}, overlap_coe=1.1)


def searched_plans(cm, se, profile):
    """The plans the multi-layer-type search emits (``cm`` / ``se``: a
    package's ``cost_model`` and ``search_engine``; ``profile(cfg)`` that
    package's measure-free profile of a model shape dict): tests/
    test_encdec.py's pp 1 (at most tp 4: the port splits the 4 heads
    exactly, where GSPMD would replicate them over tp 8), pp 2 and pp 2
    ragged searches on 8 devices, the
    E = 2 / D = 4 model at pp 4, and the coupled 1F1B under a budget only
    it fits (no recompute, 8 devices at pp 2, 16 rows in 8 micro-batches:
    more than the 4pp - 1 that 1F1B stashes at most)."""
    def engine(costs, layers, budget, **space):
        return se.SearchEngine(costs, hardware(cm), num_layers=layers,
                               space=se.SearchSpace(world_size=8, **space),
                               memory_budget_mb=budget)

    out = {}
    out["search_pp1"] = engine(search_costs(cm, 2, 2), 4, 700.0, pp_choices=[1],
                               max_tp=4).search([8]).config
    out["search_pp2"] = engine(search_costs(cm, 2, 2), 4, 700.0, pp_choices=[2],
                               max_tp=2).search([8]).config
    out["search_pp2_ragged"] = engine(search_costs(cm, 3, 5), 8, 1400.0, pp_choices=[2],
                                      max_tp=2).search([8]).config
    small = t5_shape(enc_layers=2, num_layers=4)
    eng4 = se.SearchEngine(profile(small), cm.ProfiledHardware(), num_layers=6,
                           space=se.SearchSpace(world_size=8, pp_choices=[4], max_tp=1),
                           memory_budget_mb=2000.0, mixed_precision="fp32")
    out["search_pp4"] = eng4.evaluate(4, 8, 4, "gpipe").config

    def f1b_engine(budget):
        return se.SearchEngine(profile(SHAPE), cm.ProfiledHardware(), num_layers=4,
                               space=se.SearchSpace(world_size=8, pp_choices=[2], max_tp=2,
                                                    allow_ckpt=False),
                               memory_budget_mb=budget, mixed_precision="fp32",
                               mem_unit_mb=0.0625)

    need = f1b_engine(2000.0).evaluate(2, 16, 8, "pipedream_flush").memory_mb
    out["search_1f1b"] = f1b_engine(need * 1.05).search([16], max_chunks=8).config
    return out


def hand_cases(m):
    """name → (model shape, plan, batch rows, loss tolerance) from strategy
    module ``m``: tests/test_encdec.py's multi-rank plans and more (the
    module docstring of tests/test_torch_encdec_world.py)."""
    U, L, H = m.HybridParallelConfig.uniform, m.LayerStrategy, m.HybridParallelConfig
    fp32 = dict(mixed_precision="fp32")
    ragged_div = U(8, pp=2, chunks=2, **fp32)
    ragged_div.pp_division = [2, 1, 2, 3]
    cases = {
        "tp2_hetero": (SHAPE, H(pp=1, layer_strategies=[
            L(tp=2, sp=True), L(tp=1, dp_type="zero3"),
            L(tp=2, ckpt=True), L(tp=4, dp_type="zero2")], vocab_tp=2, **fp32), 8, LOSS_TOL),
        # the encoder output (8 tokens, the decoder 16) in four decoder layouts
        "dec_layouts": (t5_shape(num_layers=4, enc_seq=8), H(pp=1, layer_strategies=[
            L(tp=2, sp=True, dp_type="zero3"), L(tp=1),
            L(tp=2, sp=True), L(tp=4, tp_consec=False), L(tp=1, dp_type="zero3", ckpt=True),
            L(tp=2, dp_type="zero2", ckpt="selective")], vocab_tp=2, **fp32), 8, LOSS_TOL),
        "pp2_ddp": (SHAPE, U(4, pp=2, chunks=2, **fp32), 8, LOSS_TOL),
        "pp2_tp2_zero3_ckpt": (SHAPE, U(4, pp=2, tp=2, dp_type="zero3", ckpt=True, chunks=2,
                                        vocab_tp=2, **fp32), 8, LOSS_TOL),
        "ragged_pp2": (t5_shape(enc_layers=3, num_layers=5), U(8, pp=2, chunks=2, **fp32), 8,
                       LOSS_TOL),
        "ragged_div": (t5_shape(enc_layers=3, num_layers=5), ragged_div, 8, LOSS_TOL),
        "1f1b_444": (t5_shape(enc_layers=4, num_layers=4),
                     U(8, pp=2, chunks=4, pipeline_type="pipedream_flush", **fp32), 16,
                     LOSS_TOL),
        "small_enc_pp4_gpipe": (t5_shape(num_layers=4), U(6, pp=4, chunks=4, **fp32), 8,
                                LOSS_TOL),
        "small_enc_pp4_1f1b": (t5_shape(num_layers=4), U(6, pp=4, chunks=4,
                                                       pipeline_type="pipedream_flush", **fp32),
                               8, LOSS_TOL),
        "chunks3_gpipe": (SHAPE, U(4, pp=2, chunks=3, **fp32), 24, CHUNKS_TOL),
        "chunks3_1f1b": (SHAPE, U(4, pp=2, chunks=3, pipeline_type="pipedream_flush", **fp32),
                         24, CHUNKS_TOL),
        "chunks1_1f1b": (SHAPE, U(4, pp=2, chunks=1, pipeline_type="pipedream_flush", **fp32),
                         24, CHUNKS_TOL),
    }
    return cases


def search_cases(searched):
    """name → (model shape, plan, batch rows, loss tolerance) of the
    searched plans (:func:`searched_plans`, as the port's strategies)."""
    shapes = {"search_pp1": SHAPE, "search_pp2": SHAPE,
              "search_pp2_ragged": t5_shape(enc_layers=3, num_layers=5),
              "search_pp4": t5_shape(num_layers=4), "search_1f1b": SHAPE}
    cases = {}
    for name, hp in searched.items():
        hp.mixed_precision = "fp32"
        cases[name] = (shapes[name], hp, 16 if name == "search_1f1b" else 8, LOSS_TOL)
    return cases


def jax_params(shape, seed=0):
    """The JAX init (numpy leaves), norm scales redrawn from a seed so that
    no gradient is structurally zero."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm

    rng = np.random.RandomState(seed + 100)

    def redraw(path, a):
        if jax.tree_util.keystr(path).endswith("'scale']"):
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    cfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), cfg))
    return jax.tree_util.tree_map_with_path(redraw, params)


def make_batches(shape, rows, seed, steps=STEPS):
    width = shape["enc_seq"] + shape["max_seq_len"] + 1
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (rows, width)).astype(np.int64) for _ in range(steps)]


def worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core import checkpoint as ck
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    try:
        for case in cases:
            cfg = ModelConfig(dtype=torch.float32, **case["shape"])
            hp = HybridParallelConfig.from_json_dict(case["plan"])
            batches = [torch.from_numpy(b) for b in case["batches"]]
            rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                                      global_batch_size=batches[0].shape[0],
                                      seq_len=cfg.max_seq_len, device="cpu")
            out = {}
            if case.get("restore"):
                # a pp 1 checkpoint (the parent's) into this plan's layout
                state = ck.restore_checkpoint_portable(case["restore"], rt)
                out["restored_params"] = hybrid.zip_map(  # training updates state in place
                    lambda a, n: np.array(a, copy=True), bridge.params_to_numpy(state["params"]))
            else:
                local = bridge.shard_params(case["params"], cfg, hp, rank, world)
                state = rt.state_from(hybrid.zip_map(
                    lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
            losses = [float(rt.eval_loss(state, batches[0]))]
            for b in batches:
                state, loss = rt.train_step(state, b)
                losses.append(float(loss))
            out["losses"] = losses
            out["params"] = bridge.params_to_numpy(state["params"])
            out["stage_layers"] = list(rt.stage_layers)
            if case.get("save"):
                out["eval_after"] = float(rt.eval_loss(state, batches[0]))
                ck.save_checkpoint_portable(case["save"], state, STEPS, rt)
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def jax_reference(shape, params, batches):
    """(eval loss of the first batch then the step losses, final params,
    first-step gradients) of the JAX single-device AdamW trajectory."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig, adamw_update, init_opt_state
    from galvatron_tpu.models import modeling as jm

    cfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    adam = AdamConfig(lr=LR, grad_clip=1.0)
    p = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jax.value_and_grad(lambda q, b: jm.lm_loss(q, b, cfg)))
    loss0, g0 = step(p, jnp.asarray(batches[0]))
    losses, opt = [float(loss0)], init_opt_state(p)
    for b in batches:
        loss, grads = step(p, jnp.asarray(b))
        p, opt = adamw_update(p, grads, opt, adam)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, g0)


def ref_key(shape, rows):
    return (tuple(sorted(shape.items())), rows)


def pp1_checkpoint(shape, params, ckpt_dir):
    """A pp 1 portable checkpoint of ``params`` written by the port at
    world size 1 (the world restores it at pp 2)."""
    from galvatron_tpu_torch.core import checkpoint as ck
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    cfg = ModelConfig(dtype=torch.float32, **shape)
    rt = hybrid.build_runtime(cfg, HybridParallelConfig.uniform(4, mixed_precision="fp32"),
                              AdamConfig(lr=LR, grad_clip=1.0), global_batch_size=8,
                              seq_len=cfg.max_seq_len, device="cpu")
    state = rt.state_from(hybrid.zip_map(
        lambda a, n: torch.from_numpy(np.array(a, copy=True)), params))
    ck.save_checkpoint_portable(str(ckpt_dir), state, 0, rt)


def jax_profile(shape):
    """The JAX package's measure-free profile of ``shape`` (made once a
    process: it compiles three programs)."""
    return _jax_profile(tuple(sorted(shape.items())))


@functools.lru_cache(maxsize=None)
def _jax_profile(items):
    import jax.numpy as jnp

    from galvatron_tpu.models.modeling import ModelConfig
    from galvatron_tpu.profiling.model import profile_model

    return profile_model(ModelConfig(dtype=jnp.float32, **dict(items)), bsz=8,
                         measure_time=False)


def run_world(d, table, extra=(), prepare=None, steps=STEPS):
    """Train every case of ``table`` (name → (shape, plan, rows, tol)) and
    the ``extra`` case dicts (each naming the :func:`ref_key` of the weights
    and batches it takes as ``ref``) in one 8-rank world under ``d``,
    computing the JAX references meanwhile; ``prepare(inputs)`` runs before
    the world starts, with the weights and batches by key. Each case
    trains ``steps`` steps. Returns
    (references by key, results by case name, the ranks, the case dicts)."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    refs_in, cases = {}, []
    for name, (shape, hp, rows, _) in table.items():
        key = ref_key(shape, rows)
        if key not in refs_in:
            refs_in[key] = (shape, jax_params(shape, seed=len(refs_in)),
                            make_batches(shape, rows, 10 * len(refs_in), steps))
        _, params, batches = refs_in[key]
        cases.append(dict(name=name, shape=shape, plan=hp.to_json_dict(), params=params,
                          batches=batches))
    cases += [dict(c, **{k: v for k, v in zip(("params", "batches"), refs_in[c.pop("ref")][1:])})
              for c in extra]
    if prepare is not None:
        prepare(refs_in)
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()  # the JAX references are computed while the world trains
    refs = {key: jax_reference(*v) for key, v in refs_in.items()}
    run.join()
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return refs, results, out["ranks"], cases


def world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def gather(got, shape, plan):
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig

    hp = HybridParallelConfig.from_json_dict(plan)
    return bridge.gather_params([g["params"] for g in got],
                                ModelConfig(dtype=torch.float32, **shape), hp, WORLD)


def check_trains_like_jax(table, refs, results, ranks, name):
    """The first batch's eval loss within 3e-5, the step losses within the
    case's tolerance, the gathered parameters within 1e-4 of the JAX
    single-device trajectory (an element whose first gradient is within
    fp32 rounding of zero within steps x lr)."""
    import jax

    from galvatron_tpu_torch.core.optim import tree_leaves

    assert name in results, world_failure(ranks)
    shape, hp, rows, tol = table[name]
    jlosses, jparams, jgrads = refs[ref_key(shape, rows)]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=EVAL_TOL, atol=EVAL_TOL)
    np.testing.assert_allclose(losses[1:], jlosses[1:], rtol=tol, atol=tol)
    full = gather(got, shape, hp.to_json_dict())
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j), g in zip(tree_leaves(full), flat, jax.tree.leaves(jgrads)):
        key = jax.tree_util.keystr(path)
        noise = np.abs(g) <= ROUNDING_OF_ZERO * np.abs(g).max()
        np.testing.assert_allclose(t[~noise], j[~noise], atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(t[noise], j[noise], atol=(len(losses) - 1) * LR, rtol=0,
                                   err_msg=key)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "worker":
        worker(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} worker CASES OUT")
