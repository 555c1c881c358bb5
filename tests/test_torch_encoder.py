"""BERT (the bidirectional encoder with the masked-LM objective) in the port
against the JAX package at fp32 on the CPU, case for case with
``tests/test_encoder.py``.

Bidirectional attention sees the future (a causal twin does not); the
masked positions are the JAX ``mlm_positions`` bit for bit (token ids up to
2^31 included) and ``split_batch`` gives the JAX inputs and labels; the
forward logits, the loss and every gradient hold the JAX ones within 1e-5
on the einsum path and on the flash path (on the CPU: the grid kernels'
plain versions, unmasked). One 8-rank gloo world trains BERT under tp 2
(with and without SP, vocab tp 2), tp 4 strided, ZeRO-3, a mixed plan and
pp 2 under GPipe and 1F1B, each held to the JAX package's single-device
3-step losses within 2e-4 and gathered parameters within 1e-4 (an element
whose first gradient is within fp32 rounding of zero is held to steps x lr,
as ``tests/test_torch_pipeline.py`` holds it). Context parallelism,
generation and serving of an encoder are refused with the reference's
messages, and the ``bert`` entry package trains.

Run as a script (``python tests/test_torch_encoder.py worker CASES OUT``)
this file is one rank of the world; that path imports no JAX.
"""

import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5  # fp32 on both sides, matmuls summed in other orders
WORLD = 8
STEPS = 3
BATCH, SEQ = 8, 32
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_hybrid_runtime.py's rtol / atol
PARAM_ATOL = 1e-4
ROUNDING_OF_ZERO = 1e-5  # tests/test_torch_pipeline.py's AdamW rule
NOISE_SHARE = 1e-3
WORLD_TIMEOUT_S = 600
# tests/test_encoder.py's ENC, with the GPT layer's biases
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
             max_seq_len=SEQ, pos_embed="learned", norm_type="layernorm", act_fn="gelu",
             tie_word_embeddings=True, causal=False, objective="mlm", use_bias=True)


def _cfgs(**kw):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    shape = dict(SHAPE, **kw)
    return jm.ModelConfig(dtype=jnp.float32, **shape), tm.ModelConfig(dtype=torch.float32,
                                                                       **shape)


def _params(jcfg, seed=0):
    """The JAX init (numpy leaves), norm scales and biases redrawn from a
    seed so that no gradient is structurally zero."""
    import jax

    from galvatron_tpu.models import modeling as jm

    rng = np.random.RandomState(seed + 100)

    def redraw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("'scale']"):
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if key.endswith("_b']") or key.endswith("'bias']"):
            return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
        return a

    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))
    return jax.tree_util.tree_map_with_path(redraw, params)


def _batch(seed=0, rows=BATCH):
    return np.random.RandomState(seed).randint(0, 127, (rows, SEQ + 1)).astype(np.int64)


def test_bidirectional_attention_sees_future():
    """Flipping the last token changes position 0's logits of the encoder
    and none of the earlier positions' of its causal twin (the JAX test's
    case); the encoder's logits equal the JAX ones."""
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs(num_layers=2)
    ref = _params(jcfg)
    params = bridge.params_from_jax(ref, tcfg, "cpu")
    t = torch.from_numpy(_batch()[:, :-1])
    t2 = t.clone()
    t2[:, -1] = (t[:, -1] + 1) % 127
    with torch.no_grad():
        enc, enc2 = tm.forward(params, t, tcfg), tm.forward(params, t2, tcfg)
        dec_cfg = tcfg.replace(causal=True)
        dec, dec2 = tm.forward(params, t, dec_cfg), tm.forward(params, t2, dec_cfg)
    assert not np.allclose(enc[:, 0].numpy(), enc2[:, 0].numpy())
    np.testing.assert_allclose(dec[:, :-1].numpy(), dec2[:, :-1].numpy(), rtol=1e-5, atol=1e-5)
    want = np.asarray(jm.forward(ref, jnp.asarray(t.numpy(), jnp.int32), jcfg))
    np.testing.assert_allclose(enc.numpy(), want, atol=ATOL, rtol=0)


def test_mlm_masking_is_the_jax_masking_bit_for_bit():
    """Deterministic, partial (~15 %) and bitwise the JAX uint32 hash, also
    for token ids whose products wrap 2^32 and for other rates."""
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs()
    t = _batch()[:, :-1]
    m1 = tm.mlm_positions(torch.from_numpy(t), tcfg).numpy()
    np.testing.assert_array_equal(m1, tm.mlm_positions(torch.from_numpy(t), tcfg).numpy())
    assert 0.05 < m1.mean() < 0.3
    big = np.random.RandomState(1).randint(0, 2 ** 31 - 1, (4, 700)).astype(np.int64)
    for tokens in (t, big):
        for rate in (0.15, 0.5):
            got = tm.mlm_positions(torch.from_numpy(tokens), tcfg.replace(mlm_mask_rate=rate))
            want = jm.mlm_positions(jnp.asarray(tokens, jnp.int32),
                                    jcfg.replace(mlm_mask_rate=rate))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_batch_matches_jax():
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs()
    b = _batch(3)
    ti, tl = tm.split_batch(torch.from_numpy(b), tcfg)
    ji, jl = jm.split_batch(jnp.asarray(b, jnp.int32), jcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    masked = tl != -100
    assert bool((ti[masked] == SHAPE["vocab_size"] - 1).all()) and 0 < int(masked.sum()) < b.size
    assert tm.loss_tokens_per_sample(tcfg, SEQ) == jm.loss_tokens_per_sample(jcfg, SEQ)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_and_gradients_match_jax(attn_impl):
    """The masked-LM loss and every gradient of the port equal the JAX
    ``lm_loss``'s (einsum attention) within 1e-5; 'flash' runs the grid
    kernels' plain versions unmasked on the CPU."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs()
    tcfg = tcfg.replace(attn_impl=attn_impl)
    ref = _params(jcfg)
    b = _batch(1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(p, jnp.asarray(b, jnp.int32), jcfg)))(jax.tree.map(jnp.asarray, ref))
    params = bridge.params_from_jax(ref, tcfg, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.lm_loss(params, torch.from_numpy(b), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=0)
    for (path, g), p in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0], leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_encoder_rejects_cp_generation_serving_packing_and_export(capsys):
    """The reference's refusals, with its messages: a CP layer on an
    encoder, generation, the serving engine (and ``cli serve`` /
    ``generate``), packed rows and ``cli export-hf``."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy
    from galvatron_tpu_torch.models import generation
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid
    from galvatron_tpu_torch.serving import Engine

    _, tcfg = _cfgs(num_layers=2)
    hp = HybridParallelConfig(pp=1, layer_strategies=[LayerStrategy(cp=2), LayerStrategy(cp=2)],
                              mixed_precision="fp32")
    with pytest.raises(ValueError, match="causal-only"):
        hybrid.build_runtime(tcfg, hp, global_batch_size=8, seq_len=SEQ, device="cpu")
    params = tm.init_model_params(tcfg, 0, "cpu")
    with pytest.raises(ValueError, match="causal"):
        generation.generate(params, torch.zeros((1, 4), dtype=torch.long), [4], tcfg)
    with pytest.raises(ValueError, match="serving engine requires a decoder-only causal LM"):
        Engine(params, tcfg, device="cpu", start_loop=False)
    with pytest.raises(ValueError, match="pack_sequences requires a decoder-only CLM"):
        hybrid.build_runtime(tcfg.replace(pack_sequences=True), None, global_batch_size=8,
                             seq_len=SEQ, device="cpu")
    flags = ["--device", "cpu", "--model_size", "bert-base", "--num_layers", "1",
             "--hidden_size", "64", "--num_heads", "4"]
    with pytest.raises(ValueError, match="serving engine requires a decoder-only causal LM"):
        cli.main(["serve", *flags])
    with pytest.raises(ValueError, match="generation requires a decoder-only causal LM"):
        cli.main(["generate", *flags, "--prompt", "hi"])
    capsys.readouterr()
    assert cli.main(["export-hf", *flags, "--output_dir", "/nonexistent"]) == 2
    assert "export-hf exports causal LM decoders only" in capsys.readouterr().out


def test_bert_family_entry(capsys):
    from galvatron_tpu_torch.models import bert

    rc = bert.main(
        ["train", "--device", "cpu", "--model_size", "bert-base",
         "--hidden_size", "64", "--num_layers", "2", "--num_heads", "4",
         "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
         "--global_train_batch_size", "8", "--train_iters", "1",
         "--mixed_precision", "fp32", "--check_loss", "1"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "iter 0: loss" in out and "bert-base layers=2" in out


# ---------------------------------------------------------------------------
# the 8-rank world (no JAX in a rank)
# ---------------------------------------------------------------------------


def _strategies(m):
    """name → (model shape change, plan) built from strategy module ``m``:
    ``tests/test_encoder.py``'s tp plans and pipelines, and more."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy
    return {
        "tp2_sp_vt2": ({}, U(4, tp=2, sp=True, mixed_precision="fp32", vocab_tp=2)),
        "tp2_vt2": ({}, U(4, tp=2, mixed_precision="fp32", vocab_tp=2)),
        "tp4_strided": ({}, U(4, tp=4, tp_consec=False, mixed_precision="fp32", vocab_tp=1)),
        "zero3_ckpt": ({}, U(4, tp=1, dp_type="zero3", ckpt=True, mixed_precision="fp32",
                             embed_dp_type="zero3")),
        "hetero_flash": (dict(attn_impl="flash"), m.HybridParallelConfig(
            pp=1, layer_strategies=[L(tp=2, sp=True, dp_type="zero3"),
                                    L(tp=4, tp_consec=False, ckpt="selective"),
                                    L(tp=1, dp_type="zero2", ckpt=True),
                                    L(tp=4, sp=True)],
            vocab_tp=2, mixed_precision="fp32")),
        "pp2_gpipe": ({}, U(4, pp=2, chunks=2, mixed_precision="fp32", pipeline_type="gpipe")),
        "pp2_1f1b": ({}, U(4, pp=2, tp=2, chunks=2, mixed_precision="fp32", vocab_tp=2,
                           pipeline_type="pipedream_flush")),
    }


CASE_NAMES = ("tp2_sp_vt2", "tp2_vt2", "tp4_strided", "zero3_ckpt", "hetero_flash",
              "pp2_gpipe", "pp2_1f1b")


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch import bridge
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
            rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                                      global_batch_size=BATCH, seq_len=SEQ, device="cpu")
            local = bridge.shard_params(case["params"], cfg, hp, rank, world)
            state = rt.state_from(hybrid.zip_map(
                lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
            losses = [float(rt.eval_loss(state, torch.from_numpy(case["batches"][0])))]
            for b in case["batches"]:
                state, loss = rt.train_step(state, torch.from_numpy(b))
                losses.append(float(loss))
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump({"losses": losses,
                             "params": bridge.params_to_numpy(state["params"])}, f)
    finally:
        dist.destroy_process_group()


def _jax_reference(shape, params, batches):
    """(eval loss of the first batch then the 3 step losses, final params,
    first-step gradients) of the JAX single-device AdamW trajectory."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig, adamw_update, init_opt_state
    from galvatron_tpu.models import modeling as jm

    cfg = jm.ModelConfig(dtype=jnp.float32, **dict(shape, attn_impl="xla"))
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from galvatron_tpu_torch.core import strategy as ts
    from galvatron_tpu_torch.parallel.launch import launch_local

    d = tmp_path_factory.mktemp("torch_encoder_world")
    tst = _strategies(ts)
    assert tuple(tst) == CASE_NAMES
    cases, table = [], {}
    for i, (name, (change, thp)) in enumerate(tst.items()):
        shape = dict(SHAPE, **change)
        params = _params(_cfgs(**change)[0], seed=i)
        batches = [_batch(10 * i + k) for k in range(STEPS)]
        table[name] = (shape, thp, params, batches)
        cases.append(dict(name=name, shape=shape, plan=thp.to_json_dict(), params=params,
                          batches=batches))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()  # the JAX references are computed while the world trains
    refs = {name: _jax_reference(shape, params, batches)
            for name, (shape, _, params, batches) in table.items()}
    run.join()
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


@pytest.mark.parametrize("name", CASE_NAMES)
def test_bert_trains_like_the_jax_package(world, name):
    """The first batch's eval loss, then the 3 step losses, within 2e-4
    (a pipeline's eval and train steps included: the masked count of each
    micro-batch is ragged), and the gathered parameters within 1e-4."""
    import jax

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models.modeling import ModelConfig

    table, refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    shape, thp, _, _ = table[name]
    jlosses, jparams, jgrads = refs[name]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    full = bridge.gather_params([g["params"] for g in got],
                                ModelConfig(dtype=torch.float32, **shape), thp, WORLD)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j), g in zip(tree_leaves(full), flat, jax.tree.leaves(jgrads)):
        key = jax.tree_util.keystr(path)
        noise = np.abs(g) <= ROUNDING_OF_ZERO * np.abs(g).max()
        np.testing.assert_allclose(t[~noise], j[~noise], atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(t[noise], j[noise], atol=STEPS * LR, rtol=0, err_msg=key)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key


def test_every_rank_of_the_world_exited_cleanly(world):
    _, _, _, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "worker":
        _worker(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} worker CASES OUT")
