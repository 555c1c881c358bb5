"""Mixture-of-experts in the port against the JAX package, the model-level
and entry-point half (split from ``tests/test_torch_moe.py``, which holds the
8-rank world, the routing pieces and the helpers these use, so that the
suite's workers share the two): the MoE block's and the whole model's loss
and gradients, greedy generation, the expert-time fit, and ``cli profile`` /
``search --enable_ep`` / ``train`` / ``generate`` / ``serve`` and the plan
checker's EP rules."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_moe import (GPT, GRAD_TOL, LOSS_TOL, ROOT, SHAPE, STEPS, _jmods,
                            _no_jax_temp_bytes, _small_cfgs, _world_failure)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
def test_moe_block_forward_and_gradients_match_jax(act):
    import jax

    from galvatron_tpu_torch.models import moe

    _, jnp, jmoe = _jmods()
    jcfg, tcfg = _small_cfgs(act_fn=act, moe_capacity_factor=1.0)
    p = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.key(1), jcfg))
    x = np.random.RandomState(2).standard_normal((4, 16, 64)).astype(np.float32)
    assert ("w3" in p) == (act == "swiglu")

    def jloss(p, x):
        return jnp.sum(jmoe.moe_block(x, p, jcfg) ** 2)

    jval, (jgp, jgx) = jax.value_and_grad(jloss, (0, 1))(jax.tree.map(jnp.asarray, p),
                                                        jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = moe.moe_block(tx, tp, tcfg)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(float((y ** 2).sum().detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=GRAD_TOL, rtol=GRAD_TOL)
    for k in p:
        g = jgp[k]["w"] if k == "router" else jgp[k]
        t = tp[k]["w"] if k == "router" else tp[k]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["llama", "gpt", "opt"])
def test_moe_model_loss_and_gradients_match_jax(family):
    """One MoE model through ``bridge.params_from_jax``: swiglu experts, and
    the GPT (gelu) and OPT (relu) families, whose experts both run
    tanh-GELU; no biases on the expert leaves under ``use_bias``."""
    import jax

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm

    _, jnp, _ = _jmods()
    extra = {} if family == "llama" else dict(
        {k: v for k, v in GPT.items() if k not in SHAPE or k == "moe_capacity_factor"},
        act_fn="gelu" if family == "gpt" else "relu")
    jcfg, tcfg = _small_cfgs(**extra)
    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(4), jcfg))
    assert "w1_b" not in params["layers"][0]["mlp"] and "router" in params["layers"][0]["mlp"]
    batch = np.random.RandomState(5).randint(0, 128, (4, 17)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.lm_loss(p, jnp.asarray(batch), jcfg)))(
        jax.tree.map(jnp.asarray, params))
    tp = bridge.params_from_jax(params, tcfg, "cpu")
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    tl = tm.lm_loss(tp, torch.from_numpy(batch).long(), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    for t, g in zip(tree_leaves(tp), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_moe_generate_greedy_matches_jax():
    """Greedy generation routes by the raw argmax at every forward (batch-1
    decode follows the router), token for token the JAX ``generate``."""
    import jax

    from galvatron_tpu.models import generation as jgen
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import generation as tgen

    _, jnp, _ = _jmods()
    jcfg, tcfg = _small_cfgs(max_seq_len=32)
    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(6), jcfg))
    tp = bridge.params_from_jax(params, tcfg, "cpu")
    for b in (1, 3):
        prompt = np.random.RandomState(b).randint(1, 128, (b, 7)).astype(np.int32)
        lengths = np.full((b,), 7, np.int32)
        ref = jgen.generate(jax.tree.map(jnp.asarray, params), jnp.asarray(prompt),
                            jnp.asarray(lengths), jcfg, jax.random.key(1), max_new_tokens=6,
                            min_prompt_len=7, temperature=0.0)
        got = tgen.generate(tp, torch.from_numpy(prompt), torch.from_numpy(lengths), tcfg,
                            max_new_tokens=6, min_prompt_len=7, temperature=0.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("slope_ms", [0.002, 0.0])
def test_moe_expert_time_fit_matches_jax(monkeypatch, slope_ms):
    """The two-point fit over the FFN width (t = a + b·f a layer): the
    expert-time fraction b·f / t; a degenerate fit (no slope) falls back to
    the parameter proxy (None)."""
    from galvatron_tpu.profiling import model as jpm
    from galvatron_tpu_torch.profiling import model as tpm

    def fake(cfg, bsz, seq, *a, **k):
        return 3.0 * bsz * cfg.num_layers * (0.5 + slope_ms * cfg.ffn) + 1.0

    monkeypatch.setattr(jpm, "_iter_time_ms", fake)
    monkeypatch.setattr(tpm, "_iter_time_ms", fake)
    _no_jax_temp_bytes(monkeypatch, jpm)
    jcfg, tcfg = _small_cfgs(ffn_dim=1024)
    jt = jpm.profile_model(jcfg, bsz=8, layernums=(1, 2)).layer_types[0]
    tt = tpm.profile_model(tcfg, bsz=8, layernums=(1, 2), device="cpu").layer_types[0]
    assert tt.moe_expert_time_fraction == pytest.approx(jt.moe_expert_time_fraction)
    if slope_ms:
        want = slope_ms * 1024 / (0.5 + slope_ms * 1024)
        assert tt.moe_expert_time_fraction == pytest.approx(want)
    else:
        assert tt.moe_expert_time_fraction is None


TINY = ["--model_size", "llama-0.3b", "--num_layers", "2", "--hidden_size", "64",
        "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
        "--moe_experts", "4"]


TRAIN = ["--global_train_batch_size", "8", "--train_iters", "3", "--mixed_precision", "fp32"]


def _cli_losses(argv, world, tmp_path, tag):
    from galvatron_tpu_torch.parallel.launch import launch_local
    from galvatron_tpu_torch.utils.metrics import read_metrics

    metrics = tmp_path / f"{tag}.jsonl"
    cmd = [sys.executable, "-m", "galvatron_tpu_torch.cli", "train", "--device", "cpu", *argv,
           "--metrics_path", str(metrics)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    if world == 1:
        r = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    else:
        ranks = launch_local(cmd, world, timeout_s=600, cwd=str(ROOT), env=env)
        assert all(r.returncode == 0 for r in ranks), _world_failure(ranks)
    return [r["loss"] for r in read_metrics(str(metrics)) if r["event"] == "train_iter"]


def test_cli_profile_search_enable_ep_then_train(tmp_path):
    """``cli profile`` of an MoE model on the CPU, ``cli search --enable_ep
    1`` on that profile (20 MB a device: the search splits the experts), and
    ``cli train`` of the emitted plan on 4 ranks: the losses of the same
    flags at world size 1."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    prefix = str(tmp_path / "moe")
    assert cli.main(["profile", "--device", "cpu", *TINY, "--profile_batch_size", "8",
                     "--output_prefix", prefix]) == 0
    prof = json.load(open(prefix + "_memory.json"))
    assert any("moe_expert_param_fraction" in json.dumps(v) for v in prof.values())
    plan = str(tmp_path / "plan.json")
    assert cli.main(["search", "--device", "cpu", *TINY, "--num_devices", "4",
                     "--time_profile_path", prefix + "_computation.json",
                     "--memory_profile_path", prefix + "_memory.json",
                     "--memory_constraint_gb", "0.02", "--settle_bsz", "8",
                     "--search_space", "dp", "--enable_ep", "1", "--mixed_precision", "fp32",
                     "--output_config_path", plan]) == 0
    hp = HybridParallelConfig.load(plan)
    assert any(s.ep > 1 for s in hp.layer_strategies), json.dumps(hp.to_json_dict())
    ref = _cli_losses(TINY + TRAIN + ["--chunks", str(hp.chunks)], 1, tmp_path, "w1")
    got = _cli_losses(TINY + TRAIN + ["--galvatron_config_path", plan], 4, tmp_path, "plan")
    assert len(got) == STEPS
    np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_cli_generate_an_moe_model(capsys):
    from galvatron_tpu_torch import cli

    assert cli.main(["generate", "--device", "cpu", *TINY, "--vocab_size", "384",
                     "--max_new_tokens", "4", "--prompt", "hi"]) == 0
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out and out[0]["prompt"] == "hi"


@pytest.mark.parametrize("ep,experts,ok", [(2, 4, True), (4, 4, True), (8, 4, False),
                                           (2, 0, False)])
def test_plan_check_passes_ep_plans_and_refuses_what_the_jax_package_refuses(ep, experts, ok):
    """GTA014 at ``cli train``'s start-up check: an ep that divides the
    expert count passes, ep over a dense model or past the experts is
    refused; the verdicts and codes are the JAX package's."""
    from galvatron_tpu.analysis import plan_check as jpc
    from galvatron_tpu.core.strategy import HybridParallelConfig as JHP
    from galvatron_tpu_torch.analysis import plan_check as tpc
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig as THP

    jcfg, tcfg = _small_cfgs(moe_experts=experts)
    codes = []
    for pc, hp_cls, cfg in ((jpc, JHP, jcfg), (tpc, THP, tcfg)):
        hp = hp_cls.uniform(2, ep=ep, mixed_precision="fp32")
        codes.append(sorted({d.code for d in pc.check_plan(hp, cfg, 8, global_bsz=8)
                             if d.severity == "error"}))
    assert codes[0] == codes[1]
    assert ("GTA014" not in codes[1]) == ok, codes


def test_cli_train_refuses_an_ep_plan_past_the_experts(tmp_path):
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.analysis.plan_check import PlanError
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    plan = str(tmp_path / "plan.json")
    HybridParallelConfig.uniform(2, ep=8, mixed_precision="fp32").save(plan)
    with pytest.raises(PlanError, match="GTA014"):
        cli.main(["train", "--device", "cpu", *TINY, *TRAIN, "--galvatron_config_path", plan])


@pytest.mark.parametrize("backend", [["--kv_num_blocks", "-1"], []], ids=["paged", "slot"])
def test_cli_serve_an_moe_model(backend):
    """``cli serve --moe_experts 4`` on both KV backends: concurrent
    requests get their full token budgets, a repeated prompt repeats, /drain
    reports no leak."""
    from tests.test_torch_serving import _http, _start_cli_serve

    base, th, rc = _start_cli_serve(["--device", "cpu", *TINY[:-4], "--seq_length", "64",
                                     "--moe_experts", "4", "--vocab_size", "384",
                                     "--prefill_chunk", "8", "--num_slots", "2", *backend])
    outs = [None] * 3

    def post(i):
        outs[i] = _http(base + "/api", {"prompts": ["moe " * (2 + i)], "tokens_to_generate": 6})

    posters = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for p in posters:
        p.start()
    for p in posters:
        p.join(60)
    for i, (code, resp) in enumerate(outs):
        assert code == 200, resp
    code, again = _http(base + "/api", {"prompts": ["moe " * 2], "tokens_to_generate": 6})
    assert code == 200 and again["tokens"] == outs[0][1]["tokens"]
    code, health = _http(base + "/healthz")
    assert health["serving"]["kv_backend"] == ("paged" if backend else "slot")
    code, drained = _http(base + "/drain", {})
    assert code == 200 and drained["leaked"] is False
    th.join(15)
    assert rc == [0]
