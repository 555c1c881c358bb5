"""The Swin pyramid under multi-rank plans: the port's runtime in one 8-rank
gloo world against the JAX package's single-device AdamW trajectory
(``tests/test_vision.py``'s ``reference_losses``) at fp32 on the CPU, case
for case with the multi-rank Swin cases of ``tests/test_vision.py`` (the
shared world code: ``tests/_encdec_common.py``).

Every plan is held to the JAX package's flat trajectory, not to its GSPMD
runtime: the world trains ``SWIN_STRATEGIES``' tp 2 and hetero (zero3 at
stage 0, tp 2 with SP and full recompute at stage 1) plans, pp 2 at tp 1 and
at tp 2 (GPipe), 1F1B at pp 2, at K = 3 sections with chunks 4 and at pp 4
(zero-pair stages in every section), a biased model whose window attention
leaves ``wo_b`` without a gradient under tp 2 and ZeRO-2, and one fp16 1F1B
step. Each case holds the first batch's eval loss within 3e-5 and the step
losses within 2e-4 (the JAX tests' bounds), and the gathered parameters
within 1e-4 (an element whose first gradient is within fp32 rounding of zero
within steps x lr); the fp16 step is held as the JAX test holds it (within
0.05 of the fp32 loss, the scale unchanged at 2^16). A pp 2 1F1B checkpoint
resumes under GPipe in the world and at pp 1 here with the same eval loss.
"""

import numpy as np
import pytest
import torch

import _encdec_common as C
import _torch_threads  # noqa: F401

# tests/_vision_common.py's SWIN_TINY: 8 x 8 patches of 2 x 2 pixels,
# stages (2, 2) at widths 16 / 32, windows of 4 x 4
SHAPE = dict(vocab_size=1, hidden_size=16, num_layers=4, num_heads=2, max_seq_len=0,
             pos_embed="learned", norm_type="layernorm", act_fn="gelu", causal=False,
             objective="cls", image_size=16, patch_size=2, num_classes=16,
             swin_depths=(2, 2), swin_window=4)
THREE = dict(SHAPE, num_layers=6, swin_depths=(2, 2, 2))
BIASED = dict(SHAPE, use_bias=True)
LOSS_TOL = 2e-4  # tests/test_vision.py's rtol / atol
FP16_TOL = 0.05  # tests/test_vision.py's fp16 bound


def swin_cases(m):
    """name → (model shape, plan, batch rows, loss tolerance) from strategy
    module ``m``: ``tests/test_vision.py``'s multi-rank Swin plans. A
    micro-batch splits over its DP ranks (the port does not pad)."""
    U, L, H = m.HybridParallelConfig.uniform, m.LayerStrategy, m.HybridParallelConfig
    fp32 = dict(mixed_precision="fp32")
    f1b = dict(pipeline_type="pipedream_flush", **fp32)
    return {
        "tp2": (SHAPE, U(4, tp=2, **fp32), 8, LOSS_TOL),
        "hetero": (SHAPE, H(pp=1, layer_strategies=[
            L(tp=1, dp_type="zero3"), L(tp=1, dp_type="zero3"),
            L(tp=2, sp=True, ckpt="full"), L(tp=2, sp=True, ckpt="full")], **fp32), 8, LOSS_TOL),
        "pp2_tp1": (SHAPE, U(4, pp=2, tp=1, chunks=2, vocab_tp=1, **fp32), 8, LOSS_TOL),
        "pp2_tp2": (SHAPE, U(4, pp=2, tp=2, chunks=2, vocab_tp=2, **fp32), 8, LOSS_TOL),
        "1f1b_pp2": (SHAPE, U(4, pp=2, chunks=2, **f1b), 8, LOSS_TOL),
        "1f1b_k3_chunks4": (THREE, U(6, pp=2, chunks=4, **f1b), 16, LOSS_TOL),
        "1f1b_pp4_zero_pairs": (SHAPE, U(4, pp=4, chunks=4, **f1b), 8, LOSS_TOL),
        "bias_tp2_zero2_sp": (BIASED, U(4, tp=2, sp=True, dp_type="zero2", vocab_tp=2,
                                        vocab_sp=True, **fp32), 8, LOSS_TOL),
        "fp16_1f1b": (SHAPE, U(4, pp=2, chunks=2, pipeline_type="pipedream_flush",
                               mixed_precision="fp16"), 8, FP16_TOL),
    }


CASE_NAMES = ("tp2", "hetero", "pp2_tp1", "pp2_tp2", "1f1b_pp2", "1f1b_k3_chunks4",
              "1f1b_pp4_zero_pairs", "bias_tp2_zero2_sp")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from galvatron_tpu_torch.core import strategy as ts

    d = tmp_path_factory.mktemp("torch_swin_world")
    table = swin_cases(ts)
    U = ts.HybridParallelConfig.uniform
    base = C.ref_key(SHAPE, 8)
    # the checkpoint: a pp 2 1F1B run saves after its steps, a pp 2 GPipe run
    # resumes from it (and a pp 1 runtime here)
    f1b = U(4, pp=2, chunks=2, pipeline_type="pipedream_flush", mixed_precision="fp32")
    gpipe = U(4, pp=2, chunks=2, mixed_precision="fp32")
    extra = [dict(name="ckpt_1f1b", shape=SHAPE, plan=f1b.to_json_dict(), ref=base,
                  save=str(d / "ckpt")),
             dict(name="resume_gpipe", shape=SHAPE, plan=gpipe.to_json_dict(), ref=base,
                  restore=str(d / "ckpt"))]
    refs, results, ranks, cases = C.run_world(d, table, extra)
    return table, refs, results, ranks, {c["name"]: c for c in cases}


@pytest.mark.parametrize("name", CASE_NAMES)
def test_swin_trains_like_the_jax_package(world, name):
    table, refs, results, ranks, _ = world
    assert tuple(table)[:len(CASE_NAMES)] == CASE_NAMES
    C.check_trains_like_jax(table, refs, results, ranks, name)


def test_fp16_1f1b_step_is_held_as_the_jax_test_holds_it(world):
    """fp16 (no kernel on Swin's path without ``fused_norm``): the losses
    finite and within 0.05 of the fp32 trajectory, the scale still 2^16."""
    table, refs, results, ranks, _ = world
    assert "fp16_1f1b" in results, C.world_failure(ranks)
    shape, _, rows, tol = table["fp16_1f1b"]
    got = results["fp16_1f1b"]
    losses = got[0]["losses"]
    assert np.isfinite(losses).all() and all(g["losses"] == losses for g in got)
    np.testing.assert_allclose(losses, refs[C.ref_key(shape, rows)][0], atol=tol, rtol=0)
    assert all(g["scale"] == 65536.0 for g in got)


def test_zero_pair_stages_hold_what_the_layout_says(world):
    """Two sections of one pair each at pp 4: both pairs go to stage 2
    (``balanced_division``'s order, the JAX ``_spread_pairs``), the other
    stages hold none and pass the messages on."""
    _, _, results, ranks, _ = world
    assert "1f1b_pp4_zero_pairs" in results, C.world_failure(ranks)
    held = [results["1f1b_pp4_zero_pairs"][r]["stage_layers"] for r in range(0, C.WORLD, 2)]
    assert held == [[], [], [0, 1, 2, 3], []]


def test_pp2_1f1b_checkpoint_resumes_under_gpipe_and_at_pp1(world):
    """The pp 2 1F1B run's portable checkpoint resumes under GPipe (its
    eval loss is the saving run's within 3e-5, every piece bit for bit) and
    at pp 1 in one process (the same)."""
    from galvatron_tpu_torch.core import checkpoint as ck
    from galvatron_tpu_torch.core.optim import AdamConfig, tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    _, _, results, ranks, case = world
    assert "ckpt_1f1b" in results and "resume_gpipe" in results, C.world_failure(ranks)
    saved = case["ckpt_1f1b"]
    after = results["ckpt_1f1b"][0]["eval_after"]
    trained = C.gather(results["ckpt_1f1b"], SHAPE, saved["plan"])
    resumed = [dict(params=g["restored_params"]) for g in results["resume_gpipe"]]
    for a, b in zip(tree_leaves(C.gather(resumed, SHAPE, case["resume_gpipe"]["plan"])),
                    tree_leaves(trained)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(results["resume_gpipe"][0]["losses"][0], after, rtol=C.EVAL_TOL)
    cfg = ModelConfig(dtype=torch.float32, **SHAPE)
    rt = hybrid.build_runtime(cfg, HybridParallelConfig.uniform(4, mixed_precision="fp32"),
                              AdamConfig(lr=C.LR, grad_clip=1.0), global_batch_size=8,
                              device="cpu")
    state = ck.restore_checkpoint_portable(saved["save"], rt)
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(trained)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert int(state["step"]) == C.STEPS
    np.testing.assert_allclose(float(rt.eval_loss(state, torch.from_numpy(saved["batches"][0]))),
                               after, rtol=C.EVAL_TOL)


def test_every_rank_of_the_world_exited_cleanly(world):
    ranks = world[3]
    assert all(r.returncode == 0 and not r.killed for r in ranks), C.world_failure(ranks)
