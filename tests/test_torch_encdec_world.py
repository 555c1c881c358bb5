"""The T5-class encoder-decoder under hand-written multi-rank plans: the
port's runtime in one 8-rank gloo world against the JAX package's
single-device AdamW trajectory at fp32 on the CPU, case for case with the
multi-rank cases of ``tests/test_encdec.py`` (the shared code:
``tests/_encdec_common.py``).

The world trains: tp 2 with heterogeneous encoder / decoder strategies (the
JAX test's plan); a plan whose decoder layers each have another layout (tp
2 with SP, tp 4 strided, ZeRO-3 with recompute, ZeRO-2 with selective
recompute) over an encoder of 8 tokens and a decoder of 16, so that the
encoder output reaches every decoder layer in its own layout and its
gradient comes back summed over all of them; pp 2 at (tp 1, ddp) and (tp 2,
zero3, ckpt); the ragged E = 3 / D = 5 at pp 2, balanced and with the
explicit ``[2, 1, 2, 3]`` division; 1F1B at (E, D, chunks) = (4, 4, 4); an
encoder stack smaller than pp (E = 2 at pp 4: zero-layer stages, both
clocks); and chunk counts 3 and 1 under both clocks. Each case holds the
first batch's eval loss within 3e-5 and the step losses within 5e-5 of the
JAX package's (its own tests' tolerances; 2e-4 for the chunk-count cases,
as there), and the gathered parameters within 1e-4 (PR 9's; an element
whose first gradient is within fp32 rounding of zero is held to steps x lr,
as ``tests/test_torch_pipeline.py`` holds it). A pp 2 checkpoint restores
at pp 1 bit for bit, and a pp 1 checkpoint at pp 2. One fp16 entry (pp 2,
1F1B, the attention through the grid kernels' plain versions) is held to the
JAX package's flat fp16 runtime: losses within 5e-3 relative, the loss scale
bitwise.
"""

import numpy as np
import pytest
import torch

import _encdec_common as C
import _torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from galvatron_tpu_torch.core import strategy as ts

    from test_torch_fp16_families import jax_fp16_trajectory

    d = tmp_path_factory.mktemp("torch_encdec_world")
    table = C.hand_cases(ts)
    pp2 = ts.HybridParallelConfig.uniform(4, pp=2, chunks=2, mixed_precision="fp32").to_json_dict()
    base = C.ref_key(C.SHAPE, 8)
    # the checkpoint round trip: pp 2 saves after its steps, and a pp 1
    # checkpoint of the initial weights (written here) restores at pp 2
    extra = [dict(name="ckpt_pp2", shape=C.SHAPE, plan=pp2, ref=base, save=str(d / "pp2_ckpt")),
             dict(name="restore_pp2", shape=C.SHAPE, plan=pp2, ref=base,
                  restore=str(d / "pp1_ckpt")),
             dict(name=FP16, shape=FP16_SHAPE, plan=ts.HybridParallelConfig.uniform(
                 4, pp=2, chunks=2, pipeline_type="pipedream_flush",
                 mixed_precision="fp16").to_json_dict(), ref=base)]
    inputs = {}

    def prepare(refs_in):
        inputs.update(refs_in)
        C.pp1_checkpoint(C.SHAPE, refs_in[base][1], d / "pp1_ckpt")

    refs, results, ranks, cases = C.run_world(d, table, extra, prepare=prepare)
    _, params, batches = inputs[base]
    refs[FP16] = jax_fp16_trajectory(FP16_SHAPE, batches, params)[1]
    return table, refs, results, ranks, {c["name"]: c for c in cases}


#: the fp16 entry (tests/test_encdec.py's pp 2 fp16 case, under 1F1B): the
#: decoder's and encoder's attention through the grid kernels' plain versions
FP16 = "fp16_1f1b"
FP16_SHAPE = dict(C.SHAPE, attn_impl="flash")


CASE_NAMES = ("tp2_hetero", "dec_layouts", "pp2_ddp", "pp2_tp2_zero3_ckpt", "ragged_pp2",
              "ragged_div", "1f1b_444", "small_enc_pp4_gpipe", "small_enc_pp4_1f1b",
              "chunks3_gpipe", "chunks3_1f1b", "chunks1_1f1b")


@pytest.mark.parametrize("name", CASE_NAMES)
def test_encdec_trains_like_the_jax_package(world, name):
    table, refs, results, ranks, _ = world
    assert tuple(table) == CASE_NAMES
    C.check_trains_like_jax(table, refs, results, ranks, name)


def test_zero_layer_stages_hold_what_the_layout_says(world):
    """E = 2 at pp 4 divides the encoder [0, 1, 1, 0] and the decoder [1, 1,
    1, 1]: device 0 holds the decoder's first layer only, device 3 the
    decoder's last (strategy indices, the encoder's first)."""
    _, _, results, ranks, _ = world
    assert "small_enc_pp4_gpipe" in results, C.world_failure(ranks)
    held = [results["small_enc_pp4_gpipe"][r]["stage_layers"] for r in range(0, C.WORLD, 2)]
    assert held == [[2], [0, 3], [1, 4], [5]]


def test_pp2_checkpoint_restores_at_pp1_and_back(world):
    """The pp 2 run's checkpoint restores into a pp 1 runtime bit for bit
    (and evaluates to the pp 2 run's loss within 3e-5); a pp 1 checkpoint
    of the initial weights restores at pp 2 bit for bit and trains like the
    JAX package (5e-5)."""
    from galvatron_tpu_torch.core import checkpoint as ck
    from galvatron_tpu_torch.core.optim import AdamConfig, tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    _, refs, results, ranks, case = world
    assert "ckpt_pp2" in results and "restore_pp2" in results, C.world_failure(ranks)
    saved = case["ckpt_pp2"]
    cfg = ModelConfig(dtype=torch.float32, **C.SHAPE)
    rt = hybrid.build_runtime(cfg, HybridParallelConfig.uniform(4, mixed_precision="fp32"),
                              AdamConfig(lr=C.LR, grad_clip=1.0), global_batch_size=8,
                              seq_len=cfg.max_seq_len, device="cpu")
    state = ck.restore_checkpoint_portable(saved["save"], rt)
    trained = C.gather(results["ckpt_pp2"], C.SHAPE, saved["plan"])
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(trained)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert int(state["step"]) == C.STEPS
    b0 = torch.from_numpy(saved["batches"][0])
    np.testing.assert_allclose(float(rt.eval_loss(state, b0)),
                               results["ckpt_pp2"][0]["eval_after"], rtol=C.EVAL_TOL)
    restored = [dict(params=g["restored_params"]) for g in results["restore_pp2"]]
    for a, b in zip(tree_leaves(C.gather(restored, C.SHAPE, saved["plan"])),
                    tree_leaves(saved["params"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(results["restore_pp2"][0]["losses"],
                               refs[C.ref_key(C.SHAPE, 8)][0], rtol=C.LOSS_TOL,
                               atol=C.LOSS_TOL)


def test_fp16_1f1b_follows_the_jax_fp16_trajectory(world):
    """fp16 at pp 2 under 1F1B, from the same weights and batches: finite
    losses, the same on every rank, within 0.05 of the fp32 trajectory (the
    JAX test's bound) and within 5e-3 relative of the JAX package's flat
    fp16 runtime, the final loss scale that runtime's."""
    from test_torch_fp16_families import assert_follows_jax_fp16

    _, refs, results, ranks, _ = world
    assert FP16 in results, C.world_failure(ranks)
    got = results[FP16]
    losses = got[0]["losses"][1:]  # the first is the eval loss
    assert np.isfinite(losses).all() and all(g["losses"] == got[0]["losses"] for g in got)
    np.testing.assert_allclose(losses, refs[C.ref_key(C.SHAPE, 8)][0][1:], atol=0.05, rtol=0)
    for g in got:
        assert_follows_jax_fp16(losses, g["scale"], refs[FP16])


def test_every_rank_of_the_world_exited_cleanly(world):
    ranks = world[3]
    assert all(r.returncode == 0 and not r.killed for r in ranks), C.world_failure(ranks)
