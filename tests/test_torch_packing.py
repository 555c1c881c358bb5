"""Packed sequences in the port (``data/packing.py``, the packed paths of
``models/modeling.py``, ``parallel/hybrid.py``, the data pipeline and the
trainer) against the JAX package.

In process (fp32, numpy-seeded inputs, the JAX weights through ``bridge``):

- ``pack_documents`` and ``PackedDataset`` rows byte for byte, and
  ``packed_batch_meta``;
- ``positions_from_segments`` and ``split_batch``'s packed branch (inputs
  and boundary-masked labels);
- the packed-vs-padded contract: a batch whose rows are one full-row
  document each gives a loss and gradients EQUAL to the last bit to the
  unpacked batch's, for rope and for learned positions;
- multi-segment rows: loss and gradients within 1e-5 of the JAX package's
  (LLaMA, GQA, GPT, MoE); no logit of one document moves when another
  document (or the padding) of the same row changes; the refusals with the
  JAX package's messages;
- the packed data pipeline's stream, per-batch meta, cursor state, resume
  refusal and summary, synchronous and prefetched;
- ``cli train --pack_sequences 1 --device cpu`` on a seeded corpus against
  the JAX ``cli train``.

One 4-rank gloo world (``parallel/launch.py``) trains packed multi-segment
batches 3 steps under DP, TP (with and without SP, and with the collective
matmul), ZeRO-3 with full recompute, vocab TP + SP with learned positions,
1F1B and GPipe at pp = 2, and an MoE model at ep = 2, from the JAX
package's ``key(0)`` weights: losses within 2e-4 of the JAX runtime's,
parameters within 1e-4. Trivially packed rows equal the unpacked run to the
last bit at tp = 2 and through 1F1B (the JAX package's engine-level
contracts). A control with the segment mask dropped must miss the JAX
losses.

Run as a script (``python tests/test_torch_packing.py worker CASES OUT``)
this file is one rank of the world; that path imports no JAX.
"""

import functools
import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
STEPS = 3
BATCH, SEQ = 8, 32
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_hybrid_runtime.py's rtol / atol
PARAM_ATOL = 1e-4
NOISE_SHARE = 1e-3  # tests/test_torch_moe.py's rule for elements near zero
GRAD_TOL = 1e-5
WORLD_TIMEOUT_S = 900
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=SEQ)
GPT = dict(SHAPE, pos_embed="learned", norm_type="layernorm", act_fn="gelu",
           tie_word_embeddings=True, use_bias=True)
MOE = dict(SHAPE, moe_experts=4)
SHAPES = {"llama": SHAPE, "gpt": GPT, "moe": MOE}


def _packed_rows(batch, seq, seed, vocab=128):
    """(batch, 2·(seq+1)) packed rows: 1-4 segments of random lengths, then
    a random run of padding (token 0, segment 0)."""
    rng = np.random.RandomState(seed)
    s1 = seq + 1
    tok = rng.randint(1, vocab, (batch, s1))
    seg = np.zeros((batch, s1), np.int64)
    for r in range(batch):
        n = s1 - rng.randint(0, s1 // 4)
        cuts = sorted(rng.choice(np.arange(2, n - 1), size=rng.randint(0, 4), replace=False))
        for j, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, n])):
            seg[r, lo:hi] = j + 1
        tok[r, n:] = 0
    return np.concatenate([tok, seg], axis=1).astype(np.int32)


def _trivial(tokens):
    """Each row one full-row document."""
    return np.concatenate([tokens, np.ones_like(tokens)], axis=1)


def _ts():
    from galvatron_tpu_torch.core import strategy as ts

    return ts


def _runtime_cases(m):
    """name → (model kind, plan, batch form) with ``m`` the strategy module:
    'packed' multi-segment rows (held to the JAX runtime), 'trivial' /
    'unpacked' (held to each other, bitwise)."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy

    def plan(layers, **kw):
        return m.HybridParallelConfig(pp=kw.pop("pp", 1), layer_strategies=layers,
                                      vocab_tp=kw.pop("vocab_tp", 1), mixed_precision="fp32",
                                      **kw)

    return {
        "dp4": ("llama", U(2, mixed_precision="fp32", vocab_tp=1), "packed"),
        "tp2": ("llama", plan([L(tp=2)] * 2, vocab_tp=2), "packed"),
        "tp2_sp": ("llama", plan([L(tp=2, sp=True)] * 2, vocab_tp=2), "packed"),
        "tp2_sp_overlap": ("llama", plan([L(tp=2, sp=True, tp_overlap=True)] * 2), "packed"),
        "tp2_sp_zero3_full": ("llama", plan([L(tp=2, sp=True, dp_type="zero3",
                                                ckpt="full")] * 2), "packed"),
        "pp2_1f1b": ("llama", plan([L()] * 2, pp=2, chunks=2,
                                    pipeline_type="pipedream_flush"), "packed"),
        "pp2_gpipe_tp2": ("llama", plan([L(tp=2)] * 2, pp=2, chunks=2), "packed"),
        "gpt_tp2_sp_vocab_sp": ("gpt", plan([L(tp=2, sp=True)] * 2, vocab_tp=2,
                                            vocab_sp=True), "packed"),
        "moe_ep2": ("moe", plan([L(ep=2)] * 2), "packed"),
        "tp2_trivial": ("llama", plan([L(tp=2)] * 2, vocab_tp=2), "trivial"),
        "tp2_unpacked": ("llama", plan([L(tp=2)] * 2, vocab_tp=2), "unpacked"),
        "pp2_1f1b_trivial": ("llama", plan([L()] * 2, pp=2, chunks=2,
                                           pipeline_type="pipedream_flush"), "trivial"),
        "pp2_1f1b_unpacked": ("llama", plan([L()] * 2, pp=2, chunks=2,
                                            pipeline_type="pipedream_flush"), "unpacked"),
    }


# ---------------------------------------------------------------------------
# a rank of the world (no JAX here)
# ---------------------------------------------------------------------------


def _runtime_case(case, rank, world):
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    cfg = ModelConfig(dtype=torch.float32, pack_sequences=case["form"] != "unpacked",
                      **case["shape"])
    hp = HybridParallelConfig.from_json_dict(case["plan"])
    rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                              global_batch_size=BATCH, seq_len=SEQ, device="cpu")
    local = bridge.shard_params(case["params"], cfg, hp, rank, world)
    state = rt.state_from(hybrid.zip_map(
        lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
    losses = []
    for b in case["batches"]:
        state, loss = rt.train_step(state, torch.from_numpy(b))
        losses.append(float(loss))
    return {"losses": losses, "params": bridge.params_to_numpy(state["params"])}


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.models import modeling

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    real = modeling.attention_xla

    def unmasked(q, k, v, cfg, q_offset, seg_ids=None, bias=None):
        return real(q, k, v, cfg, q_offset, bias=bias)

    try:
        for case in cases:
            # the control: the segment mask dropped
            modeling.attention_xla = unmasked if case.get("unmasked") else real
            res = _runtime_case(case, rank, world)
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        modeling.attention_xla = real
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side and the world (pytest)
# ---------------------------------------------------------------------------


def _jcfg(shape, **kw):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm

    return jm.ModelConfig(dtype=jnp.float32, **dict(shape, **kw))


def _tcfg(shape, **kw):
    from galvatron_tpu_torch.models.modeling import ModelConfig

    return ModelConfig(dtype=torch.float32, **dict(shape, **kw))


def _jax_params(shape, seed=0):
    """The JAX package's ``key(seed)`` weights as numpy, drawn once a shape."""
    return _jax_params_of(tuple(sorted(shape.items())), seed)


@functools.lru_cache(maxsize=None)
def _jax_params_of(shape_items, seed):
    import jax

    from galvatron_tpu.models import modeling as jm

    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed),
                                                         _jcfg(dict(shape_items))))


def _jax_reference(shape, batches):
    """The JAX runtime on one device, packed: losses and final parameters."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig
    from galvatron_tpu.core.strategy import HybridParallelConfig
    from galvatron_tpu.parallel import hybrid as jh
    from galvatron_tpu.parallel.mesh import build_mesh

    cfg = _jcfg(shape, pack_sequences=True)
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    hp = HybridParallelConfig.uniform(cfg.num_layers, mixed_precision="fp32")
    rt = jh.build_runtime(cfg, hp, mesh=mesh, axes=axes, adam=AdamConfig(lr=LR, grad_clip=1.0),
                          global_batch_size=BATCH, seq_len=SEQ)
    state = rt.init_state_from(jax.tree.map(jnp.asarray, _jax_params(shape)))
    losses = []
    for b in batches:
        state, loss = rt.train_step(state, jnp.asarray(b))
        losses.append(float(loss))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state["params"])}


def _batches(form, seed):
    rng = np.random.RandomState(seed)
    if form == "packed":
        return [_packed_rows(BATCH, SEQ, seed * 10 + i) for i in range(STEPS)]
    tokens = [rng.randint(0, SHAPE["vocab_size"], (BATCH, SEQ + 1)).astype(np.int32)
              for _ in range(STEPS)]
    return [_trivial(t) for t in tokens] if form == "trivial" else tokens


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case in one 4-rank gloo world, the JAX references computed
    meanwhile; returns (cases, references, per-rank results, launcher
    results)."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    d = tmp_path_factory.mktemp("torch_packing_world")
    params = {kind: _jax_params(shape) for kind, shape in SHAPES.items()}
    batches = {kind: _batches("packed", j + 1) for j, kind in enumerate(SHAPES)}
    plain = {"trivial": _batches("trivial", 7), "unpacked": _batches("unpacked", 7)}
    cases = []
    for name, (kind, hp, form) in _runtime_cases(_ts()).items():
        cases.append(dict(name=name, shape=SHAPES[kind], kind=kind, plan=hp.to_json_dict(),
                          form=form, params=params[kind],
                          batches=batches[kind] if form == "packed" else plain[form]))
    by_name = {c["name"]: c for c in cases}
    cases.append(dict(by_name["tp2_sp"], name="control_unmasked", unmasked=True))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()
    refs = {kind: _jax_reference(SHAPES[kind], batches[kind]) for kind in SHAPES}
    run.join()
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return {c["name"]: c for c in cases}, refs, results, out["ranks"]


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _gathered(case, got):
    """The ranks' pieces gathered into the whole tree; every rank's piece
    must equal its cut of it (no replica drifted)."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    cfg = _tcfg(case["shape"])
    hp = HybridParallelConfig.from_json_dict(case["plan"])
    pieces = [g["params"] for g in got]
    full = bridge.gather_params(pieces, cfg, hp, WORLD)
    for r in range(WORLD):
        held = bridge.shard_params(full, cfg, hp, r, WORLD)
        for a, b in zip(tree_leaves(held), tree_leaves(pieces[r])):
            np.testing.assert_array_equal(a, b)
    return full


def _check_against_jax(name, cases, refs, results):
    import jax

    from galvatron_tpu_torch.core.optim import tree_leaves

    case, got = cases[name], results[name]
    ref = refs[case["kind"]]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_TOL, atol=LOSS_TOL)
    full = _gathered(case, got)
    flat = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j) in zip(tree_leaves(full), flat):
        key = jax.tree_util.keystr(path)
        # an element within fp32 rounding of zero moves ~lr under AdamW in
        # any implementation (tests/test_torch_moe.py's rule)
        moved = np.abs(t - j) > PARAM_ATOL
        assert np.mean(moved) < NOISE_SHARE, key
        np.testing.assert_allclose(t, j, atol=STEPS * LR, rtol=0, err_msg=key)


PACKED_CASES = [n for n, (_, _, form) in _runtime_cases(_ts()).items() if form == "packed"]


@pytest.mark.parametrize("name", PACKED_CASES)
def test_packed_runtime_trains_like_the_jax_package(world, name):
    cases, refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check_against_jax(name, cases, refs, results)


@pytest.mark.parametrize("plan", ["tp2", "pp2_1f1b"])
def test_trivially_packed_rows_equal_the_unpacked_run_bitwise(world, plan):
    """The JAX package's engine-level contracts (tp = 2; 1F1B at pp = 2,
    chunks 2): one full-row document a row trains to the same losses and
    parameters as the unpacked rows, to the last bit."""
    from galvatron_tpu_torch.core.optim import tree_leaves

    cases, _, results, ranks = world
    a, b = f"{plan}_trivial", f"{plan}_unpacked"
    assert a in results and b in results, _world_failure(ranks)
    for ra, rb in zip(results[a], results[b]):
        assert ra["losses"] == rb["losses"]
        for x, y in zip(tree_leaves(ra["params"]), tree_leaves(rb["params"])):
            np.testing.assert_array_equal(x, y)


def test_control_without_the_segment_mask_misses(world):
    cases, refs, results, ranks = world
    assert "control_unmasked" in results, _world_failure(ranks)
    with pytest.raises(AssertionError):
        _check_against_jax("control_unmasked", cases, refs, results)


def test_every_rank_of_the_world_exited_cleanly(world):
    ranks = world[3]
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


# ---------------------------------------------------------------------------
# in process: data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths,capacity,bins", [
    ([5, 3, 9, 2, 4], 8, 64),  # tests/test_data_pipeline.py's case: a 9-token doc splits
    (list(np.random.RandomState(0).randint(1, 300, 400)), 129, 64),
    (list(np.random.RandomState(1).randint(1, 40, 300)), 33, 2),
    ([64, 64, 1, 63, 65, 128], 64, 4),
])
def test_pack_documents_equals_the_jax_bins(lengths, capacity, bins):
    from galvatron_tpu.data.packing import pack_documents as jpack
    from galvatron_tpu_torch.data.packing import pack_documents as tpack

    got = tpack(np.asarray(lengths), capacity, max_open_bins=bins)
    assert got == jpack(np.asarray(lengths), capacity, max_open_bins=bins)
    assert sum(p[2] for row in got for p in row) == sum(lengths)
    assert all(sum(p[2] for p in row) <= capacity for row in got)
    with pytest.raises(ValueError, match="too small"):
        tpack(np.asarray(lengths), 1)


def _corpus(tmp_path, name="c", n=200, seed=0, lens=(4, 60)):
    from galvatron_tpu_torch.data.shards import write_sharded_dataset

    rng = np.random.RandomState(seed)
    docs = [list(rng.randint(1, 128, rng.randint(*lens))) for _ in range(n)]
    prefix = str(tmp_path / name)
    write_sharded_dataset(prefix, docs, 128)
    return prefix, docs


def test_packed_dataset_rows_equal_the_jax_rows_byte_for_byte(tmp_path):
    from galvatron_tpu.data.packing import PackedDataset as JPacked
    from galvatron_tpu.data.shards import open_token_dataset as jopen
    from galvatron_tpu_torch.data.packing import PackedDataset as TPacked
    from galvatron_tpu_torch.data.shards import open_token_dataset as topen

    prefix, _ = _corpus(tmp_path)
    jp, tp = JPacked(jopen(prefix), seq_len=64), TPacked(topen(prefix), seq_len=64)
    assert tp.num_samples == jp.num_samples > 0
    assert tp.packing_efficiency == jp.packing_efficiency >= 0.9
    for i in range(tp.num_samples):
        row = tp.sample(i)
        assert row.dtype == np.int32 and row.tobytes() == jp.sample(i).tobytes()
        seg = row[65:]
        nz = seg[seg > 0]
        assert nz[0] == 1 and (np.diff(seg[: len(nz)]) >= 0).all() and (seg[len(nz):] == 0).all()


def test_packed_batch_meta_equals_jax():
    from galvatron_tpu.data.packing import packed_batch_meta as jmeta
    from galvatron_tpu_torch.data.packing import packed_batch_meta as tmeta

    s1 = 9
    row = np.zeros(2 * s1, np.int32)
    row[s1: s1 + 5] = 1  # 5 real positions, 4 pad: 5 of the 8 input slots
    assert tmeta(row[None]) == jmeta(row[None]) == {
        "nonpad_tokens": 5, "raw_tokens": 8, "packing_efficiency": 5 / 8}
    batch = _packed_rows(BATCH, SEQ, 3)
    assert tmeta(batch) == jmeta(batch)


def _pipe_cfg(objective="clm"):
    class _Cfg:  # the duck type build_data_pipeline reads
        image_size = 0
        enc_layers = 0
        vocab_size = 128

    _Cfg.objective = objective
    return _Cfg


@pytest.mark.parametrize("prefetch", [0, 2])
def test_packed_pipeline_stream_and_resume_equal_jax(tmp_path, prefetch):
    from galvatron_tpu.data import pipeline as jpipe
    from galvatron_tpu_torch.data import pipeline as tpipe

    pa, _ = _corpus(tmp_path, "a", 150, seed=1)
    pb, _ = _corpus(tmp_path, "b", 120, seed=2, lens=(10, 90))
    mixture = f"{pa}=0.6,{pb}=0.4"
    kw = dict(seed=5, mixture=mixture, pack=True, start_batch=2)
    jp = jpipe.build_data_pipeline(_pipe_cfg(), 4, 32, **kw)
    tp = tpipe.build_data_pipeline(_pipe_cfg(), 4, 32, prefetch_depth=prefetch, **kw)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(next(jp), np.asarray(next(tp)))
            assert tp.last_meta == jp.last_meta and 0 < tp.last_meta["packing_efficiency"] <= 1
        assert tp.state(28) == jp.state(28) and tp.state(28)["packed"] is True
        assert tp.summary(28) == jp.summary(28)
        assert "dataset_packing_efficiency" in tp.summary(28)
    finally:
        tp.close()
        jp.close()
    st = tp.state(28)
    # resuming at the cursor verifies; a cursor without the packed flag is refused alike
    tpipe.build_data_pipeline(_pipe_cfg(), 4, 32, seed=5, mixture=mixture, pack=True,
                              start_batch=7, resume_state=st).close()
    bad = dict(st)
    bad.pop("packed")
    for build in (jpipe.build_data_pipeline, tpipe.build_data_pipeline):
        with pytest.raises(ValueError, match="pack_sequences=False but this run has "
                                             "pack_sequences=True"):
            build(_pipe_cfg(), 4, 32, seed=5, mixture=mixture, pack=True, start_batch=7,
                  resume_state=bad)


def test_packing_needs_a_clm_model_in_the_pipeline(tmp_path):
    from galvatron_tpu.data import pipeline as jpipe
    from galvatron_tpu_torch.data import pipeline as tpipe

    pa, _ = _corpus(tmp_path)
    with pytest.raises(ValueError) as je:
        jpipe.build_data_pipeline(_pipe_cfg("mlm"), 4, 32, data_path=pa, pack=True)
    with pytest.raises(ValueError) as te:
        tpipe.build_data_pipeline(_pipe_cfg("mlm"), 4, 32, data_path=pa, pack=True)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# in process: the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_positions_from_segments_and_split_batch_equal_jax(seed):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    np.testing.assert_array_equal(
        tm.positions_from_segments(torch.tensor([[1, 1, 1, 2, 2, 3, 0, 0]]))[0].numpy(),
        [0, 1, 2, 0, 1, 0, 0, 1])
    batch = _packed_rows(BATCH, SEQ, seed)
    seg = batch[:, SEQ + 1:]
    np.testing.assert_array_equal(tm.positions_from_segments(torch.from_numpy(seg)).numpy(),
                                  np.asarray(jm.positions_from_segments(jnp.asarray(seg))))
    jin, jlab = jm.split_batch(jnp.asarray(batch), _jcfg(SHAPE, pack_sequences=True))
    tin, tlab = tm.split_batch(torch.from_numpy(batch), _tcfg(SHAPE, pack_sequences=True))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    # label i = token i+1 iff both lie in one segment (tests/test_data_pipeline.py's case)
    row = np.concatenate([np.arange(1, 10), [1, 1, 1, 2, 2, 2, 3, 0, 0]])[None].astype(np.int32)
    _, lab = tm.split_batch(torch.from_numpy(row), _tcfg(SHAPE, pack_sequences=True, max_seq_len=8))
    np.testing.assert_array_equal(lab[0].numpy(), [2, 3, -100, 5, 6, -100, -100, -100])
    assert tm.batch_row_width(_tcfg(SHAPE, pack_sequences=True), SEQ) == 2 * (SEQ + 1)


def _loss_and_grads(shape, batch, packed, hook=False):
    """The port's loss and gradients on ``batch`` from the JAX key(0) weights."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid as thybrid

    cfg = _tcfg(shape, pack_sequences=packed)
    params = bridge.params_from_jax(_jax_params(shape), cfg, "cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    layer_hook = thybrid._make_layer_hook(cfg, "none") if hook else None
    loss = tm.lm_loss(params, torch.from_numpy(batch).long(), cfg, layer_hook=layer_hook)
    loss.backward()
    return loss.detach(), [p.grad for p in tree_leaves(params)]


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_packed_vs_padded_loss_and_gradients_bitexact(kind, hook):
    """tests/test_data_pipeline.py's contract (rope and learned positions):
    one full-row document a row gives the unpacked loss and gradients to the
    last bit, through ``forward`` and through the runtime's layer hook."""
    tokens = np.random.RandomState(1).randint(0, 128, (4, SEQ + 1)).astype(np.int32)
    lu, gu = _loss_and_grads(SHAPES[kind], tokens, False, hook)
    lp, gp = _loss_and_grads(SHAPES[kind], _trivial(tokens), True, hook)
    assert float(lu) == float(lp)
    for a, b in zip(gu, gp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,kw", [("llama", {}), ("llama", {"num_kv_heads": 2}),
                                     ("gpt", {}), ("moe", {})])
def test_multi_segment_loss_and_gradients_match_jax(kind, kw):
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    shape = dict(SHAPES[kind], **kw)
    batch = _packed_rows(4, SEQ, 11)
    jcfg = _jcfg(shape, pack_sequences=True)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.lm_loss(p, jnp.asarray(batch), jcfg)))(
        jax.tree.map(jnp.asarray, _jax_params(shape)))
    tl, tg = _loss_and_grads(shape, batch, True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_TOL, atol=GRAD_TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for t, j in zip(tg, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=GRAD_TOL * max(1.0, float(np.abs(j).max())))
    # and the segment mask is what parts it from the unpacked loss of the same tokens
    unpacked = batch[:, :SEQ + 1]
    lu, _ = _loss_and_grads(shape, unpacked, False)
    assert float(lu) != float(tl)


def test_no_attention_across_documents_or_into_padding():
    """A token flipped in segment A moves no logit of segment B of the same
    row (and moves A's own); a changed pad token moves no real logit."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import modeling as tm

    cfg = _tcfg(SHAPE, pack_sequences=True, max_seq_len=16)
    params = bridge.params_from_jax(_jax_params(SHAPE), cfg, "cpu")
    toks = np.zeros((1, 16), np.int64)
    seg = np.zeros((1, 16), np.int64)
    toks[0, :8], seg[0, :8] = np.arange(1, 9), 1
    toks[0, 8:14], seg[0, 8:14] = np.arange(20, 26), 2

    def logits(t):
        with torch.no_grad():
            return tm.forward(params, torch.from_numpy(np.concatenate([t, seg], 1)), cfg)

    base = logits(toks)
    a = toks.copy()
    a[0, 3] = 99
    moved = logits(a)
    assert torch.equal(base[0, 8:14], moved[0, 8:14])
    assert not torch.equal(base[0, 3:8], moved[0, 3:8])
    pad = toks.copy()
    pad[0, 15] = 77
    assert torch.equal(base[0, :14], logits(pad)[0, :14])


@pytest.mark.parametrize("what", ["flash", "cp", "vpp", "mlm"])
def test_packing_refusals_carry_the_jax_messages(what):
    from galvatron_tpu.core.strategy import HybridParallelConfig as JHP
    from galvatron_tpu.parallel import hybrid as jh
    from galvatron_tpu_torch.parallel import hybrid as th

    ts = _ts()
    kw = {"flash": dict(attn_impl="flash"), "mlm": dict(objective="mlm")}.get(what, {})
    plan = {"cp": dict(cp=2), "vpp": dict(pp=2, vpp=2, chunks=2)}.get(what, {})
    layers = 4 if what == "vpp" else 2  # the interleaved schedule's layer rule holds
    with pytest.raises(ValueError) as je:
        jh.build_runtime(_jcfg(SHAPE, pack_sequences=True, num_layers=layers, **kw),
                         JHP.uniform(layers, mixed_precision="fp32", **plan),
                         global_batch_size=8)
    with pytest.raises(ValueError) as te:
        th.build_runtime(_tcfg(SHAPE, pack_sequences=True, num_layers=layers, **kw),
                         ts.HybridParallelConfig.uniform(layers, mixed_precision="fp32", **plan),
                         global_batch_size=8, seq_len=SEQ, device="cpu")
    assert str(te.value) == str(je.value)


def test_packed_step_reports_non_pad_rates():
    """``StepStats.per_iter`` with the batch's non-pad count: the packing
    efficiency off the card too, the rates None there (device metrics)."""
    from galvatron_tpu.obs import stepstats as jstats
    from galvatron_tpu_torch.obs.stepstats import StepStats

    cfg = _tcfg(SHAPE)
    st = StepStats(cfg, 4, SEQ, device="cpu")
    out = st.per_iter(12.5, nonpad_tokens=96)
    assert out["packing_efficiency"] == 96 / 128 and out["tokens_per_s"] is None
    assert out["tokens_per_s_raw"] is None and out["mfu"] is None
    assert set(st.per_iter(12.5)) == {"tokens_per_s", "tflops_per_device", "mfu", "hfu"}
    jst = jstats.StepStats(_jcfg(SHAPE), 4, SEQ)
    assert jst.per_iter(12.5, nonpad_tokens=96)["packing_efficiency"] == \
        pytest.approx(out["packing_efficiency"])


# ---------------------------------------------------------------------------
# cli train --pack_sequences 1 against the JAX cli train
# ---------------------------------------------------------------------------

TINY = ["--model_size", "llama-0.3b", "--num_layers", "2", "--hidden_size", "64",
        "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
        "--global_train_batch_size", "8", "--mixed_precision", "fp32", "--check_loss", "1"]


def test_cli_train_pack_sequences_gives_the_jax_cli_losses(tmp_path):
    import jax

    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.trainer import train as j_train
    from galvatron_tpu.data.pipeline import build_data_pipeline
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.utils.metrics import read_metrics as j_read
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core import data as tdata
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid
    from galvatron_tpu_torch.utils.metrics import read_metrics
    from tests.test_torch_data import jax_start_checkpoint

    rng = np.random.RandomState(4)
    docs = [list(rng.randint(1, 128, rng.randint(3, 30))) for _ in range(150)]
    prefix = str(tmp_path / "corpus")
    tdata.write_indexed_dataset(prefix, docs, 128)
    argv = TINY + ["--train_iters", "3", "--data_path", prefix, "--pack_sequences", "1"]
    jm_path, tm_path = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jlosses = j_train(j_init("train", argv + ["--metrics_path", jm_path]))["losses"]
    jcfg = jm.PRESETS["llama-0.3b"].replace(num_layers=2, hidden_size=64, num_heads=4,
                                            ffn_dim=128, vocab_size=128, max_seq_len=32,
                                            dtype=jax.numpy.float32)
    tcfg = tm.PRESETS["llama-0.3b"].replace(num_layers=2, hidden_size=64, num_heads=4,
                                            ffn_dim=128, vocab_size=128, max_seq_len=32)
    rt = hybrid.build_runtime(tcfg, global_batch_size=8, seq_len=32, mixed_precision="fp32",
                              device="cpu")
    jax_start_checkpoint(str(tmp_path / "start"), jcfg, 1234, rt)
    rc = cli.main(["train", *argv, "--device", "cpu", "--load", str(tmp_path / "start"),
                   "--metrics_path", tm_path])
    assert rc == 0
    trecs = [r for r in read_metrics(tm_path) if r["event"] == "train_iter"]
    jrecs = [r for r in j_read(jm_path) if r["event"] == "train_iter"]
    np.testing.assert_allclose([r["loss"] for r in trecs], jlosses, rtol=1e-4, atol=1e-4)
    # the per-batch stats: the JAX pipeline's meta of the same batches
    jpipe = build_data_pipeline(jcfg, 8, 32, seed=1234, data_path=prefix, pack=True)
    for t in trecs:
        next(jpipe)
        assert t["nonpad_tokens"] == jpipe.last_meta["nonpad_tokens"] < 8 * 32
        assert t["packing_efficiency"] == jpipe.last_meta["packing_efficiency"]
        assert t["tokens_per_s_raw"] is None  # a device rate: None off the card
    assert len(jrecs) == len(trecs)
    summary = [r for r in read_metrics(tm_path) if r["event"] == "data_pipeline"][0]
    jsummary = [r for r in j_read(jm_path) if r["event"] == "data_pipeline"][0]
    assert summary["dataset_packing_efficiency"] == jsummary["dataset_packing_efficiency"]


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
