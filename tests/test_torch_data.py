"""The port's corpora and data pipeline against the JAX package's on the CPU:
the same files on disk byte for byte (written by either package, read by the
other), the same windows and batches for the same seed (across epochs and
from a resume cursor), the same mixture order, cursor and resume verdicts,
the prefetcher's lifecycle, and ``cli train --data_path`` against the JAX
``cli train`` (the port starting from the JAX weights through a step-0
checkpoint written with ``bridge``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from galvatron_tpu.core import data as jdata
from galvatron_tpu.core import dataloader as jdl
from galvatron_tpu.data import mixture as jmix
from galvatron_tpu.data import pipeline as jpipe
from galvatron_tpu.data import shards as jshards
from galvatron_tpu.data.packing import WindowedDataset as JWindowed
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from galvatron_tpu_torch.core import data as tdata
from galvatron_tpu_torch.core import dataloader as tdl
from galvatron_tpu_torch.data import mixture as tmix
from galvatron_tpu_torch.data import pipeline as tpipe
from galvatron_tpu_torch.data import prefetch as tprefetch
from galvatron_tpu_torch.data import shards as tshards
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.models.tokenizer import ByteTokenizer as TByteTokenizer
import _torch_threads  # noqa: F401

LOSS_TOL = 1e-4


class _PipeCfg:  # the duck type build_data_pipeline reads
    image_size = 0
    objective = "clm"
    enc_layers = 0
    vocab_size = 128


def _docs(n, lens=(4, 60), vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, vocab, rng.randint(*lens))) for _ in range(n)]


def _files(d, names):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(names)}


# ---------------------------------------------------------------------------
# Corpora on disk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [256, 100000], ids=["uint16", "int32"])
def test_indexed_corpus_files_are_byte_identical_both_ways(tmp_path, vocab):
    docs = _docs(40, vocab=min(vocab, 70000), seed=3) + [[0, vocab - 1]]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jmeta = jdata.write_indexed_dataset(str(tmp_path / "j" / "c"), docs, vocab)
    tmeta = tdata.write_indexed_dataset(str(tmp_path / "t" / "c"), docs, vocab)
    assert jmeta == tmeta
    names = ["c.bin", "c.idx.json"]
    assert _files(tmp_path / "j", names) == _files(tmp_path / "t", names)
    # each package reads the other's corpus
    for reader, prefix in ((tdata.IndexedTokenDataset, tmp_path / "j" / "c"),
                           (jdata.IndexedTokenDataset, tmp_path / "t" / "c")):
        ds = reader(str(prefix))
        assert ds.num_docs == len(docs) and ds.dtype == np.dtype(jmeta["dtype"])
        for i in (0, 17, len(docs) - 1):
            np.testing.assert_array_equal(ds.doc(i), docs[i])


def test_sharded_corpus_files_are_byte_identical_both_ways(tmp_path):
    docs = _docs(120, seed=1)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jshards.write_sharded_dataset(str(tmp_path / "j" / "c"), docs, 128, shard_tokens=256)
    tshards.write_sharded_dataset(str(tmp_path / "t" / "c"), docs, 128, shard_tokens=256)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) > 2
    assert _files(tmp_path / "j", names) == _files(tmp_path / "t", names)
    for opener, prefix in ((tshards.open_token_dataset, tmp_path / "j" / "c"),
                           (jshards.open_token_dataset, tmp_path / "t" / "c")):
        ds = opener(str(prefix))
        np.testing.assert_array_equal(ds.doc_lengths, [len(d) for d in docs])
        np.testing.assert_array_equal(ds.doc(57), docs[57])


def test_tokenized_text_is_byte_identical(tmp_path):
    txt = tmp_path / "t.txt"
    txt.write_text("hello world\nsecond doc\n\n  third, with spaces  \n")
    jdata.tokenize_text_file(str(tmp_path / "j"), str(txt), JByteTokenizer())
    tdata.tokenize_text_file(str(tmp_path / "t"), str(txt), TByteTokenizer())
    for ext in (".bin", ".idx.json"):
        assert (tmp_path / ("j" + ext)).read_bytes() == (tmp_path / ("t" + ext)).read_bytes()
    for d, pkg, tok in (("js", jshards, JByteTokenizer()), ("ts", tshards, TByteTokenizer())):
        (tmp_path / d).mkdir()
        pkg.tokenize_text_files(str(tmp_path / d / "c"), [str(txt)], tok)
    names = sorted(os.listdir(tmp_path / "js"))
    assert _files(tmp_path / "js", names) == _files(tmp_path / "ts", names)


def _reject(fn, exc, match):
    with pytest.raises(exc, match=match):
        fn()


@pytest.mark.parametrize("case", ["out of range", "corrupt index", "corrupt shard",
                                  "empty corpus", "missing corpus"])
def test_bad_corpora_are_rejected_as_the_reference_rejects_them(tmp_path, case):
    for pkg, d, sh in ((jdata, tmp_path / "j", jshards), (tdata, tmp_path / "t", tshards)):
        d.mkdir()
        if case == "out of range":
            _reject(lambda: pkg.write_indexed_dataset(str(d / "x"), [[5, 999]], 256),
                    ValueError, "outside")
        elif case == "corrupt index":
            pkg.write_indexed_dataset(str(d / "c"), [[1, 2, 3]], 256)
            meta = json.load(open(d / "c.idx.json"))
            meta["num_tokens"] = 99
            json.dump(meta, open(d / "c.idx.json", "w"))
            _reject(lambda: pkg.IndexedTokenDataset(str(d / "c")), ValueError, "corrupt")
        elif case == "corrupt shard":
            sh.write_sharded_dataset(str(d / "c"), _docs(30), 128)
            first = json.load(open(d / "c.shards.json"))["shards"][0]["file"]
            with open(d / first, "ab") as f:
                f.write(b"\x00\x00")
            _reject(lambda: sh.open_token_dataset(str(d / "c")), ValueError, "corrupt|records")
        elif case == "empty corpus":
            _reject(lambda: sh.write_sharded_dataset(str(d / "e"), [[], []], 128), ValueError,
                    "no non-empty documents")
        else:
            _reject(lambda: pkg.IndexedTokenDataset(str(d / "none")), FileNotFoundError,
                    "idx.json")


# ---------------------------------------------------------------------------
# Windows and batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,bsz,start", [(1234, 4, 0), (7, 8, 5), (0, 2, 41)])
def test_window_batches_are_equal_across_epochs_and_resume(tmp_path, seed, bsz, start):
    prefix = str(tmp_path / "c")
    jdata.write_indexed_dataset(prefix, _docs(30, lens=(10, 90), seed=seed % 5), 128)
    jds = jdata.GPTWindowDataset(jdata.IndexedTokenDataset(prefix), 16, seed)
    tds = tdata.GPTWindowDataset(tdata.IndexedTokenDataset(prefix), 16, seed)
    assert len(jds) == len(tds) and jds.batches_per_epoch(bsz) == tds.batches_per_epoch(bsz)
    per_epoch = tds.batches_per_epoch(bsz)
    jit, tit = jds.batch_iterator(bsz, start_batch=start), tds.batch_iterator(bsz, start_batch=start)
    for _ in range(2 * per_epoch + 1):  # crosses two epoch boundaries
        a, b = next(jit), next(tit)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # the trainer's entry point: build_dataloader(data_path=...)
    jcfg = jm.ModelConfig(vocab_size=128, max_seq_len=16)
    tcfg = tm.ModelConfig(vocab_size=128, max_seq_len=16)
    a = jdl.build_dataloader(jcfg, bsz, 16, seed=seed, start_batch=start, data_path=prefix)
    b = tdl.build_dataloader(tcfg, bsz, 16, seed=seed, start_batch=start, data_path=prefix)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))


def test_windows_cross_shard_and_document_boundaries_alike(tmp_path):
    prefix = str(tmp_path / "c")
    jshards.write_sharded_dataset(prefix, _docs(80, lens=(3, 40), seed=2), 128, shard_tokens=200)
    jw = JWindowed(jshards.open_token_dataset(prefix), 24)
    tw = tpipe.WindowedDataset(tshards.open_token_dataset(prefix), 24)
    assert jw.num_samples == tw.num_samples
    for i in range(tw.num_samples):
        np.testing.assert_array_equal(jw.sample(i), tw.sample(i))


# ---------------------------------------------------------------------------
# Mixtures, cursor, resume verdicts
# ---------------------------------------------------------------------------


def _corpora(tmp_path):
    pa, pb = str(tmp_path / "a"), str(tmp_path / "b")
    jshards.write_sharded_dataset(pa, _docs(150, seed=1), 128, shard_tokens=512)
    jshards.write_sharded_dataset(pb, _docs(100, seed=2), 128, shard_tokens=512)
    return pa, pb


def test_parse_mixture_gives_the_same_sources(tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"sources": [{"name": "a", "prefix": "/p/a", "weight": 2},
                                            {"prefix": "/p/b"}]}))
    for spec in ("/p/web=0.7,/p/books=0.3", str(path)):
        assert [tuple(vars(s).values()) for s in tmix.parse_mixture(spec)] == \
            [tuple(vars(s).values()) for s in jmix.parse_mixture(spec)]
    for pkg in (jmix, tmix):
        with pytest.raises(ValueError, match="duplicate"):
            pkg.parse_mixture("/p/x=1,/p/x=2")
    # the repo's example mixture parses alike (its corpora exist on no machine here)
    example = os.path.join(os.path.dirname(__file__), "..", "configs", "data",
                           "mixture_web_books.json")
    assert [s.prefix for s in tmix.parse_mixture(example)] == \
        [s.prefix for s in jmix.parse_mixture(example)]


@pytest.mark.parametrize("seed", [7, 1234])
def test_mixture_sample_order_and_counts_are_equal(tmp_path, seed):
    pa, pb = _corpora(tmp_path)
    jm_ = jmix.MixtureDataset(["a", "b"], [JWindowed(jshards.open_token_dataset(p), 32)
                                          for p in (pa, pb)], [0.75, 0.25], seed=seed)
    tm_ = tmix.MixtureDataset(["a", "b"], [tpipe.WindowedDataset(tshards.open_token_dataset(p),
                                                                 32) for p in (pa, pb)],
                              [0.75, 0.25], seed=seed)
    n = sum(ds.num_samples for ds in tm_.datasets)
    for k in list(range(60)) + [n + 3, 2 * n + 11]:  # into later epochs of each source
        np.testing.assert_array_equal(jm_.sample(k), tm_.sample(k))
    for k in (0, 1, 7, 40, 163, 500):
        assert jm_.counts_at(k) == tm_.counts_at(k)
        assert jm_.state_at(k) == tm_.state_at(k)


def test_pipeline_batches_cursor_and_resume_verdicts_are_equal(tmp_path):
    pa, pb = _corpora(tmp_path)
    mixture = f"{pa}=0.75,{pb}=0.25"
    jp8 = jpipe.build_data_pipeline(_PipeCfg, 8, 32, seed=7, mixture=mixture)
    tp8 = tpipe.build_data_pipeline(_PipeCfg, 8, 32, seed=7, mixture=mixture)
    for _ in range(5):
        np.testing.assert_array_equal(next(jp8), next(tp8))
    st = tp8.state(40)
    assert st == jp8.state(40)
    assert tp8.summary(40) == {k: v for k, v in jp8.summary(40).items()
                               if k != "dataset_packing_efficiency"}
    # resume the same stream at bsz 4 from the converted cursor (40 / 4 = 10)
    jp4 = jpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=7, mixture=mixture, start_batch=10,
                                    resume_state=st)
    tp4 = tpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=7, mixture=mixture, start_batch=10,
                                    resume_state=st)
    np.testing.assert_array_equal(next(jp4), next(tp4))
    # the refusals: a changed mixture, a cursor that did not convert, a packed cursor
    bad = [dict(mixture=f"{pa}=0.25,{pb}=0.75", start_batch=10, resume_state=st),
           dict(mixture=mixture, start_batch=9, resume_state=st),
           dict(mixture=mixture, start_batch=10, resume_state=dict(st, packed=True))]
    for kw in bad:
        with pytest.raises(ValueError) as je:
            jpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=7, **kw)
        with pytest.raises(ValueError) as te:
            tpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=7, **kw)
        assert str(te.value) == str(je.value)


def test_single_source_pipeline_matches_and_packing_raises(tmp_path):
    # (packing is ported: the packed pipeline equals the JAX package's here,
    # and tests/test_torch_packing.py holds its mixtures, resume and prefetch)
    pa, _ = _corpora(tmp_path)
    jp = jpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=5, data_path=pa, start_batch=3)
    tp = tpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=5, data_path=pa, start_batch=3)
    for _ in range(4):
        np.testing.assert_array_equal(next(jp), next(tp))
    assert tp.last_meta == {"position": 24}
    jp = jpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=5, data_path=pa, pack=True)
    tp = tpipe.build_data_pipeline(_PipeCfg, 4, 32, seed=5, data_path=pa, pack=True)
    for _ in range(4):
        np.testing.assert_array_equal(next(jp), next(tp))
        assert tp.last_meta == jp.last_meta
    assert tp.summary(16) == jp.summary(16)
    with pytest.raises(ValueError, match="--data_path or --data_mixture"):
        tpipe.build_data_pipeline(_PipeCfg, 4, 32)


# ---------------------------------------------------------------------------
# Prefetch
# ---------------------------------------------------------------------------


def test_prefetch_depth_2_yields_the_batches_of_depth_0(tmp_path):
    pa, pb = _corpora(tmp_path)
    mixture = f"{pa}=0.7,{pb}=0.3"
    moved = []
    sync = tpipe.build_data_pipeline(_PipeCfg, 8, 32, seed=5, mixture=mixture)
    pre = tpipe.build_data_pipeline(_PipeCfg, 8, 32, seed=5, mixture=mixture, prefetch_depth=2,
                                    put_fn=lambda b: moved.append(b) or torch.from_numpy(b))
    try:
        for _ in range(6):
            a, b = next(sync), next(pre)
            assert torch.is_tensor(b)
            np.testing.assert_array_equal(a, b.numpy())
            assert sync.last_meta == pre.last_meta
        # every batch the producer handed over is a buffer of its own
        assert not any(np.shares_memory(x, y) for x, y in zip(moved, moved[1:]))
        t = pre._prefetcher._thread
    finally:
        pre.close()
        sync.close()
    assert not t.is_alive(), "the prefetch thread must join on close()"
    pre.close()  # idempotent


def test_prefetch_propagates_a_producer_exception():
    calls = {"n": 0}

    def make_item():
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("corrupt shard mid-stream")
        return np.zeros(4, np.int32), {}

    pre = tprefetch.AsyncPrefetcher(make_item, lambda b: b, depth=1)
    got = 0
    with pytest.raises(RuntimeError, match="corrupt shard"):
        for _ in range(5):
            next(pre)
            got += 1
    assert got == 2 and not pre._thread.is_alive()


# ---------------------------------------------------------------------------
# cli train on a corpus against the JAX cli train
# ---------------------------------------------------------------------------

TINY = ["--model_size", "llama-0.3b", "--num_layers", "2", "--hidden_size", "64",
        "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
        "--global_train_batch_size", "8", "--mixed_precision", "fp32", "--attn_impl", "xla",
        "--check_loss", "1"]


def jax_start_checkpoint(path, jcfg, seed, runtime):
    """A port checkpoint at step 0 holding the JAX trainer's initial state
    (the JAX init from ``seed``, zero moments), converted by ``bridge``."""
    from galvatron_tpu.core.optim import init_opt_state
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core import checkpoint as ckpt

    params = jm.init_model_params(jax.random.key(seed), jcfg)
    state = {"params": params, "opt": init_opt_state(params), "step": np.zeros((), np.int32)}
    flat = {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(state)[0]}
    ckpt.save_checkpoint_portable(path, bridge.state_from_jax(flat, runtime), 0, runtime)


def test_cli_train_on_a_corpus_gives_the_jax_cli_losses(tmp_path):
    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.trainer import train as j_train
    from galvatron_tpu_torch.core.arguments import initialize_galvatron as t_init
    from galvatron_tpu_torch.core.trainer import train as t_train
    from galvatron_tpu_torch.parallel import hybrid

    prefix = str(tmp_path / "corpus")
    tdata.write_indexed_dataset(prefix, _docs(50, lens=(20, 200), seed=4), 128)
    argv = TINY + ["--train_iters", "3", "--data_path", prefix]
    jlosses = j_train(j_init("train", argv))["losses"]
    ns = t_init("train", argv + ["--device", "cpu", "--load", str(tmp_path / "start")])
    jcfg = jm.PRESETS["llama-0.3b"].replace(num_layers=2, hidden_size=64, num_heads=4,
                                            ffn_dim=128, vocab_size=128, max_seq_len=32,
                                            dtype=jax.numpy.float32)
    tcfg = tm.PRESETS["llama-0.3b"].replace(num_layers=2, hidden_size=64, num_heads=4,
                                            ffn_dim=128, vocab_size=128, max_seq_len=32)
    rt = hybrid.build_runtime(tcfg, global_batch_size=8, seq_len=32, mixed_precision="fp32",
                              device="cpu")
    jax_start_checkpoint(str(tmp_path / "start"), jcfg, ns.seed, rt)
    out = t_train(ns)
    assert out["start_step"] == 0 and out["consumed_samples"] == 24
    np.testing.assert_allclose(out["losses"], jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_trainer_resume_replays_and_skips_nothing_per_source(tmp_path):
    """``tests/test_data_pipeline.py``'s trainer case without packing: a
    4-step run, and a 2-step run saved and resumed to 4 in the port, give
    the same losses bitwise; the checkpoint's per-source cursor equals the
    JAX trainer's for the same flags; resuming without the data flags, or
    under another mixture, is refused."""
    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.checkpoint import read_manifest as j_read_manifest
    from galvatron_tpu.core.trainer import train as j_train
    from galvatron_tpu_torch.core import checkpoint as ck
    from galvatron_tpu_torch.core.arguments import initialize_galvatron as t_init
    from galvatron_tpu_torch.core.trainer import train as t_train
    from galvatron_tpu_torch.utils.metrics import read_metrics

    for name, seed in (("web", 1), ("books", 2)):
        tshards.write_sharded_dataset(str(tmp_path / name), _docs(150, seed=seed), 128)
    mix = str(tmp_path / "mix.json")
    json.dump({"sources": [{"name": "web", "prefix": str(tmp_path / "web"), "weight": 0.7},
                           {"name": "books", "prefix": str(tmp_path / "books"), "weight": 0.3}]},
              open(mix, "w"))
    argv = ["--model_size", "llama-0.3b", "--hidden_size", "32", "--num_layers", "2",
            "--num_heads", "2", "--ffn_dim", "64", "--vocab_size", "128", "--seq_length", "32",
            "--global_train_batch_size", "8", "--mixed_precision", "fp32", "--attn_impl", "xla",
            "--data_mixture", mix, "--prefetch_depth", "2"]
    tcpu = argv + ["--device", "cpu"]
    full_m, ckd = str(tmp_path / "full.jsonl"), str(tmp_path / "ck")
    full = t_train(t_init("train", tcpu + ["--train_iters", "4", "--metrics_path", full_m]))
    t_train(t_init("train", tcpu + ["--train_iters", "2", "--save", ckd, "--save_interval", "2"]))
    res = t_train(t_init("train", tcpu + ["--train_iters", "4", "--load", ckd, "--save", ckd,
                                          "--save_interval", "2"]))
    assert res["losses"] == full["losses"][2:]
    meta = ck.read_manifest(ck.step_path(ckd, 4))["meta"]
    ds = meta["data_state"]
    assert ds["position"] == 32 == meta["samples_consumed"]
    summary = [r for r in read_metrics(full_m) if r["event"] == "data_pipeline"]
    assert summary[0]["consumed_web"] == ds["per_source_consumed"]["web"]
    assert summary[0]["consumed_books"] == ds["per_source_consumed"]["books"]
    # the JAX trainer records the same cursor for the same flags
    jck_dir = str(tmp_path / "jck")
    j_train(j_init("train", argv + ["--train_iters", "4", "--save", jck_dir]), verbose=False)
    jmeta = j_read_manifest(os.path.join(jck_dir, "step_4"))["meta"]
    assert jmeta["data_state"] == ds
    with pytest.raises(ValueError, match="data-pipeline cursor"):
        t_train(t_init("train", argv[:-4] + ["--device", "cpu", "--train_iters", "6",
                                             "--load", ckd]))
    other = str(tmp_path / "other.json")
    json.dump({"sources": [{"name": "web", "prefix": str(tmp_path / "web"), "weight": 0.3},
                           {"name": "books", "prefix": str(tmp_path / "books"), "weight": 0.7}]},
              open(other, "w"))
    bad = [other if a == mix else a for a in tcpu]
    with pytest.raises(ValueError, match="per-source consumption mismatch"):
        t_train(t_init("train", bad + ["--train_iters", "6", "--load", ckd]))
