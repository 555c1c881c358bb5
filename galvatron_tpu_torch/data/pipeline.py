"""DataPipeline: the trainer-facing facade over shards/mixture/packing/
prefetch (the port's copy of ``galvatron_tpu/data/pipeline.py``).

One object that (a) yields device-ready batches (``put_fn`` applied — on the
prefetch thread when ``prefetch_depth > 0``, inline otherwise, so the trainer
has exactly one fetch call either way), (b) reports per-batch packing stats
(``last_meta``) for true-token MFU, (c) snapshots the sample-domain cursor +
per-source consumption for checkpoint meta (``state``), and (d) verifies a
restored cursor against a recount on resume (``verify_resume`` — the
replays-zero/skips-zero contract), and (e) shuts its prefetch thread down
cleanly from every trainer exit path (``close``).

Global sample position ``k`` is the single source of truth: batch ``b`` at
global batch size ``B`` serves positions ``[b·B, (b+1)·B)``. Everything
downstream of ``k`` (source choice, epoch, permutation slot, packed row) is
a pure function of ``(config, seed, k)``, which is what makes the PR 7
sample-domain cursor conversion exact across batch-size/topology changes.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from galvatron_tpu_torch.data.mixture import (
    MixtureDataset,
    SingleSourceDataset,
    parse_mixture,
)
from galvatron_tpu_torch.data.packing import PackedDataset, WindowedDataset, packed_batch_meta
from galvatron_tpu_torch.data.prefetch import AsyncPrefetcher
from galvatron_tpu_torch.data.shards import open_token_dataset


class DataPipeline:
    """Iterator of device-ready batches with cursor/stats side channels."""

    def __init__(
        self,
        dataset: MixtureDataset,
        global_batch_size: int,
        start_batch: int = 0,
        put_fn=None,
        prefetch_depth: int = 0,
        packed: bool = False,
    ):
        self.dataset = dataset
        self.global_batch_size = int(global_batch_size)
        self.packed = packed
        self.put_fn = put_fn if put_fn is not None else (lambda b: b)
        self.last_meta: dict = {}
        self._pos = start_batch * self.global_batch_size
        self._pos_lock = threading.Lock()
        # the prefetch thread starts LAZILY on the first fetch, not here:
        # the trainer builds the pipeline during setup, a few hundred lines
        # before the try/finally that owns close() — an eager thread would
        # leak (GC-rooted via threading._active) on any setup failure in
        # between, holding device batches and corpus mmaps forever
        self._prefetch_depth = prefetch_depth
        self._prefetcher: Optional[AsyncPrefetcher] = None
        self._closed = False

    def _make_item(self):
        """Assemble the next host batch (+ its meta). Runs on the prefetch
        thread when prefetching; the batch is freshly allocated every call
        (np.stack) and never written after hand-off."""
        with self._pos_lock:
            k0 = self._pos
            self._pos += self.global_batch_size
        batch = np.stack(
            [self.dataset.sample(k0 + r) for r in range(self.global_batch_size)]
        ).astype(np.int32, copy=False)
        meta = packed_batch_meta(batch) if self.packed else {}
        meta["position"] = k0
        return batch, meta

    def __iter__(self):
        return self

    def __next__(self):
        if self._prefetch_depth > 0:
            if self._prefetcher is None:
                if self._closed:
                    raise StopIteration
                self._prefetcher = AsyncPrefetcher(
                    self._make_item, self.put_fn, depth=self._prefetch_depth
                )
            batch, meta = next(self._prefetcher)
        else:
            host, meta = self._make_item()
            batch = self.put_fn(host)
        self.last_meta = meta
        return batch

    # --- cursor / resume -------------------------------------------------

    def state(self, samples_consumed: int) -> dict:
        """Checkpoint-meta record for a run that has consumed
        ``samples_consumed`` samples since stream start (the trainer's
        ``samples_done``) — pure in the position, so safe from the watchdog
        thread mid-step."""
        st = self.dataset.state_at(int(samples_consumed))
        if self.packed:
            st["packed"] = True
        return st

    def verify_resume(self, saved_state: dict, samples_consumed: int) -> None:
        """Assert a restored checkpoint's per-source counters match what this
        pipeline derives for the same sample position: equality means the
        resumed stream replays zero and skips zero samples per source; a
        mismatch means the mixture config (sources/weights/seed) changed under
        the checkpoint, and resuming would silently re-serve or drop data."""
        if not isinstance(saved_state, dict):
            return
        pos = int(saved_state.get("position", samples_consumed))
        if pos != int(samples_consumed):
            raise ValueError(
                f"data-pipeline resume: checkpoint records sample position "
                f"{pos} but the trainer resumes at {samples_consumed} — the "
                "sample-domain cursor did not convert cleanly"
            )
        if bool(saved_state.get("packed")) != bool(self.packed):
            raise ValueError(
                "data-pipeline resume: the checkpoint was written with "
                f"pack_sequences={bool(saved_state.get('packed'))} but this "
                f"run has pack_sequences={bool(self.packed)} — the sample "
                "streams differ (packed rows vs windows) even at an "
                "identical cursor"
            )
        saved = saved_state.get("per_source_consumed")
        if not isinstance(saved, dict):
            return
        derived = self.dataset.counts_at(pos)
        if set(saved) != set(derived) or any(
            int(saved[n]) != derived[n] for n in derived
        ):
            raise ValueError(
                "data-pipeline resume: per-source consumption mismatch — "
                f"checkpoint {saved} vs derived {derived} at position {pos}. "
                "The mixture (sources, weights, or seed) changed since the "
                "checkpoint; resuming would replay or skip samples."
            )

    # --- stats ------------------------------------------------------------

    def summary(self, samples_consumed: Optional[int] = None) -> dict:
        """End-of-run record for the metrics JSONL: realized per-source
        consumption + the dataset-level packing efficiency. Flat scalars —
        the JSONL sink rejects nested values by contract. Pass the trainer's
        ``samples_done``: the producer's own position runs ahead of training
        by the prefetch depth."""
        pos = int(self._pos if samples_consumed is None else samples_consumed)
        out = {
            f"consumed_{name}": count
            for name, count in self.dataset.counts_at(pos).items()
        }
        out["samples_consumed"] = pos
        effs = [
            ds.packing_efficiency
            for ds in self.dataset.datasets
            if hasattr(ds, "packing_efficiency")
        ]
        if effs:
            out["dataset_packing_efficiency"] = float(np.mean(effs))
        return out

    def close(self) -> None:
        self._closed = True
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None


def build_data_pipeline(
    cfg,
    global_batch_size: int,
    seq_len: int,
    seed: int = 1234,
    start_batch: int = 0,
    data_path: Optional[str] = None,
    mixture: Optional[str] = None,
    pack: bool = False,
    prefetch_depth: int = 0,
    put_fn=None,
    resume_state: Optional[dict] = None,
    max_open_bins: int = 64,
) -> DataPipeline:
    """Resolve (--data_path | --data_mixture) × --pack_sequences ×
    --prefetch_depth into a DataPipeline. ``resume_state`` (the checkpoint's
    ``data_state`` meta) is verified against the rebuilt cursor."""
    if getattr(cfg, "image_size", 0):
        raise ValueError(
            "the data pipeline (mixture/packing/prefetch) serves token "
            "corpora; vision models use the synthetic loader"
        )
    if pack and (cfg.objective != "clm" or getattr(cfg, "enc_layers", 0)):
        raise ValueError(
            "--pack_sequences requires a decoder-only CLM model (segment "
            "masking and per-segment positions are defined for causal LM rows)"
        )
    if not data_path and not mixture:
        raise ValueError(
            "the data pipeline needs --data_path or --data_mixture (synthetic "
            "streams keep the legacy loader; packing needs real documents)"
        )

    if mixture:
        sources = parse_mixture(mixture)
        names = [s.name for s in sources]
        prefixes = [s.prefix for s in sources]
        weights = [s.weight for s in sources]
    else:
        import os

        names = [os.path.basename(data_path)]
        prefixes = [data_path]
        weights = [1.0]

    def rows_for(prefix: str):
        ds = open_token_dataset(prefix)
        if ds.meta.get("vocab_size", 0) > cfg.vocab_size:
            raise ValueError(
                f"corpus {prefix} vocab {ds.meta.get('vocab_size')} exceeds "
                f"the model vocab {cfg.vocab_size}"
            )
        if pack:
            return PackedDataset(ds, seq_len, max_open_bins=max_open_bins)
        return WindowedDataset(ds, seq_len)

    datasets = [rows_for(p) for p in prefixes]
    if len(datasets) == 1:
        mix = SingleSourceDataset(names[0], datasets[0], seed=seed)
    else:
        mix = MixtureDataset(names, datasets, weights, seed=seed)

    pipe = DataPipeline(
        mix,
        global_batch_size,
        start_batch=start_batch,
        put_fn=put_fn,
        prefetch_depth=prefetch_depth,
        packed=pack,
    )
    if resume_state is not None:
        try:
            pipe.verify_resume(resume_state, start_batch * global_batch_size)
        except Exception:
            pipe.close()  # don't leak the prefetch thread on a refused resume
            raise
    return pipe
