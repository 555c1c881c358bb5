"""Indexed memory-mapped token datasets — real-data training pipeline.

The port's copy of ``galvatron_tpu/core/data.py``: the same files on disk,
byte for byte, so a corpus written by either package reads in the other,
and the same windows and batches for the same seed. Design:

- On-disk format: ``<prefix>.bin`` — the flat token stream (little-endian,
  uint16 when the vocab fits, else int32); ``<prefix>.idx.json`` — dtype,
  document offsets, token count. The ``.bin`` is memory-mapped; no tokens are
  resident until touched, so corpus size is bounded by disk, not host RAM
  (megatron's indexed_dataset contract).
- ``GPTWindowDataset`` — GPT-style LM sampling: documents concatenated into
  one stream, fixed (seq_len+1)-token windows (stride seq_len so each label
  is trained exactly once), per-epoch shuffle of window order, and O(1)
  deterministic resume by batch index (same contract as the synthetic
  RandomTokenDataset, so trainer resume logic is loader-agnostic).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np


def write_indexed_dataset(
    prefix: str, docs: Iterable[Sequence[int]], vocab_size: int
) -> dict:
    """Build ``<prefix>.bin`` + ``<prefix>.idx.json`` from an iterable of
    token-id documents (the preprocess_data.py role in megatron)."""
    dtype = np.uint16 if vocab_size <= np.iinfo(np.uint16).max + 1 else np.int32
    offsets: List[int] = [0]
    total = 0
    with open(prefix + ".bin", "wb") as f:
        for doc in docs:
            arr = np.asarray(doc, dtype=dtype)
            if arr.size and (arr.max() >= vocab_size or arr.min() < 0):
                raise ValueError(
                    f"document contains token ids outside [0, {vocab_size})"
                )
            arr.tofile(f)
            total += arr.size
            offsets.append(total)
    meta = {
        "dtype": np.dtype(dtype).name,
        "vocab_size": vocab_size,
        "num_tokens": total,
        "doc_offsets": offsets,
        "version": 1,
    }
    with open(prefix + ".idx.json", "w") as f:
        json.dump(meta, f)
    return meta


def tokenize_text_file(
    prefix: str, text_path: str, tokenizer, vocab_size: Optional[int] = None
) -> dict:
    """Encode a newline-delimited text file into the indexed format using a
    tokenizer with ``encode`` and ``vocab_size`` (``models/tokenizer.py``)."""

    def docs():
        with open(text_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield tokenizer.encode(line)

    return write_indexed_dataset(prefix, docs(), vocab_size or tokenizer.vocab_size)


class IndexedTokenDataset:
    """Memory-mapped view of a ``write_indexed_dataset`` corpus."""

    def __init__(self, prefix: str):
        from galvatron_tpu_torch.core.retry import with_retries

        idx_path = prefix + ".idx.json"
        if not os.path.exists(idx_path):
            raise FileNotFoundError(
                f"{idx_path} not found — build the corpus with "
                "write_indexed_dataset / tokenize_text_file first"
            )

        def read_meta():
            with open(idx_path) as f:
                return json.load(f)

        # a corpus on network storage: transient read errors are
        # retried with backoff instead of killing the run (core/retry.py)
        self.meta = with_retries(read_meta, describe=f"read {idx_path}")
        self.dtype = np.dtype(self.meta["dtype"])
        self.tokens = with_retries(
            lambda: np.memmap(prefix + ".bin", dtype=self.dtype, mode="r"),
            describe=f"map {prefix}.bin",
        )
        if self.tokens.size != self.meta["num_tokens"]:
            raise ValueError(
                f"{prefix}.bin has {self.tokens.size} tokens but the index "
                f"records {self.meta['num_tokens']} (corrupt or mismatched pair)"
            )
        self.doc_offsets = np.asarray(self.meta["doc_offsets"], np.int64)

    @property
    def num_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def num_tokens(self) -> int:
        return int(self.meta["num_tokens"])

    def doc(self, i: int) -> np.ndarray:
        return np.asarray(self.tokens[self.doc_offsets[i] : self.doc_offsets[i + 1]])


class GPTWindowDataset:
    """Fixed-window LM samples over the concatenated token stream."""

    def __init__(self, indexed: IndexedTokenDataset, seq_len: int, seed: int = 1234):
        self.indexed = indexed
        self.seq_len = seq_len
        self.seed = seed
        self.num_samples = (indexed.num_tokens - 1) // seq_len
        if self.num_samples == 0:
            raise ValueError(
                f"corpus has {indexed.num_tokens} tokens — fewer than one "
                f"(seq_len+1)={seq_len + 1} window"
            )

    def __len__(self) -> int:
        return self.num_samples

    def sample(self, i: int) -> np.ndarray:
        s = i * self.seq_len
        return np.asarray(self.indexed.tokens[s : s + self.seq_len + 1], np.int32)

    def batches_per_epoch(self, global_batch_size: int) -> int:
        return self.num_samples // global_batch_size

    def batch_iterator(
        self, global_batch_size: int, epochs: Optional[int] = None, start_batch: int = 0
    ) -> Iterator[np.ndarray]:
        """(B, S+1) int32 batches; ``start_batch`` resumes by index arithmetic
        (window order depends only on (seed, epoch))."""
        per_epoch = self.batches_per_epoch(global_batch_size)
        if per_epoch == 0:
            raise ValueError(
                f"global_batch_size {global_batch_size} exceeds the "
                f"{self.num_samples} available windows"
            )
        from galvatron_tpu_torch.core.data_native import mix_seed, shuffle_index

        epoch, skip = divmod(start_batch, per_epoch)
        while epochs is None or epoch < epochs:
            # mixed (seed, epoch) derivation, not seed + epoch: the additive
            # form aliases adjacent streams (seed s epoch 1 == seed s+1
            # epoch 0), silently replaying another run's order
            order = shuffle_index(self.num_samples, mix_seed(self.seed, epoch))
            for b in range(skip, per_epoch):
                idx = order[b * global_batch_size : (b + 1) * global_batch_size]
                yield np.stack([self.sample(int(i)) for i in idx])
            skip = 0
            epoch += 1
