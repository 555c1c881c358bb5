"""Synthetic LM dataloader (the port's copy of ``RandomTokenDataset`` and
``build_dataloader`` in ``galvatron_tpu/core/dataloader.py``).

Yields global (B, S+1) int32 numpy batches, bit-identical to the
reference's for the same seed: the epoch order is a splitmix64 permutation
seeded from the mixed (seed, epoch) pair and each row's tokens are keyed by
its sample index. With ``data_path`` the batches come from an indexed token
corpus (``core/data.py``), GPT-window style, as the reference's do.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from galvatron_tpu_torch.core.data_native import _splitmix64_np, mix_seed, shuffle_index


class RandomTokenDataset:
    """(B, S+1) int32 token batches (inputs ‖ next-token labels).

    ``start_batch`` resumes mid-stream without materializing the skipped
    batches: contents depend only on (seed, epoch, position)."""

    def __init__(self, vocab_size: int, seq_len: int, size: int = 1024, seed: int = 1234):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def batches_per_epoch(self, global_batch_size: int) -> int:
        return max(0, (self.size - global_batch_size) // global_batch_size + 1)

    def _sample_rows(self, ids: np.ndarray) -> np.ndarray:
        n_cols = self.seq_len + 1
        base = np.uint64(mix_seed(self.seed, 0xDA7A))
        with np.errstate(over="ignore"):
            cell = (
                np.asarray(ids, np.uint64)[:, None] * np.uint64(n_cols)
                + np.arange(n_cols, dtype=np.uint64)[None]
            )
            h = _splitmix64_np(base ^ cell)
        return (h % np.uint64(self.vocab_size)).astype(np.int32)

    def batch_iterator(self, global_batch_size: int, start_batch: int = 0) -> Iterator[np.ndarray]:
        per_epoch = self.batches_per_epoch(global_batch_size)
        if per_epoch == 0:
            raise ValueError(
                f"global_batch_size {global_batch_size} exceeds dataset size "
                f"{self.size}; no full batch can be formed"
            )
        epoch, skip = divmod(start_batch, per_epoch)
        while True:
            order = shuffle_index(self.size, mix_seed(self.seed, epoch))
            start_i = skip * global_batch_size
            skip = 0
            for i in range(start_i, self.size - global_batch_size + 1, global_batch_size):
                yield self._sample_rows(order[i : i + global_batch_size])
            epoch += 1


def build_dataloader(cfg, global_batch_size: int, seq_len: Optional[int] = None,
                     size: int = 1024, seed: int = 1234, start_batch: int = 0,
                     data_path: Optional[str] = None):
    """``data_path`` selects the real-corpus path: a ``write_indexed_dataset``
    prefix is loaded memory-mapped and sampled GPT-window style
    (``core/data.py``); otherwise the synthetic random-token stream."""
    seq_len = seq_len or cfg.max_seq_len
    if data_path:
        from galvatron_tpu_torch.core.data import GPTWindowDataset, IndexedTokenDataset

        indexed = IndexedTokenDataset(data_path)
        if indexed.meta["vocab_size"] > cfg.vocab_size:
            raise ValueError(
                f"corpus vocab {indexed.meta['vocab_size']} exceeds the model "
                f"vocab {cfg.vocab_size}"
            )
        ds = GPTWindowDataset(indexed, seq_len, seed)
        return ds.batch_iterator(global_batch_size, start_batch=start_batch)
    ds = RandomTokenDataset(cfg.vocab_size, seq_len, size, seed)
    return ds.batch_iterator(global_batch_size, start_batch=start_batch)
