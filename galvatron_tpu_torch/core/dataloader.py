"""Synthetic dataloaders (the port's copy of ``RandomTokenDataset``,
``RandomImageDataset`` and ``build_dataloader`` in
``galvatron_tpu/core/dataloader.py``).

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


class _RandomStreamDataset:
    """The synthetic streams' epochs, permutations and resume: contents
    depend only on (seed, epoch, position), so ``start_batch`` resumes
    mid-stream without materialising the skipped batches. A subclass gives
    ``_sample_rows(ids)``, one batch keyed by each row's sample index."""

    def __init__(self, size: int = 1024, seed: int = 1234):
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def batches_per_epoch(self, global_batch_size: int) -> int:
        return max(0, (self.size - global_batch_size) // global_batch_size + 1)

    def _row_hash(self, ids: np.ndarray, n_cols: int) -> np.ndarray:
        """(len(ids), n_cols) uint64 lattice of splitmix64(seed ⊕ cell id)."""
        base = np.uint64(mix_seed(self.seed, 0xDA7A))
        with np.errstate(over="ignore"):
            cell = (
                np.asarray(ids, np.uint64)[:, None] * np.uint64(n_cols)
                + np.arange(n_cols, dtype=np.uint64)[None]
            )
            return _splitmix64_np(base ^ cell)

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


class RandomTokenDataset(_RandomStreamDataset):
    """(B, S+1) int32 token batches (inputs ‖ next-token labels)."""

    def __init__(self, vocab_size: int, seq_len: int, size: int = 1024, seed: int = 1234):
        super().__init__(size, seed)
        self.vocab_size = vocab_size
        self.seq_len = seq_len

    def _sample_rows(self, ids: np.ndarray) -> np.ndarray:
        h = self._row_hash(ids, self.seq_len + 1)
        return (h % np.uint64(self.vocab_size)).astype(np.int32)


class RandomImageDataset(_RandomStreamDataset):
    """The vision families' synthetic stream: each row is n_pixels values
    in 0..255 (as int32) ‖ one class label, the (B, sample_len + 1) int32
    contract of the token loaders."""

    def __init__(self, n_pixels: int, num_classes: int, size: int = 1024, seed: int = 1234):
        super().__init__(size, seed)
        self.n_pixels = n_pixels
        self.num_classes = num_classes

    def _sample_rows(self, ids: np.ndarray) -> np.ndarray:
        h = self._row_hash(ids, self.n_pixels + 1)
        pixels = (h[:, : self.n_pixels] % np.uint64(256)).astype(np.int32)
        labels = (h[:, self.n_pixels :] % np.uint64(self.num_classes)).astype(np.int32)
        return np.concatenate([pixels, labels], axis=1)


def build_dataloader(cfg, global_batch_size: int, seq_len: Optional[int] = None,
                     size: int = 1024, seed: int = 1234, start_batch: int = 0,
                     data_path: Optional[str] = None):
    """``data_path`` selects the real-corpus path: a ``write_indexed_dataset``
    prefix is loaded memory-mapped and sampled GPT-window style
    (``core/data.py``); otherwise the synthetic random-token stream, or for
    a vision model (``image_size``) the synthetic image stream. An
    encoder-decoder's rows are its encoder tokens ‖ the decoder's
    ``seq_len`` + 1 (the reference's ``sample_len`` + 1)."""
    if getattr(cfg, "image_size", 0):
        if data_path:
            raise ValueError("indexed token corpora do not apply to vision models")
        ds = RandomImageDataset(cfg.sample_len, cfg.num_classes, size, seed)
        return ds.batch_iterator(global_batch_size, start_batch=start_batch)
    seq_len = (seq_len or cfg.max_seq_len) + (cfg.enc_seq if getattr(cfg, "enc_layers", 0)
                                               else 0)
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
