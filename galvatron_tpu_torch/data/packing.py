"""Greedy first-fit sequence packing with segment ids (the port's copy of
``galvatron_tpu/data/packing.py``).

T5-style packing: documents are bin-packed into fixed-capacity rows instead
of each padding to ``seq_len`` — padding waste drops from (1 − mean_doc_len /
seq_len) to the bin-packing residual. One packed sample row is

    ``[tokens (S+1)] ‖ [segment ids (S+1)]``  →  width 2·(S+1), int32

where ``S = seq_len``. Segment ids are 1-based per document within the row
and 0 on padding; they are monotonically non-decreasing along the row (the
model's per-segment position reset relies on that — see
``modeling.positions_from_segments``). Padding uses token id 0: those
positions are unreachable through attention (segment 0 never matches a real
segment) and carry no loss (``split_batch`` masks labels at every segment
boundary and on padding), so the pad id's embedding never influences
training.

Documents longer than the row capacity are split into capacity-sized pieces,
each its own segment (standard long-document truncation-into-chunks).

Packing is computed once at dataset open, over documents in corpus order —
deterministic, so ``sample(i)`` stays a pure function of the index and the
sample-domain resume cursor applies unchanged. First-fit scans a bounded
window of open bins (``max_open_bins``) for O(n·window) build time.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Piece = Tuple[int, int, int]  # (doc id, start offset within doc, length)


def pack_documents(
    doc_lengths: np.ndarray, capacity: int, max_open_bins: int = 64
) -> List[List[Piece]]:
    """Greedy first-fit: each document (split into ≤``capacity`` pieces) goes
    into the first open bin with room, else opens a new bin; the oldest open
    bin is closed when more than ``max_open_bins`` are open. Returns the bins
    in the order they were opened."""
    if capacity < 2:
        raise ValueError(f"row capacity {capacity} too small to train on")
    closed: List[List[Piece]] = []
    open_bins: List[Tuple[int, List[Piece]]] = []  # (free tokens, pieces)
    for doc_id, length in enumerate(np.asarray(doc_lengths, np.int64)):
        start = 0
        while start < length:
            piece = (int(doc_id), int(start), int(min(capacity, length - start)))
            plen = piece[2]
            placed = False
            for b, (free, pieces) in enumerate(open_bins):
                if free >= plen:
                    pieces.append(piece)
                    if free == plen:
                        closed.append(pieces)
                        open_bins.pop(b)
                    else:
                        open_bins[b] = (free - plen, pieces)
                    placed = True
                    break
            if not placed:
                if plen == capacity:
                    closed.append([piece])  # exact fill: never opens
                else:
                    open_bins.append((capacity - plen, [piece]))
                    if len(open_bins) > max_open_bins:
                        closed.append(open_bins.pop(0)[1])
            start += plen
    closed.extend(pieces for _, pieces in open_bins)
    return closed


class PackedDataset:
    """Packed sample rows over a token dataset (sharded or legacy).

    ``sample(i)`` → ``(2·(seq_len+1),)`` int32: tokens ‖ segment ids."""

    def __init__(self, dataset, seq_len: int, max_open_bins: int = 64):
        self.dataset = dataset
        self.seq_len = seq_len
        self.capacity = seq_len + 1
        self.rows = pack_documents(
            dataset.doc_lengths, self.capacity, max_open_bins=max_open_bins
        )
        if not self.rows:
            raise ValueError("corpus has no documents to pack")
        filled = sum(p[2] for row in self.rows for p in row)
        self.packing_efficiency = filled / float(self.capacity * len(self.rows))

    @property
    def num_samples(self) -> int:
        return len(self.rows)

    def sample(self, i: int) -> np.ndarray:
        row = self.rows[i]
        tokens = np.zeros(self.capacity, np.int32)
        seg = np.zeros(self.capacity, np.int32)
        pos = 0
        for seg_id, (doc_id, start, length) in enumerate(row, start=1):
            tokens[pos : pos + length] = self.dataset.doc(doc_id)[start : start + length]
            seg[pos : pos + length] = seg_id
            pos += length
        return np.concatenate([tokens, seg])


class WindowedDataset:
    """Unpacked fixed windows over the concatenated document stream — the
    GPT-style sampling of ``core/data.GPTWindowDataset`` behind the
    position-addressable ``num_samples``/``sample(i)`` interface (mixture
    sources without ``--pack_sequences``). Windows may cross shard boundaries;
    the stitch copies one row, not the corpus."""

    def __init__(self, dataset, seq_len: int):
        self.dataset = dataset
        self.seq_len = seq_len
        self.num_samples = max(0, dataset.num_tokens - 1) // seq_len
        if self.num_samples <= 0:
            raise ValueError(
                f"corpus has {dataset.num_tokens} tokens — fewer than one "
                f"(seq_len+1)={seq_len + 1} window"
            )
        self._doc_lengths = np.asarray(dataset.doc_lengths, np.int64)
        self._doc_starts = np.concatenate([[0], np.cumsum(self._doc_lengths)])

    def sample(self, i: int) -> np.ndarray:
        start, stop = i * self.seq_len, i * self.seq_len + self.seq_len + 1
        out = np.empty(stop - start, np.int32)
        filled = 0
        # first doc overlapping `start`, then walk forward
        d = int(np.searchsorted(self._doc_starts, start, side="right")) - 1
        while filled < len(out):
            doc = self.dataset.doc(d)
            lo = start + filled - int(self._doc_starts[d])
            take = min(len(doc) - lo, len(out) - filled)
            out[filled : filled + take] = doc[lo : lo + take]
            filled += take
            d += 1
        return out


def packed_batch_meta(batch: np.ndarray) -> dict:
    """Host-side packing stats of one packed ``(B, 2·(S+1))`` batch: non-pad
    INPUT tokens (the S columns the model consumes — what true-token MFU
    counts), raw input tokens, and the fill fraction."""
    s1 = batch.shape[1] // 2
    seg_in = batch[:, s1 : 2 * s1 - 1]  # segment ids of the S input positions
    nonpad = int((seg_in > 0).sum())
    raw = int(seg_in.size)
    return {
        "nonpad_tokens": nonpad,
        "raw_tokens": raw,
        "packing_efficiency": nonpad / float(raw) if raw else 0.0,
    }
