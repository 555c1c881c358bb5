"""Multi-file mmap-backed shard format for token corpora.

Successor of the single-file ``core/data.py`` indexed layout (which it reads
transparently — see ``open_token_dataset``): the token stream is split over
``<prefix>.shard-NNNNN.bin`` files with one JSON manifest
``<prefix>.shards.json`` carrying dtype, per-shard document offsets, and
totals. The manifest is committed atomically (tmp + fsync + rename, the
core/checkpoint.py publish discipline) so a writer killed mid-build can never
leave a readable-but-torn corpus; shard ``.bin`` files are memory-mapped on
open, so corpus size is bounded by disk, not host RAM (the Megatron
indexed_dataset contract, multi-file like its blended/split variants).

Documents never span shards: a shard is closed when the next document would
push it past ``shard_tokens`` (single documents larger than ``shard_tokens``
get a shard of their own). That keeps ``doc(i)`` a single contiguous mmap
slice — no stitch copies on the hot read path.
"""

from __future__ import annotations

import json
import os
from bisect import bisect_right
from typing import Iterable, List, Optional, Sequence

import numpy as np

MANIFEST_SUFFIX = ".shards.json"


def _commit_json(path: str, obj: dict) -> None:
    """Atomic JSON publish: tmp + fsync + rename + dir fsync."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def write_sharded_dataset(
    prefix: str,
    docs: Iterable[Sequence[int]],
    vocab_size: int,
    shard_tokens: int = 1 << 22,
) -> dict:
    """Build ``<prefix>.shard-NNNNN.bin`` files + the fsynced manifest from an
    iterable of token-id documents. Returns the manifest dict."""
    dtype = np.uint16 if vocab_size <= np.iinfo(np.uint16).max + 1 else np.int32
    shards: List[dict] = []
    cur_f = None
    cur_offsets: List[int] = [0]

    def close_shard():
        nonlocal cur_f
        if cur_f is None:
            return
        cur_f.flush()
        os.fsync(cur_f.fileno())
        cur_f.close()
        shards[-1]["doc_offsets"] = list(cur_offsets)
        shards[-1]["num_tokens"] = cur_offsets[-1]
        cur_f = None

    def open_shard():
        nonlocal cur_f, cur_offsets
        name = f"{os.path.basename(prefix)}.shard-{len(shards):05d}.bin"
        shards.append({"file": name})
        cur_offsets = [0]
        cur_f = open(os.path.join(os.path.dirname(prefix) or ".", name), "wb")

    n_docs = 0
    for doc in docs:
        arr = np.asarray(doc, dtype=dtype)
        if arr.size and (arr.max() >= vocab_size or arr.min() < 0):
            raise ValueError(f"document contains token ids outside [0, {vocab_size})")
        if arr.size == 0:
            continue
        if cur_f is None or (
            cur_offsets[-1] and cur_offsets[-1] + arr.size > shard_tokens
        ):
            close_shard()
            open_shard()
        arr.tofile(cur_f)
        cur_offsets.append(cur_offsets[-1] + arr.size)
        n_docs += 1
    close_shard()
    if n_docs == 0:
        # a committed-but-empty manifest would fail later with cryptic
        # numpy/index errors deep inside the packer or window sampler
        raise ValueError(
            f"{prefix}: corpus has no non-empty documents — nothing to write"
        )
    manifest = {
        "version": 1,
        "dtype": np.dtype(dtype).name,
        "vocab_size": vocab_size,
        "num_docs": n_docs,
        "num_tokens": sum(s["num_tokens"] for s in shards),
        "shards": shards,
    }
    _commit_json(prefix + MANIFEST_SUFFIX, manifest)
    return manifest


class ShardedTokenDataset:
    """Memory-mapped reader over a ``write_sharded_dataset`` corpus.

    Same duck type as the legacy ``IndexedTokenDataset`` (``num_docs`` /
    ``num_tokens`` / ``doc(i)`` / ``doc_lengths``) so the packer and the
    mixture treat both interchangeably. Manifest read and every shard mmap go
    through ``core/retry.py`` — corpora live on network storage and a
    transient blip must not kill the run."""

    def __init__(self, prefix: str):
        from galvatron_tpu_torch.core.retry import with_retries

        man_path = prefix + MANIFEST_SUFFIX
        if not os.path.exists(man_path):
            raise FileNotFoundError(
                f"{man_path} not found — build the corpus with "
                "write_sharded_dataset first (or pass a legacy single-file "
                "prefix through open_token_dataset)"
            )

        def read_manifest():
            with open(man_path) as f:
                return json.load(f)

        self.meta = with_retries(read_manifest, describe=f"read {man_path}")
        self.dtype = np.dtype(self.meta["dtype"])
        base = os.path.dirname(prefix) or "."
        self._maps: List[np.memmap] = []
        self._doc_offsets: List[np.ndarray] = []
        # cumulative doc counts per shard → global doc index via bisect
        self._doc_cum: List[int] = [0]
        for sh in self.meta["shards"]:
            path = os.path.join(base, sh["file"])
            m = with_retries(
                lambda p=path: np.memmap(p, dtype=self.dtype, mode="r"),
                describe=f"map {path}",
            )
            if m.size != sh["num_tokens"]:
                raise ValueError(
                    f"{path} has {m.size} tokens but the manifest records "
                    f"{sh['num_tokens']} (corrupt or mismatched shard)"
                )
            self._maps.append(m)
            offs = np.asarray(sh["doc_offsets"], np.int64)
            self._doc_offsets.append(offs)
            self._doc_cum.append(self._doc_cum[-1] + len(offs) - 1)
        if self._doc_cum[-1] != self.meta["num_docs"]:
            raise ValueError(
                f"manifest num_docs {self.meta['num_docs']} disagrees with the "
                f"per-shard offsets ({self._doc_cum[-1]} docs)"
            )
        if self.num_docs == 0:
            # hand-built or legacy-converted manifests: refuse here with a
            # clear message rather than crash in a downstream consumer
            raise ValueError(f"{prefix}: corpus has zero documents")

    @property
    def num_docs(self) -> int:
        return int(self.meta["num_docs"])

    @property
    def num_tokens(self) -> int:
        return int(self.meta["num_tokens"])

    @property
    def doc_lengths(self) -> np.ndarray:
        if not self._doc_offsets:
            return np.zeros(0, np.int64)
        return np.concatenate([np.diff(o) for o in self._doc_offsets])

    def doc(self, i: int) -> np.ndarray:
        if not 0 <= i < self.num_docs:
            raise IndexError(f"doc {i} out of range [0, {self.num_docs})")
        s = bisect_right(self._doc_cum, i) - 1
        j = i - self._doc_cum[s]
        offs = self._doc_offsets[s]
        return np.asarray(self._maps[s][offs[j] : offs[j + 1]])


class _LegacyAdapter:
    """``IndexedTokenDataset`` behind the sharded duck type."""

    def __init__(self, indexed):
        self.indexed = indexed
        self.meta = indexed.meta

    @property
    def num_docs(self) -> int:
        return self.indexed.num_docs

    @property
    def num_tokens(self) -> int:
        return self.indexed.num_tokens

    @property
    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.indexed.doc_offsets)

    def doc(self, i: int) -> np.ndarray:
        return self.indexed.doc(i)


def open_token_dataset(prefix: str):
    """Open a corpus by prefix: the sharded manifest when present, else the
    legacy single-file ``<prefix>.idx.json`` layout — one entry point for
    every consumer (mixture sources, the packer, build_data_pipeline)."""
    if os.path.exists(prefix + MANIFEST_SUFFIX):
        return ShardedTokenDataset(prefix)
    from galvatron_tpu_torch.core.data import IndexedTokenDataset

    return _LegacyAdapter(IndexedTokenDataset(prefix))


def tokenize_text_files(
    prefix: str,
    text_paths: Sequence[str],
    tokenizer,
    vocab_size: Optional[int] = None,
    shard_tokens: int = 1 << 22,
) -> dict:
    """Encode newline-delimited text files into the sharded format (one
    document per non-blank line, files concatenated in order)."""

    def docs():
        for path in text_paths:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield tokenizer.encode(line)

    return write_sharded_dataset(
        prefix, docs(), vocab_size or tokenizer.vocab_size, shard_tokens=shard_tokens
    )
