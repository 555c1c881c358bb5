"""Data subsystem of the port (the counterpart of ``galvatron_tpu/data/``):
sharded corpora, deterministic mixtures and async device prefetch.

- ``shards``   — mmap-backed multi-file shard format (fsynced manifest,
                 ``core/retry.py`` on reads) that also reads the single-file
                 ``core/data.py`` layout;
- ``mixture``  — deterministic weighted mixture over N corpora, seeded and
                 position-addressable, so the sample-domain resume cursor
                 converts exactly across batch-size changes;
- ``packing``  — greedy first-fit sequence packing with segment ids;
- ``prefetch`` — a background host thread assembling batch k+1 and moving
                 it to the rank's device while step k runs;
- ``pipeline`` — the facade the trainer drives: ``build_data_pipeline``.
"""

from galvatron_tpu_torch.data.mixture import (
    MixtureDataset,
    MixtureSchedule,
    MixtureSource,
    SingleSourceDataset,
    parse_mixture,
)
from galvatron_tpu_torch.data.packing import PackedDataset, WindowedDataset, pack_documents
from galvatron_tpu_torch.data.pipeline import DataPipeline, build_data_pipeline
from galvatron_tpu_torch.data.prefetch import AsyncPrefetcher
from galvatron_tpu_torch.data.shards import (
    ShardedTokenDataset,
    open_token_dataset,
    tokenize_text_files,
    write_sharded_dataset,
)

__all__ = [
    "AsyncPrefetcher",
    "DataPipeline",
    "MixtureDataset",
    "MixtureSchedule",
    "MixtureSource",
    "PackedDataset",
    "ShardedTokenDataset",
    "SingleSourceDataset",
    "WindowedDataset",
    "build_data_pipeline",
    "pack_documents",
    "open_token_dataset",
    "parse_mixture",
    "tokenize_text_files",
    "write_sharded_dataset",
]
