"""Continuous-batching serving on the slot or the paged KV backend.

- [[kv_slots]] ``SlotKVCache``: the contiguous ``(L, num_slots,
  max_seq_len, kv, hd)`` device cache + slot allocator (the default,
  ``kv_num_blocks=0``).
- [[paged_kv]] ``PagedKVCache``: device block pool + host block allocator
  with copy-on-write prefix sharing and block-headroom admission.
- [[scheduler]] ``Scheduler``: FIFO admission queue with TTL and bounded
  depth (``QueueFull``, ``RequestExpired``).
- [[resilience]]: the request lifecycle, the engine crash supervisor and the
  exceptions the server maps to HTTP.
- [[engine]] ``Engine``: the loop (chunked prefill, host sampling, one
  decode forward over all slots per iteration, drain and audit) over
  either backend.
"""

from galvatron_tpu_torch.serving.engine import Engine
from galvatron_tpu_torch.serving.kv_slots import SlotKVCache
from galvatron_tpu_torch.serving.paged_kv import NoFreeBlocks, PagedKVCache
from galvatron_tpu_torch.serving.resilience import (
    DeadlineExceeded,
    EngineClosed,
    EngineDraining,
    EngineRestarted,
    EngineSupervisor,
    RequestCancelled,
    RequestShed,
)
from galvatron_tpu_torch.serving.scheduler import QueueFull, Request, RequestExpired, Scheduler

__all__ = [
    "Engine",
    "SlotKVCache",
    "PagedKVCache",
    "NoFreeBlocks",
    "Scheduler",
    "Request",
    "QueueFull",
    "RequestExpired",
    "RequestShed",
    "RequestCancelled",
    "DeadlineExceeded",
    "EngineDraining",
    "EngineClosed",
    "EngineRestarted",
    "EngineSupervisor",
]
