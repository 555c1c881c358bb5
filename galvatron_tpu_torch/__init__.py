"""PyTorch/CUDA port of galvatron_tpu, slice by slice.

The JAX package beside this one (``galvatron_tpu``) is the reference every
module here is held against; this package imports ``torch`` and never
``jax`` or anything of ``galvatron_tpu``. Module names mirror the reference
so each counterpart is easy to find:

- ``models/``: ``modeling`` (decoder-LM config, RMSNorm, RoPE, SwiGLU,
  fused QKV, einsum attention, init), ``generation`` (contiguous, slot-wise
  and paged KV-cache forwards, sampling, the generation loop),
  ``tokenizer`` (byte tokenizer).
- ``ops/``: ``flash_attention`` (paged decode attention: plain PyTorch
  version, CUDA kernel wrapper, launch counter), ``csrc/*.cu`` (hand-written
  Hopper kernels), ``_build`` (nvcc build + ctypes loading at first use).
- ``serving/``: the continuous-batching engine on the slot or the paged KV
  backend, its scheduler, request lifecycle, slot and block allocators.
- ``core/``: the trainer and its services (``checkpoint``, ``data``,
  ``dataloader``, ``optim``, ``schedules``); ``data/``: sharded corpora,
  mixtures, prefetch; ``parallel/``: the hybrid-parallel runtime.
- ``server`` (HTTP front end) and ``cli`` (``train``, ``generate``, ``serve``
  and more).
- ``bridge``: weights and train states from the JAX package's numpy trees
  and back.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(``--device cpu``); without a card and without that request they raise.
"""

from galvatron_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
