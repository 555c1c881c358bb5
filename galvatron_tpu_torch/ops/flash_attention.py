"""Decode attention over a contiguous cache and over the paged K/V pool.

Counterpart of ``decode_attention`` and ``paged_decode_attention`` /
``_paged_decode_kernel`` in ``galvatron_tpu/ops/flash_attention.py``.

For the paged op there are three pieces, side by side:

- :func:`paged_decode_attention_plain`: the plain PyTorch version of the
  kernel's function (gather the pages, upcast to fp32, mask, softmax,
  accumulate, cast). The CPU tests use it; on the card it is what the
  kernel is compared with.
- :func:`paged_decode_attention`: the wrapper. A CPU tensor goes to the
  plain version; a CUDA tensor launches the hand-written Hopper kernel
  ``csrc/paged_decode.cu`` or raises. There is no fall back from the card
  to the plain version.
- ``paged_decode_attention.launches``: a plain integer, incremented where
  the wrapper launches the kernel and nowhere else, so a run can show that
  its decode steps went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from galvatron_tpu_torch.ops import _build

#: shared memory one thread block may use on Hopper (227 KB)
_MAX_SMEM_BYTES = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention(q, k, v, q_offset=0, sm_scale=None):
    """Single-query attention for a contiguous KV cache (the reference's
    ``decode_attention``). q: (B, 1, n, d); k/v: (B, S, kv, d). GQA-native:
    the group dim rides inside the einsum (kv-major, like ``_repeat_kv``).
    Scores in fp32 with the -1e30 mask, probabilities cast to q's dtype
    before the PV product, as the reference does."""
    b, q_len, n, d = q.shape
    if q_len != 1:
        raise ValueError(f"decode_attention requires q_len == 1, got {q_len}")
    kv = k.shape[2]
    g = n // kv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q[:, 0].reshape(b, kv, g, d)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k).float() * sm_scale
    offsets = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    allowed = torch.arange(k.shape[1], device=q.device)[None] <= offsets
    scores = scores.masked_fill(~allowed[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v)
    return out.reshape(b, 1, n, d)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, q_offset,
                                 sm_scale=None):
    """The kernel's function in plain PyTorch: gather each row's pages
    through its table, upcast to fp32, mask keys at positions > the row's
    offset with -1e30, softmax, accumulate in fp32, cast to q's dtype.
    Shapes as :func:`paged_decode_attention`."""
    b, _, n, d = q.shape
    _, block_size, kv, _ = k_pages.shape
    max_blocks = block_tables.shape[1]
    g = n // kv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, max_blocks * block_size, kv, d).float()
    v = v_pages[tables].reshape(b, max_blocks * block_size, kv, d).float()
    qg = q[:, 0].reshape(b, kv, g, d).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k) * sm_scale
    offsets = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    allowed = torch.arange(k.shape[1], device=q.device)[None] <= offsets
    scores = scores.masked_fill(~allowed[:, None, None, :], -1e30)
    out = torch.einsum("bkgs,bskh->bkgh", torch.softmax(scores, dim=-1), v)
    return out.reshape(b, 1, n, d).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, q_offset,
                           sm_scale=None):
    """One-query decode attention over a paged K/V pool.

    q: (B, 1, n, d); k_pages/v_pages: (num_blocks, block_size, kv, d), one
    layer of the serving pool; block_tables: (B, max_blocks) int32 mapping
    row b's logical block j to a pool block; q_offset: (B,) int32 absolute
    query positions (>= 0). Returns (B, 1, n, d) in q's dtype.

    The kernel's contract holds on every device: bf16 or fp32 q/k/v of one
    dtype, int32 tables and offsets, contiguous tensors, d a multiple of 8
    and at most 256; anything else raises. CPU tensors then run the plain
    version; CUDA tensors launch the kernel."""
    b, q_len, n, d = q.shape
    if q_len != 1:
        raise ValueError(f"paged_decode_attention requires q_len == 1, got {q_len}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(
            f"k_pages/v_pages must both be (num_blocks, block_size, kv, {d}); "
            f"got {tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )
    _, block_size, kv, _ = k_pages.shape
    if n % kv:
        raise ValueError(f"{n} query heads are not a multiple of {kv} kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, max_blocks), got {tuple(block_tables.shape)}")
    if not torch.is_tensor(q_offset) or tuple(q_offset.shape) != (b,):
        raise ValueError(f"q_offset must be a ({b},) tensor")
    tensors = (q, k_pages, v_pages, block_tables, q_offset)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k_pages, v_pages, block_tables and q_offset must share one device")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"the paged_decode kernel takes bf16 or fp32 q/k/v of one dtype, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if block_tables.dtype != torch.int32 or q_offset.dtype != torch.int32:
        raise TypeError("block_tables and q_offset must be int32")
    if d % 8 or d > 256:
        raise ValueError(f"the paged_decode kernel takes head_dim % 8 == 0 and <= 256, got {d}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged_decode kernel takes contiguous tensors only")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_tables, q_offset, sm_scale
        )
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q, k_pages and v_pages must be 16-byte aligned")
    g = n // kv
    launch, smem_bytes = _kernel()
    if smem_bytes(g, d) > _MAX_SMEM_BYTES:
        raise ValueError(
            f"group of {g} query heads at head_dim {d} needs {smem_bytes(g, d)} "
            f"bytes of shared memory, above the {_MAX_SMEM_BYTES} a block may use"
        )
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), q_offset.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, kv, g, d, block_size, block_tables.shape[1],
            float(sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _kernel():
    """(launch, smem_bytes) ctypes functions of the built library."""
    lib = _build.load("paged_decode")
    launch = lib.galvatron_paged_decode
    launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    launch.restype = ctypes.c_int
    smem = lib.galvatron_paged_decode_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    return launch, smem
