"""HuggingFace checkpoint directories, read and written without
``transformers`` or ``safetensors``.

The JAX package's importer and ``export-hf`` lean on ``transformers``
(``AutoConfig``, ``from_pretrained``, ``save_pretrained``) and on
``safetensors``; the port does their file work itself, so that it needs
neither:

- **safetensors**: an 8-byte little-endian header length, a JSON header
  (per tensor ``dtype``, ``shape`` and ``data_offsets`` into the data
  section; an optional ``__metadata__`` string map), then the raw
  little-endian bytes. :func:`read_safetensors` memory-maps the file and
  returns numpy views (F64 / F32 / F16 / I64 / I32 / I16 / I8 / U8 / BOOL);
  BF16 is read as ``uint16`` and widened exactly to fp32 (its bits shifted
  left by 16). :func:`write_safetensors` writes numpy arrays as their own
  dtype and bfloat16 torch tensors as BF16 (an fp32 array narrows through
  torch's round-to-nearest-even, exact for values that were bf16).
- **torch ``.bin`` shards** through ``torch.load(map_location="cpu",
  weights_only=True)``.
- **the two index files** (``model.safetensors.index.json``,
  ``pytorch_model.bin.index.json``: ``weight_map`` from tensor name to
  shard file).
- **``config.json``** → a namespace carrying, for LLaMA, GPT-2 and OPT, the
  defaults of ``transformers``' config class (``LlamaConfig``,
  ``GPT2Config``, ``OPTConfig``) and the derived fields their ``__init__``
  sets, so that a file which leaves out optional fields reads as
  ``AutoConfig`` reads it (``LlamaConfig().rms_norm_eps`` is 1e-6, where
  the JAX importer's own fallback would say 1e-5). Baichuan has no config
  class there and is read raw, as the JAX importer does.

Every file read goes through ``core/retry.py`` (multi-GB shards off network
storage), as the JAX importer's reads do.
"""

from __future__ import annotations

import json
import os
import struct
from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from galvatron_tpu_torch.core.retry import with_retries

#: safetensors dtype names → numpy dtypes (BF16 is handled on its own)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_NP_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}

SAFE_INDEX = "model.safetensors.index.json"
BIN_INDEX = "pytorch_model.bin.index.json"
SAFE_SINGLE = "model.safetensors"
BIN_SINGLE = "pytorch_model.bin"
#: ``save_pretrained``'s default ``max_shard_size`` ("5GB", decimal)
DEFAULT_SHARD_BYTES = 5 * 10 ** 9


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def read_safetensors_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(the JSON header, the data section's byte offset in the file)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    return header, 8 + n


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) → fp32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file, by name: numpy views of the
    memory-mapped file (read-only), BF16 widened to fp32 copies."""
    header, base = read_safetensors_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = mm[base + begin:base + end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            out[name] = bf16_to_f32(raw.view(np.uint16)).reshape(shape)
        elif info["dtype"] in _ST_DTYPES:
            out[name] = raw.view(_ST_DTYPES[info["dtype"]]).reshape(shape)
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which this "
                             f"reader does not take ({', '.join(['BF16', *_ST_DTYPES])})")
    return out


def _storage(t) -> Tuple[np.ndarray, str]:
    """(C-ordered bytes-ready array, safetensors dtype name) of one tensor."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "BF16"
        t = t.numpy()
    a = np.asarray(t)
    if not a.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        a = a.copy(order="C")
    if a.dtype not in _NP_NAMES:
        raise ValueError(f"dtype {a.dtype} has no safetensors name here")
    return a, _NP_NAMES[a.dtype]


def write_safetensors(path: str, tensors: Mapping[str, Any],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (numpy arrays, or torch tensors: bfloat16 as BF16)
    to ``path`` in name order; returns the data bytes written. The header
    is padded with spaces to a multiple of 8 bytes, as the format's own
    writer does."""
    arrays = {name: _storage(t) for name, t in sorted(tensors.items())}
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, (a, dt) in arrays.items():
        header[name] = {"dtype": dt, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a, _ in arrays.values():
            f.write(memoryview(a.reshape(-1)).cast("B"))
    return offset


# ---------------------------------------------------------------------------
# checkpoint directories
# ---------------------------------------------------------------------------


def _load_file(path: str, name: str) -> Dict[str, Any]:
    full = os.path.join(path, name)
    if name.endswith(".safetensors"):
        return with_retries(lambda: read_safetensors(full), describe=f"read {name}")
    return with_retries(lambda: torch.load(full, map_location="cpu", weights_only=True),
                        describe=f"read {name}")


def read_index(path: str) -> Dict[str, str]:
    """An index file's ``weight_map`` (tensor name → shard file)."""
    def read():
        with open(path) as f:
            return json.load(f)["weight_map"]
    return with_retries(read, describe=f"read {os.path.basename(path)}")


def weight_files(path: str) -> List[str]:
    """The weight files of a checkpoint directory, in the JAX importer's
    order of preference: a safetensors index, a ``.bin`` index, then a
    single safetensors or ``.bin`` file."""
    for index in (SAFE_INDEX, BIN_INDEX):
        idx = os.path.join(path, index)
        if os.path.exists(idx):
            return sorted(set(read_index(idx).values()))
    for single in (SAFE_SINGLE, BIN_SINGLE):
        if os.path.exists(os.path.join(path, single)):
            return [single]
    raise FileNotFoundError(f"no model weights (safetensors/bin) under {path}")


def read_state_dict(path: str) -> Dict[str, Any]:
    """The raw state dict of a checkpoint directory (numpy arrays from
    safetensors, CPU tensors from ``.bin`` files), sharded or not, without
    any model class."""
    sd: Dict[str, Any] = {}
    for name in weight_files(path):
        sd.update(_load_file(path, name))
    return sd


def plan_shards(sizes: Mapping[str, int], max_bytes: int = DEFAULT_SHARD_BYTES
                ) -> List[List[str]]:
    """Tensor names split into shards in order, as ``save_pretrained`` splits
    a state dict: a tensor larger than ``max_bytes`` alone in a shard,
    otherwise a new shard whenever the next tensor would overflow it."""
    shards: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for name, n in sizes.items():
        if n > max_bytes:
            shards.append([name])
            continue
        if cur and cur_bytes + n > max_bytes:
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += n
    if cur:
        shards.append(cur)
    return shards


def write_hf_dir(out_dir: str, config: Dict[str, Any], state_dict: Mapping[str, Any],
                 max_shard_bytes: int = DEFAULT_SHARD_BYTES) -> List[str]:
    """``config.json`` and the weights as safetensors: one
    ``model.safetensors``, or ``model-0000i-of-0000n.safetensors`` shards
    with ``model.safetensors.index.json`` when the weights exceed
    ``max_shard_bytes`` (``save_pretrained``'s layout and metadata, so
    ``from_pretrained`` loads the directory). Returns the files written."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)
        f.write("\n")
    sizes = {k: _storage(v)[0].nbytes for k, v in state_dict.items()}
    shards = plan_shards(sizes, max_shard_bytes)
    meta = {"format": "pt"}
    if len(shards) == 1:
        write_safetensors(os.path.join(out_dir, SAFE_SINGLE), state_dict, meta)
        return ["config.json", SAFE_SINGLE]
    files, weight_map = [], {}
    for i, names in enumerate(shards):
        fn = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(out_dir, fn), {k: state_dict[k] for k in names}, meta)
        files.append(fn)
        weight_map.update({k: fn for k in names})
    with open(os.path.join(out_dir, SAFE_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes.values())},
                   "weight_map": dict(sorted(weight_map.items()))}, f, indent=2)
        f.write("\n")
    return ["config.json", *files, SAFE_INDEX]


# ---------------------------------------------------------------------------
# config.json
# ---------------------------------------------------------------------------

#: what ``transformers`` (4.57) fills in for a field ``config.json`` leaves
#: out, per family: the config class's defaults, with ``PretrainedConfig``'s
#: ``tie_word_embeddings`` where the class passes none of its own
HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=None,
                  max_position_embeddings=2048, rms_norm_eps=1e-6, rope_theta=10000.0,
                  rope_scaling=None, attention_bias=False, mlp_bias=False,
                  tie_word_embeddings=False, hidden_act="silu"),
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12,
                 n_inner=None, activation_function="gelu_new", layer_norm_epsilon=1e-5,
                 scale_attn_by_inverse_layer_idx=False, tie_word_embeddings=True),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12, ffn_dim=3072,
                max_position_embeddings=2048, do_layer_norm_before=True,
                word_embed_proj_dim=None, num_attention_heads=12, activation_function="relu",
                enable_bias=True, tie_word_embeddings=True),
}
#: GPT2Config's ``attribute_map``: the generic names a file may use
_GPT2_ALIASES = {"hidden_size": "n_embd", "max_position_embeddings": "n_positions",
                 "num_attention_heads": "n_head", "num_hidden_layers": "n_layer"}


def read_config_json(path: str) -> Dict[str, Any]:
    """A checkpoint directory's raw ``config.json``."""
    full = os.path.join(path, "config.json")

    def read():
        with open(full) as f:
            return json.load(f)
    return with_retries(read, describe="read config.json")


def hf_config(raw: Mapping[str, Any]) -> SimpleNamespace:
    """A ``config.json`` dict as the namespace ``AutoConfig`` would build
    for its ``model_type`` (LLaMA, GPT-2, OPT: the class defaults for the
    fields it leaves out, then the fields their ``__init__`` derives); any
    other type (Baichuan) as it is."""
    arch = raw.get("model_type")
    if arch not in HF_DEFAULTS:
        return SimpleNamespace(**raw)
    d = dict(HF_DEFAULTS[arch])
    if arch == "gpt2":
        raw = {_GPT2_ALIASES.get(k, k): v for k, v in raw.items()}
    d.update(raw)
    if arch == "llama" and d["num_key_value_heads"] is None:
        d["num_key_value_heads"] = d["num_attention_heads"]
    if arch == "opt" and d["word_embed_proj_dim"] is None:
        d["word_embed_proj_dim"] = d["hidden_size"]
    return SimpleNamespace(**d)
