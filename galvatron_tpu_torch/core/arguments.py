"""Flags of the ported modes: the model group and the ``serve`` group of
``galvatron_tpu/core/arguments.py``, limited to what the port runs, plus
``--device``. Flags of unported features are absent, so passing one is an
argparse error rather than a silently ignored option."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from galvatron_tpu_torch.models.modeling import PRESETS, ModelConfig


def _add_model_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--model_size", type=str, default="llama-0.3b", choices=sorted(PRESETS))
    g.add_argument(
        "--set_model_config_manually", type=int, default=0,
        help="1 = require the full manual model config (vocab/hidden/layers/heads); "
        "0 = preset sizes, with any explicitly-passed flags overriding",
    )
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--num_heads", type=int, default=None)
    g.add_argument("--num_kv_heads", type=int, default=None)
    g.add_argument("--ffn_dim", type=int, default=None)
    g.add_argument("--seq_length", type=int, default=None)


def _add_serve_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("serve")
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; 'cuda' without a card is an error")
    g.add_argument("--tokenizer", type=str, default="byte",
                   help="'byte' (the only tokenizer ported so far)")
    g.add_argument("--max_new_tokens", type=int, default=64,
                   help="default tokens_to_generate of a request")
    g.add_argument("--seed", type=int, default=1234, help="per-request sampling seed base")
    g.add_argument("--port", type=int, default=5000)
    g.add_argument("--host", type=str, default="127.0.0.1")
    g.add_argument("--num_slots", type=int, default=4,
                   help="KV slots = max concurrently decoding requests")
    g.add_argument("--prefill_chunk", type=int, default=32,
                   help="prompt tokens prefilled per forward when a request joins")
    g.add_argument("--kv_num_blocks", type=int, default=0,
                   help="paged KV backend: block-pool size including the null "
                   "block; -1 = auto-size to num_slots x max_blocks; 0 = the "
                   "contiguous slot cache, not ported yet")
    g.add_argument("--kv_block_size", type=int, default=16, help="tokens per KV block")
    g.add_argument("--prefix_cache", type=str, default="on", choices=["on", "off"],
                   help="keep refcount-0 prompt blocks registered for "
                   "copy-on-write prefix sharing (LRU-evicted under pressure)")
    g.add_argument("--request_ttl_s", type=float, default=30.0,
                   help="end-to-end request deadline; <= 0: no deadline")
    g.add_argument("--deadline_policy", type=str, default="partial",
                   choices=["partial", "fail"],
                   help="over-deadline DECODING requests: 'partial' returns the "
                   "text so far marked truncated=deadline; 'fail' 503s them")
    g.add_argument("--max_queue", type=int, default=64,
                   help="admission queue depth; beyond it requests 503")
    g.add_argument("--drain_timeout_s", type=float, default=30.0,
                   help="graceful drain bound (SIGTERM or POST /drain)")
    g.add_argument("--max_engine_restarts", type=int, default=3,
                   help="consecutive no-progress in-process engine restarts "
                   "before the engine gives up")


def build_parser(mode: str) -> argparse.ArgumentParser:
    if mode != "serve":
        raise ValueError(f"mode {mode!r} is not ported yet (ROADMAP.md §1)")
    p = argparse.ArgumentParser(f"galvatron_tpu_torch {mode}")
    _add_model_args(p)
    _add_serve_args(p)
    return p


def initialize_galvatron(mode: str, args: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser(mode).parse_args(args)


def model_config_from_args(ns: argparse.Namespace) -> ModelConfig:
    """Preset lookup; explicitly passed shape flags override it."""
    cfg = PRESETS[ns.model_size]
    overrides = {}
    for field, attr in [
        ("vocab_size", "vocab_size"), ("hidden_size", "hidden_size"),
        ("num_layers", "num_layers"), ("num_heads", "num_heads"),
        ("num_kv_heads", "num_kv_heads"), ("ffn_dim", "ffn_dim"),
        ("max_seq_len", "seq_length"),
    ]:
        v = getattr(ns, attr, None)
        if v is not None:
            overrides[field] = v
    if getattr(ns, "set_model_config_manually", 0):
        missing = [f for f in ("vocab_size", "hidden_size", "num_layers", "num_heads")
                   if f not in overrides]
        if missing:
            raise ValueError(f"--set_model_config_manually 1 requires {missing} to be passed")
    return dataclasses.replace(cfg, **overrides)
