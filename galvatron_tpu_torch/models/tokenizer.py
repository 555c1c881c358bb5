"""Byte tokenizer for the generation path (the port's own copy of
``galvatron_tpu/models/tokenizer.py``'s ``ByteTokenizer``).

A local ``transformers`` tokenizer is not ported yet: ``build_tokenizer``
raises for anything but ``"byte"`` (ROADMAP.md §1, "HF import/export")."""

from __future__ import annotations

from typing import List, Optional, Sequence


def pad_vocab_size(n: int, divisor: int = 128) -> int:
    """Round vocab up so TP shards divide evenly."""
    return (n + divisor - 1) // divisor * divisor


class ByteTokenizer:
    """UTF-8 bytes; ids 256/257/258 = bos/eos/pad."""

    def __init__(self):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258

    @property
    def vocab_size(self) -> int:
        return pad_vocab_size(259)

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] if bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


def build_tokenizer(name_or_path: Optional[str] = None) -> ByteTokenizer:
    if name_or_path in (None, "", "byte"):
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name_or_path!r}: only the byte tokenizer is ported "
        "(ROADMAP.md §1, 'HF import/export')"
    )
