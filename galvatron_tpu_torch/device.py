"""Device resolution for the port's entry points.

Entry points run on the card by default. A caller that wants the CPU says
so (``device="cpu"``); a missing card is an error, never a silent fall back
to the CPU, so a number taken on the CPU cannot pass for a card's."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` when CUDA is asked
    for (explicitly or by default) and no card is visible. A bare ``cuda``
    resolves to the current card's index, so it compares equal to the
    device of the tensors made there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' (--device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
