"""Device resolution for the port's entry points.

Entry points run on the card by default. A caller that wants the CPU says
so (``device="cpu"``); a missing card is an error, never a silent fall back
to the CPU, so a number taken on the CPU cannot pass for a card's. A rank of
a multi-process world runs on ``cuda:LOCAL_RANK`` (:func:`rank_device`)."""

from __future__ import annotations

from typing import Union

import os

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


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device of this process under the torchrun environment contract:
    ``cuda:LOCAL_RANK`` (0 when unset) for a cuda request, made the current
    card; the CPU when asked for. A ``LOCAL_RANK`` with no visible card
    raises: ranks never wrap around onto fewer cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    resolve_device(torch.device("cuda", 0))  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", "0") or 0)
    if not 0 <= local < torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK={local} but only {torch.cuda.device_count()} card(s) are visible; "
            "start at most one rank per visible card (several ranks may share a card only "
            "with the same LOCAL_RANK)")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)
