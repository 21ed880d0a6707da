"""Where the port runs: every entry point takes a ``device`` that defaults
to the card, and a CUDA request on a machine without one raises instead
of falling back to the CPU."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT = "cuda"


def resolve(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no card is present."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
