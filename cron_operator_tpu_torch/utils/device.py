"""Where the port's entry points run: the CUDA card unless asked otherwise."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(platform: Optional[str] = None) -> torch.device:
    """``torch.device`` for a ``param.platform`` value.

    Unset, ``"cuda"`` or ``"gpu"`` mean the card, and raise ``RuntimeError``
    when there is none: an entry point never carries on quietly on the CPU.
    ``"cpu"`` is the explicit request for the CPU (tests).
    """
    if platform in (None, "", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass platform=cpu to run on "
                "the CPU"
            )
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown platform {platform!r} (cuda, gpu or cpu)")


__all__ = ["resolve_device"]
