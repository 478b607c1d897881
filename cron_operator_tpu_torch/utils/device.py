"""Where the port's entry points run: the CUDA card unless asked otherwise.

The port's mesh is the process group's world, one rank per device: a rank
of a world above one drives ``cuda:$LOCAL_RANK``. This differs from the JAX
package's single controller, where one process drives every device it sees
(``param.devices`` caps them): here ``param.devices`` must equal the world
size, and one process never drives several cards.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def resolve_device(platform: Optional[str] = None,
                   devices: Optional[int] = None) -> torch.device:
    """``torch.device`` for a ``param.platform`` value.

    Unset, ``"cuda"`` or ``"gpu"`` mean the card, and raise ``RuntimeError``
    when there is none: an entry point never carries on quietly on the CPU.
    ``"cpu"`` is the explicit request for the CPU (tests). Under a world
    above one the card is ``cuda:$LOCAL_RANK`` (made current); one process
    keeps ``cuda``, the current card.

    ``devices`` (``param.devices``; 0 or None: unset) must equal the world
    size, else ``ValueError`` names both; a lone process that sees several
    cards and asks for more than one is told to launch one rank per card.
    """
    world = world_size()
    want = int(devices or 0)
    if want > 0 and want != world:
        if (world == 1 and want > 1 and platform != "cpu"
                and torch.cuda.is_available()
                and torch.cuda.device_count() > 1):
            raise ValueError(
                f"param.devices={want}: one process drives one card here; "
                f"launch one rank per card (a world of {want} ranks, "
                "WORLD_SIZE/RANK/LOCAL_RANK)"
            )
        raise ValueError(
            f"param.devices={want} but the world has {world} rank(s): "
            "the mesh is one rank per device"
        )
    if platform in (None, "", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass platform=cpu to run on "
                "the CPU"
            )
        if world == 1:
            return torch.device("cuda")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        return device
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown platform {platform!r} (cuda, gpu or cpu)")


__all__ = ["resolve_device", "world_size"]
