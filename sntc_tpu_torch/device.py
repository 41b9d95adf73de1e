"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to
``"cuda"``; the CPU is used only when the caller names it (the tests
do).  Asking for CUDA on a machine without it raises: the port never
continues on the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, refusing CUDA where there
    is none and any type other than ``cuda`` or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but CUDA is not "
                "available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda | cpu)")
    return dev
