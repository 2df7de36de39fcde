"""The port's device gate.  ``None`` means the card: every entry point of
the port runs on CUDA unless the caller asks for the CPU, and a missing card
is an error, never a silent fallback."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Map a requested device to a concrete ``torch.device``.

    ``None`` and ``"cuda"`` need a CUDA card; ``"cpu"`` always works.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs a CUDA card but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev
