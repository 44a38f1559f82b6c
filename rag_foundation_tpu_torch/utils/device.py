"""Device selection: the card unless the caller asks for the CPU.

There is no silent fallback. Asking for ``"cuda"`` on a machine without
a card raises, so a run that was meant for the GPU never carries on on
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "card; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
