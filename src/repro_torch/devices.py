"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``"cuda"``, and asking for it where there is none raises
instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev
