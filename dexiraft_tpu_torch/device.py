"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``). A
CUDA device that is not there raises, naming the device that was asked
for: nothing moves to the CPU behind the caller's back. The CPU runs only
when the caller asks for it, and then every kernel wrapper takes its
plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but torch reports no "
                "CUDA device; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; expected "
                         "'cuda[:N]' or 'cpu'")
    return dev
