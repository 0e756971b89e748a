"""Device resolution shared by the port's entry points.

Entry points (``serve.Engine``, the models, the kernel wrappers) default to
``device="cuda"`` and run on the CPU only when the caller asks for it.  A
CUDA request without a card raises: nothing continues silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device``'s type."""
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(
                f"tensor on {t.device} but device={device}; move the inputs "
                "or pass the matching device")
