"""Device resolution shared by every entry point of the port.

Counterpart of ceracoder_tpu/utils/jaxenv.py. Entry points default to
``cuda``; without a card they raise instead of falling back, unless the
caller asks for the CPU (the tests do).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the torch device to run on (default ``cuda``).

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is False. Also pins the
    float-precision switches: no float product lies on the codec path
    (it is integer-exact), but TF32 would round one if it ever did.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def upload(plane, device: torch.device) -> torch.Tensor:
    """A host plane (numpy array or tensor) on `device`. To a card it
    goes from pinned memory without blocking: a copy from pageable
    memory waits for all device work already queued."""
    if not isinstance(plane, torch.Tensor):
        plane = torch.as_tensor(np.asarray(plane))
    if device.type == "cuda" and plane.device.type == "cpu":
        return plane.pin_memory().to(device, non_blocking=True)
    return plane.to(device)
