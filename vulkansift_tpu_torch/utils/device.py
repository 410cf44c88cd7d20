"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the default
device is ``"cuda"``, and asking for CUDA where there is none raises instead
of quietly dropping to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

from ..errors import DeviceError, InvalidInputError

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda",
                   index: int = -1) -> torch.device:
    """The torch device an entry point runs on.

    ``device`` None means ``"cuda"``. A CUDA device without an index takes
    ``index`` when it is >= 0, else the current CUDA device. Raises
    :class:`DeviceError` when CUDA is asked for and unavailable, and
    :class:`InvalidInputError` for an index out of range or another device
    type.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise InvalidInputError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise DeviceError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    idx = dev.index if dev.index is not None else (
        index if index >= 0 else torch.cuda.current_device())
    if not 0 <= idx < n:
        raise InvalidInputError(f"CUDA device index {idx} out of range ({n} devices)")
    return torch.device("cuda", idx)
