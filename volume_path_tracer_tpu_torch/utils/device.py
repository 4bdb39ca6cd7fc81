"""Device selection for the port's entry points.

Entry points (Medium.from_grids, Scene.from_config, render, cli.main) run on
the CUDA device unless the caller asks for the CPU. Leaving the device unset
on a machine without CUDA is an error: the port never carries on quietly on
the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or the CUDA device when it is None (raises without CUDA)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(cli: --cpu) to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)
