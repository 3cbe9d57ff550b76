"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# gridDim.z carries the frame index
MAX_FRAMES = 65535


def int32_tensor(name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)!r}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape "
                         f"{tuple(t.shape)}")


def route(kernel: str, *tensors: torch.Tensor) -> str:
    """"cpu" (the plain version) or "cuda" (the kernel); any other device,
    or operands on different devices, raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{kernel}: operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel or plain version for device "
                         f"{dev}")
    if dev.type == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{kernel}: operands must be contiguous")
        if tensors[0].shape[0] > MAX_FRAMES:
            raise ValueError(f"{kernel}: at most {MAX_FRAMES} frames per "
                             f"launch, got {tensors[0].shape[0]}")
    return dev.type
