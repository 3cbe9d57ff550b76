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


def _device_type(kernel: str, *tensors: torch.Tensor) -> str:
    """"cpu" or "cuda", the one device of all operands; any other device,
    or operands on different devices, raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{kernel}: operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel or plain version for device "
                         f"{dev}")
    return dev.type


def route(kernel: str, *tensors: torch.Tensor) -> str:
    """"cpu" (the plain version) or "cuda" (the kernel, which takes
    contiguous operands)."""
    dev = _device_type(kernel, *tensors)
    if dev == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{kernel}: operands must be contiguous")
        if tensors[0].shape[0] > MAX_FRAMES:
            raise ValueError(f"{kernel}: at most {MAX_FRAMES} frames per "
                             f"launch, got {tensors[0].shape[0]}")
    return dev


# K4 (csrc/flash_attn.cu) instantiates these: the prefill forms at the
# (Dk, Dv) pairs of ATTENTION_HEAD_DIMS (DeepSeek-V2's MLA at (192, 128)),
# the decode form at one head dim of DECODE_HEAD_DIMS
ATTENTION_DTYPES = (torch.float32, torch.bfloat16)
ATTENTION_HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (256, 256))
DECODE_HEAD_DIMS = ((64, 64), (128, 128), (256, 256))


def attention(kernel: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, head_dims=ATTENTION_HEAD_DIMS) -> str:
    """Shapes of q (B, Sq, H, Dk), k (B, Skv, Hkv, Dk) and v (B, Skv, Hkv,
    Dv), then the route: v has its own head dim and agrees with k in the
    rest.  Unlike ``route``'s kernels, K4 reads through strides: a CUDA
    operand needs only its last dim contiguous, a type of
    ``ATTENTION_DTYPES`` and a (Dk, Dv) of ``head_dims``; any other pair
    raises (the plain version on the CPU takes every pair)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{kernel}: {name} must be a 4-d tensor "
                             f"(B, S, heads, D)")
    B, _, H, D = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if k.shape[1] < 1 or k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"{kernel}: {H} query heads cannot share "
                         f"{k.shape[2]} kv heads over {k.shape[1]} keys")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{kernel}: q, k, v types {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    dev = _device_type(kernel, q, k, v)
    if dev == "cuda":
        if q.dtype not in ATTENTION_DTYPES:
            raise TypeError(f"{kernel}: the kernel takes float32 or "
                            f"bfloat16, got {q.dtype}")
        if (D, v.shape[3]) not in head_dims:
            raise ValueError(f"{kernel}: the kernel is built for (Dk, Dv) "
                             f"{head_dims}, got {(D, v.shape[3])}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1:
                raise ValueError(f"{kernel}: {name}'s last dim must be "
                                 f"contiguous")
        if B * H > MAX_FRAMES:
            raise ValueError(f"{kernel}: at most {MAX_FRAMES} (batch x "
                             f"heads) per launch, got {B * H}")
    return dev


# K4's bf16 prefill form (csrc/flash_attn_wgmma.cuh, whose tensor maps need
# 16-byte aligned addresses and strides) and its decode form
# (csrc/flash_decode.cu) move rows 16 bytes at a time
ROW_ALIGN_BYTES = 16


def row_misalignment(t: torch.Tensor):
    """Why ``t``'s rows break 16-byte copies, or None: its data_ptr() must
    be a multiple of 16 bytes and its (b, s, h) strides multiples of 16
    bytes (8 bf16 or 4 f32 elements).  A dim of size 1 is never stepped
    over, so its stride does not matter."""
    if t.data_ptr() % ROW_ALIGN_BYTES:
        return (f"data_ptr() {t.data_ptr():#x} is not a multiple of "
                f"{ROW_ALIGN_BYTES} bytes")
    for dim in range(3):
        step = t.stride(dim) * t.element_size()
        if t.shape[dim] > 1 and step % ROW_ALIGN_BYTES:
            return (f"stride {t.stride(dim)} of dim {dim} ({step} bytes) is "
                    f"not a multiple of {ROW_ALIGN_BYTES} bytes")
    return None


def rows_aligned(kernel: str, form: str, **operands: torch.Tensor) -> None:
    """Raise unless every operand meets ``row_misalignment``'s rule."""
    for name, t in operands.items():
        why = row_misalignment(t)
        if why is not None:
            raise ValueError(f"{kernel}: the {form} form needs 16-byte "
                             f"aligned rows; {name}'s {why}")
