"""Device selection and the float32 precision settings of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``"cuda"`` is the
    current CUDA device); raises when it names CUDA and no CUDA device is
    present (the port does not move to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pin_fp32() -> None:
    """Full float32 on the card: cuDNN runs float32 convolutions in TF32
    unless told not to, which would break parity with the float32 artifacts'
    math. Sets both process-wide switches to False."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
