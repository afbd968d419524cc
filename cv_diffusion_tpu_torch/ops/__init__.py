"""Ops of the PyTorch port: plain versions and kernel wrappers."""

import torch


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in at least float32: the dtype for statistics and accumulations
    (a float64 tensor, as in a reference evaluation, stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
