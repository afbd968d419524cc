"""Exponential moving average of the parameters.

Counterpart of ``cv_diffusion_tpu/training/ema.py``: the EMA is a dict of
tensors keyed by parameter name, updated in place after each optimizer
update; evaluation calls the model with it (``torch.func.functional_call``),
so no weights are swapped.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


@torch.no_grad()
def init_ema(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``params`` (never an alias: the optimizer updates the
    parameters in place)."""
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], decay: float,
               step: Optional[int] = None) -> None:
    """shadow ← shadow·d + p·(1−d), in place, for every name in
    ``ema_params`` (JAX ``update_ema``). d is ``decay`` in float32, or with
    ``step`` t (the step before its increment) the warmed-up
    min(decay, (1+t)/(10+t)), also in float32."""
    d = np.float32(decay)
    if step is not None:
        t = np.float32(step)
        d = min(d, (np.float32(1.0) + t) / (np.float32(10.0) + t))
    shadow = list(ema_params.values())
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, [params[name].detach().to(e.dtype)
                                 for name, e in ema_params.items()],
                        alpha=float(np.float32(1.0) - d))
