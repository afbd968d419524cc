"""Quantization-aware training: int8 fake-quant with straight-through
gradients.

Counterpart of ``cv_diffusion_tpu/export/qat.py``. :func:`fake_quant_params`
simulates the int8 weight export inside the forward: every tensor that the
export quantizes (the skip rule on its JAX path, ``export.quantization.
should_skip_quant``) is quantized and dequantized with the export's
per-channel scale, the rounding passed straight through. The gradient also
flows through the scale (its absmax), as in JAX, where ``int8_scale`` is not
stop-gradient'ed, and the clip to ±127 passes half the gradient at a bound,
as ``jnp.clip`` does (the element at a channel's absmax always lands on ±127;
``ops/qconv.clip``). :func:`make_qat_train_step` is the train step with that
transform applied to the parameters inside the loss
(``training.train_state.make_train_step(params_transform=)``): the
optimizer and the EMA update the raw parameters. Activation-aware QAT
(``qat_act``) adds the convolutions' own input fake-quant
(``unet.act_quant="fake"``, ``ops/qconv.py``).

The scale is JAX's as it runs compiled: ``max(absmax · float(1/127),
1e-12)`` (``ops/qconv.py`` on XLA's rewrite of the division by 127).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops.qconv import INV_127, QMAX, WEIGHT_SCALE_FLOOR, clip, ste_round
from ..weights import jax_paths
from .quantization import QuantizationConfig, should_skip_quant


def fake_quant_tensor(p: torch.Tensor, per_channel: bool = True) -> torch.Tensor:
    """``clip(round(p / s), -127, 127) · s`` in at least float32, cast back to
    p's dtype; ``s`` per output channel (the torch tensor's axis 0, the JAX
    tensor's last) for tensors of two or more dimensions, else one scale.
    Straight-through rounding; gradients reach p through s too."""
    pf = p.to(torch.promote_types(p.dtype, torch.float32))
    if per_channel and pf.dim() >= 2:
        absmax = pf.abs().amax(dim=tuple(range(1, pf.dim())), keepdim=True)
    else:
        absmax = pf.abs().amax()
    scale = torch.clamp_min(absmax * INV_127, WEIGHT_SCALE_FLOOR)
    q = clip(ste_round(pf / scale), -QMAX, QMAX)
    return (q * scale).to(p.dtype)


def fake_quant_params(params: Dict[str, torch.Tensor], model_config,
                      config: QuantizationConfig = QuantizationConfig()
                      ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``params`` (a state dict of the port's model for
    ``model_config``) that the int8 export quantizes, fake-quantized; the
    others (norms, biases, scales, tensors of fewer than ``min_size``
    elements: the skip rule on their JAX paths) as they are."""
    paths = jax_paths(model_config, params)
    return {k: p if should_skip_quant(paths[k], p, config)
            else fake_quant_tensor(p, config.per_channel)
            for k, p in params.items()}


def make_qat_train_step(model, schedule, train_config,
                        quant_config: Optional[QuantizationConfig] = None,
                        mesh=None) -> Callable:
    """The train step whose forward sees int8-fake-quantized weights (JAX
    ``make_qat_train_step``): ``training.train_state.make_train_step`` with
    :func:`fake_quant_params` as its ``params_transform``, so clipping,
    AdamW, the EMA, gradient accumulation and data parallelism over
    ``mesh`` are those of plain training."""
    from ..training.train_state import make_train_step

    qcfg = quant_config or QuantizationConfig()
    return make_train_step(model, schedule, train_config,
                           params_transform=lambda p: fake_quant_params(
                               p, model.config, qcfg), mesh=mesh)
