"""Weight quantization for serving packages: bf16 and int8.

Counterpart of the weight half of ``cv_diffusion_tpu/export/quantization.py``
(its ``:35-185``), on the port's state dicts:

* **bf16**: cast the float tensors to bfloat16 (by default all of them;
  ``skip_norm_params=True`` keeps what the skip rule keeps);
* **int8**: symmetric per-channel weight quantization, int8 values and
  float32 scales ``s = max(absmax / 127, 1e-12)``, ``q = clip(round(w / s),
  -127, 127)`` with round-half-to-even, dequantized to float32 at load.

The skip rule (:func:`should_skip_quant`: norms, biases, scales, tensors of
fewer than ``min_size`` elements and non-float tensors stay as they are) is
the JAX package's, and it is written for JAX paths: the attention block's
output GroupNorm is ``mid_attn/out_norm/scale`` there (skipped) and
``mid_attn.to_out.1.weight`` here (which no pattern matches). So every rule
is applied to the tensor's JAX path (``weights.jax_paths``). Per-channel is
the JAX tensor's last axis, which every conversion of ``weights.py`` moves
to the torch tensor's axis 0: the reduction is over all other axes, and the
scales come out shaped as the JAX scales converted the same way (``[O, 1,
1, 1]`` for a conv kernel, ``[O, 1]`` for a dense one). On the same weights
the results equal the JAX package's bit for bit
(``tests/test_torch_port_quantization.py``).

The int8 activation path (``int8_act``, ``act_quant_model``, calibration)
and QAT are not ported (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DiffusionConfig
from ..weights import jax_paths

StateDict = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class QuantizationConfig:
    """The JAX ``QuantizationConfig`` (``quantization.py:35``)."""

    dtype: str = "bf16"  # bf16 | int8
    per_channel: bool = True
    # tensors whose JAX paths contain any of these are kept float32
    skip_patterns: Tuple[str, ...] = ("norm", "bias", "scale")
    # the least number of elements worth quantizing
    min_size: int = 256


def _path_str(path: Sequence[str]) -> str:
    return "/".join(str(p) for p in path)


def should_skip_quant(path: Sequence[str], p: torch.Tensor,
                      config: QuantizationConfig = QuantizationConfig()) -> bool:
    """The skip rule (``quantization.py:73``): non-float tensors, tensors of
    fewer than ``min_size`` elements and those whose JAX ``path`` contains a
    skip pattern stay as they are."""
    name = _path_str(path).lower()
    return (not p.is_floating_point()
            or p.numel() < config.min_size
            or any(pat in name for pat in config.skip_patterns))


def int8_scale(pf: torch.Tensor, per_channel: bool) -> torch.Tensor:
    """The symmetric int8 scale ``max(absmax / 127, 1e-12)`` of a float32
    tensor in the torch layout (``quantization.py:85``): per output channel
    (axis 0, the JAX tensor's last) for tensors of two or more dimensions,
    kept as a broadcastable ``[O, 1, …]``, else one scalar."""
    if per_channel and pf.dim() >= 2:
        absmax = pf.abs().amax(dim=tuple(range(1, pf.dim())), keepdim=True)
    else:
        absmax = pf.abs().max()
    return torch.clamp_min(absmax / 127.0, 1e-12)


def _quantize_tensor(p: torch.Tensor, per_channel: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: ``q = clip(round(p / s), -127, 127)``."""
    pf = p.float()
    scale = int8_scale(pf, per_channel)
    q = torch.clamp(torch.round(pf / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_bf16(state_dict: StateDict, model_config: DiffusionConfig,
                  skip_norm_params: bool = False,
                  config: QuantizationConfig = QuantizationConfig()) -> StateDict:
    """Float tensors cast to bfloat16 (``quantization.py:51``): all of them
    by default; with ``skip_norm_params``, all but those the skip rule keeps.
    ``model_config`` names each tensor's JAX path."""
    if not skip_norm_params:
        return {k: t.to(torch.bfloat16) if t.is_floating_point() else t
                for k, t in state_dict.items()}
    paths = jax_paths(model_config, state_dict)
    return {k: t if should_skip_quant(paths[k], t, config) else t.to(torch.bfloat16)
            for k, t in state_dict.items()}


def quantize_int8(state_dict: StateDict, model_config: DiffusionConfig,
                  config: QuantizationConfig = QuantizationConfig()
                  ) -> Dict[str, Dict[str, Any]]:
    """``{"values", "scales", "quantized"}``, each keyed by the state dict's
    names (``quantization.py:106``): int8 values and their float32 scales
    where the skip rule quantizes, else the tensor itself, a scalar scale of
    1 and ``False``."""
    paths = jax_paths(model_config, state_dict)
    values, scales, mask = {}, {}, {}
    for k, t in state_dict.items():
        if should_skip_quant(paths[k], t, config):
            values[k], scales[k], mask[k] = t, torch.ones((), dtype=torch.float32), False
        else:
            values[k], scales[k] = _quantize_tensor(t, config.per_channel)
            mask[k] = True
    return {"values": values, "scales": scales, "quantized": mask}


def dequantize_int8(quantized: Dict[str, Dict[str, Any]],
                    dtype: torch.dtype = torch.float32) -> StateDict:
    """The float state dict back from :func:`quantize_int8`'s output
    (``quantization.py:129``)."""
    return {k: (v.float() * quantized["scales"][k]).to(dtype)
            if quantized["quantized"][k] else v
            for k, v in quantized["values"].items()}


def quantize_model(state_dict: StateDict, model_config: DiffusionConfig,
                   dtype: str = "bf16",
                   config: Optional[QuantizationConfig] = None):
    """(quantized, codec tag) for ``dtype`` (``quantization.py:140``):
    ``bf16`` / ``bfloat16`` / ``fp16`` → bf16, ``int8`` / ``int8_dynamic``
    → int8, ``fp32`` / ``float32`` / ``none`` → the state dict itself.
    Raises ``ValueError`` for any other."""
    config = config or QuantizationConfig(dtype=dtype)
    if dtype in ("bf16", "bfloat16", "fp16"):
        return quantize_bf16(state_dict, model_config), "bf16"
    if dtype in ("int8", "int8_dynamic"):
        return quantize_int8(state_dict, model_config, config), "int8"
    if dtype in ("fp32", "float32", "none"):
        return state_dict, "fp32"
    raise ValueError(f"Unknown quantization dtype: {dtype}")


def param_bytes(tensors: StateDict) -> int:
    """Bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors.values())


def quantization_report(original: StateDict, quantized) -> Dict[str, float]:
    """Sizes before and after (``quantization.py:157``): MiB and the
    compression ratio; an int8 dict counts its values and scales."""
    if isinstance(quantized, dict) and "values" in quantized:
        q_bytes = param_bytes(quantized["values"]) + param_bytes(quantized["scales"])
    else:
        q_bytes = param_bytes(quantized)
    o_bytes = param_bytes(original)
    return {
        "original_mb": o_bytes / 2 ** 20,
        "quantized_mb": q_bytes / 2 ** 20,
        "compression": o_bytes / max(1, q_bytes),
    }


def quantization_error(original: StateDict, dequantized: StateDict) -> float:
    """The largest relative weight error over the float tensors
    (``quantization.py:175``): max |o − d| / max(1e-8, max |o|), in float32
    on the host."""
    errs = []
    for k, o in original.items():
        if o.is_floating_point():
            of = o.detach().float().cpu().numpy()
            df = dequantized[k].detach().float().cpu().numpy()
            denom = max(1e-8, float(np.abs(of).max()))
            errs.append(float(np.abs(of - df).max()) / denom)
    return max(errs) if errs else 0.0
