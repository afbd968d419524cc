"""Weights for the port: carried across from a JAX params tree, or made from
a seed.

:func:`state_dict_from_jax` turns the JAX package's ``LowLightDiffusion``
params (a nested dict of numpy arrays, NHWC/HWIO) into a state dict of
:class:`~.models.diffusion.LowLightDiffusion` that loads with ``strict=True``.
It is a copy of the mapping in ``cv_diffusion_tpu/utils/torch_compat.py``
(``export_unet_state_dict``): only numpy is needed, so the conversion runs
wherever the params can be read, and the tensors travel on from there.

:func:`init_weights` makes full-width weights from a seed, directly on the
device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import DiffusionConfig, UNetConfig


def _conv(k) -> np.ndarray:
    # kernel [kH, kW, I/g, O] → torch conv weight [O, I/g, kH, kW]
    return np.transpose(np.asarray(k, dtype=np.float32), (3, 2, 0, 1))


def _dense(k) -> np.ndarray:
    return np.transpose(np.asarray(k, dtype=np.float32), (1, 0))


def _1x1_from_dense(k) -> np.ndarray:
    # [I, O] → [O, I, 1, 1]
    return _dense(k)[:, :, None, None]


def _vec(p) -> np.ndarray:
    return np.asarray(p, dtype=np.float32)


def _gn(out, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _vec(p["scale"])
    out[f"{prefix}.bias"] = _vec(p["bias"])


def _irb(out, p: str, b: Dict[str, Any]) -> None:
    _gn(out, f"{p}.norm1", b["norm1"])
    out[f"{p}.expand.weight"] = _conv(b["expand"]["kernel"])
    out[f"{p}.norm2.weight"] = _vec(b["norm2_scale"])
    out[f"{p}.norm2.bias"] = _vec(b["norm2_bias"])
    out[f"{p}.time_mlp.1.weight"] = _dense(b["time_mlp"]["kernel"])
    out[f"{p}.time_mlp.1.bias"] = _vec(b["time_mlp"]["bias"])
    out[f"{p}.depthwise.weight"] = _conv(b["depthwise"]["kernel"])
    out[f"{p}.project.weight"] = _conv(b["project"]["kernel"])
    if "se" in b:
        out[f"{p}.se.fc1.weight"] = _1x1_from_dense(b["se"]["fc1"]["kernel"])
        out[f"{p}.se.fc1.bias"] = _vec(b["se"]["fc1"]["bias"])
        out[f"{p}.se.fc2.weight"] = _1x1_from_dense(b["se"]["fc2"]["kernel"])
        out[f"{p}.se.fc2.bias"] = _vec(b["se"]["fc2"]["bias"])
    if "skip" in b:
        out[f"{p}.skip.weight"] = _conv(b["skip"]["kernel"])


def _attention(out, p: str, b: Dict[str, Any]) -> None:
    _gn(out, f"{p}.norm", b["norm"])
    out[f"{p}.to_qkv.weight"] = _conv(b["to_qkv"]["kernel"])
    out[f"{p}.to_out.0.weight"] = _conv(b["to_out"]["kernel"])
    _gn(out, f"{p}.to_out.1", b["out_norm"])


def unet_state_dict_from_jax(params: Dict[str, Any],
                             config: UNetConfig) -> Dict[str, np.ndarray]:
    """JAX ``EfficientUNet`` params → reference-torch UNet state dict (numpy,
    float32), key for key and value for value what the JAX package's
    ``export_unet_state_dict`` gives."""
    if not config.use_linear_attention:
        raise NotImplementedError(
            "standard softmax attention is not ported (ROADMAP queue 1 item 7)")
    out: Dict[str, np.ndarray] = {}
    out["time_mlp.1.weight"] = _dense(params["time_mlp"]["dense1"]["kernel"])
    out["time_mlp.1.bias"] = _vec(params["time_mlp"]["dense1"]["bias"])
    out["time_mlp.3.weight"] = _dense(params["time_mlp"]["dense2"]["kernel"])
    out["time_mlp.3.bias"] = _vec(params["time_mlp"]["dense2"]["bias"])
    out["init_conv.weight"] = _conv(params["init_conv"]["kernel"])
    out["init_conv.bias"] = _vec(params["init_conv"]["bias"])

    channels = config.channels
    current_res = config.image_size
    for level in range(len(channels)):
        attn_here = current_res in config.attention_resolutions
        idx = 0
        for block in range(config.num_res_blocks):
            _irb(out, f"encoder_blocks.{level}.{idx}",
                 params[f"enc_{level}_{block}"])
            idx += 1
            if attn_here:
                _attention(out, f"encoder_blocks.{level}.{idx}",
                           params[f"enc_attn_{level}_{block}"])
                idx += 1
        if level < len(channels) - 1:
            out[f"downsamplers.{level}.down.weight"] = _conv(
                params[f"down_{level}"]["conv"]["kernel"])
            out[f"downsamplers.{level}.down.bias"] = _vec(
                params[f"down_{level}"]["conv"]["bias"])
            current_res //= 2

    _irb(out, "mid_block1", params["mid_block1"])
    _attention(out, "mid_attn", params["mid_attn"])
    _irb(out, "mid_block2", params["mid_block2"])

    for level in range(len(channels)):
        attn_here = current_res in config.attention_resolutions
        idx = 0
        for block in range(config.num_res_blocks + 1):
            _irb(out, f"decoder_blocks.{level}.{idx}",
                 params[f"dec_{level}_{block}"])
            idx += 1
            if attn_here:
                _attention(out, f"decoder_blocks.{level}.{idx}",
                           params[f"dec_attn_{level}_{block}"])
                idx += 1
        if level < len(channels) - 1:
            out[f"upsamplers.{level}.conv.weight"] = _conv(
                params[f"up_{level}"]["conv"]["kernel"])
            out[f"upsamplers.{level}.conv.bias"] = _vec(
                params[f"up_{level}"]["conv"]["bias"])
            current_res *= 2

    _gn(out, "final_norm", params["final_norm"])
    out["final_conv.weight"] = _conv(params["final_conv"]["kernel"])
    out["final_conv.bias"] = _vec(params["final_conv"]["bias"])
    return out


def state_dict_from_jax(params: Dict[str, Any],
                        config: DiffusionConfig) -> Dict[str, torch.Tensor]:
    """JAX ``LowLightDiffusion`` params (``{"unet": …[, "condition_encoder":
    …]}``) → a state dict of the port's ``LowLightDiffusion`` (CPU tensors;
    ``load_state_dict`` copies them to the model's device)."""
    out = {f"unet.{k}": v
           for k, v in unet_state_dict_from_jax(params["unet"],
                                                config.unet).items()}
    if config.condition_mode == "add":
        ce = params["condition_encoder"]
        for i, name in ((0, "conv1"), (2, "conv2")):
            out[f"condition_encoder.{i}.weight"] = _conv(ce[name]["kernel"])
            out[f"condition_encoder.{i}.bias"] = _vec(ce[name]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


@torch.no_grad()
def init_weights(config: DiffusionConfig, seed: int,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Random weights for ``config`` made from ``seed`` on ``device``: LeCun
    normal kernels (std 1/√fan_in, the JAX package's initialiser), zero
    biases, unit GroupNorm scales."""
    from .device import resolve_device
    from .models.diffusion import LowLightDiffusion

    dev = resolve_device(device)
    with torch.device("meta"):
        shapes = {k: p.shape
                  for k, p in LowLightDiffusion(config).state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if len(shape) > 1:
            fan_in = int(np.prod(shape[1:]))
            out[name] = (torch.randn(shape, generator=gen, device=dev)
                         / float(np.sqrt(fan_in)))
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=dev)
        else:
            out[name] = torch.ones(shape, device=dev)
    return out
