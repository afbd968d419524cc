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

The int8 activation compute path (JAX ``:189-268``): :func:`act_quant_model`
builds the model whose convolutions compute in int8 (``ops/qconv.py``);
:func:`calibrate_act_scales` records each calibrated convolution's input
amax over batches (the PTQ calibration; the ReLU6-bound convolutions keep
their static scale), :func:`act_scales` / :func:`load_act_scales` read and
set a model's scales, and :func:`assert_calibrated` refuses an amax ≤ 0.
:func:`calibrate_activations` is the static calibration of every module's
output absmax under flax's intermediate names (JAX ``:271``), and
:func:`benchmark_quantized_model` times the codecs (``:334``). The random
draws of both calibrations (t and the noise, per batch) are explicit, or
come from a ``torch.Generator``, so that a test can hand them JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DiffusionConfig
from ..weights import jax_paths, model_entries

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


# ---------------------------------------------------------------------------
# int8 activation compute: the model, its scales, PTQ calibration
# ---------------------------------------------------------------------------

def act_quant_model(config: DiffusionConfig, device="cuda"):
    """(model, schedule) of ``config`` with the int8 activation × weight
    compute path (``unet.act_quant=True``; JAX ``act_quant_model``). Its
    state dict is the float model's, so the float weights load with
    ``strict=True``."""
    import dataclasses

    from ..models.diffusion import create_model

    cfg = dataclasses.replace(config, unet=dataclasses.replace(
        config.unet, act_quant=True))
    return create_model(cfg, device=device)


def qconv_modules(model: torch.nn.Module):
    """``{name: QConv}`` of every quantizing convolution in ``model``, in
    module order."""
    from ..ops.qconv import QConv

    return {n: m for n, m in model.named_modules() if isinstance(m, QConv)}


def act_scales(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's activation scales, ``{QConv name: amax}`` (float32; a
    float64 model's float64), the statically bound ones (6.0) included, as
    JAX's ``act_scales`` collection holds them (``weights.act_scales_to_jax``
    converts)."""
    return {n: m.amax.detach().clone() for n, m in qconv_modules(model).items()}


@torch.no_grad()
def load_act_scales(model: torch.nn.Module, scales: Dict[str, torch.Tensor]) -> None:
    """Set the model's scales from ``{QConv name: amax}`` (every QConv of
    the model must be named). A module whose amax is > 0 then quantizes
    with it; one at 0 keeps the dynamic per-batch fallback."""
    modules = qconv_modules(model)
    missing = sorted(set(modules) - set(scales))
    extra = sorted(set(scales) - set(modules))
    if missing or extra:
        raise KeyError(f"act scales: missing {missing[:5]}, not in the model {extra[:5]}")
    for name, m in modules.items():
        m.set_amax(scales[name])


def assert_calibrated(scales: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` naming every module whose amax is ≤ 0 (JAX
    ``assert_calibrated``): an uncalibrated module would quantize with a
    degenerate scale."""
    bad = [n for n, v in scales.items() if float(v) <= 0.0]
    if bad:
        raise ValueError(
            f"act_scales has uncalibrated entries (amax == 0): {bad}; "
            "run calibrate_act_scales over representative batches first")


def _calibration_inputs(model, schedule, batch, draw, generator):
    """(noisy, low, t) of one calibration batch, NCHW, on the model's device
    in float32 (a float64 model's float64): the batch's images
    (``normal_light``, else ``low_light``) noised at t with ε, both taken
    from ``draw`` (t [B], noise NHWC) or drawn from ``generator`` (t, then
    ε: ``models.diffusion.sample_timesteps_and_noise``)."""
    from ..models.diffusion import sample_timesteps_and_noise
    from ..models.scheduler import add_noise

    param = next(model.parameters())
    device, dtype = param.device, torch.promote_types(param.dtype, torch.float32)

    def tensor(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x
                               ).to(device=device, dtype=dtype)

    low = tensor(batch["low_light"])
    high = tensor(batch["normal_light"] if "normal_light" in batch else batch["low_light"])
    if draw is None:
        t, noise = sample_timesteps_and_noise(schedule, high.shape, generator, device)
    else:
        t = torch.as_tensor(np.asarray(draw[0]) if not isinstance(draw[0], torch.Tensor)
                            else draw[0]).to(device=device, dtype=torch.int64)
        noise = tensor(draw[1])
    nchw = lambda x: x.permute(0, 3, 1, 2).contiguous()  # noqa: E731
    return add_noise(schedule, nchw(high), nchw(noise), t), nchw(low), t


@torch.no_grad()
def calibrate_act_scales(model: torch.nn.Module, schedule, batches,
                         draws=None, generator: Optional[torch.Generator] = None,
                         max_batches: int = 100) -> Dict[str, torch.Tensor]:
    """PTQ calibration (JAX ``calibrate_act_scales``, ``:207``): the
    conditioned forward of each batch (its images noised at t with ε, ⊕ its
    low-light images), in eval mode, on an ``act_quant=True`` model
    (:func:`act_quant_model`) holding the trained weights. Every module
    without a static bound starts at 0 and records ``max(amax, max|x|)`` of
    its input, running its float path; the ReLU6-bound modules keep 6.0
    and run the int8 path, so that what the modules after them record is
    what they will see when serving (``ops/qconv.py``).

    ``draws`` gives each batch's (t [B], ε NHWC); without it they are drawn
    from ``generator``. Returns :func:`act_scales` of the model, which then
    holds them (a module whose amax came out > 0 quantizes with it)."""
    modules = qconv_modules(model)
    if not modules or not all(m.act_quant is True for m in modules.values()):
        raise ValueError("calibrate_act_scales needs an act_quant=True model "
                         "(export.quantization.act_quant_model)")
    model.eval()
    for m in modules.values():
        m.set_amax(0.0 if m.act_bound is None else float(m.act_bound))
        m.calibrating = True
    seen = 0
    try:
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            model(*_calibration_inputs(model, schedule, batch,
                                       None if draws is None else draws[i],
                                       generator))
            seen += 1
    finally:
        for m in modules.values():
            m.calibrating = False
    if not seen:
        raise ValueError("calibrate_act_scales needs at least one batch")
    scales = act_scales(model)
    load_act_scales(model, scales)
    return scales


def _flax_module_names(model: torch.nn.Module) -> Dict[str, str]:
    """``{port module name: flax module path}`` of every module of the
    ``LowLightDiffusion`` that has a counterpart in the JAX model: the model
    itself (``""``), the UNet, its blocks and their layers
    (``unet.encoder_blocks.0.0.se.fc1`` → ``unet/enc_0_0/se/fc1``). Built
    from ``weights.model_entries``: each parameter's module pairs with its
    leaf's module, and each block with its layers' parent (the shortest
    port name where two parents meet, e.g. an attention block over its
    ``to_out`` sequence)."""
    pairs: Dict[str, str] = {"": "", "unet": "unet"}
    parents: Dict[str, str] = {}
    for name, path, _, _ in model_entries(model.config):
        if path[-1] not in ("kernel", "bias", "scale"):
            continue        # an IRB's own norm2_scale / norm2_bias
        module, jpath = name.rsplit(".", 1)[0], "/".join(path[:-1])
        pairs[module] = jpath
        parent, jparent = module.rsplit(".", 1)[0], "/".join(path[:-2])
        if jparent not in parents or len(parent) < len(parents[jparent]):
            parents[jparent] = parent
    for jparent, parent in parents.items():
        pairs.setdefault(parent, jparent)
    present = dict(model.named_modules())
    return {k: v for k, v in pairs.items() if k in present}


@torch.no_grad()
def calibrate_activations(model: torch.nn.Module, schedule, batches,
                          draws=None, generator: Optional[torch.Generator] = None,
                          max_batches: int = 100) -> Dict[str, float]:
    """Per-module output absmax over calibration batches (JAX
    ``calibrate_activations``, ``:271``): the conditioned forward of each
    batch, as :func:`calibrate_act_scales` runs it, with a forward hook on
    every module that flax's ``capture_intermediates`` sees, keyed by
    flax's name (``unet/enc_0_0/expand/__call__/[0]``; the whole model's
    output ``__call__/[0]``), so the dict equals JAX's key for key. The
    draws, as :func:`calibrate_act_scales`'s."""
    model.eval()
    present = dict(model.named_modules())
    running: Dict[str, torch.Tensor] = {}
    hooks = []

    def hook(key):
        def record(mod, args, out):
            value = out.detach().float().abs().amax()
            running[key] = (value if key not in running
                            else torch.maximum(running[key], value))
        return record

    for module, jpath in _flax_module_names(model).items():
        key = f"{jpath}/__call__/[0]" if jpath else "__call__/[0]"
        hooks.append(present[module].register_forward_hook(hook(key)))
    try:
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            model(*_calibration_inputs(model, schedule, batch,
                                       None if draws is None else draws[i],
                                       generator))
    finally:
        for h in hooks:
            h.remove()
    return {k: float(running[k]) for k in sorted(running)}


@torch.no_grad()
def benchmark_quantized_model(model: torch.nn.Module, schedule,
                              dtypes: Sequence[str] = ("fp32", "bf16", "int8"),
                              batch_size: int = 8, num_runs: int = 10,
                              num_inference_steps: int = 4) -> Dict[str, Dict[str, float]]:
    """Latency and size per weight codec (JAX ``benchmark_quantized_model``,
    ``:334``): the model's sampler on ``batch_size`` low-light images (U[-1,
    -0.5], numpy seed 0) with each codec's weights brought back to float32
    (int8 dequantized: a weight-only codec, not int8 compute), two warm-up
    runs, then ``num_runs`` timed ones ending in a synchronise; the mean,
    spread and percentile ms, the size and compression, images/s, and the
    speed-up over the fp32 entry."""
    import time

    from ..models.diffusion import enhance

    device = next(model.parameters()).device
    size = model.config.unet.image_size
    low = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, -0.5, (batch_size, size, size, 3)).astype(np.float32)).to(device)
    state = {k: t.detach() for k, t in model.state_dict().items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {}
    for dtype in dtypes:
        qparams, codec = quantize_model(state, model.config, dtype)
        run = (dequantize_int8(qparams) if codec == "int8"
               else {k: t.float() for k, t in qparams.items()})

        def sample(i):
            return enhance(model, schedule, low, num_inference_steps=num_inference_steps,
                           generator=torch.Generator(device=device).manual_seed(i),
                           device=device, params=run)
        for i in range(3):          # the first call and two warm-up runs
            sample(i)
        sync()
        times = []
        for i in range(num_runs):
            t0 = time.perf_counter()
            sample(i)
            sync()
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times) * 1000
        rep = quantization_report(state, qparams)
        results[dtype] = {
            "mean_ms": float(arr.mean()), "std_ms": float(arr.std()),
            "min_ms": float(arr.min()), "max_ms": float(arr.max()),
            "p50_ms": float(np.percentile(arr, 50)),
            "size_mb": rep["quantized_mb"], "compression": rep["compression"],
            "compute_path": "dequantized-weights" if codec == "int8" else codec,
            "img_per_sec": batch_size / (arr.mean() / 1000),
        }
    base = results.get("fp32") or results.get("float32")
    if base is not None:
        for r in results.values():
            r["speedup_vs_fp32"] = base["mean_ms"] / r["mean_ms"]
    return results
