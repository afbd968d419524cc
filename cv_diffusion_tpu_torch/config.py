"""Model and training configuration.

Counterpart of ``cv_diffusion_tpu/config.py``: the same frozen dataclasses
and variant presets, so that an artifact's ``model_config.json`` means the
same model in both packages, and :class:`TrainConfig` field for field. The
YAML loader and the data configs stay in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _freeze(value):
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


@dataclass(frozen=True)
class UNetConfig:
    """Architecture hyperparameters (field for field the JAX ``UNetConfig``).

    ``use_pallas`` is read so that every artifact's file parses, and its
    value is ignored: linear attention always goes through the hand-written
    CUDA kernel's wrapper, which runs the plain version on the CPU.
    ``use_pallas_irb`` routes every stride-1 IRB at inference through the
    fused-IRB kernel's wrapper in the same way, and ``fold_gn`` folds GN2 ⊕
    FiLM at inference, as in the JAX package. ``dtype`` is the compute
    dtype (``"float32"`` or ``"bfloat16"``; the parameters are float32
    either way), and ``remat`` with ``remat_policy`` (``"full"``,
    ``"conv"``) and ``remat_scope`` (``"all"``, ``"decoder"``)
    rematerialises blocks in the backward (``models/unet.py``);
    ``act_quant`` (False, True: int8 compute, ``"fake"``: fake-quant for
    activation-aware QAT) is the convolutions' mode (``ops/qconv.py``). The
    other execution knob, ``split_skip``, is read likewise, and building a
    model that asks for it raises ``NotImplementedError``.
    """

    in_channels: int = 3
    out_channels: int = 3
    base_channels: int = 32
    channel_multipliers: Tuple[int, ...] = (1, 2, 4, 8)
    attention_resolutions: Tuple[int, ...] = (16, 8)
    num_attention_heads: int = 4
    attention_head_dim: int = 32
    use_linear_attention: bool = True
    num_res_blocks: int = 2
    expansion_ratio: int = 4
    use_se: bool = True
    se_ratio: float = 0.25
    time_embed_dim: int = 128
    dropout: float = 0.0
    quantization_friendly: bool = True
    image_size: int = 256
    dtype: str = "float32"
    use_pallas: bool = False
    use_pallas_irb: bool = False
    fold_gn: bool = False
    split_skip: bool = False
    act_quant: Any = False
    remat: bool = False
    remat_policy: str = "full"
    remat_scope: str = "all"

    @property
    def channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_multipliers)

    def resolutions(self) -> Tuple[int, ...]:
        """Feature-map resolution at each UNet level (pre-downsample)."""
        res = []
        r = self.image_size
        for _ in self.channel_multipliers:
            res.append(r)
            r //= 2
        return tuple(res)


UNET_VARIANTS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(base_channels=16, channel_multipliers=(1, 2, 4, 8),
                 num_res_blocks=1, expansion_ratio=2, time_embed_dim=64,
                 num_attention_heads=2),
    "small": dict(base_channels=32, channel_multipliers=(1, 2, 4, 8),
                  num_res_blocks=2, expansion_ratio=4, time_embed_dim=128,
                  num_attention_heads=4),
    "base": dict(base_channels=48, channel_multipliers=(1, 2, 4, 8),
                 num_res_blocks=2, expansion_ratio=4, time_embed_dim=192,
                 num_attention_heads=6),
    "large": dict(base_channels=64, channel_multipliers=(1, 2, 4, 8),
                  num_res_blocks=3, expansion_ratio=4, time_embed_dim=256,
                  num_attention_heads=8),
}


def variant_of(unet_cfg: Dict[str, Any]) -> Optional[str]:
    """Name of the variant preset matching a (possibly partial) UNet-config
    dict, or None."""
    def _norm(v):
        return tuple(v) if isinstance(v, list) else v

    for name, kwargs in UNET_VARIANTS.items():
        if all(_norm(unet_cfg.get(k)) == _norm(v) for k, v in kwargs.items()):
            return name
    return None


def unet_config(variant: str = "small", image_size: int = 256,
                **overrides) -> UNetConfig:
    if variant not in UNET_VARIANTS:
        raise ValueError(
            f"Unknown variant: {variant}. Choose from {sorted(UNET_VARIANTS)}")
    kwargs: Dict[str, Any] = dict(UNET_VARIANTS[variant])
    kwargs["image_size"] = image_size
    kwargs.update(overrides)
    return UNetConfig(**kwargs)


@dataclass(frozen=True)
class SchedulerConfig:
    """LCM scheduler configuration (the JAX ``SchedulerConfig``)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"       # epsilon | v_prediction
    rescale_betas_zero_snr: bool = False
    num_inference_steps: int = 4
    original_inference_steps: int = 50
    clip_pred_x0: bool = False


@dataclass(frozen=True)
class DiffusionConfig:
    """Top-level conditional-diffusion model configuration."""

    unet: UNetConfig = field(default_factory=UNetConfig)
    scheduler: SchedulerConfig = field(
        default_factory=lambda: SchedulerConfig(rescale_betas_zero_snr=True))
    image_size: int = 256
    num_inference_steps: int = 4
    condition_mode: str = "concat"  # concat | add


def diffusion_config(unet_variant: str = "small", image_size: int = 256,
                     num_inference_steps: int = 4,
                     condition_mode: str = "concat",
                     prediction_type: str = "epsilon",
                     **unet_overrides) -> DiffusionConfig:
    in_channels = 6 if condition_mode == "concat" else 3
    return DiffusionConfig(
        unet=unet_config(unet_variant, image_size=image_size,
                         in_channels=in_channels, **unet_overrides),
        scheduler=SchedulerConfig(rescale_betas_zero_snr=True,
                                  prediction_type=prediction_type),
        image_size=image_size,
        num_inference_steps=num_inference_steps,
        condition_mode=condition_mode,
    )


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration, field for field and default for default the
    JAX ``TrainConfig`` (``cv_diffusion_tpu/config.py:242``).

    The port trains with linear attention through its CUDA kernels (forward
    and backward); ``use_pallas`` is read and ignored, as in
    :class:`UNetConfig`. ``use_amp`` (the default) trains the model in
    bfloat16 compute on float32 parameters, ``remat`` rematerialises its
    blocks, and ``init_params_from`` / ``init_params_ema`` warm-start from a
    checkpoint, as in the JAX trainer. ``native_loader``,
    ``prefetch_batches`` and ``data_on_device`` route
    ``data.dataset.create_dataloaders`` as in JAX (``native_loader=True``
    raises where the C++ loader cannot be built); checkpoints are written
    on a worker thread unless ``async_checkpoints`` is off; sample grids go
    to ``output_dir`` every ``sample_interval`` epochs. Fields the port does
    not have yet make the trainer raise ``NotImplementedError``
    (``training.train_state.check_trainable``): a ``mesh_shape`` over more
    than one device, and ``use_wandb``. ``qat``/``qat_act`` train through
    ``export.qat`` (``training.trainer``).
    """

    unet_variant: str = "small"
    image_size: int = 256
    num_inference_steps: int = 4

    epochs: int = 100
    batch_size: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    gradient_clip: float = 1.0

    scheduler_type: str = "cosine"  # cosine | onecycle
    warmup_epochs: int = 5
    min_lr: float = 1e-6
    faithful_no_warmup: bool = False

    use_amp: bool = True

    use_ema: bool = True
    ema_decay: float = 0.9999
    ema_warmup: bool = True

    loss_type: str = "mse"  # mse | huber | l1

    log_interval: int = 100
    save_interval: int = 5
    sample_interval: int = 1
    num_samples: int = 4
    async_checkpoints: bool = True

    output_dir: str = "outputs"
    checkpoint_dir: str = "checkpoints"

    use_wandb: bool = False
    wandb_project: str = "low-light-diffusion-tpu"
    wandb_run_name: Optional[str] = None

    resume_from: Optional[str] = None

    seed: int = 0
    native_loader: Optional[bool] = None
    prefetch_batches: int = 2
    data_on_device: bool = False
    debug_nans: bool = False
    use_pallas: bool = False
    remat: bool = False
    grad_accum_steps: int = 1
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    qat: bool = False
    qat_act: bool = False
    init_params_from: Optional[str] = None
    init_params_ema: bool = False
    prediction_type: str = "epsilon"


def to_json(cfg) -> str:
    """A config dataclass as JSON (the checkpoints' ``config``)."""
    return json.dumps(dataclasses.asdict(cfg), indent=2)


_NESTED = {"unet": UNetConfig, "scheduler": SchedulerConfig}


def from_dict(cls, data: Dict[str, Any]):
    """Rebuild a (possibly nested) config dataclass from a plain dict,
    ignoring keys the dataclass does not have."""
    kwargs: Dict[str, Any] = {}
    names = {f.name for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in names:
            continue
        if key in _NESTED and isinstance(value, dict):
            kwargs[key] = from_dict(_NESTED[key], value)
        else:
            kwargs[key] = _freeze(value)
    return cls(**kwargs)


def load_model_config(path: str, variant: Optional[str] = None,
                      image_size: Optional[int] = None) -> DiffusionConfig:
    """An artifact's ``model_config.json`` as a :class:`DiffusionConfig`.

    ``variant`` replaces the UNet's preset widths and ``image_size`` its
    resolution; everything else comes from the file.
    """
    with open(path) as f:
        data = json.load(f)
    cfg = from_dict(DiffusionConfig, data.get("model", data))
    unet = cfg.unet
    if variant is not None:
        if variant not in UNET_VARIANTS:
            raise ValueError(f"Unknown variant: {variant}. "
                             f"Choose from {sorted(UNET_VARIANTS)}")
        unet = dataclasses.replace(unet, **UNET_VARIANTS[variant])
    if image_size is not None:
        unet = dataclasses.replace(unet, image_size=image_size)
        cfg = dataclasses.replace(cfg, image_size=image_size)
    return dataclasses.replace(cfg, unet=unet)


def load_timesteps(path: str) -> Tuple[int, ...]:
    """The timestep grid of a distilled student (``student_timesteps.json``)."""
    with open(path) as f:
        grid = json.load(f)["timesteps"]
    if not grid or list(grid) != sorted(grid, reverse=True):
        raise ValueError(f"{path}: timesteps must be a descending list, got {grid}")
    return tuple(int(t) for t in grid)
