"""Weights for the port: carried across from a JAX params tree, or made from
a seed.

:func:`state_dict_from_jax` turns the JAX package's ``LowLightDiffusion``
params (a nested dict of numpy arrays, NHWC/HWIO) into a state dict of
:class:`~.models.diffusion.LowLightDiffusion` that loads with ``strict=True``.
It is a copy of the mapping in ``cv_diffusion_tpu/utils/torch_compat.py``
(``export_unet_state_dict``): only numpy is needed, so the conversion runs
wherever the params can be read, and the tensors travel on from there.

Both walk :func:`model_entries`, which pairs each state-dict name with the
path of its JAX leaf; :func:`jax_paths` gives those paths, so that the
port's quantization (``export/quantization.py``) applies the JAX package's
skip rule, which is written for JAX paths, and :func:`act_scales_to_jax` /
:func:`act_scales_from_jax` carry calibrated activation scales between the
port's ``QConv`` modules and JAX's ``act_scales`` collection.

:func:`save_state_dict_npz` and :func:`load_state_dict_npz` write and read
the port's own weights file (``artifacts_torch/<name>.npz``; a committed
artifact's is written by ``scripts/torch_port_export_weights.py``; a
serving package's ``params.npz``, also bf16 and int8): numpy only, so the
card's machine, which cannot open the orbax checkpoints, reads it too.

:func:`init_weights` makes full-width weights from a seed, directly on the
device.
"""

from __future__ import annotations

import hashlib
import json
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterable, List, Tuple

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


# One walk of the model's parameters gives, for each state-dict name, the
# path of its JAX leaf and the layout conversion: ``(name, path, convert,
# optional)``. :func:`unet_state_dict_from_jax` reads the leaves through it,
# :func:`jax_paths` names them, so the two cannot drift apart. An optional
# entry (a block's SE and skip) is there when its JAX leaf is, or when its
# torch name is in the state dict.
Entry = Tuple[str, Tuple[str, ...], Callable[[Any], np.ndarray], bool]


def _gn_entries(prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    return [(f"{prefix}.weight", path + ("scale",), _vec, False),
            (f"{prefix}.bias", path + ("bias",), _vec, False)]


def _irb_entries(p: str, b: Tuple[str, ...]) -> List[Entry]:
    out = _gn_entries(f"{p}.norm1", b + ("norm1",)) + [
        (f"{p}.expand.weight", b + ("expand", "kernel"), _conv, False),
        (f"{p}.norm2.weight", b + ("norm2_scale",), _vec, False),
        (f"{p}.norm2.bias", b + ("norm2_bias",), _vec, False),
        (f"{p}.time_mlp.1.weight", b + ("time_mlp", "kernel"), _dense, False),
        (f"{p}.time_mlp.1.bias", b + ("time_mlp", "bias"), _vec, False),
        (f"{p}.depthwise.weight", b + ("depthwise", "kernel"), _conv, False),
        (f"{p}.project.weight", b + ("project", "kernel"), _conv, False)]
    for fc in ("fc1", "fc2"):
        out += [(f"{p}.se.{fc}.weight", b + ("se", fc, "kernel"), _1x1_from_dense, True),
                (f"{p}.se.{fc}.bias", b + ("se", fc, "bias"), _vec, True)]
    out.append((f"{p}.skip.weight", b + ("skip", "kernel"), _conv, True))
    return out


def _attention_entries(p: str, b: Tuple[str, ...], linear: bool) -> List[Entry]:
    """A linear attention block's entries (``to_out`` a conv and a
    GroupNorm), or a softmax one's (``to_out`` a conv alone), as
    ``cv_diffusion_tpu/utils/torch_compat.py:119-127``."""
    out = (_gn_entries(f"{p}.norm", b + ("norm",))
           + [(f"{p}.to_qkv.weight", b + ("to_qkv", "kernel"), _conv, False)])
    if not linear:
        return out + [(f"{p}.to_out.weight", b + ("to_out", "kernel"), _conv, False)]
    return (out + [(f"{p}.to_out.0.weight", b + ("to_out", "kernel"), _conv, False)]
            + _gn_entries(f"{p}.to_out.1", b + ("out_norm",)))


def _conv_entries(prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    return [(f"{prefix}.weight", path + ("kernel",), _conv, False),
            (f"{prefix}.bias", path + ("bias",), _vec, False)]


def unet_entries(config: UNetConfig) -> List[Entry]:
    """Every parameter the UNet of ``config`` can have, in state-dict order:
    (torch name, path in the JAX ``EfficientUNet`` params, the conversion of
    the JAX leaf to the torch layout, whether it is optional)."""
    linear = config.use_linear_attention
    out: List[Entry] = [
        ("time_mlp.1.weight", ("time_mlp", "dense1", "kernel"), _dense, False),
        ("time_mlp.1.bias", ("time_mlp", "dense1", "bias"), _vec, False),
        ("time_mlp.3.weight", ("time_mlp", "dense2", "kernel"), _dense, False),
        ("time_mlp.3.bias", ("time_mlp", "dense2", "bias"), _vec, False),
        *_conv_entries("init_conv", ("init_conv",))]

    channels = config.channels
    current_res = config.image_size
    for level in range(len(channels)):
        attn_here = current_res in config.attention_resolutions
        idx = 0
        for block in range(config.num_res_blocks):
            out += _irb_entries(f"encoder_blocks.{level}.{idx}", (f"enc_{level}_{block}",))
            idx += 1
            if attn_here:
                out += _attention_entries(f"encoder_blocks.{level}.{idx}",
                                          (f"enc_attn_{level}_{block}",), linear)
                idx += 1
        if level < len(channels) - 1:
            out += _conv_entries(f"downsamplers.{level}.down", (f"down_{level}", "conv"))
            current_res //= 2

    out += _irb_entries("mid_block1", ("mid_block1",))
    out += _attention_entries("mid_attn", ("mid_attn",), linear)
    out += _irb_entries("mid_block2", ("mid_block2",))

    for level in range(len(channels)):
        attn_here = current_res in config.attention_resolutions
        idx = 0
        for block in range(config.num_res_blocks + 1):
            out += _irb_entries(f"decoder_blocks.{level}.{idx}", (f"dec_{level}_{block}",))
            idx += 1
            if attn_here:
                out += _attention_entries(f"decoder_blocks.{level}.{idx}",
                                          (f"dec_attn_{level}_{block}",), linear)
                idx += 1
        if level < len(channels) - 1:
            out += _conv_entries(f"upsamplers.{level}.conv", (f"up_{level}", "conv"))
            current_res *= 2

    out += _gn_entries("final_norm", ("final_norm",))
    out += _conv_entries("final_conv", ("final_conv",))
    return out


def model_entries(config: DiffusionConfig) -> List[Entry]:
    """:func:`unet_entries` of the whole ``LowLightDiffusion`` (names under
    ``unet.``, paths under ``unet``), and its condition encoder's."""
    out = [(f"unet.{n}", ("unet",) + path, conv, opt)
           for n, path, conv, opt in unet_entries(config.unet)]
    if config.condition_mode == "add":
        for i, name in ((0, "conv1"), (2, "conv2")):
            out += _conv_entries(f"condition_encoder.{i}",
                                 ("condition_encoder", name))
    return out


def _leaf(tree: Dict[str, Any], path: Tuple[str, ...]):
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _from_jax(params: Dict[str, Any], entries: List[Entry]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, path, convert, optional in entries:
        leaf = _leaf(params, path)
        if leaf is None:
            if optional:
                continue
            raise KeyError(f"JAX params have no {'/'.join(path)} (for {name})")
        out[name] = convert(leaf)
    return out


def unet_state_dict_from_jax(params: Dict[str, Any],
                             config: UNetConfig) -> Dict[str, np.ndarray]:
    """JAX ``EfficientUNet`` params → reference-torch UNet state dict (numpy,
    float32), key for key and value for value what the JAX package's
    ``export_unet_state_dict`` gives."""
    return _from_jax(params, unet_entries(config))


def state_dict_from_jax(params: Dict[str, Any],
                        config: DiffusionConfig) -> Dict[str, torch.Tensor]:
    """JAX ``LowLightDiffusion`` params (``{"unet": …[, "condition_encoder":
    …]}``) → a state dict of the port's ``LowLightDiffusion`` (CPU tensors;
    ``load_state_dict`` copies them to the model's device)."""
    out = _from_jax(params, model_entries(config))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def jax_paths(config: DiffusionConfig,
              names: Iterable[str]) -> Dict[str, Tuple[str, ...]]:
    """The JAX params path of each state-dict name in ``names`` (a state
    dict of the port's ``LowLightDiffusion`` for ``config``), e.g.
    ``unet.mid_attn.to_out.1.weight`` → ``("unet", "mid_attn", "out_norm",
    "scale")``. Every converted leaf's last JAX axis is the torch tensor's
    axis 0. Raises ``KeyError`` for a name the model does not have."""
    names = list(names)
    paths = {n: path for n, path, _, _ in model_entries(config)}
    missing = [n for n in names if n not in paths]
    if missing:
        raise KeyError(f"not parameters of the model: {missing[:5]}")
    return {n: paths[n] for n in names}


def _module_path(config: DiffusionConfig, module: str) -> Tuple[str, ...]:
    """The JAX module path of the port's convolution ``module`` (the path
    of its kernel without ``kernel``)."""
    path = jax_paths(config, [f"{module}.weight"])[f"{module}.weight"]
    if path[-1] != "kernel":
        raise KeyError(f"{module} is not a convolution of the model")
    return path[:-1]


def act_scales_to_jax(config: DiffusionConfig,
                      scales: Dict[str, Any]) -> Dict[str, Any]:
    """The port's activation scales (``{QConv module name: amax}``, e.g.
    ``unet.mid_attn.to_out.0``) as the JAX package's ``act_scales``
    collection: nested dicts to ``{"amax": float32 array}`` under each
    module's JAX path (``unet/mid_attn/to_out/amax``)."""
    out: Dict[str, Any] = {}
    for name, amax in scales.items():
        node = out
        for key in _module_path(config, name):
            node = node.setdefault(key, {})
        node["amax"] = np.asarray(torch.as_tensor(amax).detach().cpu(), np.float32)
    return out


def act_scales_from_jax(config: DiffusionConfig, act_scales: Dict[str, Any],
                        modules: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The JAX ``act_scales`` collection as the port's scales for the
    convolutions ``modules`` (the names of a model's ``QConv``s): each
    one's amax, read at its JAX path, in its dtype (float32). Raises ``KeyError`` for a
    module the collection does not hold."""
    out = {}
    for name in modules:
        path = _module_path(config, name) + ("amax",)
        leaf = _leaf(act_scales, path)
        if leaf is None:
            raise KeyError(f"act_scales have no {'/'.join(path)} (for {name})")
        out[name] = torch.from_numpy(np.array(leaf).reshape(()))
    return out


def _npz_text(a: np.ndarray) -> str:
    return a.tobytes().decode("utf-8")


def _text_npz(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), np.uint8)


# the file's streams: each dtype's tensors concatenated and split into byte
# planes (byte k of each little-endian element), named as stored
_STREAMS = (("float32", "<f4", ("plane0", "plane1", "plane2", "plane3")),
            ("bfloat16", "<u2", ("bf16_plane0", "bf16_plane1")),
            ("int8", "i1", ("int8_plane",)),
            ("bool", "u1", ("bool_plane",)))
_NP_DTYPES = {d: n for d, n, _ in _STREAMS}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "bool": torch.bool}


def _bits(t: torch.Tensor, dtype: str) -> np.ndarray:
    """t's elements, flat, as the stream of ``dtype`` holds them (bf16 as
    its uint16 bits)."""
    t = t.detach().cpu().contiguous()
    if dtype == "bfloat16":
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).astype(_NP_DTYPES[dtype], copy=False)


def save_state_dict_npz(state_dict: Dict[str, torch.Tensor], path: str,
                        source: str) -> str:
    """Write ``state_dict`` (float32, bfloat16, int8 or bool tensors) in the
    format that :func:`load_state_dict_npz` reads, with
    ``np.savez_compressed``; returns the SHA-256 of the raw bytes. Split
    into byte planes, the exponent bytes compress apart from the mantissa
    bytes (~9% smaller than one zlib stream of the floats), and every
    tensor is kept bit for bit."""
    names = {v: k for k, v in _TORCH_DTYPES.items()}
    index, parts = [], {d: [] for d, _, _ in _STREAMS}
    offsets = dict.fromkeys(parts, 0)
    for name, t in state_dict.items():
        if t.dtype not in names:
            raise TypeError(f"{name}: no {t.dtype} in the weights format")
        dtype = names[t.dtype]
        row = [name, list(t.shape), offsets[dtype]]
        index.append(row if dtype == "float32" else row + [dtype])
        parts[dtype].append(_bits(t, dtype))
        offsets[dtype] += t.numel()
    arrays, raw = {}, b""
    for dtype, np_dtype, planes in _STREAMS:
        if not parts[dtype] and dtype != "float32":
            continue
        flat = (np.concatenate(parts[dtype]) if parts[dtype]
                else np.zeros(0, np_dtype)).tobytes()
        raw += flat
        split = np.frombuffer(flat, np.uint8).reshape(-1, len(planes))
        arrays.update({p: np.ascontiguousarray(split[:, k])
                       for k, p in enumerate(planes)})
    digest = hashlib.sha256(raw).hexdigest()
    np.savez_compressed(path, **arrays, index=_text_npz(json.dumps(index)),
                        sha256=_text_npz(digest), source=_text_npz(source))
    return digest


def load_state_dict_npz(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """The state dict in a weights file of the port's format, on ``device``.

    The file holds each dtype's tensors concatenated and split into byte
    planes: the float32 ones as ``plane0`` … ``plane3`` (byte k of each
    little-endian float), bfloat16 as ``bf16_plane0`` and ``bf16_plane1``
    (their uint16 bits), int8 as ``int8_plane`` and bool as ``bool_plane``;
    an ``index`` (JSON ``[[name, shape, offset(, dtype)], …]``, offsets in
    elements of the tensor's own stream, float32 when no dtype is given),
    the ``sha256`` of the streams' raw bytes in that order and the
    ``source``'s name, all as uint8 arrays. The bytes are put back together
    and checked against the SHA-256 (``ValueError`` on a mismatch) before
    any tensor is made.
    """
    from .device import resolve_device

    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        streams, raw = {}, b""
        for dtype, np_dtype, planes in _STREAMS:
            if planes[0] not in z.files:
                continue
            cols = [z[p] for p in planes]
            if len({c.shape for c in cols}) != 1:
                raise ValueError(f"{path}: byte planes of different lengths")
            flat = np.stack(cols, axis=1).tobytes()
            raw += flat
            streams[dtype] = np.frombuffer(flat, np_dtype)
        index = json.loads(_npz_text(z["index"]))
        want = _npz_text(z["sha256"])
    got = hashlib.sha256(raw).hexdigest()
    if got != want:
        raise ValueError(f"{path}: SHA-256 of the weights is {got}, "
                         f"the file records {want}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape, offset, *dtype in index:
        dtype = dtype[0] if dtype else "float32"
        n = int(np.prod(shape, dtype=np.int64))
        t = torch.from_numpy(streams[dtype][offset:offset + n].reshape(shape).copy())
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        elif dtype == "bool":
            t = t.to(torch.bool)
        out[name] = t.to(dev)
    return out


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
