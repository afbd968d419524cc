"""Migration entry of the port: ``python -m cv_diffusion_tpu_torch.migrate``.

    python -m cv_diffusion_tpu_torch.migrate ref_checkpoint.pt out_package/ [--device cuda]

Counterpart of ``examples/migrate_from_torch.py``: a trained checkpoint of
the reference PyTorch project (a ``model_state_dict`` with ``unet.``-prefixed
keys, as its trainer writes it, or a bare UNet state dict) into a serving
package. The file is read with ``torch.load(weights_only=True)`` (tensors
and plain containers only). The variant comes from ``init_conv.weight``'s
output width (16, 32, 48, 64: tiny to large) and the conditioning from its
input width (6: concat, 3: add, whose ``condition_encoder.*`` weights are
carried as they are); the model is the JAX script's (256², 4 steps,
epsilon). The port's modules carry the reference's names and layouts (the
SE and attention 1×1 convolutions included), so the weights load by name
with ``strict=True``: a missing, extra or misshapen tensor raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch

from .device import resolve_device

VARIANT_BY_BASE = {16: "tiny", 32: "small", 48: "base", 64: "large"}


def migrated_state_dict(raw) -> Dict[str, torch.Tensor]:
    """The port's ``LowLightDiffusion`` state dict of a reference checkpoint
    (its ``model_state_dict``, or the dict itself): ``unet.*`` as they are
    (a bare UNet state dict gets the prefix), ``condition_encoder.*`` as
    they are, float32; every other key (an EMA, a scheduler buffer) is
    dropped, as in the JAX script."""
    sd = raw.get("model_state_dict", raw)
    unet = {k: v for k, v in sd.items() if k.startswith("unet.")}
    if not unet:
        unet = {f"unet.{k}": v for k, v in sd.items()
                if not k.startswith("condition_encoder.")}
    cond = {k: v for k, v in sd.items() if k.startswith("condition_encoder.")}
    return {k: v.detach().float().cpu() for k, v in {**unet, **cond}.items()}


def migrated_config(state: Dict[str, torch.Tensor]):
    """The DiffusionConfig of a migrated state dict, from
    ``unet.init_conv.weight`` [base, in_channels, 3, 3] (JAX
    ``examples/migrate_from_torch.py:45-48``)."""
    from .config import diffusion_config

    base, in_ch = state["unet.init_conv.weight"].shape[:2]
    if base not in VARIANT_BY_BASE or in_ch not in (3, 6):
        raise ValueError(f"init_conv.weight {tuple(state['unet.init_conv.weight'].shape)}: "
                         "not a reference EfficientUNet (base width 16/32/48/64, "
                         "3 or 6 input channels)")
    mode = "concat" if in_ch == 6 else "add"
    if mode == "add" and not any(k.startswith("condition_encoder.") for k in state):
        raise ValueError("an add-mode checkpoint (3 input channels) without "
                         "condition_encoder.* weights")
    print(f"variant={VARIANT_BY_BASE[base]}, in_channels={in_ch}")
    return diffusion_config(VARIANT_BY_BASE[base], image_size=256,
                            condition_mode=mode)


def migrate(ckpt_path: str, out_dir: str, device="cuda") -> Dict[str, str]:
    """Write the serving package of the reference checkpoint ``ckpt_path``
    into ``out_dir``; returns its files by role."""
    from .export.serving import create_serving_package
    from .models.diffusion import create_model

    state = migrated_state_dict(torch.load(ckpt_path, map_location="cpu",
                                           weights_only=True))
    model, schedule = create_model(migrated_config(state), device=device)
    model.load_state_dict(state, strict=True)
    return create_serving_package(out_dir, model, schedule, num_inference_steps=4)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[2].replace("\n", " "),
                                allow_abbrev=False)
    p.add_argument("checkpoint", help="the reference checkpoint (.pt)")
    p.add_argument("output", help="the serving package's directory")
    p.add_argument("--device", default="cuda",
                   help="Device the model is built on (default: cuda)")
    args = p.parse_args(argv)
    resolve_device(args.device)
    files = migrate(args.checkpoint, args.output, args.device)
    print("Converted package:")
    for k, v in files.items():
        print(f"  {k}: {v}")
    return files


if __name__ == "__main__":
    main(sys.argv[1:])
