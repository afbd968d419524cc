"""The port runs with the package set of the machine that has the card.

That machine has Python, PyTorch with CUDA, Triton, the CUDA toolkit, numpy,
scipy, einops, pytest and hypothesis, and none of JAX, flax, optax, orbax,
tensorstore, PyYAML, OpenCV, Pillow or safetensors. A subprocess here refuses
to import any of those, or anything of the JAX package, and under that block
imports every module of the port and ``chip_smoke``, then serves one request
through ``ServingPipeline.from_config`` on the CPU, the same request with
``use_pallas_irb`` on, runs ``fused_irb_v1`` on one block, and takes one
train step.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cv_diffusion_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "yaml",
           "cv2", "PIL", "safetensors", "cv_diffusion_tpu")

_CHILD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {blocked!r}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{{name}} is not installed where the card is")
            return None

    sys.meta_path.insert(0, Refuse())

    import numpy as np
    import cv_diffusion_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        cv_diffusion_tpu_torch.__path__, "cv_diffusion_tpu_torch.")]
    for name in names + ["chip_smoke"]:
        importlib.import_module(name)

    from cv_diffusion_tpu_torch.config import load_model_config
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.weights import init_weights

    art = "artifacts/vreg1b_gt03_ema/"
    cfg = load_model_config(art + "model_config.json", variant="tiny",
                            image_size=32)
    pipe = ServingPipeline.from_config(
        art + "model_config.json", art + "student_timesteps.json",
        init_weights(cfg, seed=0, device="cpu"), device="cpu",
        variant="tiny", image_size=32)
    assert pipe.config.timesteps == (739,)
    img = np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    out = pipe(img, seed=0)
    assert out.shape == img.shape and out.dtype == np.uint8

    # the same request with every IRB through the fused kernel's wrapper
    import dataclasses
    from cv_diffusion_tpu_torch.models.diffusion import create_model
    fused_cfg = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_pallas_irb=True))
    model, schedule = create_model(fused_cfg, device="cpu")
    model.load_state_dict(init_weights(cfg, seed=0, device="cpu"), strict=True)
    fused = ServingPipeline(model, schedule, pipe.config, device="cpu")(img, seed=0)
    assert fused.shape == img.shape and fused.dtype == np.uint8
    assert np.abs(fused.astype(int) - out.astype(int)).max() <= 1

    # fused_irb (v1), whose wrapper no model path calls, on CPU tensors
    import torch
    from cv_diffusion_tpu_torch.models.blocks import InvertedResidualBlock
    from cv_diffusion_tpu_torch.ops.fused_irb import irb_args
    from cv_diffusion_tpu_torch.ops.fused_irb_kernel import fused_irb_v1
    blk = dict(model.unet.named_modules())["encoder_blocks.0.0"]
    assert isinstance(blk, InvertedResidualBlock)
    xb = torch.randn(1, blk.expand.weight.shape[1], 16, 16)
    with torch.no_grad():
        fs, fb = blk.time_mlp(torch.randn(1, blk.time_mlp[1].in_features)).chunk(2, dim=-1)
        v1 = fused_irb_v1(xb, film_scale=fs, film_shift=fb, **irb_args(blk))
    assert v1.shape == (1, blk.project.weight.shape[0], 16, 16)
    assert bool(torch.isfinite(v1).all()) and fused_irb_v1.launches == 0

    # one train step of the tiny UNet on synthetic data
    import torch
    from cv_diffusion_tpu_torch.config import TrainConfig
    from cv_diffusion_tpu_torch.data.dataset import (DataLoader,
                                                     SyntheticLowLightDataset)
    from cv_diffusion_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    data = SyntheticLowLightDataset(
        np.random.default_rng(1).integers(0, 256, (2, 40, 40, 3), dtype=np.uint8),
        image_size=32)
    batch = next(iter(DataLoader(data, 2)))
    tcfg = TrainConfig(use_amp=False)
    model.train()
    state = create_train_state(model, tcfg)
    state, metrics = make_train_step(model, schedule, tcfg)(state, batch)
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED-OK", len(names))
""")


def test_port_runs_without_the_jax_stack():
    code = _CHILD.format(blocked=set(BLOCKED))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|tensorstore|yaml"
    r"|cv2|PIL|safetensors)\b"
    r"|^\s*(?:import|from)\s+cv_diffusion_tpu(?:\.|\s|,|$)", re.M)


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)   # one order in every pytest-xdist worker


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_the_jax_stack(path):
    with open(path) as f:
        text = f.read()
    found = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not found, found


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from cv_diffusion_tpu_torch.config import diffusion_config
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.models.diffusion import create_model, enhance

    cfg = diffusion_config("tiny", 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(cfg)
    model, schedule = create_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingPipeline(model, schedule)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enhance(model, schedule, torch.zeros(1, 32, 32, 3), timesteps=[739])


@pytest.mark.parametrize("field,value", [
    ("split_skip", True),
    ("act_quant", True), ("remat", True), ("use_linear_attention", False),
    ("dtype", "bfloat16")])
def test_unported_paths_raise(field, value):
    from cv_diffusion_tpu_torch.config import diffusion_config
    from cv_diffusion_tpu_torch.models.diffusion import create_model

    cfg = diffusion_config("tiny", 32, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(cfg, device="cpu")
