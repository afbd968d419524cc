"""The port runs with the package set of the machine that has the card.

That machine has Python, PyTorch with CUDA, Triton, the CUDA toolkit, numpy,
scipy, einops, pytest and hypothesis, and none of JAX, flax, optax, orbax,
tensorstore, PyYAML, OpenCV, Pillow, safetensors or scikit-learn. A
subprocess here refuses to import any of those, or anything of the JAX
package, and under that block imports every module of the port and
``chip_smoke``, then serves one request through
``ServingPipeline.from_config`` on the CPU, writes, loads and serves a bf16,
an int8 and an int8_act (calibrated on one batch) serving package of that
model, serves the same request with
``use_pallas_irb`` on, runs ``fused_irb_v1`` on one block, takes one
train step, serves the request in bf16 compute and takes one ``use_amp``
step; then loads the committed student's ``.npz`` and serves a request
through ``ServingPipeline.from_artifact``, makes a small synthetic split and
computes the five quality metrics; then decodes a PNG directory into a
device cache on the CPU, writes a sample grid, saves a checkpoint
asynchronously and runs ``python -m cv_diffusion_tpu_torch.train``'s
``main`` on the CPU for one epoch of the tiny model on that directory, and
``python -m cv_diffusion_tpu_torch.distill``'s ``main`` (regression, from a
``save_params`` teacher) on the same directory.
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
           "cv2", "PIL", "safetensors", "sklearn", "cv_diffusion_tpu")

_CHILD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {blocked!r}

    # torch probes for optional libraries (scikit-learn among them) with
    # importlib.util.find_spec, which returns None on the card and would
    # raise under the block below: its probe runs first
    import torch._dynamo

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

    # bf16 and int8 serving packages written, loaded and served
    import tempfile
    import torch
    from cv_diffusion_tpu_torch.export.serving import create_serving_package
    with tempfile.TemporaryDirectory() as tmp:
        for codec in ("bf16", "int8"):
            create_serving_package(f"{{tmp}}/{{codec}}", pipe.model, pipe.schedule,
                                   quantize=codec, timesteps=[739])
            packaged = ServingPipeline.from_package(f"{{tmp}}/{{codec}}", device="cpu")
            assert packaged.config.timesteps == (739,)
            got = packaged(img, seed=0)
            assert got.shape == img.shape and got.dtype == np.uint8
        # an int8_act package: the int8-compute model calibrated on one
        # batch, written, loaded and served
        from cv_diffusion_tpu_torch.export.quantization import (
            act_quant_model, calibrate_act_scales)
        qmodel, _ = act_quant_model(cfg, device="cpu")
        qmodel.load_state_dict(pipe.model.state_dict(), strict=True)
        calib = [{{"low_light": np.full((2, 32, 32, 3), -0.5, np.float32),
                   "normal_light": np.zeros((2, 32, 32, 3), np.float32)}}]
        scales = calibrate_act_scales(qmodel, pipe.schedule, calib,
                                      generator=torch.Generator().manual_seed(0))
        create_serving_package(f"{{tmp}}/int8_act", pipe.model, pipe.schedule,
                               quantize="int8_act", act_scales=scales, timesteps=[739])
        packaged = ServingPipeline.from_package(f"{{tmp}}/int8_act", device="cpu")
        assert packaged.model.config.unet.act_quant is True
        got = packaged(img, seed=0)
        assert got.shape == img.shape and got.dtype == np.uint8

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
    from cv_diffusion_tpu_torch.config import TrainConfig, diffusion_config
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

    # bf16 compute: one request, and one use_amp step (train_model's model)
    from cv_diffusion_tpu_torch.models.diffusion import with_dtype
    bf16 = with_dtype(pipe.model, "bfloat16")
    got = ServingPipeline(bf16, pipe.schedule, pipe.config, device="cpu")(img, seed=0)
    assert got.shape == img.shape and got.dtype == np.uint8
    amp = TrainConfig(use_amp=True, unet_variant="tiny", image_size=32)
    amp_model, amp_sched = create_model(diffusion_config(
        "tiny", 32, dtype="bfloat16"), device="cpu")
    amp_model.train()
    state = create_train_state(amp_model, amp)
    state, metrics = make_train_step(amp_model, amp_sched, amp)(state, batch)
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in amp_model.parameters())

    # the committed student from its weights file, the split, the metrics
    student = ServingPipeline.from_artifact("vreg1b_gt03_ema", device="cpu")
    out = student(img, seed=0)
    assert out.shape == img.shape and out.dtype == np.uint8
    from cv_diffusion_tpu_torch.data.synthetic import make_split
    from cv_diffusion_tpu_torch.training import metrics as M
    low, high = make_split(2, 64, 0)
    assert low.shape == high.shape == (2, 64, 64, 3) and low.dtype == np.uint8
    p, t = (torch.from_numpy(a).float() / 255 for a in (low, high))
    big = torch.rand(1, 176, 176, 3, generator=torch.Generator().manual_seed(0))
    vals = [M.psnr(p, t), M.ssim(p, t), M.mae(p, t), M.gmsd(p, t),
            M.ms_ssim(big, (big * 0.9).clamp(0, 1))]
    assert all(bool(torch.isfinite(v)) for v in vals), vals
    # the training input path: a PNG directory decoded into a device cache
    # on the CPU, a sample grid, an asynchronous checkpoint save
    import pathlib, tempfile
    from cv_diffusion_tpu_torch.data import png
    from cv_diffusion_tpu_torch.data.dataset import create_dataloaders
    from cv_diffusion_tpu_torch.training.checkpoint import (AsyncCheckpointSaver,
                                                            load_raw)
    from cv_diffusion_tpu_torch.training.trainer import save_comparison_grid
    tmp = pathlib.Path(tempfile.mkdtemp())
    rng = np.random.default_rng(2)
    for i in range(4):
        for sub in ("low", "high"):
            png.write_png(tmp / "lol" / sub / f"{{i}}.png",
                          rng.integers(0, 256, (36, 40, 3), dtype=np.uint8),
                          (0, 1, 2, 3, 4))
    train, val = create_dataloaders(str(tmp / "lol"), str(tmp / "lol"),
                                    batch_size=2, image_size=32, native=False,
                                    device_cache=True, device="cpu")
    b, v = next(iter(train)), next(iter(val))
    assert b["low_light"].shape == (2, 32, 32, 3)
    assert train.nbytes() == 2 * 4 * 36 * 40 * 3
    save_comparison_grid(v["low_light"], v["low_light"], v["normal_light"],
                         str(tmp / "grid.png"))
    assert png.read_image(tmp / "grid.png").shape == (96, 64, 3)
    saver = AsyncCheckpointSaver()
    saver.save(str(tmp / "ck.pt"), state, epoch=0, best_val_loss=1.0,
               config_json="{{}}")
    saver.wait()
    assert load_raw(str(tmp / "ck.pt"))["step"] == 1
    # the training CLI on those directories
    from cv_diffusion_tpu_torch import train as cli
    cli.main(["--data_dir", str(tmp / "lol"), "--val_dir", str(tmp / "lol"),
              "--variant", "tiny", "--image_size", "32", "--epochs", "1",
              "--batch_size", "2", "--device", "cpu",
              "--output_dir", str(tmp / "out"), "--checkpoint_dir", str(tmp / "ck")])
    assert (tmp / "ck" / "final_model.pt").is_file()
    assert (tmp / "out" / "samples_epoch_0.png").is_file()
    # the distillation CLI on those directories, from a save_params teacher
    from cv_diffusion_tpu_torch import distill
    from cv_diffusion_tpu_torch.config import to_json
    from cv_diffusion_tpu_torch.training.checkpoint import save_params
    teacher_cfg = diffusion_config("tiny", 32, prediction_type="v_prediction")
    save_params(str(tmp / "teacher"), init_weights(teacher_cfg, seed=0, device="cpu"),
                to_json(teacher_cfg))
    distill.main(["--teacher", str(tmp / "teacher"), "--data_dir", str(tmp / "lol"),
                  "--val_dir", str(tmp / "lol"), "--variant", "tiny", "--image_size", "32",
                  "--epochs", "1", "--batch_size", "2", "--regression",
                  "--teacher_steps", "2", "--gt_weight", "0.3", "--device", "cpu",
                  "--output_dir", str(tmp / "dout"), "--checkpoint_dir", str(tmp / "dck")])
    assert (tmp / "dck" / "student_final" / "student_timesteps.json").is_file()
    assert "cv_diffusion_tpu_torch.models.distillation" in sys.modules

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
    r"|cv2|PIL|safetensors|sklearn)\b"
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
    ("split_skip", True), ("use_linear_attention", False)])
def test_unported_paths_raise(field, value):
    from cv_diffusion_tpu_torch.config import diffusion_config
    from cv_diffusion_tpu_torch.models.diffusion import create_model

    cfg = diffusion_config("tiny", 32, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(cfg, device="cpu")


@pytest.mark.parametrize("field,value", [("remat", True), ("dtype", "bfloat16"),
                                         ("act_quant", True), ("act_quant", "fake")])
def test_ported_paths_build(field, value):
    """bf16 compute, remat and int8 / fake-quant activation compute, refused
    before they were ported, build."""
    from cv_diffusion_tpu_torch.config import diffusion_config
    from cv_diffusion_tpu_torch.models.diffusion import create_model

    model, _ = create_model(diffusion_config("tiny", 32, **{field: value}),
                            device="cpu")
    assert getattr(model.config.unet, field) == value
