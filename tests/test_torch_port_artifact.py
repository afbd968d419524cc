"""The committed 1-step student in the port's own format, and the JAX
reference numbers that the card's evaluation is held to.

- ``artifacts_torch/vreg1b_gt03_ema.npz`` read by ``load_state_dict_npz``
  equals, tensor for tensor and bit for bit, ``state_dict_from_jax`` of the
  orbax artifact; a corrupted byte plane fails its SHA-256 check; the file
  stays under 62.0 MB and the tree that git would commit under 266 MB (the
  card's copy of a checkout holds 256 MiB).
- ``ServingPipeline.from_artifact`` serves a request as ``from_config`` on
  the orbax-converted weights does, and refuses an artifact whose weights
  are not in the tree.
- The evaluation's inputs and noise hash to the reference JSON's SHA-256s,
  and image 0 recomputed at 256² on the CPU: JAX within 0.01 dB of its
  recorded PSNR, the port within 0.1 dB (the parity gate), both within
  1 LSB of the committed uint8 output.
"""

import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from cv_diffusion_tpu.config import from_dict as jax_from_dict
from cv_diffusion_tpu.data.augment import normalize as jax_normalize
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.diffusion import denormalize_image
from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
from cv_diffusion_tpu.training import checkpoint as ckpt
from cv_diffusion_tpu.training import metrics as jm
from cv_diffusion_tpu_torch import evaluate as ev
from cv_diffusion_tpu_torch.config import load_model_config
from cv_diffusion_tpu_torch.export.serving import ServingPipeline
from cv_diffusion_tpu_torch.models.diffusion import LowLightDiffusion
from cv_diffusion_tpu_torch.weights import (load_state_dict_npz,
                                            save_state_dict_npz,
                                            state_dict_from_jax)

from test_torch_port_weights import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "vreg1b_gt03_ema"
STUDENT = os.path.join(REPO, "artifacts", NAME)
NPZ = os.path.join(REPO, "artifacts_torch", f"{NAME}.npz")
REF = os.path.join(REPO, "artifacts_torch", f"{NAME}.eval_ref.json")
REF_U8 = os.path.join(REPO, "artifacts_torch", f"{NAME}.eval_ref_u8.npz")
NPZ_MAX_BYTES = 62_000_000
TREE_MAX_BYTES = 266_000_000


@pytest.fixture(scope="module")
def orbax_state_dict():
    params = ckpt.load_inference_params(STUDENT, verbose=False)
    cfg = load_model_config(os.path.join(STUDENT, "model_config.json"))
    return state_dict_from_jax(params, cfg)


@pytest.fixture(scope="module")
def reference():
    with open(REF) as f:
        return json.load(f)


def test_npz_is_the_orbax_artifact_bit_for_bit(orbax_state_dict):
    sd = load_state_dict_npz(NPZ, device="cpu")
    assert list(sd) == list(orbax_state_dict)
    for k, t in orbax_state_dict.items():
        assert sd[k].dtype == torch.float32 and sd[k].device.type == "cpu"
        assert torch.equal(sd[k], t), k
    model = LowLightDiffusion(load_model_config(
        os.path.join(STUDENT, "model_config.json")))
    model.load_state_dict(sd, strict=True)
    assert os.path.getsize(NPZ) <= NPZ_MAX_BYTES
    with np.load(NPZ, allow_pickle=False) as z:
        assert z["source"].tobytes().decode() == NAME


def test_npz_sha256_check_refuses_a_corrupted_plane(tmp_path):
    gen = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(4, 3, 3, 3, generator=gen),
          "a.bias": torch.randn(4, generator=gen)}
    path = str(tmp_path / "w.npz")
    save_state_dict_npz(sd, path, "test")
    back = load_state_dict_npz(path, device="cpu")
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["plane2"][5] ^= 1            # one bit of one weight's mantissa
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **arrays)
    with pytest.raises(ValueError, match="SHA-256"):
        load_state_dict_npz(bad, device="cpu")


def test_from_artifact_serves_the_student(orbax_state_dict):
    pipe = ServingPipeline.from_artifact(NAME, device="cpu")
    ref = ServingPipeline.from_config(
        os.path.join(STUDENT, "model_config.json"),
        os.path.join(STUDENT, "student_timesteps.json"), orbax_state_dict,
        device="cpu")
    assert pipe.config.timesteps == (739,)
    img = np.random.default_rng(4).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    out = pipe(img, seed=0)
    assert out.shape == img.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref(img, seed=0))
    with pytest.raises(FileNotFoundError, match="ROADMAP queue 1 item 1"):
        ServingPipeline.from_artifact("vreg2b_gt03_ema", device="cpu")


def test_eval_inputs_hash_to_the_reference(reference):
    low, high = ev.eval_split(reference["n"], reference["size"], reference["seed"])
    init, step = ev.eval_noise(reference["n"], reference["size"], reference["seed"],
                               len(reference["timesteps"]))
    assert init.shape == (15, 256, 256, 3) and step.shape == (1, 15, 256, 256, 3)
    assert not step.any()       # a 1-step grid's last step adds no noise
    for h, im in zip(ev.input_hashes(low, high, init), reference["images"]):
        assert (h["low"], h["high"], h["noise"]) == (
            im["low_sha256"], im["high_sha256"], im["noise_sha256"])
    assert reference["noise"] == ev.NOISE_RECIPE


def test_image0_recomputed_by_jax_and_the_port(reference, orbax_state_dict):
    """Image 0 of the reference, at 256² on the CPU: JAX's sampler and
    metrics as ``scripts/evaluate.py`` runs them, and the port's
    ``evaluate`` functions on the port's model."""
    low, high = ev.eval_split(reference["n"], reference["size"], reference["seed"])
    init, step = ev.eval_noise(reference["n"], reference["size"], reference["seed"], 1)
    low, high, init, step = low[:1], high[:1], init[:1], step[:, :1]
    want = reference["images"][0]
    with np.load(REF_U8, allow_pickle=False) as z:
        want_u8 = z["pred_u8"][0]

    with open(os.path.join(STUDENT, "model_config.json")) as f:
        jcfg = jax_from_dict(JaxDiffusionConfig, json.load(f))
    jmodel, jschedule = jax_create_model(jcfg)
    out = jax_enhance(jmodel, jschedule,
                      {"params": ckpt.load_inference_params(STUDENT, verbose=False)},
                      jax.random.key(0), jnp.asarray(jax_normalize(low)),
                      init_noise=jnp.asarray(init), step_noise=jnp.asarray(step),
                      timesteps=reference["timesteps"])
    pred = jnp.clip(denormalize_image(out), 0.0, 1.0)
    tgt = denormalize_image(jnp.asarray(jax_normalize(high)))
    assert abs(float(jm.psnr(pred, tgt)) - want["psnr"]) <= 0.01
    jax_u8 = np.asarray(jnp.clip(pred * 255.0, 0, 255).astype(jnp.uint8))[0]
    assert np.abs(jax_u8.astype(int) - want_u8.astype(int)).max() <= 1

    model = LowLightDiffusion(load_model_config(
        os.path.join(STUDENT, "model_config.json"))).eval()
    model.load_state_dict(orbax_state_dict, strict=True)
    from cv_diffusion_tpu_torch.models.scheduler import make_schedule
    got = ev.enhance_split(model, make_schedule(model.config.scheduler), low, init,
                           step, reference["timesteps"], device="cpu")
    per = ev.per_image_metrics(got, ev.target_unit(high, "cpu"))
    assert abs(per["psnr"][0] - want["psnr"]) <= 0.1
    for k, tol in (("ssim", 2e-3), ("mae", 1e-3), ("ms_ssim", 2e-3), ("gmsd", 2e-3)):
        assert abs(per[k][0] - want[k]) <= tol, k
    port_u8 = ev.to_u8(got)[0]
    assert np.abs(port_u8.astype(int) - want_u8.astype(int)).max() <= 1


def _committed_files():
    """What ``git add -A`` would commit: tracked and untracked files that
    ``.gitignore`` does not list, as they are on disk."""
    out = subprocess.run(
        ["git", "ls-files", "-z", "--cached", "--others", "--exclude-standard"],
        cwd=REPO, capture_output=True, check=True).stdout
    return [os.path.join(REPO, p) for p in out.decode().split("\0") if p]


@pytest.mark.skipif(shutil.which("git") is None
                    or not os.path.isdir(os.path.join(REPO, ".git")),
                    reason="needs git and the repository's .git")
def test_committed_tree_fits_the_card_copy():
    files = {p for p in _committed_files() if os.path.isfile(p)}
    total = sum(os.path.getsize(p) for p in files)
    assert NPZ in files
    assert total <= TREE_MAX_BYTES, f"{total} bytes in the tree"
