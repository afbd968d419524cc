"""The port's quality metrics and synthetic split against the JAX package's.

- ``cv_diffusion_tpu_torch.training.metrics`` against
  ``cv_diffusion_tpu.training.metrics`` on numpy-seeded images: PSNR, SSIM,
  MAE and GMSD at 32², 192² and 256², MS-SSIM (five scales) at 192² and
  256², on a noisy pair and on identical inputs (PSNR's 1e-12 floor, SSIM
  1, GMSD 0): within 1e-5, absolute, relative for PSNR; and non-square,
  colour-distinct images, where metrics taken over the wrong axes differ.
- ``data/synthetic.py``: Pillow's bilinear resize reproduced bit for bit,
  and ``make_split(15, 256, 77)`` against ``scripts/make_synthetic_dataset.py``'s
  ``generate_scene`` / ``synthetic_low_light`` sequence (the validation
  split), bit for bit.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cv_diffusion_tpu.data.augment import synthetic_low_light
from cv_diffusion_tpu.training import metrics as jm
from cv_diffusion_tpu_torch.data.synthetic import make_split, resize_bilinear_u8
from cv_diffusion_tpu_torch.training import metrics as tm

from test_torch_port_weights import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
METRICS = ("psnr", "ssim", "mae", "gmsd", "ms_ssim")


def _pair(size, identical, seed=0, width=None):
    rng = np.random.default_rng(seed + size)
    a = rng.uniform(0, 1, (2, size, width or size, 3)).astype(np.float32)
    if identical:
        return a, a.copy()
    return a, np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)


def _both(name, a, b):
    j = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)))
    t = getattr(tm, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert t.dtype == torch.float32 and t.dim() == 0
    return j, float(t)


@pytest.mark.parametrize("identical", [False, True], ids=["noisy", "identical"])
@pytest.mark.parametrize("name,size", [
    (name, size) for name in METRICS for size in (32, 192, 256)
    if not (name == "ms_ssim" and size < 176)])
def test_metric_matches_jax(name, size, identical):
    j, t = _both(name, *_pair(size, identical))
    if name == "psnr":
        assert abs(t - j) <= TOL * abs(j), (t, j)
    else:
        assert abs(t - j) <= TOL, (t, j)
    if identical:
        want = {"psnr": 120.0, "ssim": 1.0, "mae": 0.0, "gmsd": 0.0, "ms_ssim": 1.0}
        assert t == pytest.approx(want[name], abs=1e-5)


@pytest.mark.parametrize("name", ["ssim", "gmsd", "ms_ssim"])
def test_metric_layout_is_nhwc(name):
    """On [B, H, W, C] with H ≠ W and different content per channel the port
    equals JAX; the same images' channels-first bytes read as [B, H, W, C]
    (a reshape where a permute belongs) give another value."""
    a, b = _pair(192, False, seed=5, width=208)
    a[..., 0] *= 0.3
    b[..., 2] = b[..., 2] ** 2
    j, t = _both(name, a, b)
    assert abs(t - j) <= TOL, (t, j)

    def misread(x):
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                                .reshape(x.shape))

    assert abs(float(getattr(tm, name)(misread(a), misread(b))) - t) > 1e-3


@pytest.mark.parametrize("src,dst", [
    ((4, 4), (256, 256)), ((15, 15), (256, 256)), ((7, 13), (64, 48)),
    ((256, 256), (100, 37)), ((50, 60), (50, 61)), ((5, 5), (9, 5))])
def test_resize_bilinear_matches_pillow(src, dst):
    img = np.random.default_rng(sum(src + dst)).integers(0, 256, src + (3,),
                                                        dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear_u8(img, *dst), want)


def test_make_split_matches_the_script():
    """make_split(15, 256, 77): the validation split of
    ``make_synthetic_dataset.py --seed 0`` (``write_split(..., 15, 256, 77,
    photo_fraction=0.0)``), generated here with the script's own functions
    and Pillow, bit for bit."""
    scripts = os.path.join(REPO, "scripts")
    sys.path.insert(0, scripts)
    try:
        import make_synthetic_dataset as script
    finally:
        # by value: the script puts the repository's root in front of it,
        # and a scripts/ left on the path shadows the standard library's
        # profile module (scripts/profile.py) for every later import
        sys.path.remove(scripts)
    low, high = make_split(15, 256, 77)
    rng = np.random.default_rng(77)
    highs = list(script._photo_crops(rng, 256, 0))
    while len(highs) < 15:
        highs.append(script.generate_scene(rng, 256))
    rng.shuffle(highs)
    lows = [synthetic_low_light(np.random.default_rng(77 * 1_000_003 + i), h)
            for i, h in enumerate(highs)]
    assert low.dtype == high.dtype == np.uint8
    assert low.shape == high.shape == (15, 256, 256, 3)
    np.testing.assert_array_equal(high, np.stack(highs))
    np.testing.assert_array_equal(low, np.stack(lows))
    assert len({h.tobytes() for h in high}) == 15


def test_make_split_refuses_photo_crops():
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        make_split(4, 64, 0, photo_fraction=0.25)
