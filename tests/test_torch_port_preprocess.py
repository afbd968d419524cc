"""The port's serving pre/post-processing (torch bilinear on the device)
against the JAX package's (``cv2.resize`` on the host): the letterbox
geometry is exact and the pixels agree within 1 LSB (OpenCV's fixed-point
bilinear weights round differently from float32 arithmetic)."""

import dataclasses

import numpy as np
import pytest
import torch

from cv_diffusion_tpu.export.preprocess import PostProcessor as JaxPost
from cv_diffusion_tpu.export.preprocess import PreProcessor as JaxPre
from cv_diffusion_tpu_torch.export.preprocess import PostProcessor, PreProcessor

from test_torch_port_weights import one_torch_thread  # noqa: F401

pytest.importorskip("cv2")

SIZES = [(400, 600), (480, 720), (720, 480), (97, 301), (256, 256),
         (512, 512), (300, 200), (1000, 37)]


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    # smooth content plus noise, so interpolation is exercised on both
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx[..., None] / 7.0 + yy[..., None] / 11.0
                              + np.arange(3))
    noisy = base + rng.normal(0, 20, (h, w, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("keep_aspect", [True, False])
@pytest.mark.parametrize("h,w", SIZES)
def test_pre_and_post_match_cv2(h, w, keep_aspect):
    img = _image(h, w, h * w)
    ref, ref_meta = JaxPre(256, keep_aspect, normalize=False)(img)
    got, meta = PreProcessor(256, keep_aspect, device="cpu")(img)
    assert dataclasses.asdict(meta) == dataclasses.asdict(ref_meta)
    assert got.shape == ref.shape == (1, 256, 256, 3)
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()
    if keep_aspect:   # the padding is exactly zero on both sides
        top, bottom, left, right = meta.pad
        inside = np.zeros((256, 256), bool)
        inside[top:256 - bottom, left:256 - right] = True
        assert not got.numpy()[0][~inside].any()

    out = _image(256, 256, 1)                     # a served canvas
    ref_out = JaxPost()(out[None], ref_meta)
    got_out = PostProcessor()(torch.from_numpy(out), meta)
    assert got_out.shape == ref_out.shape == img.shape
    assert got_out.dtype == np.uint8
    diff = np.abs(got_out.astype(int) - ref_out.astype(int))
    assert diff.max() <= 1, diff.max()


def test_rejects_non_rgb_uint8():
    with pytest.raises(ValueError):
        PreProcessor(256, device="cpu")(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError):
        PreProcessor(256, device="cpu")(np.zeros((8, 8), np.uint8))
