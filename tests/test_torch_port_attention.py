"""The port's linear attention against the JAX package's.

The plain version (the kernel's CPU branch) is held against
``linear_attention_xla`` and against the Pallas kernel in interpret mode, at
the shapes and tolerances of ``tests/test_pallas_kernels.py``: atol 2e-5 in
float32, 2e-2 in bfloat16. The plain backward, and the autograd function's
CPU backward, are held against the gradients of JAX's
``linear_attention_pallas_trainable`` in interpret mode at that file's
gradient shapes and atol 5e-4, and checked by ``gradcheck`` in float64. The
CUDA kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cv_diffusion_tpu.ops.pallas_attention as pa
from cv_diffusion_tpu.ops.attention import linear_attention_xla
from cv_diffusion_tpu_torch.config import load_model_config
from cv_diffusion_tpu_torch.models.blocks import LinearAttention
from cv_diffusion_tpu_torch.models.diffusion import create_model
from cv_diffusion_tpu_torch.ops import cuda_build
from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
from cv_diffusion_tpu_torch.ops.attention import (
    linear_attention, linear_attention_backward_plain, linear_attention_plain)

from test_torch_port_weights import one_torch_thread  # noqa: F401

SHAPES = [(2, 256, 4, 32), (1, 1000, 4, 32), (2, 64, 2, 32), (1, 128, 1, 128),
          (1, 128, 6, 32), (1, 192, 8, 32)]


@pytest.fixture
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pa.pl, "pallas_call", patched)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla(shape):
    q, k, v = _qkv(shape, 0)
    ref = np.asarray(linear_attention_xla(*map(jnp.asarray, (q, k, v))))
    out = linear_attention_plain(*map(torch.from_numpy, (q, k, v)))
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, _interpret_mode):
    q, k, v = _qkv(shape, 1)
    ref = np.asarray(pa.linear_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                                tile_n=256))
    out = linear_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_plain_bf16_matches_pallas_interpret(_interpret_mode):
    q, k, v = _qkv((1, 256, 4, 32), 2)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = pa.linear_attention_pallas(jq, jk, jv, tile_n=256)
    # identical bf16 inputs on both sides
    tq, tk, tv = (torch.from_numpy(np.asarray(x, dtype=np.float32))
                  .to(torch.bfloat16) for x in (jq, jk, jv))
    out = linear_attention_plain(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32), atol=2e-2)


@pytest.mark.parametrize("shape", [(2, 256, 4, 32), (1, 1000, 4, 32)])
def test_kernel_wrapper_cpu_branch_is_the_plain_version(shape):
    q, k, v = map(torch.from_numpy, _qkv(shape, 3))
    before = lak.linear_attention_kernel.launches
    out = lak.linear_attention_kernel(q, k, v)
    assert torch.equal(out, linear_attention_plain(q, k, v))
    assert torch.equal(linear_attention(q, k, v), out)
    # the CPU branch launches nothing
    assert lak.linear_attention_kernel.launches == before


@pytest.mark.parametrize("b,n,h", [(1, 1024, 4), (8, 1024, 4), (1, 1000, 4),
                                   (1, 1, 1), (2, 64, 2), (64, 4096, 8)])
def test_reduce_chunks_cover_every_token(b, n, h):
    s, chunk = lak.reduce_chunks(b, n, h)
    assert s >= 1 and chunk >= 1
    assert s * chunk >= n > (s - 1) * chunk      # no chunk is empty
    assert lak.reduce_chunks(b, n, h) == (s, chunk)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "CUDA_ROOTS", ())
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lak.build()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_attention_goes_through_the_kernel_wrapper(monkeypatch,
                                                         use_pallas):
    """``use_pallas`` is read from artifact files and ignored: every attention
    block of a model built from an artifact's config calls the kernel's
    wrapper, so on the card the model cannot reach the plain version."""
    art = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts",
                       "vreg1b_gt03_ema", "model_config.json")
    cfg = load_model_config(art, variant="tiny", image_size=32)
    cfg = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_pallas=use_pallas))
    model, _ = create_model(cfg, device="cpu")
    calls = []
    wrapper = lak.linear_attention_kernel

    def spy(q, k, v, eps=1e-6):
        calls.append(tuple(q.shape))
        return wrapper(q, k, v, eps)

    monkeypatch.setattr(lak, "linear_attention_kernel", spy)
    blocks = [m for m in model.modules() if isinstance(m, LinearAttention)]
    x = torch.zeros(1, cfg.unet.in_channels, 32, 32)
    with torch.no_grad():
        model.unet(x, torch.tensor([739], dtype=torch.int32))
    assert blocks and len(calls) == len(blocks)


GRAD_SHAPES = [(2, 256, 4, 32), (1, 100, 2, 32), (1, 128, 6, 32)]


def _jax_trainable_grads(q, k, v, ct):
    def loss(q, k, v):
        return jnp.sum(pa.linear_attention_pallas_trainable(q, k, v) * ct)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_backward_plain_matches_jax_trainable(shape, _interpret_mode):
    """The closed form against JAX's custom VJP (``_trainable_bwd``)."""
    q, k, v = _qkv(shape, 4)
    ct = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    ref = _jax_trainable_grads(q, k, v, ct)
    got = linear_attention_backward_plain(
        *map(torch.from_numpy, (q, k, v, ct)))
    for g, r, name in zip(got, ref, "qkv"):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, atol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_function_cpu_backward_matches_jax_trainable(shape, _interpret_mode):
    """What the model's attention gives autograd on the CPU: the plain
    versions in both directions, no launch."""
    q, k, v = _qkv(shape, 6)
    ct = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    ref = _jax_trainable_grads(q, k, v, ct)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (lak.linear_attention_kernel.launches,
              lak.linear_attention_backward_kernel.launches)
    out = linear_attention(tq, tk, tv)
    (out * torch.from_numpy(ct)).sum().backward()
    assert (lak.linear_attention_kernel.launches,
            lak.linear_attention_backward_kernel.launches) == before
    for t, r, name in zip((tq, tk, tv), ref, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=5e-4,
                                   err_msg=f"d{name}")


def test_function_gradcheck_float64():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 37, 3, 8)))
               .requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: lak.linear_attention_trainable(a, b, c), (q, k, v))


def test_backward_plain_is_autograd_of_the_plain_forward_in_float64():
    rng = np.random.default_rng(9)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, 64, 2, 32)) * 3)
                  for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(linear_attention_plain(q, k, v), (q, k, v), g)
    got = linear_attention_backward_plain(q.detach(), k.detach(), v.detach(), g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("shape", [(1, 64, 2, 32), (1, 10, 1, 32)])
def test_backward_wrapper_cpu_branch_is_the_plain_version(shape):
    q, k, v, g = (torch.from_numpy(x) for x in _qkv(shape, 10) + _qkv(shape, 11)[:1])
    before = lak.linear_attention_backward_kernel.launches
    got = lak.linear_attention_backward_kernel(q, k, v, g)
    ref = linear_attention_backward_plain(q, k, v, g)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert lak.linear_attention_backward_kernel.launches == before


def test_backward_kernel_checks_its_inputs():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="one shape"):
        lak._check(q, q, q, torch.zeros(1, 8, 1, 64))
    with pytest.raises(TypeError, match="float32 or all"):
        lak._check(q, q, q, q.double())
    with pytest.raises(ValueError, match="head dim"):
        lak._check(*(torch.zeros(1, 8, 1, 16),) * 4)
