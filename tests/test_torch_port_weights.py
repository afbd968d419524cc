"""Weights carried from the JAX package into the port, and the port's
blocks and UNet against flax ``apply`` on them (atol/rtol 1e-4, as
``tests/test_unet.py``).

The JAX params are random numpy values in the shapes of the JAX model
(every leaf perturbed, GroupNorm scales and biases included), so a key that
lands on the wrong tensor shows.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.config import diffusion_config as jax_diffusion_config
from cv_diffusion_tpu.models import blocks as jblocks
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.unet import EfficientUNet
from cv_diffusion_tpu.utils.torch_compat import export_unet_state_dict
from cv_diffusion_tpu_torch.config import diffusion_config
from cv_diffusion_tpu_torch.models import blocks as tblocks
from cv_diffusion_tpu_torch.models.diffusion import LowLightDiffusion
from cv_diffusion_tpu_torch.models.unet import count_params
from cv_diffusion_tpu_torch.weights import (init_weights, state_dict_from_jax,
                                            unet_state_dict_from_jax)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process: the suite runs in several
    pytest-xdist workers on the machine's cores, and torch's OpenMP threads
    (one per core in every worker) would spin against each other and the
    JAX tests. The port's test files import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_jax_params(variant, size, seed=0, perturb_norms=True, **overrides):
    """(jax config, port config, params): random numpy params in the shapes
    of the JAX ``LowLightDiffusion`` (shapes from tracing, no init run).
    Kernels are LeCun normal; 1-D leaves (biases, GroupNorm scales) are
    perturbed by N(0, 0.1²) around flax's init values, or left at those
    values (0 and 1) without ``perturb_norms``."""
    jcfg = jax_diffusion_config(variant, size, prediction_type="v_prediction",
                                **overrides)
    model, _ = jax_create_model(jcfg)
    z = jnp.zeros((1, size, size, 3))
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.key(0)}, z, z,
                           jnp.zeros((1,), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1])
        if len(leaf.shape) > 1:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = np.full(leaf.shape, 1.0 if "scale" in name else 0.0)
        if perturb_norms:
            base = base + 0.1 * rng.standard_normal(leaf.shape)
        return base.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    tcfg = diffusion_config(variant, size, prediction_type="v_prediction",
                            **overrides)
    return jcfg, tcfg, params


def port_model(tcfg, params):
    model = LowLightDiffusion(tcfg).eval()
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return model


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def load_block(block, state_dict, prefix):
    sub = {k[len(prefix) + 1:]: v for k, v in state_dict.items()
           if k.startswith(prefix + ".")}
    block.load_state_dict(sub, strict=True)
    return block.eval()


@pytest.mark.parametrize("variant", ["tiny", "small"])
def test_converter_equals_export_unet_state_dict(variant):
    jcfg, tcfg, params = random_jax_params(variant, 32)
    ref = export_unet_state_dict(params["unet"], jcfg.unet)
    got = unet_state_dict_from_jax(params["unet"], tcfg.unet)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    full = state_dict_from_jax(params, tcfg)
    assert set(full) == {f"unet.{k}" for k in ref}
    LowLightDiffusion(tcfg).load_state_dict(full, strict=True)


def test_small_has_the_reference_param_count():
    with torch.device("meta"):
        model = LowLightDiffusion(diffusion_config("small", 256))
    assert count_params(model.unet) == 18_008_035


def test_init_weights_seeded_and_loadable():
    tcfg = diffusion_config("tiny", 32)
    a = init_weights(tcfg, seed=3, device="cpu")
    b = init_weights(tcfg, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["unet.init_conv.weight"],
                           init_weights(tcfg, seed=4, device="cpu")["unet.init_conv.weight"])
    LowLightDiffusion(tcfg).load_state_dict(a, strict=True)


@pytest.mark.parametrize("prefix,flax_name,cin,cout", [
    ("mid_block1", "mid_block1", 128, 128),            # identity residual
    ("encoder_blocks.1.0", "enc_1_0", 16, 32),         # 1×1 skip residual
])
def test_irb_matches_flax(prefix, flax_name, cin, cout):
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=1)
    sd = state_dict_from_jax(params, tcfg)
    u = jcfg.unet
    block = load_block(tblocks.InvertedResidualBlock(
        cin, cout, u.time_embed_dim, expansion_ratio=u.expansion_ratio),
        sd, f"unet.{prefix}")
    assert (block.skip is not None) == (cin != cout)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    temb = rng.standard_normal((2, u.time_embed_dim)).astype(np.float32)
    ref = jblocks.InvertedResidualBlock(
        out_channels=cout, expansion_ratio=u.expansion_ratio).apply(
        {"params": params["unet"][flax_name]}, jnp.asarray(x), jnp.asarray(temb))
    with torch.no_grad():
        got = block(nchw(x), torch.from_numpy(temb))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def _attention_case(prefix, flax_name, channels, size, float64):
    """(port block, flax result, input) for one attention block of tiny@32;
    flax in float64 when asked (see ``flax_in_float64``)."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=3)
    sd = state_dict_from_jax(params, tcfg)
    u = jcfg.unet
    block = load_block(tblocks.LinearAttentionBlock(
        channels, u.num_attention_heads, u.attention_head_dim),
        sd, f"unet.{prefix}")
    dt = np.float64 if float64 else np.float32
    x = np.random.default_rng(4).standard_normal(
        (2, size, size, channels)).astype(dt)
    ref = jblocks.LinearAttentionBlock(
        num_heads=u.num_attention_heads, dim_head=u.attention_head_dim,
        dtype=dt).apply(
        {"params": jax.tree.map(lambda a: jnp.asarray(a, dt),
                                params["unet"][flax_name])}, jnp.asarray(x))
    return block, np.asarray(ref), x


@pytest.mark.parametrize("prefix,flax_name,channels,size", [
    ("mid_attn", "mid_attn", 128, 4),
    ("encoder_blocks.2.1", "enc_attn_2_0", 64, 8),
])
def test_linear_attention_block_matches_flax(prefix, flax_name, channels, size):
    block, ref, x = _attention_case(prefix, flax_name, channels, size,
                                    float64=False)
    with torch.no_grad():
        got = block(nchw(x))
    np.testing.assert_allclose(nhwc(got), ref, **TOL)


def test_linear_attention_block_math_matches_flax_in_float64(flax_in_float64):
    """Over 16×16 tokens of N(0, 1) input the block is ill-conditioned in
    float32 (flax's own float32 result is 3.3e-4 from float64: the attention
    output is close to the mean of v and out_norm divides by a small
    spread). Both sides in float64 agree to rounding."""
    block, ref, x = _attention_case("encoder_blocks.1.1", "enc_attn_1_0", 32,
                                    16, float64=True)
    with torch.no_grad():
        got = nhwc(block.double()(nchw(x).double()))
    np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)


@contextlib.contextmanager
def jax_in_float64(monkeypatch, extra=()):
    """Run the JAX package in float64: x64 on, and its hard-wired float32
    statistics and casts (``jnp.float32`` in ops/norms, ops/attention,
    models/blocks, ops/qconv, and the modules in ``extra``) made float64
    inside the block."""
    from cv_diffusion_tpu.ops import attention, norms, qconv

    class _Jnp64:
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    with monkeypatch.context() as patch, jax.enable_x64(True):
        for module in (norms, attention, jblocks, qconv) + tuple(extra):
            patch.setattr(module, "jnp", _Jnp64())
        yield


@pytest.fixture
def flax_in_float64(monkeypatch):
    """The JAX package in float64 for the duration of the test."""
    with jax_in_float64(monkeypatch):
        yield


def _unet_outputs(variant, perturb_norms, float64=False):
    """(port, flax) UNet outputs, NHWC, on one random input at 32²; in
    float32, or in float64 on both sides."""
    jcfg, tcfg, params = random_jax_params(variant, 32, seed=5,
                                           perturb_norms=perturb_norms)
    model = port_model(tcfg, params)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 6))
    t = np.asarray([10, 900], dtype=np.int32)
    ucfg, dt = jcfg.unet, np.float32
    if float64:
        ucfg, dt = dataclasses.replace(ucfg, dtype="float64"), np.float64
        model.double()
    ref = jax.jit(EfficientUNet(ucfg).apply)(
        {"params": jax.tree.map(lambda a: jnp.asarray(a, dt), params["unet"])},
        jnp.asarray(x, dt), jnp.asarray(t))
    with torch.no_grad():
        got = nhwc(model.unet(nchw(x.astype(dt)), torch.from_numpy(t)))
    return got, np.asarray(ref), model


@pytest.mark.parametrize("variant", ["tiny", "small"])
def test_unet_math_matches_flax_in_float64(variant, flax_in_float64):
    """Every bias and GroupNorm scale perturbed; both sides in float64 agree
    to rounding, so the port computes the JAX package's function."""
    got, ref, _ = _unet_outputs(variant, perturb_norms=True, float64=True)
    np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)


@pytest.mark.parametrize("variant", ["tiny", "small"])
def test_unet_forward_matches_flax(variant, monkeypatch):
    """float32 on both sides, flax-init statistics (zero biases, unit
    GroupNorm scales), as ``tests/test_unet.py`` uses. Measured against
    flax's own float64 evaluation of the same weights and input, flax's
    float32 result is off by up to 7.2e-4 on small and the port's by
    1.8e-4, so the two are held at 1e-3 and the port to no larger an error
    than flax's."""
    got, ref, _ = _unet_outputs(variant, perturb_norms=False)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-4)
    with jax_in_float64(monkeypatch):
        _, exact, _ = _unet_outputs(variant, perturb_norms=False, float64=True)
    assert np.abs(got - exact).max() <= np.abs(ref - exact).max()
