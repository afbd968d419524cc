"""The port's ``split_skip`` decoder rewrite against the JAX package's, on
the CPU.

``concat_group_norm_parts`` against JAX's and against GroupNorm of the
concatenation; the IRB's ``skip_input`` under each of JAX's conditions
(``cv_diffusion_tpu/models/blocks.py:177-185``): split at stride 1 with a
concatenation wider than the output, and concatenated with ``act_quant``,
``use_pallas_irb``, ``fold_gn``, at stride 2 and where the concatenation is
as wide as the output, each against flax's block with its ``skip_input``;
and the tiny UNet at 32² with ``split_skip`` against JAX's ``split_skip``
UNet and against the port's own concat UNet, forward and gradients. The
group statistics of two parts sum in another order than the
concatenation's, so float64 is held at 1e-9 and float32 at the UNet's 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.models import blocks as jblocks
from cv_diffusion_tpu.models.unet import EfficientUNet
from cv_diffusion_tpu.ops import norms as jnorms
from cv_diffusion_tpu.ops import qconv as jqconv
from cv_diffusion_tpu_torch.config import diffusion_config
from cv_diffusion_tpu_torch.models import blocks as tblocks
from cv_diffusion_tpu_torch.models.diffusion import LowLightDiffusion
from cv_diffusion_tpu_torch.ops.norms import concat_group_norm_parts, group_norm
from cv_diffusion_tpu_torch import weights as tweights
from cv_diffusion_tpu_torch.weights import _from_jax, _irb_entries, init_weights

from test_torch_port_training import _Np64
from test_torch_port_weights import (jax_in_float64, nchw, nhwc,  # noqa: F401
                                     one_torch_thread, port_model,
                                     random_jax_params)

TEMB = 16


def _parts(shape_u, shape_s, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_u).astype(dtype) * 2 + 0.5,
            rng.standard_normal(shape_s).astype(dtype) - 0.3)


@pytest.mark.parametrize("cu,cs,groups", [(192, 128, 32), (24, 8, 16), (5, 3, 4)])
def test_concat_group_norm_parts(cu, cs, groups, monkeypatch):
    """Against JAX's ``concat_group_norm_parts`` (NHWC) in float64 at 1e-9
    and against the port's GroupNorm of the concatenation (float64 1e-9,
    float32 1e-5); groups straddle the boundary (small's 320-channel level:
    group size 10 over 192 + 128)."""
    u, s = _parts((2, cu, 6, 5), (2, cs, 6, 5), cu)
    rng = np.random.default_rng(1)
    w, b = (rng.standard_normal(cu + cs) for _ in range(2))
    tu, ts, tw, tb = map(torch.from_numpy, (u, s, w, b))
    got = concat_group_norm_parts(tu, ts, tw, tb, groups)
    with jax_in_float64(monkeypatch):
        ref = jnorms.concat_group_norm_parts(
            *(jnp.asarray(x.transpose(0, 2, 3, 1)) for x in (u, s)),
            jnp.asarray(w), jnp.asarray(b), groups)
    cat = group_norm(torch.cat([tu, ts], 1), tw, tb, groups)
    for part, want, lo, hi in zip(got, ref, (0, cu), (cu, cu + cs)):
        assert part.dtype == torch.float64
        np.testing.assert_allclose(nhwc(part), np.asarray(want), atol=1e-9, rtol=0)
        np.testing.assert_allclose(part.numpy(), cat[:, lo:hi].numpy(), atol=1e-9,
                                   rtol=0)
    got32 = concat_group_norm_parts(tu.float(), ts.float(), tw.float(), tb.float(),
                                    groups)
    assert got32[0].dtype == torch.float32
    np.testing.assert_allclose(torch.cat(got32, 1).numpy(), cat.numpy(), atol=1e-5,
                               rtol=0)


# (name, cu, cs, cout, block kwargs, train, splits): JAX's split_ok
CONDITIONS = [
    ("split", 24, 16, 16, {}, False, True),
    ("split_in_training", 24, 16, 16, {}, True, True),
    ("act_quant", 24, 16, 16, dict(act_quant="fake"), False, False),
    ("use_pallas_irb", 24, 16, 16, dict(use_pallas_irb=True), True, False),
    ("fold_gn", 24, 16, 16, dict(fold_gn=True), False, False),
    ("stride_2", 24, 16, 16, dict(stride=2), False, False),
    ("as_wide_as_the_output", 24, 16, 40, {}, False, False),
]


@pytest.mark.parametrize("name,cu,cs,cout,kwargs,train,splits", CONDITIONS,
                         ids=[c[0] for c in CONDITIONS])
def test_irb_skip_input_matches_flax(name, cu, cs, cout, kwargs, train, splits,
                                     monkeypatch):
    """The IRB given ``skip_input`` against flax's block given the same,
    float64 on both sides at 1e-9: split where JAX splits, concatenated
    where it does not (``use_pallas_irb`` in training, where JAX's block runs
    its unfused path too), with one parameter set for both routes."""
    u, s = _parts((2, 8, 8, cu), (2, 8, 8, cs), 3)
    temb = np.random.default_rng(4).standard_normal((2, TEMB))
    block_j = jblocks.InvertedResidualBlock(out_channels=cout, expansion_ratio=2,
                                            dtype=jnp.float64, **kwargs)
    with jax_in_float64(monkeypatch, extra=(jqconv,)):
        params = block_j.init(jax.random.key(0), jnp.asarray(u), jnp.asarray(temb),
                              False, jnp.asarray(s))["params"]
        rng = np.random.default_rng(5)
        params = jax.tree.map(
            lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape), params)
        ref = block_j.apply({"params": params}, jnp.asarray(u), jnp.asarray(temb),
                            train, jnp.asarray(s))
    block = tblocks.InvertedResidualBlock(cu + cs, cout, TEMB, expansion_ratio=2,
                                          **kwargs).double()
    with monkeypatch.context() as patch:   # keep the converter's float64
        patch.setattr(tweights, "np", _Np64())
        sd = _from_jax(params, _irb_entries("b", ()))
    block.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    block.train(train)
    assert block.splits(cu + cs) is splits
    formed = []   # the shapes of every 4-D concatenation the block forms
    cat = torch.cat

    def counted(*args, **kwargs):
        out = cat(*args, **kwargs)
        if out.dim() == 4:
            formed.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "cat", counted)
    with torch.no_grad():
        got = block(nchw(u), torch.from_numpy(temb), skip_input=nchw(s))
    monkeypatch.undo()
    assert formed == ([] if splits else [(2, cu + cs, 8, 8)])
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-9, rtol=0)


def _unet(float64, split):
    """(port, flax) outputs of the tiny UNet at 32² (JAX with
    ``split_skip=split``), and the port's model."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=5, split_skip=split)
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
    return got, np.asarray(ref), model, x, t


@pytest.mark.parametrize("float64", [True, False])
def test_unet_matches_jax_split_skip(float64, monkeypatch):
    """The port's ``split_skip`` UNet against JAX's on the same weights:
    float64 at 1e-9, float32 at 1e-3; and against the port's own concat UNet
    on them."""
    if float64:
        with jax_in_float64(monkeypatch):
            got, ref, model, x, t = _unet(True, True)
        tol = 1e-9
    else:
        got, ref, model, x, t = _unet(False, True)
        tol = 1e-3
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    concat = LowLightDiffusion(dataclasses.replace(
        model.config, unet=dataclasses.replace(model.config.unet, split_skip=False)))
    concat.load_state_dict(model.state_dict(), strict=True)
    concat.to(next(model.parameters()).dtype).eval()
    dt = np.float64 if float64 else np.float32
    with torch.no_grad():
        want = nhwc(concat.unet(nchw(x.astype(dt)), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_split_unet_gradients_equal_the_concat_unet():
    """One backward of the tiny UNet with and without ``split_skip`` on the
    same weights and input (the split path runs in training, as JAX's),
    float64: every parameter's gradient at 1e-9, the decoder's first IRBs
    split (no concatenation formed) and their gradients not zero."""
    cfg = diffusion_config("tiny", 32)
    weights = init_weights(cfg, seed=2, device="cpu")
    models = []
    for split in (False, True):
        m = LowLightDiffusion(dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, split_skip=split)))
        m.load_state_dict(weights, strict=True)
        models.append(m.double().train())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 32, 32)))
    t = torch.tensor([20, 600])
    for m in models:
        m.unet(x, t).square().mean().backward()
    grads = [{k: p.grad for k, p in m.named_parameters()} for m in models]
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(), atol=1e-9,
                                   rtol=0, err_msg=name)
    first = models[1].unet.decoder_blocks[0][0]
    assert first.splits(first.norm1.weight.numel())
    assert float(first.expand.weight.grad.abs().max()) > 0
