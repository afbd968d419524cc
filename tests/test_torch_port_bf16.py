"""The port's bfloat16 compute against the JAX package's, on the CPU.

Both sides compute in bf16 the way flax does (``UNetConfig.dtype``): float32
parameters cast at each use, every convolution and dense layer rounding its
output to bf16 and adding its bias in bf16, GroupNorm's statistics, the
sinusoid, the SE sigmoid and the bilinear resize in float32, the sampler's
scheduler arithmetic in float32. Inputs are made with numpy from a seed and
handed to both sides already rounded to bf16.

Two bf16 computations of the same function agree only to bf16's rounding:
XLA and PyTorch accumulate each product in float32 in their own orders, so
an output lands on the neighbouring bf16 value now and then (one unit in
the last place, ``ulp``: 2⁻⁸ of the value's binade), and the next layer
carries that on. The bounds below are stated per module in such units, or
against the module's output scale where a whole network carries them; each
was measured on these inputs and holds with room (the measured values are
in the tests' docstrings). For scale: the same bf16 module is typically
much further from its own float32 result than from JAX's bf16 one.
"""

import dataclasses
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cv_diffusion_tpu.config import TrainConfig as JaxTrainConfig
from cv_diffusion_tpu.models import blocks as jblocks
from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
from cv_diffusion_tpu.models.unet import EfficientUNet
from cv_diffusion_tpu.ops.norms import gn2_film_affine_gram as jax_gram
from cv_diffusion_tpu.ops.norms import group_norm as jax_group_norm
from cv_diffusion_tpu.training import train_state as jts
from cv_diffusion_tpu_torch.config import TrainConfig
from cv_diffusion_tpu_torch.models import blocks as tblocks
from cv_diffusion_tpu_torch.models.diffusion import (EnhanceOutput, enhance,
                                                     sample_timesteps_and_noise,
                                                     with_dtype)
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.ops.norms import gn2_film_affine_gram, group_norm
from cv_diffusion_tpu_torch.training import train_state as tts
from cv_diffusion_tpu_torch.weights import state_dict_from_jax, unet_entries

from test_torch_port_weights import one_torch_thread  # noqa: F401
from test_torch_port_weights import (load_block, nchw, nhwc, port_model,
                                     random_jax_params)

BF16 = jnp.bfloat16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even), as float32."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(BF16).astype(jnp.float32))


def ulps(got: np.ndarray, ref: np.ndarray, floor: float = 0.0) -> float:
    """The largest |got − ref| in units of bf16's spacing at each element's
    magnitude (the larger of the two's, and at least ``floor``: below it
    the float32 results' own rounding, not bf16's, sets the difference)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(ref)), floor)
    spacing = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float((np.abs(got - ref) / spacing).max())


def rel(got, ref) -> float:
    """max |got − ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# --- GroupNorm and the Gram fold ----------------------------------------------

@pytest.mark.parametrize("channels,groups,offset", [(64, 32, 0.0), (48, 16, 3.0)])
def test_group_norm_bf16_matches_jax(channels, groups, offset):
    """Statistics and affine in float32 over the bf16 input, the result cast
    back to bf16 (``ops/norms.py:40-67``): the same bf16 value, or its
    neighbour where the float32 results straddle a rounding boundary
    (≤ 1 ulp; measured 0 and 1). ``offset`` puts the mean far from 0, where
    E[x²] − E[x]² cancels: there the two float32 means differ by an ulp of
    3, which moves outputs near 0 by ~1e-7, many ulps of such small values,
    so the spacing is taken at 1/8 at least."""
    rng = np.random.default_rng(channels)
    x = bf16_values(rng.standard_normal((2, 8, 8, channels)) + offset)
    scale = (1 + 0.1 * rng.standard_normal(channels)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    ref = jax_group_norm(jnp.asarray(x, BF16), jnp.asarray(scale),
                         jnp.asarray(bias), groups)
    got = group_norm(nchw(x).to(torch.bfloat16), torch.from_numpy(scale),
                     torch.from_numpy(bias), groups)
    assert ref.dtype == BF16 and got.dtype == torch.bfloat16
    assert ulps(nhwc(got.float()), np.asarray(ref, np.float32), floor=0.125) <= 1


def test_gram_fold_on_bf16_input_matches_jax():
    """The fold of GN2 ⊕ FiLM from the Gram of a bf16 x̂ (``fold_gn`` in bf16:
    x̂ is GN1's bf16 output): both sides take the exact products of the bf16
    values in float32 (JAX ``ops/norms.py:150-209``, default precision,
    float32 accumulation); the affines are float32, held at the float32
    fold's 1e-5."""
    rng = np.random.default_rng(3)
    b, size, cin, chid, groups = 2, 8, 32, 128, 32
    xhat = bf16_values(np.clip(rng.standard_normal((b, size, size, cin)) + 0.5, 0, 6))
    wexp = (rng.standard_normal((cin, chid)) / np.sqrt(cin)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(chid)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(chid)).astype(np.float32)
    fs = bf16_values(0.2 * rng.standard_normal((b, chid)))
    fb = bf16_values(0.2 * rng.standard_normal((b, chid)))
    ra, rb = jax_gram(jnp.asarray(xhat, BF16), jnp.asarray(wexp), jnp.asarray(scale),
                      jnp.asarray(bias), jnp.asarray(fs, BF16), jnp.asarray(fb, BF16),
                      num_groups=groups)
    ga, gb = gn2_film_affine_gram(nchw(xhat).to(torch.bfloat16),
                                  torch.from_numpy(wexp).t(), torch.from_numpy(scale),
                                  torch.from_numpy(bias), _t(fs), _t(fb), groups)
    assert ga.dtype == torch.float32
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), atol=1e-5, rtol=0)


# --- blocks ---------------------------------------------------------------------

def _irb_case(prefix, flax_name, cin, cout, **flags):
    """(port block, flax block, its params, bf16 x, bf16 t_emb) for one IRB
    of tiny@32 in bf16 compute."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=1)
    sd = state_dict_from_jax(params, tcfg)
    u = jcfg.unet
    block = load_block(tblocks.InvertedResidualBlock(
        cin, cout, u.time_embed_dim, expansion_ratio=u.expansion_ratio, **flags),
        sd, f"unet.{prefix}")
    tblocks.set_compute_dtype(block, torch.bfloat16)
    flax = jblocks.InvertedResidualBlock(out_channels=cout,
                                         expansion_ratio=u.expansion_ratio,
                                         dtype=BF16, **flags)
    rng = np.random.default_rng(2)
    x = bf16_values(rng.standard_normal((2, 8, 8, cin)))
    temb = bf16_values(rng.standard_normal((2, u.time_embed_dim)))
    return block, flax, params["unet"][flax_name], x, temb


def _irb_outputs(prefix, flax_name, cin, cout, **flags):
    block, flax, p, x, temb = _irb_case(prefix, flax_name, cin, cout, **flags)
    ref = flax.apply({"params": p}, jnp.asarray(x, BF16), jnp.asarray(temb, BF16))
    with torch.no_grad():
        got = block(nchw(x).to(torch.bfloat16), _t(temb))
    assert ref.dtype == BF16 and got.dtype == torch.bfloat16
    return nhwc(got.float()), np.asarray(ref, np.float32)


IRB_CASES = [("mid_block1", "mid_block1", 128, 128),        # identity residual
             ("encoder_blocks.1.0", "enc_1_0", 16, 32)]      # 1×1 skip residual


@pytest.mark.parametrize("prefix,flax_name,cin,cout", IRB_CASES)
def test_irb_bf16_matches_flax(prefix, flax_name, cin, cout):
    """The unfused block in bf16: within 2e-2 of its output's scale
    (measured 6.4e-3 and 7.8e-3: a few ulps of the hidden layers, carried
    through four convolutions)."""
    got, ref = _irb_outputs(prefix, flax_name, cin, cout)
    assert rel(got, ref) <= 2e-2


@pytest.mark.parametrize("prefix,flax_name,cin,cout", IRB_CASES)
def test_fused_irb_bf16_route_matches_jax(prefix, flax_name, cin, cout):
    """``use_pallas_irb`` in bf16: the port's route on the CPU (the kernel's
    plain version, bf16 product operands as the kernel's bf16 entry) against
    JAX's ``fused_irb_v2`` in interpret mode, within 1e-2 of the output's
    scale (measured 3.9e-3 and 7.8e-3). And the fused route is as far from
    the unfused block in the port as in JAX: JAX's own bf16 kernel differs
    from JAX's unfused bf16 block (it keeps h1, h2 and h3 in float32 and
    rounds only the products' operands), and the port's gap is within 1.5×
    JAX's (measured 0.98× and 1.0×)."""
    fused_got, fused_ref = _irb_outputs(prefix, flax_name, cin, cout,
                                        use_pallas_irb=True)
    plain_got, plain_ref = _irb_outputs(prefix, flax_name, cin, cout)
    assert rel(fused_got, fused_ref) <= 1e-2
    jax_gap, port_gap = rel(fused_ref, plain_ref), rel(fused_got, plain_got)
    assert 0 < jax_gap and port_gap <= 1.5 * jax_gap


def _attention_case(seed=3):
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=seed)
    sd = state_dict_from_jax(params, tcfg)
    u = jcfg.unet
    block = load_block(tblocks.LinearAttentionBlock(
        128, u.num_attention_heads, u.attention_head_dim), sd, "unet.mid_attn")
    tblocks.set_compute_dtype(block, torch.bfloat16)
    flax = jblocks.LinearAttentionBlock(num_heads=u.num_attention_heads,
                                        dim_head=u.attention_head_dim, dtype=BF16)
    rng = np.random.default_rng(4)
    x = bf16_values(rng.standard_normal((2, 8, 8, 128)))
    cot = bf16_values(rng.standard_normal((2, 8, 8, 128)))
    return block, flax, params, tcfg, x, cot


def test_attention_block_bf16_forward_and_backward_match_flax():
    """The linear-attention block in bf16, forward and backward (the port's
    autograd function, the kernels' plain versions on the CPU) against
    flax's with ``jax.vjp`` on the same cotangent: the output within 2e-2 of
    its scale (measured 3.9e-3), the float32 parameter gradients within 3e-2
    of each one's largest entry (measured up to 8.2e-3) and the bf16 input
    gradient within 3e-2 (measured 7.6e-3)."""
    block, flax, params, tcfg, x, cot = _attention_case()

    def f(p, xx):
        return flax.apply({"params": p}, xx)

    ref, vjp = jax.vjp(f, params["unet"]["mid_attn"], jnp.asarray(x, BF16))
    ref_dp, ref_dx = vjp(jnp.asarray(cot, BF16))
    xt = nchw(x).to(torch.bfloat16).requires_grad_()
    block.train()
    got = block(xt)
    got.backward(nchw(cot).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    assert rel(nhwc(got.float()), np.asarray(ref, np.float32)) <= 2e-2
    assert rel(nhwc(xt.grad.float()), np.asarray(ref_dx, np.float32)) <= 3e-2
    tree = dict(params, unet=dict(params["unet"], mid_attn=jax.tree.map(np.asarray, ref_dp)))
    ref_sd = state_dict_from_jax(tree, tcfg)
    for name, param in block.named_parameters():
        assert param.grad.dtype == torch.float32
        assert rel(param.grad.numpy(), ref_sd[f"unet.mid_attn.{name}"].numpy()) <= 3e-2, name


def test_upsample_bf16_matches_flax():
    """Bilinear ×2 in float32, cast back to bf16, then the bf16 3×3 conv
    with its bias added in bf16 (``blocks.py:420-421``): within 2 ulps
    (measured 1)."""
    rng = np.random.default_rng(7)
    c = 32
    x = bf16_values(rng.standard_normal((2, 8, 8, c)))
    kernel = (rng.standard_normal((3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jblocks.Upsample(dtype=BF16).apply(
        {"params": {"conv": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}},
        jnp.asarray(x, BF16))
    up = tblocks.Upsample(c)
    with torch.no_grad():
        up.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        up.conv.bias.copy_(torch.from_numpy(bias))
        tblocks.set_compute_dtype(up, torch.bfloat16)
        got = up(nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (2, c, 16, 16)
    assert ulps(nhwc(got.float()), np.asarray(ref, np.float32)) <= 2


# --- the UNet, the sampler, a train step ----------------------------------------
#
# The JAX side of these tests is compiled with XLA's excess precision off
# (``jax_compiled``). On, XLA's CPU compiler may drop a cast to bf16 whose
# value feeds a float32 computation (a GroupNorm's output, a convolution's
# input or output) and so skip a rounding the model's code writes; off,
# every cast rounds, as the port's do.
#
# A whole network cannot be held to JAX's value by value: where XLA and
# PyTorch accumulate a product in other orders a few outputs of a block land
# on the neighbouring bf16 value, the next blocks carry the flips on, and
# the two networks' outputs end as far apart as either is from its float32
# result (a float32 computation of the same network is that far too). So
# the network is held block by block: each block of the port, handed the
# inputs JAX's block received, must give JAX's bf16 output bit for bit in
# all but a few values (BLOCK_MISMATCH); the port's blocks computing in
# float32 are run through the same check and must fail it. The sampler is
# held the same way, with a stand-in for the UNet that both sides compute
# exactly. The whole network's output is held to JAX's own spread: no
# further from JAX's result than SPREAD times JAX's distance from itself
# with excess precision on, a second bf16 computation of the same code.

NO_EXCESS = {"xla_allow_excess_precision": False}
# (mean, largest) share of a block's outputs that may differ from JAX's bf16
# output: measured 0.6% on average and 4.9% in the worst block (the trained
# student at 48²; random tiny weights 0.02% and 0.3%); the float32 blocks
# differ in 40% and 50% on average
BLOCK_MISMATCH = (0.02, 0.25)
SPREAD = 1.5


def jax_compiled(fn, *args, excess=False):
    """``fn(*args)`` jitted and compiled with XLA's excess precision off (or
    on, XLA's default, with ``excess``)."""
    return jax.jit(fn).lower(*args).compile({} if excess else NO_EXCESS)(*args)


def mean_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean())


def _bf16_cfgs(jcfg, tcfg):
    return (dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, dtype="bfloat16")),
            dataclasses.replace(tcfg, unet=dataclasses.replace(tcfg.unet, dtype="bfloat16")))


def _with_dtype(tcfg, dtype):
    return dataclasses.replace(tcfg, unet=dataclasses.replace(tcfg.unet, dtype=dtype))


def jax_unet_blocks(ucfg, params, x, t, excess=False):
    """JAX's UNet output on (x, t) and, for each of its top-level blocks, the
    inputs it received and its output."""
    def tap(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and len(context.module.scope.path) == 1:
            context.module.sow("intermediates", "io", (args, out))
        return out

    def f(p, xx, tt):
        with nn.intercept_methods(tap):
            return EfficientUNet(ucfg).apply({"params": p}, xx, tt,
                                             mutable=["intermediates"])

    out, state = jax_compiled(f, params, jnp.asarray(x), jnp.asarray(t), excess=excess)
    return (np.asarray(out, np.float32),
            {k: v["io"][0] for k, v in state["intermediates"].items()})


def port_block_names(ucfg) -> dict:
    """JAX's top-level UNet block names → the port's module names."""
    names = {n: n for n in ("time_mlp", "init_conv", "final_norm", "final_conv")}
    for name, path, _, _ in unet_entries(ucfg):
        if path[1:] in (("norm1", "scale"), ("norm", "scale")):      # IRB, attention
            names[path[0]] = name[:-len(f".{path[1]}.weight")]
        elif path[1:] == ("conv", "kernel"):                         # up-, downsampling
            names[path[0]] = name.rsplit(".", 2)[0]
    return names


def block_mismatch(unet, ucfg, io) -> dict:
    """{JAX block: the share of its bf16 outputs that the port's block gives
    otherwise}, each port block handed the inputs JAX's block received (in
    the port block's compute dtype) and its output rounded to bf16."""
    names, shares = port_block_names(ucfg), {}
    dtype = unet.compute_dtype or torch.float32
    for name, (args, ref) in io.items():
        inputs = []
        for a in map(np.asarray, args):
            if a.dtype == np.bool_:                       # flax's ``train``
                continue
            if a.dtype == np.int32:
                inputs.append(torch.from_numpy(a.copy()))
            else:
                a = np.asarray(a, np.float32)
                inputs.append((nchw(a) if a.ndim == 4 else torch.from_numpy(a)).to(dtype))
        with torch.no_grad():
            got = unet.get_submodule(names[name])(*inputs).to(torch.bfloat16).float()
        got = nhwc(got) if got.ndim == 4 else got.numpy()
        shares[name] = float((got != np.asarray(ref, np.float32)).mean())
    return shares


def blocks_agree(shares: dict) -> bool:
    mean, largest = BLOCK_MISMATCH
    return np.mean(list(shares.values())) <= mean and max(shares.values()) <= largest


@pytest.mark.parametrize("dtype,holds", [("bfloat16", True), ("float32", False)])
def test_tiny_unet_bf16_matches_flax(dtype, holds):
    """The tiny UNet at 32² (attention at 16² and 8²), random weights, in bf16
    compute: each block handed JAX's inputs gives JAX's bf16 output but for
    BLOCK_MISMATCH (measured 0.02% on average, 0.3% in the worst block);
    the same blocks in float32 must fail that (measured 50% on average).
    The whole UNet: a bf16 output, its distance from JAX's within SPREAD
    times JAX's own distance with excess precision on (measured 3.0e-2
    against 3.8e-2; the float32 UNet is 3.7e-2 away, so this bound alone
    does not tell the dtypes apart)."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=5)
    jb, _ = _bf16_cfgs(jcfg, tcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 6)).astype(np.float32)
    t = np.asarray([10, 900], dtype=np.int32)
    ref, io = jax_unet_blocks(jb.unet, params["unet"], x, t)
    model = port_model(_with_dtype(tcfg, dtype), params)
    assert blocks_agree(block_mismatch(model.unet, jb.unet, io)) == holds
    if holds:
        ref_excess, _ = jax_unet_blocks(jb.unet, params["unet"], x, t, excess=True)
        with torch.no_grad():
            got = model.unet(nchw(x), torch.from_numpy(t))
        assert got.dtype == torch.bfloat16
        assert mean_abs(nhwc(got.float()), ref) <= SPREAD * mean_abs(ref_excess, ref)


STUDENT_SIZE = 48     # levels at 48, 24, 12, 6: no attention but mid_attn, as at 256²


def _student():
    """(jax config, port config, params) of the committed 1-step student
    (``artifacts/vreg1b_gt03_ema``, orbax, read by the JAX package here) at
    48²: trained weights, where the bf16 noise is that of a real model
    (random weights make the attention block and its GroupNorm
    ill-conditioned, and bf16 gradients there differ by whole factors
    between any two implementations)."""
    from cv_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
    from cv_diffusion_tpu.config import from_dict as jax_from_dict
    from cv_diffusion_tpu.training.checkpoint import load_inference_params
    from cv_diffusion_tpu_torch.config import load_model_config

    path = os.path.join(REPO, "artifacts", "vreg1b_gt03_ema")
    with open(os.path.join(path, "model_config.json")) as f:
        jcfg = jax_from_dict(JaxDiffusionConfig, json.load(f))
    jcfg = dataclasses.replace(jcfg, image_size=STUDENT_SIZE, unet=dataclasses.replace(
        jcfg.unet, image_size=STUDENT_SIZE))
    tcfg = load_model_config(os.path.join(path, "model_config.json"),
                             image_size=STUDENT_SIZE)
    return jcfg, tcfg, load_inference_params(path, verbose=False)


student = pytest.fixture(scope="module")(_student)


@pytest.mark.parametrize("dtype,holds", [("bfloat16", True), ("float32", False)])
def test_student_unet_blocks_match_jax(student, dtype, holds):
    """The trained student's UNet at 48², block by block as the tiny UNet's:
    in bf16 each block gives JAX's bf16 output but for BLOCK_MISMATCH
    (measured 0.6% on average, 4.9% in the worst block, ``dec_1_0``), in
    float32 the check fails (measured 40% on average)."""
    jcfg, tcfg, params = student
    jb, _ = _bf16_cfgs(jcfg, tcfg)
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.standard_normal((2, STUDENT_SIZE, STUDENT_SIZE, 3)),
                        rng.uniform(-1, 1, (2, STUDENT_SIZE, STUDENT_SIZE, 3))],
                       -1).astype(np.float32)
    _, io = jax_unet_blocks(jb.unet, params["unet"], x, np.asarray([10, 739], np.int32))
    model = port_model(_with_dtype(tcfg, dtype), params)
    assert blocks_agree(block_mismatch(model.unet, jb.unet, io)) == holds


def _sampler_inputs(grid, size, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32),
            rng.standard_normal((2, size, size, 3)).astype(np.float32),
            rng.standard_normal((len(grid), 2, size, size, 3)).astype(np.float32))


def _port_enhance(tcfg, params, grid, size, return_intermediate=False, unet_hook=None):
    low, init, noise = _sampler_inputs(grid, size)
    model = port_model(tcfg, params)
    if unet_hook is not None:
        model.unet.register_forward_hook(unet_hook)
    return enhance(model, make_schedule(tcfg.scheduler),
                   torch.from_numpy(low), timesteps=grid,
                   init_noise=torch.from_numpy(init),
                   step_noise=torch.from_numpy(noise), device="cpu",
                   return_intermediate=return_intermediate)


def _jax_enhance(jcfg, params, grid, size, return_intermediate=False, excess=False,
                 stand_in=False):
    """JAX's sampler on the inputs of :func:`_sampler_inputs`; with
    ``stand_in`` its UNet replaced by x_t − condition."""
    low, init, noise = _sampler_inputs(grid, size)
    jmodel, jschedule = jax_create_model(jcfg)

    def replace_unet(next_fun, args, kwargs, context):
        if stand_in and isinstance(context.module, EfficientUNet):
            return args[0][..., :3] - args[0][..., 3:]
        return next_fun(*args, **kwargs)

    def f(p, lo, i, n):
        with nn.intercept_methods(replace_unet):
            out = jax_enhance(jmodel, jschedule, {"params": p}, jax.random.key(0), lo,
                              init_noise=i, step_noise=n, timesteps=grid,
                              return_intermediate=return_intermediate)
        return (out.enhanced, out.intermediate) if return_intermediate else out

    out = jax_compiled(f, params, jnp.asarray(low), jnp.asarray(init),
                       jnp.asarray(noise), excess=excess)
    return jdiffusion.EnhanceOutput(*out) if return_intermediate else out


def sampler_agrees(got, ref) -> bool:
    """Two sampler results equal but for one bf16 ulp in at most 0.1% of the
    values (the scheduler's float32 arithmetic, associated otherwise by XLA,
    moves the odd value across a rounding boundary)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float((got != ref).mean()) <= 1e-3 and ulps(got, ref) <= 1


def _stand_in_unet(module, args, out):
    """The port's UNet replaced by x_t − condition, as JAX's in
    :func:`_jax_enhance` (one subtraction in the compute dtype: exact on
    both sides)."""
    return args[0][:, :3] - args[0][:, 3:]


@pytest.mark.parametrize("grid", [[739], [739, 259]])
@pytest.mark.parametrize("dtype,holds", [("bfloat16", True), ("float32", False)])
def test_bf16_sampler_rounds_as_jax(grid, dtype, holds):
    """The sampler around a stand-in UNet that both sides compute exactly
    (x_t − condition): in bf16 the carry, noise and condition are rounded
    to bf16 and the scheduler runs in float32, and the port's result is
    JAX's bf16 result as :func:`sampler_agrees` (measured: one value of
    6,144 one ulp off on [739], none on [739, 259]); the same sampler
    computing in float32 fails that (measured 36% and 46% of the values
    off, by up to 181 and 405 ulps)."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=7)
    jb, _ = _bf16_cfgs(jcfg, tcfg)
    ref = np.asarray(_jax_enhance(jb, params, grid, 32, stand_in=True), np.float32)
    got = _port_enhance(_with_dtype(tcfg, dtype), params, grid, 32,
                        unet_hook=_stand_in_unet)
    assert sampler_agrees(got.to(torch.bfloat16).float().numpy(), ref) == holds


@pytest.mark.parametrize("grid", [[739], [739, 259]])
def test_enhance_bf16_matches_jax(student, grid):
    """The sampler of the bf16 student at 48²: a bf16 result in [-1, 1], on
    average within SPREAD times JAX's distance from itself with excess
    precision on (measured 4.4e-3 against 4.7e-3, and 4.1e-3 against
    4.2e-3; the float32 sampler is as far, 4.4e-3 and 3.9e-3), and at most
    0.125 anywhere (measured 0.043 and 0.023). What tells bf16 from float32
    is held by ``test_bf16_sampler_rounds_as_jax`` (the sampler) and
    ``test_student_unet_blocks_match_jax`` (the UNet, block by block)."""
    jcfg, tcfg, params = student
    jb, tb = _bf16_cfgs(jcfg, tcfg)
    got = _port_enhance(tb, params, grid, STUDENT_SIZE)
    ref = _jax_enhance(jb, params, grid, STUDENT_SIZE)
    ref_excess = _jax_enhance(jb, params, grid, STUDENT_SIZE, excess=True)
    assert got.dtype == torch.bfloat16 and ref.dtype == BF16
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert np.abs(got).max() <= 1.0
    assert mean_abs(got, ref) <= SPREAD * mean_abs(np.asarray(ref_excess, np.float32), ref)
    assert np.abs(got - ref).max() <= 0.125


def test_return_intermediate_matches_jax():
    """``return_intermediate`` on a 2-step grid: an ``EnhanceOutput`` whose
    ``intermediate`` stacks each step's carry, unclipped, [steps, B, H, W,
    3] in the compute dtype, whose last entry clipped is ``enhanced``;
    against JAX's ``EnhanceOutput`` at the sampler's 5e-3 (float32, tiny
    UNet at 32²)."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=7, perturb_norms=False)
    got = _port_enhance(tcfg, params, [739, 259], 32, return_intermediate=True)
    ref = _jax_enhance(jcfg, params, [739, 259], 32, return_intermediate=True)
    assert isinstance(got, EnhanceOutput)
    assert got.intermediate.shape == (2, 2, 32, 32, 3)
    assert got.intermediate.dtype == got.enhanced.dtype == torch.float32
    assert torch.equal(got.intermediate[-1].clamp(-1, 1), got.enhanced)
    for a, b in ((got.enhanced, ref.enhanced), (got.intermediate, ref.intermediate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3, rtol=0)


def test_return_intermediate_bf16_matches_jax():
    """The same in bf16 compute, around the stand-in UNet of
    ``test_bf16_sampler_rounds_as_jax``: both carries bf16 and JAX's as
    :func:`sampler_agrees`, the last one clipped equal to ``enhanced``."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=7)
    jb, tb = _bf16_cfgs(jcfg, tcfg)
    got = _port_enhance(tb, params, [739, 259], 32, return_intermediate=True,
                        unet_hook=_stand_in_unet)
    ref = _jax_enhance(jb, params, [739, 259], 32, return_intermediate=True,
                       stand_in=True)
    assert got.intermediate.dtype == got.enhanced.dtype == torch.bfloat16
    assert got.intermediate.shape == (2, 2, 32, 32, 3)
    assert torch.equal(got.intermediate[-1].clamp(-1, 1), got.enhanced)
    for a, b in ((got.enhanced, ref.enhanced), (got.intermediate, ref.intermediate)):
        assert sampler_agrees(a.float().numpy(), b)


def test_with_dtype_keeps_the_weights_and_builds_bf16():
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=7)
    model = port_model(tcfg, params)
    bf16 = with_dtype(model, "bfloat16")
    assert bf16.config.unet.dtype == "bfloat16" and not bf16.training
    assert bf16.compute_dtype == torch.bfloat16 and model.compute_dtype == torch.float32
    sd = model.state_dict()
    assert all(torch.equal(t, sd[k]) and t.dtype == torch.float32
               for k, t in bf16.state_dict().items())
    assert bf16.unet.init_conv.compute_dtype == torch.bfloat16
    assert model.unet.init_conv.compute_dtype is None


def _grad_rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ over every tensor of two gradient dicts."""
    num = sum(float(np.square(a[k].astype(np.float64) - b[k]).sum()) for k in b)
    den = sum(float(np.square(b[k].astype(np.float64)).sum()) for k in b)
    return (num / den) ** 0.5


def _moved_share(a, b) -> float:
    """The share of parameter entries more than 1e-6 apart in two updates."""
    return (sum(int((np.abs(a[k] - b[k]) > 1e-6).sum()) for k in b)
            / sum(v.size for v in b.values()))


def _bf16_valued(grads: dict, names) -> bool:
    """Whether every gradient of ``names`` holds bf16 values only."""
    return all(np.array_equal(grads[k], bf16_values(grads[k])) for k in names)


def test_use_amp_train_step_matches_jax(student):
    """One train step with ``use_amp`` (bf16 compute; float32 parameters,
    gradients, AdamW and EMA) of the student at 48² against the JAX
    package's: its ``train_forward`` of the bf16 model, ``diffusion_loss``
    in float32, the gradients and optax's clip + AdamW (``make_optimizer``),
    on the same weights, batch, t and ε (the port's draws replayed).

    What a float32 step fails (the port's own float32 step is run through
    the same checks): every convolution's and dense layer's weight and bias
    gradient holds bf16 values only, as JAX's do (the layer's product runs
    in bf16 and its cast back to the float32 parameter is exact; float32:
    none of the 227); the gradients of the last layers, where bf16's flips
    have not spread yet, are JAX's: final_norm's within 4 bf16 ulps
    (measured 1.1 and 1.2; float32 15 and 9.0) and final_conv's weight
    within 8e-3 of its largest (measured 4.9e-3; float32 1.1e-2).

    What bounds the step as a whole, bf16 or float32 alike: the loss within
    2e-4 relative (measured 6.8e-5), the gradients within SPREAD times the
    float32 step's distance from JAX's (measured 2.7e-2 against 2.9e-2 of
    their norm), no parameter moved more than 2.5·lr from JAX's (AdamW's
    first update is ±lr wherever a gradient is far above eps, so an entry
    whose gradient's sign differs moves by up to 2·lr), and the share of
    entries more than 1e-6 from JAX's within SPREAD times the float32
    step's (measured 6.3% against 6.8%: bf16 noise flips the sign of many
    small gradients)."""
    jcfg, tcfg, params = student
    jb, tb = _bf16_cfgs(jcfg, tcfg)
    kw = dict(epochs=2, warmup_epochs=0)
    jc = JaxTrainConfig(use_amp=True, **kw)
    size = STUDENT_SIZE
    rng = np.random.default_rng(20)
    batch = {k: rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
             for k in ("low_light", "normal_light")}
    t, eps = sample_timesteps_and_noise(make_schedule(tb.scheduler), (2, size, size, 3),
                                        torch.Generator().manual_seed(0), "cpu")

    jmodel, jschedule = jax_create_model(jb)

    def jloss(p):
        res = jdiffusion.train_forward(
            jmodel, jschedule, {"params": p}, jax.random.key(0),
            jnp.asarray(batch["low_light"]), jnp.asarray(batch["normal_light"]),
            timesteps=jnp.asarray(t.numpy(), jnp.int32), noise=jnp.asarray(eps.numpy()))
        return jdiffusion.diffusion_loss(res["noise_pred"], res["target"])

    tx, _ = jts.make_optimizer(jc, 4)

    def jstep(p):
        loss, grads = jax.value_and_grad(jloss)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    loss, grads, new = jax_compiled(jstep, params)
    flat = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                         state_dict_from_jax(jax.tree.map(np.asarray, tree), tb).items()}
    ref_grads, ref_params = flat(grads), flat(new)

    def port_step(cfg, use_amp):
        """(loss, gradients before clipping, parameters after, the names of
        the convolutions' and dense layers' parameters) of the port's step."""
        tc = TrainConfig(use_amp=use_amp, **kw)
        model = port_model(cfg, params)
        raw = {}
        for name, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, name=name: raw.__setitem__(name, p.grad.detach().numpy().copy()))
        state = tts.create_train_state(model, tc, steps_per_epoch=4)
        state, metrics = tts.make_train_step(model, make_schedule(cfg.scheduler), tc)(
            state, batch)
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
        assert all(e.dtype == torch.float32 for e in state.ema_params.values())
        layers = [f"{n}.{k}" for n, m in model.named_modules()
                  if isinstance(m, (tblocks.Conv2d, tblocks.Linear))
                  for k, _ in m.named_parameters(recurse=False)]
        return (float(metrics["loss"]), raw,
                {k: p.detach().numpy() for k, p in model.named_parameters()}, layers)

    got_loss, got_grads, got_params, layers = port_step(tb, True)
    _, grads32, params32, _ = port_step(tcfg, False)

    def last_layers_agree(g) -> bool:
        return (all(ulps(g[k], ref_grads[k]) <= 4
                    for k in ("unet.final_norm.weight", "unet.final_norm.bias"))
                and rel(g["unet.final_conv.weight"], ref_grads["unet.final_conv.weight"])
                <= 8e-3)

    assert len(layers) == 227 and _bf16_valued(ref_grads, layers)
    assert _bf16_valued(got_grads, layers) and last_layers_agree(got_grads)
    assert not _bf16_valued(grads32, layers) and not last_layers_agree(grads32)
    np.testing.assert_allclose(got_loss, float(loss), rtol=2e-4)
    assert _grad_rel(got_grads, ref_grads) <= SPREAD * _grad_rel(grads32, ref_grads)
    lr = TrainConfig().learning_rate
    assert max(float(np.abs(got_params[k] - v).max())
               for k, v in ref_params.items()) <= 2.5 * lr
    assert (_moved_share(got_params, ref_params)
            <= SPREAD * _moved_share(params32, ref_params))
