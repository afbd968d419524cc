"""The port's fused inverted residual block against the JAX package's.

``fused_irb_v2_plain`` (the CUDA kernel's CPU branch) is held against
``fused_irb_v2`` in Pallas interpret mode at 2e-4, the per-IRB tolerance of
``tests/test_pallas_kernels.py``, on that file's cases; the Gram fold of GN2 ⊕
FiLM against ``gn2_film_affine_gram`` at 1e-5; the port's block with
``use_pallas_irb`` or ``fold_gn`` against the flax block with the same flag;
and the tiny UNet and the 1-step sampler with ``use_pallas_irb`` against the
JAX package's at the UNet's 1e-3 and the sampler's 5e-3. The CUDA kernel
itself is held against the plain version on the card by ``chip_smoke.py``.
"""

import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cv_diffusion_tpu.ops.pallas_irb as pirb
from cv_diffusion_tpu.models import blocks as jblocks
from cv_diffusion_tpu.models.unet import EfficientUNet
from cv_diffusion_tpu.ops.norms import gn2_film_affine_gram as jax_gram
from cv_diffusion_tpu_torch.config import load_model_config
from cv_diffusion_tpu_torch.models import blocks as tblocks
from cv_diffusion_tpu_torch.models.diffusion import (LowLightDiffusion,
                                                     create_model)
from cv_diffusion_tpu_torch.ops import cuda_build
from cv_diffusion_tpu_torch.ops import fused_irb_kernel as fik
from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
from cv_diffusion_tpu_torch.ops.fused_irb import fused_irb_v2_plain, irb_args
from cv_diffusion_tpu_torch.ops.norms import gn2_film_affine_gram
from cv_diffusion_tpu_torch.weights import _irb

from test_torch_port_sampler import _both_enhance
from test_torch_port_weights import one_torch_thread  # noqa: F401
from test_torch_port_weights import nchw, nhwc, port_model, random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IRB_TOL = dict(atol=2e-4, rtol=0)


# --- (a) the Gram fold of GN2 ⊕ FiLM ------------------------------------------

def _gram_inputs(b, size, cin, chid, seed):
    rng = np.random.default_rng(seed)
    xhat = np.clip(rng.standard_normal((b, size, size, cin)) + 0.5, 0, 6)
    return dict(xhat=xhat.astype(np.float32),
                wexp=(rng.standard_normal((cin, chid)) / np.sqrt(cin)).astype(np.float32),
                scale=(1 + 0.1 * rng.standard_normal(chid)).astype(np.float32),
                bias=(0.1 * rng.standard_normal(chid)).astype(np.float32),
                film_scale=(0.2 * rng.standard_normal((b, chid))).astype(np.float32),
                film_shift=(0.2 * rng.standard_normal((b, chid))).astype(np.float32))


def _port_gram(a, groups, dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in a.items()}
    return gn2_film_affine_gram(nchw(t["xhat"].numpy()).to(dtype),
                                t["wexp"].t(), t["scale"], t["bias"],
                                t["film_scale"], t["film_shift"], groups)


@pytest.mark.parametrize("b,size,cin,chid,groups", [
    (2, 8, 32, 128, 32), (1, 16, 48, 96, 32), (2, 12, 96, 384, 32),
    (1, 8, 16, 64, 16),
    (1, 64, 16, 64, 16), (2, 96, 8, 32, 8)])   # Gram over 2 and 4 chunks
def test_gram_fold_matches_jax(b, size, cin, chid, groups):
    a = _gram_inputs(b, size, cin, chid, seed=cin)
    ra, rb = jax_gram(*(jnp.asarray(a[k]) for k in ("xhat", "wexp", "scale", "bias",
                                                    "film_scale", "film_shift")),
                      num_groups=groups)
    ga, gb = _port_gram(a, groups)
    assert ga.dtype == torch.float32 and tuple(ga.shape) == (b, chid)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), atol=1e-5, rtol=0)


def test_gram_fold_float64_shows_the_float32_cancellation():
    """In float64 the fold equals GN2 ⊕ FiLM computed from h1 itself (two
    passes, no cancellation) to rounding; the float32 fold, port's and JAX's,
    carries the E[h²] − E[h]² cancellation error, which stays within 1e-5."""
    b, size, cin, chid, groups = 2, 16, 96, 384, 32
    a = _gram_inputs(b, size, cin, chid, seed=5)
    x64 = a["xhat"].astype(np.float64).reshape(b, -1, cin)
    h1 = x64 @ a["wexp"].astype(np.float64)                    # [B, N, Chid]
    hg = h1.reshape(b, -1, groups, chid // groups)
    mean = hg.mean(axis=(1, 3))
    var = ((hg - mean[:, None, :, None]) ** 2).mean(axis=(1, 3))
    rstd = np.repeat(1 / np.sqrt(var + 1e-5), chid // groups, axis=1)
    mean = np.repeat(mean, chid // groups, axis=1)
    fs = 1 + a["film_scale"].astype(np.float64)
    exact_a = rstd * a["scale"] * fs
    exact_b = (a["bias"] - mean * rstd * a["scale"]) * fs + a["film_shift"]

    a64, b64 = _port_gram(a, groups, torch.float64)
    assert a64.dtype == torch.float64
    np.testing.assert_allclose(a64.numpy(), exact_a, atol=1e-10, rtol=0)
    np.testing.assert_allclose(b64.numpy(), exact_b, atol=1e-10, rtol=0)
    a32, b32 = _port_gram(a, groups)
    ra, rb = jax_gram(*(jnp.asarray(a[k]) for k in ("xhat", "wexp", "scale", "bias",
                                                    "film_scale", "film_shift")),
                      num_groups=groups)
    for got in (a32.numpy(), np.asarray(ra)):
        err = np.abs(got - exact_a).max()
        assert 0 < err <= 1e-5
    for got in (b32.numpy(), np.asarray(rb)):
        assert np.abs(got - exact_b).max() <= 1e-5


# --- (b, c) one block -----------------------------------------------------------

def _flax_block(cin, cout, exp, use_se, quant, **flags):
    return jblocks.InvertedResidualBlock(out_channels=cout, expansion_ratio=exp,
                                         use_se=use_se,
                                         quantization_friendly=quant, **flags)


def _block_case(cin=32, cout=32, exp=4, size=32, batch=2, use_se=True,
                quant=True):
    """(flax params, x NHWC, time embedding, port block) for one IRB: flax's
    init with every 1-D leaf (GroupNorm, biases) perturbed, carried into the
    port's block."""
    rng = np.random.default_rng(cin + size)
    x = rng.standard_normal((batch, size, size, cin)).astype(np.float32)
    temb = rng.standard_normal((batch, 64)).astype(np.float32)
    params = _flax_block(cin, cout, exp, use_se, quant).init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(temb))["params"]
    params = jax.tree.map(
        lambda a: (np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                    if a.ndim == 1 else 0)).astype(np.float32),
        params)
    sd = {}
    _irb(sd, "b", params)
    block = tblocks.InvertedResidualBlock(
        cin, cout, 64, expansion_ratio=exp, use_se=use_se,
        quantization_friendly=quant)
    block.load_state_dict({k[2:]: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return params, x, temb, block.eval()


BLOCK_CASES = {
    "identity": dict(),
    "skip_32_64": dict(cout=64),
    "no_se_silu": dict(use_se=False, quant=False),
    "cin48_16_groups": dict(cin=48, cout=48, exp=2, size=16),
    "size24_uneven_tile": dict(size=24),
    "skip_96_384_32": dict(cin=96, cout=32, size=16, batch=1),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fused_plain_matches_pallas_interpret(case):
    kw = BLOCK_CASES[case]
    params, x, temb, block = _block_case(**kw)
    quant = kw.get("quant", True)
    use_se = kw.get("use_se", True)
    t = params["time_mlp"]
    film = jax.nn.silu(jnp.asarray(temb)) @ t["kernel"] + t["bias"]
    fs, fb = jnp.split(film, 2, axis=-1)
    ref = pirb.fused_irb_v2(jnp.asarray(x), film_scale=fs, film_shift=fb,
                            silu=not quant, use_se=use_se, interpret=True,
                            tile_h=8, **pirb.irb_params_from_flax(params))
    args = irb_args(block)
    assert args["use_se"] == use_se and args["silu"] == (not quant)
    assert ("wskip" in args) == (kw.get("cin", 32) != kw.get("cout", 32))
    with torch.no_grad():
        got = fused_irb_v2_plain(nchw(x), film_scale=torch.from_numpy(np.array(fs)),
                                 film_shift=torch.from_numpy(np.array(fb)),
                                 **args)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **IRB_TOL)


@pytest.mark.parametrize("flag", ["use_pallas_irb", "fold_gn"])
@pytest.mark.parametrize("case", ["identity", "skip_32_64", "no_se_silu"])
def test_block_rewrite_matches_flax(flag, case):
    kw = BLOCK_CASES[case]
    params, x, temb, block = _block_case(**kw)
    cin, cout = kw.get("cin", 32), kw.get("cout", 32)
    ref = _flax_block(cin, cout, kw.get("exp", 4), kw.get("use_se", True),
                      kw.get("quant", True), **{flag: True}).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(temb))
    setattr(block, flag, True)
    with torch.no_grad():
        got = block(nchw(x), torch.from_numpy(temb))
        block.train()          # training takes the unfused path, same math
        unfused = block(nchw(x), torch.from_numpy(temb))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **IRB_TOL)
    np.testing.assert_allclose(nhwc(unfused), nhwc(got), **IRB_TOL)


# --- (d) the slice as a whole ----------------------------------------------------

@pytest.fixture(scope="module")
def fused_unet_case():
    """The tiny UNet with use_pallas_irb on both sides, on one input; JAX
    runs its fused IRBs in Pallas interpret mode, once for the module."""
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=11,
                                           perturb_norms=False,
                                           use_pallas_irb=True)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 32, 32, 6)).astype(np.float32)
    t = np.asarray([5, 700], dtype=np.int32)
    ref = jax.jit(EfficientUNet(jcfg.unet).apply)(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(t))
    return tcfg, params, x, t, np.asarray(ref)


def test_fused_unet_matches_jax(fused_unet_case):
    """float32 on both sides at the UNet tolerance of the port's other float32
    UNet test (1e-3: flax's own float32 result on random weights is up to
    7.2e-4 from float64); the port's fused UNet also agrees with its own
    unfused one."""
    tcfg, params, x, t, ref = fused_unet_case
    model = port_model(tcfg, params)
    assert tcfg.unet.use_pallas_irb
    with torch.no_grad():
        got = nhwc(model.unet(nchw(x), torch.from_numpy(t)))
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-4)
    plain_cfg = dataclasses.replace(
        tcfg, unet=dataclasses.replace(tcfg.unet, use_pallas_irb=False))
    with torch.no_grad():
        unfused = nhwc(port_model(plain_cfg, params).unet(nchw(x),
                                                          torch.from_numpy(t)))
    np.testing.assert_allclose(got, unfused, atol=1e-3, rtol=1e-4)


def test_fused_enhance_matches_jax():
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=7,
                                           perturb_norms=False,
                                           use_pallas_irb=True)
    got, ref = _both_enhance(jcfg, tcfg, params, 32, [739])
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


# --- (e) routing, plan and build --------------------------------------------------

@pytest.mark.parametrize("variant,expected", [("tiny", None), ("small", 22)])
def test_model_irbs_go_through_the_kernel_wrapper(monkeypatch, variant,
                                                  expected):
    """With ``use_pallas_irb`` every stride-1 IRB of a model built from an
    artifact's config calls the fused kernel's wrapper once, so on the card
    the model cannot reach the unfused path; the small UNet has 22."""
    art = os.path.join(REPO, "artifacts", "vreg1b_gt03_ema", "model_config.json")
    cfg = load_model_config(art, variant=variant, image_size=32)
    cfg = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_pallas_irb=True))
    model, _ = create_model(cfg, device="cpu")
    calls = []
    wrapper = fik.fused_irb_v2

    def spy(x, **kw):
        calls.append(tuple(x.shape))
        return wrapper(x, **kw)

    monkeypatch.setattr(fik, "fused_irb_v2", spy)
    irbs = [m for m in model.modules()
            if isinstance(m, tblocks.InvertedResidualBlock)]
    assert irbs and all(m.stride == 1 for m in irbs)
    with torch.no_grad():
        model.unet(torch.zeros(1, cfg.unet.in_channels, 32, 32),
                   torch.tensor([739], dtype=torch.int32))
    assert len(calls) == len(irbs)
    if expected is not None:
        assert len(calls) == expected


def test_kernel_wrapper_cpu_branch_is_the_plain_version():
    _, x, temb, block = _block_case(cout=64, size=16)
    fs, fb = block.time_mlp(torch.from_numpy(temb)).chunk(2, dim=-1)
    before = fik.fused_irb_v2.launches
    with torch.no_grad():
        out = fik.fused_irb_v2(nchw(x), film_scale=fs, film_shift=fb,
                               **irb_args(block))
        ref = fused_irb_v2_plain(nchw(x), film_scale=fs, film_shift=fb,
                                 **irb_args(block))
    assert torch.equal(out, ref)
    assert fik.fused_irb_v2.launches == before     # the CPU branch launches nothing


def test_tile_table_matches_the_source():
    """The wrapper's tile table is the one the CUDA source was built with
    (the launcher also refuses a mismatch at run time)."""
    with open(fik.SOURCE) as f:
        src = f.read()
    table = {int(co): (int(th), int(tw), int(cc)) for co, th, tw, cc in re.findall(
        r"OutCfg<(\d+)> \{ static constexpr int TH = (\d+), TW = (\d+), CC = (\d+);", src)}
    assert table == fik.OUT_TILES
    assert f"kPoolTile = {fik.POOL_TILE};" in src
    assert f"kPoolCC = {fik.POOL_CHUNK};" in src
    names = re.search(r"enum Ptr \{(.*?)\};", src, re.S).group(1)
    assert len([n for n in names.replace("\n", " ").split(",") if n.strip()]) \
        == len(fik._PTRS) + 1                        # + kNumPtrs


class _RecordingLib:
    """Stands in for the kernel library: records what a launch is given."""

    def fused_irb_f32(self, ptrs, ints, stream):
        self.ptrs = dict(zip(fik._PTRS, ptrs))
        self.dims = dict(zip(fik._DIMS, ints))
        return 0


def test_launch_hands_the_kernel_x_and_the_modules_own_weights():
    """The kernel reads x (it applies GN1's affine itself) and every weight
    in its module's layout: a launch copies no parameter."""
    _, x, temb, block = _block_case(cout=64, size=16)
    fs, fb = block.time_mlp(torch.from_numpy(temb)).chunk(2, dim=-1)
    x = nchw(x).contiguous()
    lib = _RecordingLib()
    with torch.no_grad():
        fik._launch(lib, None, x, film_scale=fs, film_shift=fb, **irb_args(block))
    params = dict(x=x, wexp=block.expand.weight, wdw=block.depthwise.weight,
                  wproj=block.project.weight, wskip=block.skip.weight,
                  se_w1=block.se.fc1.weight, se_b1=block.se.fc1.bias,
                  se_w2=block.se.fc2.weight, se_b2=block.se.fc2.bias)
    assert {k: lib.ptrs[k] for k in params} == {k: t.data_ptr() for k, t in params.items()}
    assert lib.dims["cin"] == x.shape[1] and lib.dims["cout"] == 64
    assert all(lib.ptrs[k] for k in ("a1", "b1", "a2", "b2", "out", "gate"))


# base (48·8 = 384 channels deep) and large (512): the middle blocks and the
# decoder's first concat blocks at 32² of a 256² image
WIDE = [(1, 1536, 384, 32), (8, 1536, 384, 32), (1, 3072, 384, 32),
        (8, 3072, 384, 32), (1, 2048, 512, 32), (8, 2048, 512, 32),
        (1, 4096, 512, 32), (8, 4096, 512, 32)]


@pytest.mark.parametrize("b,chid,cout,h", [
    (1, 128, 32, 256), (8, 384, 32, 256), (1, 256, 64, 128), (1, 768, 64, 128),
    (1, 512, 128, 64), (1, 1536, 128, 64), (1, 1024, 256, 32),
    (8, 2048, 256, 32), (2, 96, 48, 16), (2, 128, 32, 24), (1, 8, 1, 1)] + WIDE)
def test_plan_covers_every_hidden_chunk(b, chid, cout, h):
    pl = fik.plan(b, chid, cout, h, h)
    chunks = math.ceil(chid / pl.chunk)
    assert pl.groups >= 1 and pl.chunks_per_group >= 1
    assert pl.groups * pl.chunks_per_group >= chunks > (pl.groups - 1) * pl.chunks_per_group
    assert 1 <= pl.pool_groups <= math.ceil(h / fik.POOL_TILE) ** 2
    # blocks of at most 256 output channels cover every output channel
    co_pad = min(c for c in fik.OUT_TILES if c >= min(cout, max(fik.OUT_TILES)))
    assert pl.co_blocks == math.ceil(cout / co_pad)
    assert (pl.tile_h, pl.tile_w, pl.chunk) == fik.OUT_TILES[co_pad]
    assert pl.groups * pl.co_blocks <= 65535          # grid dimension y
    assert fik.plan(b, chid, cout, h, h) == pl


def test_plan_refuses_wide_outputs():
    """Outputs wider than ``MAX_COUT`` (eight blocks of 256, four times the
    widest IRB of any variant) are refused; the base and large widths are
    taken."""
    for variant, cout in (("base", 384), ("large", 512)):
        assert fik.plan(1, 4 * cout, cout, 32, 32).co_blocks == 2, variant
    with pytest.raises(ValueError, match="output channels"):
        fik.plan(1, 1024, fik.MAX_COUT + 1, 32, 32)
    with pytest.raises(ValueError, match="output channels"):
        fik.plan(1, 1024, 0, 32, 32)


@pytest.mark.parametrize("variant", ["base", "large"])
def test_base_and_large_irb_shapes_are_planned(variant):
    """Every stride-1 IRB shape of the base and large UNets at 256² (the
    decoder concat blocks up to 768→3072→384 and 1024→4096→512) has a
    plan, so ``use_pallas_irb=True`` serves them on the card."""
    from cv_diffusion_tpu_torch.config import diffusion_config

    cfg = diffusion_config(variant, 256)
    with torch.device("meta"):
        model = LowLightDiffusion(cfg)
    shapes = set()
    for m in model.modules():
        if isinstance(m, tblocks.InvertedResidualBlock):
            shapes.add((m.expand.weight.shape[1], m.expand.weight.shape[0],
                        m.project.weight.shape[0]))
    widest = max(shapes, key=lambda s: s[2])
    assert widest[2] == {"base": 384, "large": 512}[variant]
    assert (2 * widest[2], 8 * widest[2], widest[2]) in shapes
    for cin, chid, cout in sorted(shapes):
        for b in (1, 8):
            assert fik.plan(b, chid, cout, 32, 32).co_blocks == math.ceil(cout / 256)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "CUDA_ROOTS", ())
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fik.build()
    assert list(tmp_path.iterdir()) == []


def test_both_kernels_build_into_one_directory_by_source_hash():
    """One build helper: each kernel's library is named by its own source
    and the shared flags, in the same git-ignored directory."""
    assert lak.SOURCE != fik.SOURCE
    assert os.path.dirname(lak.SOURCE) == os.path.dirname(fik.SOURCE) == cuda_build.CSRC_DIR
    assert cuda_build.BUILD_DIR.endswith(os.path.join("cv_diffusion_tpu_torch", "_build"))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "cv_diffusion_tpu_torch/_build/" in f.read().split()
