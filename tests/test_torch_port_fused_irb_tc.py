"""The fused IRB kernel's tensor-core design, checked on the CPU.

``csrc/fused_irb.cu`` runs the expand, the project and the skip as warp-level
``mma.sync`` on Hopper's tensor cores: float32 operands split into two TF32
parts (3×TF32), bf16 operands (v2's bf16 entry) as they are. This sandbox
cannot run it; ``chip_smoke.py`` holds it against its plain version on the
card. Here a numpy emulation of the kernel's 3×TF32 product makes the
precision argument at the widest block of the small UNet
(``decoder_blocks.0.0``, 512→2048→256), and the wrapper's plan is held to the
source's tiles at every IRB shape of a small-UNet call at 256².
"""

import math
import re

import numpy as np
import pytest

from cv_diffusion_tpu_torch.ops import fused_irb_kernel as fik

IRB_TOL = 2e-4     # the kernel against its plain version (chip_smoke.py)
MMA_K = 8          # columns of K one m16n8k8 TF32 step takes


def tf32_rna(v) -> np.ndarray:
    """float32 → TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``: to nearest,
    ties away from zero; the low 13 bits of the result are zero."""
    u = np.asarray(v, dtype=np.float32).view(np.uint32)
    finite = (u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    rounded = np.where(finite, u + np.uint32(0x1000), u) & np.uint32(0xFFFFE000)
    return rounded.astype(np.uint32).view(np.float32)


def split_tf32(v):
    """The kernel's split of a float32 operand: big = tf32(v) to nearest,
    small = v − big (exact in float32) cut to TF32 toward zero."""
    v = np.asarray(v, dtype=np.float32)
    big = tf32_rna(v)
    small = (v - big).view(np.uint32) & np.uint32(0xFFFFE000)
    return big, small.view(np.float32)


def mma_product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a [M, K] · b [K, N] as the kernel's MMA steps form it: 8 columns of K a
    step; a step's TF32 products are exact, each MMA adds them to the
    float32 accumulator. ``passes`` 3 is 3×TF32 (small·big, big·small,
    big·big, in the kernel's order), 1 a single TF32 pass."""
    if passes == 3:
        (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
        terms = [(as_, bb), (ab, bs), (ab, bb)]
    else:
        terms = [(tf32_rna(a), tf32_rna(b))]
    acc = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k in range(0, a.shape[1], MMA_K):
        for x, y in terms:
            step = x[:, k:k + MMA_K].astype(np.float64) @ y[k:k + MMA_K].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                  # TF32's spacing at 1
    half = np.float32(2.0 ** -11)
    got = tf32_rna(np.array([one + half, -(one + half), one + half - np.float32(2.0 ** -20),
                             one + ulp + half, 3.0], dtype=np.float32))
    np.testing.assert_array_equal(
        got, np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0], dtype=np.float32))
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert not (tf32_rna(v).view(np.uint32) & np.uint32(0x1FFF)).any()
    big, small = split_tf32(v)
    # two TF32 parts carry 21 of float32's 24 significant bits or more
    assert (np.abs((big.astype(np.float64) + small) - v) <= 2.0 ** -21 * np.abs(v)).all()


def _decoder_block_0_0(product: str, rng):
    """Operands of one product of ``decoder_blocks.0.0`` (512→2048→256) on
    64 pixels, at the kernel's magnitudes: x̂ = ReLU6 output against W_exp
    [2048, 512] (LeCun normal), or h3·gate against W_proj [256, 2048]."""
    cin, chid, cout, pixels = 512, 2048, 256, 64
    if product == "expand":
        a = np.clip(rng.standard_normal((pixels, cin)) + 0.5, 0.0, 6.0)
        w = rng.standard_normal((chid, cin)) / np.sqrt(cin)
    else:
        a = np.clip(rng.standard_normal((pixels, chid)) + 0.5, 0.0, 6.0) * rng.uniform(
            0.0, 1.0, chid)
        w = rng.standard_normal((cout, chid)) / np.sqrt(chid)
    return a.astype(np.float32), w.T.astype(np.float32)


@pytest.mark.parametrize("product", ["expand", "project"])
def test_3xtf32_meets_the_kernel_bound_where_one_tf32_pass_does_not(product):
    """The precision argument of the design, made before the card: at K =
    512 (expand) and 2048 (project) the emulated 3×TF32 product is within
    the kernel's 2e-4 bound of the float64 product, and within a small
    factor of a float32 product; one TF32 pass is not within the bound."""
    a, b = _decoder_block_0_0(product, np.random.default_rng(8))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    err3 = np.abs(mma_product(a, b, 3) - exact).max()
    err1 = np.abs(mma_product(a, b, 1) - exact).max()
    err32 = np.abs((a @ b) - exact).max()
    assert err3 <= IRB_TOL / 20, err3
    assert err3 <= 8 * err32, (err3, err32)
    assert err1 > IRB_TOL, err1


def test_products_run_on_the_tensor_cores():
    """The source's expand, project and skip are warp-level MMAs: m16n8k8
    TF32 with the 3×TF32 split for float32 operands, m16n8k16 bf16 for v2's
    bf16 entry; no product loop on the CUDA cores is left."""
    with open(fik.SOURCE) as f:
        src = f.read()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "cvt.rn.bf16x2.f32" in src
    split = re.search(r"void split_tf32\(.*?\n\}", src, re.S).group(0)
    assert "(__float_as_uint(v) + 0x1000u) & 0xffffe000u" in split    # to nearest, ties away
    assert "v - __uint_as_float(big)) & 0xffffe000u" in split         # the rest, cut
    gemm = re.search(r"void warp_gemm\(.*?\n\}", src, re.S).group(0)
    assert "for (int pass = 0; pass < 3; ++pass)" in gemm   # small·big, big·small, big·big
    assert "mma_tf32(" in gemm and "mma_bf16(" in gemm
    # the expand (output and pool passes), the project and the skip
    assert len(re.findall(r"warp_gemm<BF, L::\w+, L::\w+>\(", src)) == 4
    for gone in ("tile_fma", "expand_region", "fmaf(xa[i]"):
        assert gone not in src
    assert "cp.async.cg.shared.global [%0], [%1], 16" in src


# every IRB of one small-UNet call at 256²: (Cin, Chid, Cout, H)
SMALL_UNET_IRBS = [(32, 128, 32, 256), (96, 384, 32, 256), (32, 128, 64, 128),
                   (64, 256, 64, 128), (192, 768, 64, 128), (64, 256, 128, 64),
                   (128, 512, 128, 64), (384, 1536, 128, 64), (128, 512, 256, 32),
                   (256, 1024, 256, 32), (512, 2048, 256, 32)]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("cin,chid,cout,h", SMALL_UNET_IRBS)
def test_plan_at_the_small_unet_shapes(cin, chid, cout, h, b):
    """At every small-UNet shape the output pass takes its output width's
    tile and chunk, its hidden groups cover every chunk once with none
    empty, and the pool pass's blocks cover every 64-channel chunk once,
    at most four on one staged x̂."""
    pl = fik.plan(b, chid, cout, h, h)
    co_pad = min(c for c in fik.OUT_TILES if c >= cout)
    assert (pl.tile_h, pl.tile_w, pl.chunk) == fik.OUT_TILES[co_pad]
    chunks = math.ceil(chid / pl.chunk)
    groups = [range(g * pl.chunks_per_group, min(chunks, (g + 1) * pl.chunks_per_group))
              for g in range(pl.groups)]
    assert all(groups) and sum(len(r) for r in groups) == chunks
    tiles = math.ceil(h / pl.tile_h) * math.ceil(h / pl.tile_w)
    assert pl.groups == 1 or tiles * b * pl.groups <= 2 * fik._OUT_BLOCKS
    pchunks = math.ceil(chid / fik.POOL_CHUNK)
    assert 1 <= pl.pool_chunks <= fik.POOL_CHUNKS
    blocks = [range(k * pl.pool_chunks, min(pchunks, (k + 1) * pl.pool_chunks))
              for k in range(math.ceil(pchunks / pl.pool_chunks))]
    assert all(blocks) and sum(len(r) for r in blocks) == pchunks
    pool_tiles = math.ceil(h / fik.POOL_TILE[0]) * math.ceil(h / fik.POOL_TILE[1])
    assert 1 <= pl.pool_groups <= pool_tiles
