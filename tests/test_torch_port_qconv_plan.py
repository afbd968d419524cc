"""The int8 kernels' launch plans and layouts, checked on the CPU.

``csrc/qconv.cu`` runs the dense int8 convolution as an implicit GEMM on
the tensor cores, tiled per shape by ``ops/qconv_kernel.py::plan_dense``,
and the depthwise one in bands of output rows staged in shared memory
(``plan_depthwise``). They run only on the card, where ``chip_smoke.py``
holds them against their plain versions. Here, on the CPU:

- every plan at the 83 ``QConv`` calls of the small UNet at 256² and at
  edge shapes (ragged M, O = 3, Cin = 6, stride 2 on odd H and W, batch 1
  and 8) covers the output once and K, and fits the shared memory it
  declares;
- a numpy model of the dense kernel's blocks (each K step, each 16-byte
  chunk's tap and channel, the zero fill of the padding and past K) equals
  the plain version bit for bit;
- a numpy model of the depthwise kernel's blocks (the band's input staged
  with its halo in rotated slots, each quad's window of input words, the
  stores of each column tile) writes each output once and equals the plain
  version bit for bit, outputs wider than one column tile included;
- the layouts padded to ``CHANNEL_MULTIPLE`` hold zeros in their padding,
  and the plain versions give the same values as on the unpadded operands.
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cv_diffusion_tpu_torch.config import load_model_config
from cv_diffusion_tpu_torch.export.quantization import act_quant_model, qconv_modules
from cv_diffusion_tpu_torch.ops import qconv as tq
from cv_diffusion_tpu_torch.ops import qconv_kernel as qk

DTYPES = (torch.float32, torch.bfloat16)
# (depthwise, Cin, Cout, kernel, stride, H, W): ragged M, O = 3, Cin = 6,
# stride 2 on odd H and W, channels that are not a multiple of 32, outputs
# wider than a depthwise column tile (as chip_smoke.py's INT8_EDGES)
EDGES = ((False, 6, 3, 3, 1, 37, 29), (False, 6, 32, 3, 2, 33, 19),
         (False, 100, 70, 3, 2, 17, 9), (False, 40, 3, 1, 1, 13, 7),
         (False, 2048, 256, 1, 1, 5, 3), (False, 300, 136, 3, 1, 11, 11),
         (True, 12, 12, 3, 1, 9, 7), (True, 40, 40, 3, 2, 17, 9),
         (True, 100, 100, 3, 2, 33, 31), (True, 2048, 2048, 3, 1, 5, 3),
         (True, 32, 32, 3, 1, 5, 300), (True, 40, 40, 3, 2, 7, 601),
         (False, 32, 48, 3, 1, 5, 300))


@pytest.fixture(scope="module")
def unet_calls():
    """(depthwise, Cin, Cout, kernel, stride, H, W) of each of the 83
    QConv calls of one small-UNet call at 256², in call order."""
    cfg = load_model_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "artifacts", "vreg1b_gt03_ema", "model_config.json"))
    model, _ = act_quant_model(cfg, "cpu")
    calls = []

    def hook(mod, args):
        calls.append((mod.depthwise, mod.in_channels, mod.out_channels, mod.kernel_size[0],
                      mod.stride[0], args[0].shape[2], args[0].shape[3]))

    for m in qconv_modules(model).values():
        m.act_quant = False         # the float path: only the shapes are wanted
        m.register_forward_pre_hook(hook)
    size = cfg.unet.image_size
    with torch.inference_mode():
        model.unet(torch.zeros(1, cfg.unet.in_channels, size, size),
                   torch.tensor([739], dtype=torch.int32))
    return calls


def check_dense_plan(n, cin, cout, k, stride, h, w, dtype):
    cp = tq.padded_channels(cin)
    p = qk.plan_dense(n, h, w, cp, cout, k, stride, k // 2, dtype)
    bm, bn, wm, wn = qk.DENSE_TILES[p.tile]
    oh, ow = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    m = n * oh * ow
    # the tiles cover the output once, the K steps cover K
    assert (p.bm, p.bn) == (bm, bn) and p.grid == (-(-m // bm), -(-cout // bn))
    assert (p.grid[0] - 1) * bm < m <= p.grid[0] * bm
    assert (p.grid[1] - 1) * bn < cout <= p.grid[1] * bn
    assert (p.steps - 1) * qk.BK < k * k * cp <= p.steps * qk.BK
    # warps, loader and shared memory as the source lays them out
    assert p.threads == 32 * wm * wn and bm % (16 * wm) == 0 and bn % (8 * wn) == 0
    assert (4 * bm) % p.threads == 0 and (4 * bn) % p.threads == 0
    es = torch.tensor([], dtype=dtype).element_size()
    assert p.smem_bytes == max(qk.STAGES * (bm + bn) * qk.BK, bn * (bm + 16 // es) * es)
    assert p.smem_bytes <= qk.SMEM_MAX
    return p


def check_depthwise_plan(n, c, stride, h, w):
    cp = tq.padded_channels(c)
    p = qk.plan_depthwise(n, h, w, cp, stride)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    # bands of rows and columns cover the output once; slabs cover Cp
    assert (p.grid[1] - 1) * p.rows < oh <= p.grid[1] * p.rows
    assert (p.grid[0] - 1) * p.cols < ow <= p.grid[0] * p.cols
    assert p.grid[2] == n * cp // qk.SLAB and cp % qk.SLAB == 0
    assert 1 <= p.cols <= qk.DW_MAX_COLS and 1 <= p.rows <= qk.DW_MAX_ROWS
    assert p.cols == ow or p.cols % 4 == 0    # a quad's pixels on one output row
    # the staged columns hold every quad's window: its 4 pixels and the halo
    quads = -(-p.cols // 4)
    in_cols = p.smem_bytes // (((p.rows - 1) * stride + 3) * qk.SLAB)
    assert in_cols % 4 == 0 and (4 * quads - 1) * stride + 2 < in_cols
    assert p.smem_bytes == ((p.rows - 1) * stride + 3) * in_cols * qk.SLAB
    assert p.smem_bytes <= qk.DW_SMEM_MAX
    return p


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8])
def test_plans_cover_every_qconv_of_a_small_unet_call(unet_calls, batch, dtype):
    """All 83 calls (61 dense, 22 depthwise) of the small UNet at 256²: the
    output tiled once, the shared memory within bounds; a wave of blocks
    where the shape allows one, the big calls in the big tile."""
    assert len(unet_calls) == 83 and sum(c[0] for c in unet_calls) == 22
    plans = {}
    for dw, cin, cout, k, stride, h, w in unet_calls:
        if dw:
            assert cin == cout and k == 3
            plans[(dw, cin, cout, k, stride, h)] = check_depthwise_plan(batch, cin, stride, h, w)
        else:
            plans[(dw, cin, cout, k, stride, h)] = check_dense_plan(batch, cin, cout, k, stride, h,
                                                                    w, dtype)
    assert plans[(False, 32, 128, 1, 1, 256)].tile == 0
    assert plans[(False, 128, 32, 1, 1, 256)].tile == 3
    for key, p in plans.items():
        if not key[0]:
            assert math.prod(p.grid) >= qk.SMS or p.tile in (2, 3)
        else:
            assert 2 * math.prod(p.grid) >= 3 * qk.SMS or p.rows == 1
            assert p.rows & (p.rows - 1) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("edge", EDGES, ids=[f"{'dw' if e[0] else 'dense'}{e[1:]}" for e in EDGES])
def test_plans_at_edge_shapes(edge, batch, dtype):
    dw, cin, cout, k, stride, h, w = edge
    if dw:
        check_depthwise_plan(batch, cin, stride, h, w)
    else:
        check_dense_plan(batch, cin, cout, k, stride, h, w, dtype)


def dense_by_blocks(xq: np.ndarray, wq: np.ndarray, plan, stride: int, pad: int) -> np.ndarray:
    """The dense kernel's int32 sums [M, O] as its blocks form them: each
    tile takes its K steps; within a step each 16-byte chunk k reads tap
    k // Cp, channels k % Cp .. + 15, of every pixel row (zero where the tap
    falls in the padding, past K, or past the last pixel) and of every
    output channel row (zero past O or K)."""
    n, h, w, cp = xq.shape
    o, ks = wq.shape[0], wq.shape[1]
    oh, ow = (h + 2 * pad - ks) // stride + 1, (w + 2 * pad - ks) // stride + 1
    ktot = ks * ks * cp
    m_all = n * oh * ow
    acc = np.zeros((plan.grid[0] * plan.bm, plan.grid[1] * plan.bn), np.int32)
    m = np.arange(plan.grid[0] * plan.bm)
    img, pix = m // (oh * ow), m % (oh * ow)
    ih0, iw0 = (pix // ow) * stride - pad, (pix % ow) * stride - pad
    wflat = wq.reshape(o, ktot)
    for kt in range(plan.steps):
        for chunk in range(qk.BK // 16):
            k = kt * qk.BK + 16 * chunk
            if k >= ktot:
                continue
            tap, c = divmod(k, cp)
            kh, kw = divmod(tap, ks)
            ih, iw = ih0 + kh, iw0 + kw
            ok = (m < m_all) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
            a = np.zeros((len(m), 16), np.int32)
            a[ok] = xq[img[ok], ih[ok], iw[ok], c:c + 16]
            b = np.zeros((acc.shape[1], 16), np.int32)
            b[:o] = wflat[:, k:k + 16]
            acc += a @ b.T
    return acc[:m_all, :o]


@pytest.mark.parametrize("case", [
    (1, 64, 40, 5, 5, 3, 1),      # 3x3, O not a multiple of the tile
    (2, 6, 3, 9, 7, 3, 1),        # Cin 6 padded to 32, O = 3
    (1, 40, 70, 9, 9, 3, 2),      # stride 2 on odd H and W
    (1, 512, 64, 4, 4, 1, 1),     # 1x1, eight K steps
    (2, 96, 130, 8, 8, 1, 1),     # K = 96: a last step half past K
], ids=["3x3", "cin6_o3", "s2_odd", "1x1_k512", "k96"])
def test_dense_blocks_sum_what_the_plain_version_sums(case):
    n, cin, cout, h, w, k, stride = case
    g = torch.Generator().manual_seed(sum(case))
    xq = tq.quantize_plain(torch.randn(n, cin, h, w, generator=g) * 2, torch.tensor(3.0))
    wq, _ = tq.quantize_weight(torch.randn(cout, cin, k, k, generator=g))
    wl = tq.dense_weight_layout(wq)
    plan = qk.plan_dense(n, h, w, xq.shape[-1], cout, k, stride, k // 2, torch.float32)
    got = dense_by_blocks(xq.numpy(), wl.numpy(), plan, stride, k // 2)
    want = tq.int8_acc_plain(xq, wl, stride, k // 2)
    np.testing.assert_array_equal(got, want.permute(0, 2, 3, 1).reshape(got.shape).numpy())


def dw_slot(p: np.ndarray) -> np.ndarray:
    """The source's slot of staged pixel p in its row (``dw_slot``)."""
    return (p & ~3) | ((p + (p >> 2)) & 3)


def depthwise_by_blocks(xq: np.ndarray, wl: np.ndarray, plan, stride: int):
    """The depthwise kernel's int32 sums [N, Cp, OH, OW] as its blocks form
    them, and how often each output was stored: each block stages its
    band's input rows and columns (from one pixel before its first output
    column and row, times the stride; zero outside the image) in rotated
    slots, then each quad of 4 output pixels of a row reads its window of
    3·stride + 3 staged pixels a kernel row and stores the pixels that lie
    in the block's columns and in the output."""
    n, h, w, cp = xq.shape
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    rows, cols = plan.rows, plan.cols
    in_rows = (rows - 1) * stride + 3
    in_cols = plan.smem_bytes // (in_rows * qk.SLAB)
    quads, nw = -(-cols // 4), 3 * stride + 3
    out = np.zeros((n, cp, oh, ow), np.int64)
    stores = np.zeros((n, cp, oh, ow), np.int64)
    r, q = np.divmod(np.arange(rows * quads), quads)          # a block's items
    xs = xq.astype(np.int64)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            for z in range(plan.grid[2]):
                b, c0 = z // (cp // qk.SLAB), z % (cp // qk.SLAB) * qk.SLAB
                ih = by * rows * stride - 1 + np.arange(in_rows)
                iw = bx * cols * stride - 1 + np.arange(in_cols)
                ok = ((ih >= 0) & (ih < h))[:, None] & ((iw >= 0) & (iw < w))[None, :]
                staged = np.zeros((in_rows, in_cols, qk.SLAB), np.int64)
                src = xs[b][np.clip(ih, 0, h - 1)][:, np.clip(iw, 0, w - 1), c0:c0 + qk.SLAB]
                staged[:, dw_slot(np.arange(in_cols))] = np.where(ok[..., None], src, 0)
                acc = np.zeros((len(r), 4, qk.SLAB), np.int64)
                for kh in range(3):
                    win = staged[(r * stride + kh)[:, None],
                                 dw_slot(4 * q[:, None] * stride + np.arange(nw)[None, :])]
                    for j in range(4):
                        for kw in range(3):
                            acc[:, j] += win[:, j * stride + kw] * wl[kh * 3 + kw, c0:c0 + qk.SLAB]
                for j in range(4):
                    o_h, o_w = by * rows + r, bx * cols + 4 * q + j
                    keep = (o_h < oh) & (4 * q + j < cols) & (o_w < ow)
                    out[b, c0:c0 + qk.SLAB, o_h[keep], o_w[keep]] = acc[keep, j]
                    stores[b, c0:c0 + qk.SLAB, o_h[keep], o_w[keep]] += 1
    return out, stores


@pytest.mark.parametrize("case", [
    (1, 12, 9, 7, 1, None),           # one block, a ragged quad
    (2, 40, 17, 9, 2, None),          # stride 2 on odd H and W, two slabs
    (8, 64, 40, 40, 1, None),         # bands of two rows
    (1, 32, 5, 300, 1, None),         # two column tiles of DW_MAX_COLS
    (1, 40, 7, 601, 2, None),         # two column tiles at stride 2
    (1, 12, 9, 30, 1, (4, 8)),        # ragged bands and column tiles
    (1, 12, 10, 33, 2, (2, 8)),       # the same at stride 2
], ids=["one_block", "s2_odd", "bands", "wide", "wide_s2", "tiles", "tiles_s2"])
def test_depthwise_blocks_sum_what_the_plain_version_sums(case):
    n, c, h, w, stride, launch = case
    g = torch.Generator().manual_seed(sum(case[:5]))
    xq = tq.quantize_plain(torch.randn(n, c, h, w, generator=g) * 2, torch.tensor(3.0))
    wd, _ = tq.quantize_weight(torch.randn(c, 1, 3, 3, generator=g))
    wl = tq.depthwise_weight_layout(wd)
    cp = xq.shape[-1]
    plan = (qk.plan_depthwise(n, h, w, cp, stride) if launch is None
            else qk.depthwise_launch(n, h, w, cp, stride, *launch))
    if launch is None and w > qk.DW_MAX_COLS:
        assert plan.grid[0] > 1 and plan.cols == qk.DW_MAX_COLS
    got, stores = depthwise_by_blocks(xq.numpy(), wl.numpy(), plan, stride)
    assert (stores == 1).all()
    want = tq.int8_depthwise_acc_plain(xq, wl, c, stride)
    np.testing.assert_array_equal(got[:, :c], want.numpy())
    assert not got[:, c:].any()


@pytest.mark.parametrize("c", [3, 6, 12, 32, 40, 100])
def test_layouts_pad_with_zeros_and_the_plain_versions_keep_their_values(c):
    """Under ``CHANNEL_MULTIPLE`` (32) the activations, the dense and the
    depthwise weights are padded with zeros, and the plain versions give
    what they give on the unpadded int8 operands (a float64 convolution of
    the same values, then the epilogue)."""
    assert tq.CHANNEL_MULTIPLE == 32 and tq.padded_channels(c) == -(-c // 32) * 32
    g = torch.Generator().manual_seed(c)
    x = torch.randn(2, c, 7, 6, generator=g) * 2
    amax = torch.tensor(2.5)
    xq = tq.quantize_plain(x, amax)
    cp = xq.shape[-1]
    assert cp == tq.padded_channels(c) and not bool(xq[..., c:].any())
    wq, s_w = tq.quantize_weight(torch.randn(5, c, 3, 3, generator=g))
    wl = tq.dense_weight_layout(wq)
    assert wl.shape == (5, 3, 3, cp) and not bool(wl[..., c:].any())
    bias = torch.randn(5, generator=g)
    for stride in (1, 2):
        exact = F.conv2d(xq[..., :c].permute(0, 3, 1, 2).double(), wq.double(), stride=stride,
                         padding=1).to(torch.int32)
        assert torch.equal(tq.int8_acc_plain(xq, wl, stride, 1), exact)
        assert torch.equal(tq.int8_conv_plain(xq, wl, amax, s_w, bias, stride, 1, torch.float32),
                           tq._epilogue(exact, amax, s_w, bias, torch.float32))
    wd, s_d = tq.quantize_weight(torch.randn(c, 1, 3, 3, generator=g))
    dl = tq.depthwise_weight_layout(wd)
    assert dl.shape == (9, cp) and not bool(dl[:, c:].any())
    for stride in (1, 2):
        exact = F.conv2d(xq[..., :c].permute(0, 3, 1, 2).double(), wd.double(), stride=stride,
                         padding=1, groups=c).to(torch.int32)
        assert torch.equal(tq.int8_depthwise_acc_plain(xq, dl, c, stride), exact)
        got = tq.int8_depthwise_plain(xq, dl, c, amax, s_d, None, stride, torch.bfloat16)
        assert torch.equal(got, tq._epilogue(exact, amax, s_d, None, torch.bfloat16))


def test_the_source_runs_the_products_on_the_tensor_cores():
    """The dense entry multiplies with mma.sync m16n8k32 s8 fed by ldmatrix
    and loads by 16-byte cp.async; nothing in the file uses __dp4a; the
    tiles and constants are the wrapper's."""
    src = open(qk.SOURCE).read()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in src
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in src
    assert "__dp4a" not in src
    for t, (bm, bn, wm, wn) in enumerate(qk.DENSE_TILES):
        assert f"using Tile{t} = DenseTile<{bm}, {bn}, {wm}, {wn}>;" in src
    assert f"constexpr int kBK = {qk.BK};" in src and f"constexpr int kStages = {qk.STAGES};" in src
    assert f"constexpr int kSlab = {qk.SLAB};" in src
    assert f"constexpr int kChannelMultiple = {tq.CHANNEL_MULTIPLE};" in src
