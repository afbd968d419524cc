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
  and the plain versions give the same values as on the unpadded operands;
- a numpy model of the activation quantize's blocks (``quantize_kernel``: a
  warp a tile of one 32-channel slab × 32 pixels; each lane's channels and
  pixels, its 16-byte or element loads, its stores) writes every output
  byte once and equals ``quantize_plain`` at the edge shapes (rows that are
  not 16-byte aligned, C < Cp, ragged tiles), and at the 83 QConv inputs at
  batch 1 and 8 the warps' tiles and a tile's lanes cover the output once;
- a numpy model of the weight pass's blocks (``quantize_weight_kernel``: a
  block an output channel or a warp a 32-channel slab, the row's max, the
  layout written in words) equals ``quantize_weight`` and the layouts at
  the 83 QConvs' weights and the edge weights, an all-zero channel and
  exact halves included;
- the weight wrapper on the CPU is the plain chain, and ``QConv``'s int8
  path goes through it; the quantize kernels' constants and C signatures
  are the Python side's.
"""

import math
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cv_diffusion_tpu_torch.config import load_model_config
from cv_diffusion_tpu_torch.export.quantization import act_quant_model, qconv_modules
from cv_diffusion_tpu_torch.ops import qconv as tq
from cv_diffusion_tpu_torch.ops import qconv_kernel as qk
from cv_diffusion_tpu_torch.ops.qconv import QConv

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


# --- the two quantize kernels: the activations' and the weight pass ----------

# a quantize tile's channels: one 32-byte run of a pixel
SLAB = tq.CHANNEL_MULTIPLE
# an output channel whose absmax is 127 (s_w = 1): the rest land on halves
HALVES = (127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5, -125.5)


def q_np(v: np.ndarray, s) -> np.ndarray:
    """``clip(rint(v / s), -127, 127)`` in float32, as int8."""
    return np.clip(np.rint(v.astype(np.float32) / np.float32(s)), -127, 127).astype(np.int8)


def warp_units(plan):
    """(unit, lane) of every lane of the grid whose warp has a unit:
    warp w of block b takes unit 4b + w."""
    warps = plan.grid * (qk.QUANTIZE_THREADS // 32)
    unit = np.repeat(np.arange(warps), 32)
    lane = np.tile(np.arange(32), warps)
    keep = unit < plan.units
    return unit[keep], lane[keep]


def lane_tile(plan, n, cp, unit, lane):
    """The source's unit → (image, slab, chunk), then each lane's first
    channel c0 and first pixel p0: S = 32 / LC lanes share a pixel's
    32-byte sector."""
    slabs = cp // SLAB
    chunk = unit % plan.chunks
    slab = unit // plan.chunks % slabs
    img = unit // plan.chunks // slabs
    assert (img < n).all()
    lc = plan.lane_channels
    sect = SLAB // lc
    c0 = slab * SLAB + lc * (lane % sect)
    p0 = chunk * qk.QUANTIZE_TILE + plan.vec * (lane // sect)
    return img, c0, p0


def quantize_by_blocks(x: torch.Tensor, amax: torch.Tensor, aligned: bool = True):
    """The quantize kernel's output [N, HW, Cp] and each byte's store count,
    as its lanes form them: LC channel rows from c0, V pixels from p0 each
    (one 16-byte load a row where the plan is vectorized, else element by
    element, nothing past C or HW), then V stores of LC channels, one a
    pixel below HW."""
    n, c, h, w = x.shape
    hw, cp = h * w, tq.padded_channels(c)
    plan = qk.quantize_launch(n, c, hw, x.dtype, aligned)
    xs = x.float().reshape(n, c, hw).numpy()
    s = tq.act_scale(amax).numpy()
    out = np.full((n, hw, cp), 99, np.int8)
    stores = np.zeros((n, hw, cp), np.int64)
    unit, lane = warp_units(plan)
    img, c0, p0 = lane_tile(plan, n, cp, unit, lane)
    live = p0 < hw
    img, c0, p0 = img[live], c0[live], p0[live]
    ch = c0[:, None] + np.arange(plan.lane_channels)[None, :]        # [lanes, LC]
    px = p0[:, None] + np.arange(plan.vec)[None, :]                  # [lanes, V]
    loaded = (ch < c)[:, :, None] & (px < hw)[:, None, :]            # [lanes, LC, V]
    if plan.vectorized:   # a 16-byte load: a whole aligned vector of one row
        assert (hw % plan.vec == 0) and (p0 % plan.vec == 0).all()
        assert (loaded == (ch < c)[:, :, None]).all()
    vals = np.zeros(loaded.shape, np.float32)
    idx = np.nonzero(loaded)
    vals[idx] = xs[img[idx[0]], ch[idx[0], idx[1]], px[idx[0], idx[2]]]
    q = q_np(vals, s)
    for j in range(plan.vec):
        ok = px[:, j] < hw
        rows = (img[ok][:, None], px[ok, j][:, None], ch[ok])
        out[rows] = q[ok, :, j]
        np.add.at(stores, rows, 1)
    return out, stores


def quantize_tiles(n, c, hw, dtype):
    """The two levels of the quantize kernel's stores at a shape: the
    warps' tiles (image, 32 channels, QUANTIZE_TILE pixels) cover [N, HW,
    Cp] once, and the 32 lanes of a tile, full or the ragged last, cover it
    once."""
    cp = tq.padded_channels(c)
    plan = qk.quantize_launch(n, c, hw, dtype)
    assert plan.grid * (qk.QUANTIZE_THREADS // 32) >= plan.units > (plan.grid - 1) * (
        qk.QUANTIZE_THREADS // 32)
    units = np.arange(plan.units)
    img, c0, p0 = lane_tile(plan, n, cp, units, np.zeros_like(units))
    tile = qk.QUANTIZE_TILE
    key = (img * (cp // SLAB) + c0 // SLAB) * plan.chunks + p0 // tile
    assert np.array_equal(np.sort(key), units)                        # each tile once
    assert (p0 < hw).all() and (plan.chunks - 1) * tile < hw
    for valid in {tile, hw - (plan.chunks - 1) * tile}:
        lane = np.arange(32)
        _, c0, p0 = lane_tile(plan, 1, SLAB, np.zeros_like(lane), lane)
        cover = np.zeros((valid, SLAB), np.int64)
        for j in range(plan.vec):
            for ln in np.nonzero(p0 + j < valid)[0]:
                cover[p0[ln] + j, c0[ln]:c0[ln] + plan.lane_channels] += 1
        assert (cover == 1).all()
    return plan


def edge_inputs():
    return sorted({(cin, h, w) for _, cin, _, _, _, h, w in EDGES})


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", edge_inputs(), ids=lambda s: "x".join(map(str, s)))
def test_quantize_blocks_at_edge_shapes(shape, batch, dtype):
    """Every output byte stored once and equal to ``quantize_plain``, the
    padding 0; rows whose length is not a multiple of the vector (HW % 4 in
    float32, % 8 in bf16) load element by element, and so does any shape
    whose x does not start on 16 bytes."""
    cin, h, w = shape
    rng = np.random.default_rng(cin * h + w)
    x = torch.from_numpy((rng.standard_normal((batch, cin, h, w)) * 2).astype(np.float32)).to(dtype)
    amax = x.float().abs().amax() * 0.75
    want = tq.quantize_plain(x, amax).reshape(batch, h * w, -1).numpy()
    for aligned in (True, False):
        got, stores = quantize_by_blocks(x, amax, aligned)
        assert (stores == 1).all()
        np.testing.assert_array_equal(got, want)
    assert not want[..., cin:].any()
    plan = qk.quantize_launch(batch, cin, h * w, dtype)
    assert plan.vectorized == (h * w % plan.vec == 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8])
def test_quantize_tiles_cover_every_qconv_input_of_a_small_unet_call(unet_calls, batch, dtype):
    """The 83 inputs (23 shapes) of the small UNet at 256²: the tiles cover
    each output once, all 16-byte rows; B = 8's largest input takes 196,608
    warps, and a batch-1 32² input still spreads over 64 blocks or more."""
    assert len(unet_calls) == 83
    plans = {}
    for _, cin, _, _, _, h, w in unet_calls:
        plans[(cin, h)] = quantize_tiles(batch, cin, h * w, dtype)
        assert plans[(cin, h)].vectorized
    assert plans[(384, 256)].units == batch * 12 * 65536 // qk.QUANTIZE_TILE
    assert plans[(256, 32)].grid >= 64


def test_quantize_blocks_equal_the_plain_version_at_reduced_unet_inputs(unet_calls):
    """The whole model (values and stores) at each of the 23 input shapes'
    channels on an 8 × 8 and a 12 × 12 image, float32 and bf16."""
    rng = np.random.default_rng(3)
    for cin in sorted({c[1] for c in unet_calls}):
        for hw, dtype in ((8, torch.float32), (12, torch.bfloat16)):
            x = torch.from_numpy(rng.standard_normal((2, cin, hw, hw)).astype(np.float32)).to(dtype)
            amax = torch.tensor(1.5)
            got, stores = quantize_by_blocks(x, amax)
            assert (stores == 1).all()
            np.testing.assert_array_equal(
                got, tq.quantize_plain(x, amax).reshape(2, hw * hw, -1).numpy())


def weight_by_blocks(w: np.ndarray, depthwise: bool):
    """The weight kernel's (layout, s_w) and each layout byte's store count,
    as its blocks form them. Dense: block o takes output channel o; its
    threads' max |w| along the row (thread t: elements t + 256k) reduced
    across the block; word i (thread i + 256k) of [K, K, Cp] is tap 4i //
    Cp, channels 4i % Cp .. + 3, each read at row[c · K² + tap] below I and
    0 past it. Depthwise: warp v of block b takes the 32-channel slab 8b +
    v, lane l its channel 32 (8b + v) + l with its 9 weights, tap t stored
    at [t, o]."""
    o, i, k, _ = w.shape
    kk, warps = k * k, qk.WEIGHT_THREADS // 32
    inv, floor = np.float32(tq.INV_127), np.float32(tq.WEIGHT_SCALE_FLOOR)
    if depthwise:
        cp = tq.padded_channels(o)
        out = np.full((9, cp), 99, np.int8)
        stores = np.zeros((9, cp), np.int64)
        s_w = np.full(o, -1.0, np.float32)
        blocks = -(-(cp // SLAB) // warps)
        ch = np.arange(blocks * warps * 32)
        ch = ch[ch < cp]
        v = np.zeros((len(ch), 9), np.float32)
        v[ch < o] = w.reshape(o, 9)[ch[ch < o]]
        s = np.maximum(np.abs(v).max(axis=1) * inv, floor)
        s_w[ch[ch < o]] = s[ch < o]
        for t in range(9):
            out[t, ch] = np.clip(np.rint(v[:, t] / s), -127, 127).astype(np.int8)
            stores[t, ch] += 1
        return out, s_w, stores
    cp = tq.padded_channels(i)
    rows = w.reshape(o, i * kk)
    oo = np.arange(o)                                               # grid O
    threads = np.arange(qk.WEIGHT_THREADS)
    partial = np.zeros((o, qk.WEIGHT_THREADS), np.float32)
    for e0 in range(0, i * kk, qk.WEIGHT_THREADS):
        e = e0 + threads
        ok = e < i * kk
        partial[:, ok] = np.maximum(partial[:, ok], np.abs(rows[:, e[ok]]))
    m = partial.max(axis=1)                          # shuffles, then shared memory
    s = np.maximum(m * inv, floor)
    words = kk * cp // 4
    wi = np.arange(words)
    tap, c = 4 * wi // cp, 4 * wi % cp
    out = np.full((o, kk * cp), 99, np.int8)
    stores = np.zeros((o, kk * cp), np.int64)
    for l in range(4):
        cc = c + l
        ok = cc < i
        val = np.zeros((len(oo), words), np.float32)
        val[:, ok] = rows[oo][:, cc[ok] * kk + tap[ok]]
        q = np.clip(np.rint(val / s[:, None]), -127, 127).astype(np.int8)
        q[:, ~ok] = 0
        out[oo[:, None], (4 * wi + l)[None, :]] = q
        stores[oo[:, None], (4 * wi + l)[None, :]] += 1
    return out.reshape(o, k, k, cp), s.astype(np.float32), stores


def check_weight(w: np.ndarray, depthwise: bool):
    wt = torch.from_numpy(w)
    wq, s_w = tq.quantize_weight(wt)
    want = (tq.depthwise_weight_layout if depthwise else tq.dense_weight_layout)(wq)
    got, got_s, stores = weight_by_blocks(w, depthwise)
    assert (stores == 1).all()
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got_s, s_w.numpy())
    return want


def special_weight(rng, o, i, k):
    """Random weights with output channel 0 all zero (s_w = 1e-12, every
    value 0) and channel 1's first values ``HALVES``."""
    w = (rng.standard_normal((o, i, k, k)) * 0.05).astype(np.float32)
    w[0] = 0.0
    if o > 1:
        flat = w[1].reshape(-1)
        flat[:min(len(HALVES), flat.size)] = HALVES[:flat.size]
    return w


@pytest.mark.parametrize("kind", ["dense", "depthwise"])
def test_weight_blocks_at_every_qconv_weight_of_a_small_unet(unet_calls, kind):
    """The 83 QConvs' weight shapes (61 dense, 22 depthwise), each with a
    zero channel and a channel of exact halves."""
    rng = np.random.default_rng(17)
    calls = [c for c in unet_calls if c[0] == (kind == "depthwise")]
    assert len(calls) == {"dense": 61, "depthwise": 22}[kind]
    for dw, cin, cout, k, *_ in calls:
        want = check_weight(special_weight(rng, cout, 1 if dw else cin, k), dw)
        assert not (want[:, 0] if dw else want[0]).any()


@pytest.mark.parametrize("edge", EDGES, ids=[f"{'dw' if e[0] else 'dense'}{e[1:]}" for e in EDGES])
def test_weight_blocks_at_edge_shapes(edge):
    dw, cin, cout, k = edge[:4]
    rng = np.random.default_rng(cin + cout)
    check_weight(special_weight(rng, cout, 1 if dw else cin, k), dw)


def test_weight_halves_round_to_even_and_a_zero_channel_takes_the_floor():
    """Output channel 0 all zero: s_w = float32(1e-12) and every value 0;
    channel 1's taps ``HALVES`` over s_w = 1 round half to even; the wrapper
    and the blocks' model agree, dense and depthwise."""
    w = special_weight(np.random.default_rng(0), 4, 6, 3)
    for dw, wt in ((False, w), (True, np.ascontiguousarray(w[:, :1]))):
        wl, s_w = qk.quantize_weight(torch.from_numpy(wt), dw)
        assert float(s_w[0]) == np.float32(1e-12) and float(s_w[1]) == 1.0
        taps = wl[:, 1] if dw else wl[1, :, :, 0].reshape(9)
        zero = wl[:, 0] if dw else wl[0]
        assert taps.tolist() == [127, 2, -4, 0, 0, 2, -2, 126, -126] and not zero.any()
        got, got_s, _ = weight_by_blocks(wt, dw)
        np.testing.assert_array_equal(got, wl.numpy())
        np.testing.assert_array_equal(got_s, s_w.numpy())


def test_weight_wrapper_on_the_cpu_is_the_plain_chain():
    """On CPU tensors the wrapper runs ``quantize_weight`` and the layout
    (float64 kept), counts nothing, and refuses a device without a kernel."""
    before = qk.quantize_weight.launches
    g = torch.Generator().manual_seed(5)
    for shape, dw in (((8, 6, 3, 3), False), ((3, 40, 1, 1), False), ((12, 1, 3, 3), True)):
        for dtype in (torch.float32, torch.float64):
            w = torch.randn(shape, generator=g, dtype=dtype)
            wl, s_w = qk.quantize_weight(w, dw)
            wq, want_s = tq.quantize_weight(w)
            want = (tq.depthwise_weight_layout if dw else tq.dense_weight_layout)(wq)
            assert torch.equal(wl, want) and torch.equal(s_w, want_s) and s_w.dtype == dtype
    assert qk.quantize_weight.launches == before
    with pytest.raises(ValueError, match="no quantize_weight kernel"):
        qk.quantize_weight(torch.zeros(3, 6, 3, 3, device="meta"), False)


def test_qconv_int8_path_takes_the_weight_wrapper(monkeypatch):
    """``QConv._int8_conv`` quantizes its weight through
    ``qconv_kernel.quantize_weight`` (one call a forward, no switch) and its
    output is the chain's."""
    g = torch.Generator().manual_seed(2)
    calls = []
    real = qk.quantize_weight
    monkeypatch.setattr(qk, "quantize_weight",
                        lambda w, dw: calls.append((tuple(w.shape), dw)) or real(w, dw))
    for dense in (True, False):
        conv = (QConv(6, 5, 3, padding=1, act_quant=True) if dense
                else QConv(6, 6, 3, padding=1, groups=6, act_quant=True))
        conv.set_amax(2.0)
        x = torch.randn(2, 6, 7, 5, generator=g)
        y = conv(x)
        wq, s_w = tq.quantize_weight(conv.weight)
        xq = tq.quantize_plain(x, conv.amax)
        want = (tq.int8_conv_plain(xq, tq.dense_weight_layout(wq), conv.amax, s_w,
                                   conv.bias.detach(), 1, 1, torch.float32) if dense
                else tq.int8_depthwise_plain(xq, tq.depthwise_weight_layout(wq), 6, conv.amax,
                                             s_w, conv.bias.detach(), 1, torch.float32))
        assert torch.equal(y, want)
    assert calls == [((5, 6, 3, 3), False), ((6, 1, 3, 3), True)]


def test_the_source_quantizes_as_the_python_side_plans():
    """The quantize kernels' constants, C signatures and arithmetic are the
    ones the wrapper, the plan and the plain versions assume."""
    src = open(qk.SOURCE).read()

    def const(name):
        return re.search(rf"constexpr (?:int|float) {name} = ([^;]+);", src).group(1)

    assert int(const("kQuantizeThreads")) == qk.QUANTIZE_THREADS
    assert int(const("kQuantizeLaneElems")) == qk.QUANTIZE_LANE_ELEMS
    assert const("kQuantizeTile") == "kQuantizeLaneElems" and qk.QUANTIZE_TILE == qk.QUANTIZE_LANE_ELEMS
    assert int(const("kWeightThreads")) == qk.WEIGHT_THREADS
    assert float(const("kWeightFloor").rstrip("f")) == tq.WEIGHT_SCALE_FLOOR
    assert float(const("kActFloor").rstrip("f")) == tq.ACT_SCALE_FLOOR
    assert "constexpr int V = 16 / static_cast<int>(sizeof(T));" in src
    assert ("constexpr int LC = kQuantizeLaneElems / V, S = kChannelMultiple / LC;" in src)
    for dt in ("f32", "bf16"):
        assert (f"int qconv_quantize_{dt}(const void* x, const void* amax, void* out, int N, "
                "int C, int HW, int Cp,") in src
    assert re.search(r"int qconv_quantize_weight_f32\(const void\* w, void\* s_w, void\* out, "
                     r"int O, int I, int K, int Cp,\s+int depthwise, void\* stream\)", src)
    # IEEE division, half to even, the clamp: as the plain versions; a zero
    # (which the plain version takes to 0 too) is not divided
    assert "rintf(__fdiv_rn(x == 0.0f ? s : x, s))" in src and "-127.0f), 127.0f)" in src
    assert "return x == 0.0f ? 0 : static_cast<signed char>(__float2int_rn(q));" in src
    zeros = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 3.0])
    assert tq.quantize_plain(zeros.reshape(1, 5, 1, 1), torch.tensor(3.0))[0, 0, 0, :5].tolist() \
        == [0, 0, 0, 0, 127]
    assert "__fmul_rn(m, kInv127), kWeightFloor)" in src
    # the transpose in registers: no shared-memory tile in the quantize section
    section = src[src.index("// --- the quantize entries"):src.index("// The weights of one QConv")]
    assert "__shared__" not in section and "__byte_perm" in section
    for dtype in DTYPES:
        plan = qk.quantize_launch(1, 6, 65536, dtype)
        assert plan.vec * torch.tensor([], dtype=dtype).element_size() == 16
        assert plan.vec * plan.lane_channels == qk.QUANTIZE_LANE_ELEMS
        # the lanes of a warp: 32 channels x QUANTIZE_TILE pixels
        assert 32 * qk.QUANTIZE_LANE_ELEMS == SLAB * qk.QUANTIZE_TILE
