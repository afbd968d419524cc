"""A float32 model of the flash-attention backward kernels' arithmetic, on
the CPU.

The dK/dV and dQ kernels (``csrc/flash_attention.cu``) run on the tensor
cores, which this machine does not have, so their arithmetic is modelled
here step by step and held to the plain version
(``softmax_attention_backward_rows``) at the card's own gate
(``chip_smoke.flash_limit``). The model follows the source: each warp walks
the other side 16 columns (a chunk) at a time, a split block's warps take
every split-th chunk and their partial sums are added in warp order; P =
exp2(S * scale * log2(e) - lse * log2(e)) and dS = (dP - di) * P * scale are
formed in float32; in bf16, P and dS are rounded to bf16 (to nearest even)
before their products and each ``mma`` adds its 16 products into the
accumulator; in float32 every product is 3xTF32 (``split_tf32``: big
rounded to 10 mantissa bits, ties away from zero, small = x - big cut toward
zero; small.big + big.small + big.big), and a chunk's products are summed
apart before one float32 add into the accumulator. The dQ kernel also forms
di (a quad's four lanes each sum a quarter of the row, then two butterfly
adds). A product's own sum is taken in float64 and rounded once: the
tensor cores' internal order is not modelled. The kernels themselves are
held to the plain versions on the card by ``chip_smoke.py`` (phase 22).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from cv_diffusion_tpu_torch.ops import flash_attention_kernel as fk
from cv_diffusion_tpu_torch.ops.attention import (
    row_dot, softmax_attention_backward_rows, softmax_attention_plain)

CHUNK = 16                # columns of S a warp forms at a time (kChunk)
SPLITS = (1, 2, 4)        # warps on the same 16 rows the source takes
LOG2E = np.float32(1.4426950408889634)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def cols(dtype, d):
    """Rows of a staged tile of the other side (the source's ``bcols``)."""
    return 32 if dtype == torch.float32 and d == 128 else 64


def split_tf32(x: np.ndarray):
    """(big, small) of float32 x as the source's ``split_tf32``."""
    x = np.asarray(x, np.float32)
    big = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    small = ((x - big).view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    return big, small


def bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even), kept as float32."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float().numpy()


def product(a, b, tf32: bool) -> np.ndarray:
    """a @ b^T over the last axis ([..., M, K] by [..., N, K]) as the tensor
    cores take it: bf16 values exactly, or 3xTF32; summed in float64,
    returned unrounded."""
    if not tf32:
        return np.einsum("...mk,...nk->...mn", a.astype(np.float64), b.astype(np.float64))
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    f = lambda x, y: np.einsum("...mk,...nk->...mn", x.astype(np.float64),  # noqa: E731
                               y.astype(np.float64))
    return f(as_, bb) + f(ab, bs) + f(ab, bb)


def add(acc, x):
    """acc + x rounded once to float32."""
    return (acc.astype(np.float64) + x).astype(np.float32)


def model_side(rows_a, rows_b, cols_a, cols_b, lse, di, scale, tf32, split, keys_are_rows):
    """One kernel's walk for all its blocks at once: rows_a, rows_b the
    block's own rows (k, v in dK/dV; q, dO in dQ), cols_a, cols_b the other
    side's (q, dO; k, v), all [B, H, N, D] float32 values; lse, di [B, H, N]
    of the queries. Returns the accumulators: (dK, dV) or (dQ,)."""
    n = rows_a.shape[2]
    c = np.float32(np.float32(scale) * LOG2E)
    lrow = (lse * LOG2E).astype(np.float32)
    accs = [[np.zeros(rows_a.shape, np.float32) for _ in range(split)]
            for _ in range(2 if keys_are_rows else 1)]
    for j in range(0, n, CHUNK):
        part, sl = (j // CHUNK) % split, slice(j, min(j + CHUNK, n))
        ca, cb = cols_a[:, :, sl], cols_b[:, :, sl]
        s = product(rows_a, ca, tf32).astype(np.float32)      # [B, H, rows, chunk]
        dp = product(rows_b, cb, tf32).astype(np.float32)
        if keys_are_rows:       # the chunk's columns are queries
            lq, dq_ = lrow[:, :, None, sl], di[:, :, None, sl]
        else:                   # the rows are queries
            lq, dq_ = lrow[:, :, :, None], di[:, :, :, None]
        arg = (s.astype(np.float64) * c - lq.astype(np.float64)).astype(np.float32)
        p = np.exp2(arg).astype(np.float32)
        ds = (((dp - dq_).astype(np.float32) * p).astype(np.float32) * np.float32(scale)
              ).astype(np.float32)
        pairs = ((ds, ca), (p, cb)) if keys_are_rows else ((ds, ca),)   # dK, dV; dQ
        for acc, (w, x) in zip(accs, pairs):
            xt = np.swapaxes(x, -1, -2)                         # [B, H, D, chunk]
            if tf32:
                acc[part] = add(acc[part], product(w, xt, True))
            else:
                acc[part] = add(acc[part], product(bf16(w), xt, False))
    out = []
    for acc in accs:
        total = acc[0]
        for p in range(1, split):
            total = add(total, acc[p].astype(np.float64))
        out.append(total)
    return out


def model_di(o, do):
    """di as the dQ kernel forms it: four sequential quarter sums of
    fused multiply-adds, then (s0 + s1) + (s2 + s3)."""
    d = o.shape[-1]
    quarters = []
    for t in range(4):
        acc = np.zeros(o.shape[:-1], np.float32)
        for e in range(t * d // 4, (t + 1) * d // 4):
            acc = add(acc, o[..., e].astype(np.float64) * do[..., e].astype(np.float64))
        quarters.append(acc)
    return ((quarters[0] + quarters[1]).astype(np.float32)
            + (quarters[2] + quarters[3]).astype(np.float32)).astype(np.float32)


def model_backward(q, k, v, do, out, lse, scale, split):
    """(dq, dk, dv, di) of the two kernels' model, the dQ kernel first (it
    forms di), from [B, N, H, D] tensors of one dtype."""
    tf32 = q.dtype == torch.float32
    bhnd = lambda t: t.float().transpose(1, 2).contiguous().numpy()   # noqa: E731
    qn, kn, vn, don, on = map(bhnd, (q, k, v, do, out))
    lse_n = lse.float().numpy()
    di = model_di(on, don)
    (dq,) = model_side(qn, don, kn, vn, lse_n, di, scale, tf32, split, keys_are_rows=False)
    dk, dv = model_side(kn, vn, qn, don, lse_n, di, scale, tf32, split, keys_are_rows=True)
    back = lambda a: torch.from_numpy(a).transpose(1, 2).to(q.dtype)   # noqa: E731
    return back(dq), back(dk), back(dv), torch.from_numpy(di)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(4)]


def test_model_follows_the_source():
    """The constants the model takes from the source: 16-column chunks,
    staged tiles of 64 rows (32 in f32 at D = 128), splits of 1, 2 or 4, and
    the split and rounding instructions it models."""
    src = open(fk.SOURCE).read()
    assert f"constexpr int kChunk = {CHUNK};" in src
    assert "sizeof(T) == 4 && D == 128 ? 32 : 64" in src
    assert "(split != 1 && split != 2 && split != 4)" in src
    assert "big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;" in src
    assert "small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;" in src
    assert "cvt.rn.bf16x2.f32" in src
    assert "exp2f(fmaf(s[nb][i], c, -tl[col] * kLog2e))" in src
    assert "(dp[nb][i] - tdi[col]) * p * scale" in src
    for d in fk.HEAD_DIMS:
        assert CHUNK * max(SPLITS) <= cols(torch.bfloat16, d)


def test_split_tf32_rebuilds_each_value():
    """big + small is within 2^-21 of x, relatively, over magnitudes from
    2^-100 to 2^100 (where small is a normal float too) and at exact ties;
    big has 10 mantissa bits, rounded to nearest with ties away from zero,
    and small is cut toward zero."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * 2.0 ** rng.integers(-100, 100, 200_000)).astype(np.float32)
    # 1 + m 2^-10 + 2^-11 for every 10-bit m, at several exponents: exact ties
    mant = np.arange(1024, dtype=np.uint32) << np.uint32(13) | np.uint32(0x1000)
    ties = np.concatenate([(np.uint32(e << 23) | mant).view(np.float32) for e in (30, 60, 127, 200)])
    x = np.concatenate([x, ties, -ties, np.float32([0.0, 1.0, -3.5])])
    big, small = split_tf32(x)
    assert not (big.view(np.uint32) & np.uint32(0x1fff)).any()
    assert not (small.view(np.uint32) & np.uint32(0x1fff)).any()
    rebuilt = big.astype(np.float64) + small.astype(np.float64)
    assert np.all(np.abs(rebuilt - x) <= 2.0 ** -21 * np.abs(x.astype(np.float64)))
    tb, _ = split_tf32(ties)
    assert np.all(np.abs(tb) > np.abs(ties))                  # ties away from zero
    assert np.all(np.abs(small) <= np.abs(x - big))           # small cut toward zero


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1024, 4, 32), (2, 300, 3, 64)])
def test_model_meets_the_card_gate(shape, dtype, split):
    """The model's dQ, dK, dV against the plain version within
    ``chip_smoke.flash_limit`` (float32: 5e-4; bf16: 4 ulps of each
    reference's largest magnitude), every split the source takes; its di
    within 10x the forward's float32 limit of ``row_dot``; the 3xTF32 model
    within 1e-5 of the float32 plain version."""
    smoke = _smoke()
    name = str(dtype).replace("torch.", "")
    q, k, v, do = _inputs(shape, dtype, 19)
    scale = shape[-1] ** -0.5
    out, lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
    di = row_dot(out, do)
    ref = softmax_attention_backward_rows(q, k, v, do, lse, di, scale)
    *grads, di_model = model_backward(q, k, v, do, out, lse, scale, split)
    assert float((di_model - di).abs().max()) <= 10 * smoke.FLASH_TOL[0]
    for g, r in zip(grads, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        e = float((g.float() - r.float()).abs().max())
        assert e <= smoke.flash_limit(r, name, backward=True)
        if dtype == torch.float32:
            assert e <= 1e-5


def test_the_gate_sees_a_dropped_chunk():
    """A control of the comparison above: in bf16 the model's dV and the
    plain version's agree well inside the gate, and the model with one
    chunk of 16 queries left out is at least twice the gate away."""
    smoke = _smoke()
    shape, scale = (1, 256, 2, 32), 32 ** -0.5
    q, k, v, do = _inputs(shape, torch.bfloat16, 7)
    out, lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
    ref = softmax_attention_backward_rows(q, k, v, do, lse, row_dot(out, do), scale)
    limit = smoke.flash_limit(ref[2], "bfloat16", backward=True)
    dv = model_backward(q, k, v, do, out, lse, scale, 2)[2]
    assert float((dv.float() - ref[2].float()).abs().max()) <= limit / 2
    keep = torch.ones(shape[1], dtype=torch.bool)
    keep[64:64 + CHUNK] = False
    out2, lse2 = softmax_attention_plain(q[:, keep], k, v, scale, return_lse=True)
    dropped = model_backward(q[:, keep], k, v, do[:, keep], out2, lse2, scale, 2)[2]
    assert float((dropped.float() - ref[2].float()).abs().max()) >= 2 * limit
