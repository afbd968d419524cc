"""A float32 model of the flash-attention forward kernel's arithmetic, on the
CPU.

The forward kernel (``csrc/flash_attention.cu``, ``flash_fwd_kernel``) runs
on the tensor cores, which this machine does not have, so its arithmetic is
modelled here step by step and held to the plain version
(``softmax_attention_plain``) at the card's own gate
(``chip_smoke.flash_limit``). The model follows the source: a warp walks
the keys 16 columns (a chunk) at a time, a split block's warps (parts) take
every split-th chunk of each staged tile of 128 keys (64 in f32 at D =
128). S comes from one product (bf16 values exactly, or 3xTF32); keys past
N are -inf; m2 = max(m2, (the chunk's max of the raw scores) * c) (c =
scale * log2(e), scale > 0), alpha = exp2(m2_old - m2_new) rescales the
row sum l and the accumulator, P = exp2(fma(S, c,
-m2)), each lane of a quad sums its own four columns of a chunk into its
share of l from the unrounded P, then in bf16 P is rounded to bf16 (to
nearest even) before its product with v and the product is added into the
accumulator; in float32 the chunk's 3xTF32 product is summed apart and
added once. At the end the parts are merged in part order (m2 = max m2_p,
l and acc summed with factors exp2(m2_p - m2) by fused multiply-adds), the
quad's shares of l are added ((l0 + l1) + (l2 + l3)), out = acc / l and
lse = m2 * ln(2) + log(l), in natural-log units. A product's own sum is
taken in float64 and rounded once: the tensor cores' internal order is not
modelled. The kernel itself is held to the plain version on the card by
``chip_smoke.py`` (phase 22); the plain version is held to JAX's stock
kernel in interpret mode by ``test_torch_port_softmax_attention.py``.
"""

import numpy as np
import pytest
import torch

from cv_diffusion_tpu_torch.ops import flash_attention_kernel as fk
from cv_diffusion_tpu_torch.ops.attention import softmax_attention_plain
from test_torch_port_flash_backward import CHUNK, LOG2E, SPLITS, _smoke, add, bf16, product

LN2 = np.float32(0.6931471805599453)
# a lane t of a quad owns columns 2t, 2t + 1, 8 + 2t, 9 + 2t of a chunk, summed in that order
LANE_COLS = np.array([[2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t] for t in range(4)]).T


def fcols(dtype, d):
    """Keys of a staged tile of the forward (the source's ``fcols``)."""
    return 64 if dtype == torch.float32 and d == 128 else 128


def _chunks(n, bc, split, part):
    """The key offsets of the chunks part ``part`` takes, tile after tile."""
    for k0 in range(0, n, bc):
        yield from (k0 + j for j in range(CHUNK * part, bc, CHUNK * split) if k0 + j < n)


def model_forward(q, k, v, scale, split, drop=None):
    """(out, lse) of the forward kernel's model from [B, N, H, D] tensors of
    one dtype; ``drop`` the key offset of one chunk to leave out (a
    control)."""
    tf32 = q.dtype == torch.float32
    bhnd = lambda t: t.float().transpose(1, 2).contiguous().numpy()   # noqa: E731
    qn, kn, vn = map(bhnd, (q, k, v))
    b, h, n, d = qn.shape
    c = np.float32(np.float32(scale) * LOG2E)
    m2s, ls, accs = [], [], []
    for part in range(split):
        m2 = np.full((b, h, n), -np.inf, np.float32)
        lane_l = np.zeros((b, h, n, 4), np.float32)
        acc = np.zeros((b, h, n, d), np.float32)
        for j in _chunks(n, fcols(q.dtype, d), split, part):
            if j == drop:
                continue
            kc = np.zeros((b, h, CHUNK, d), np.float32)
            vc = np.zeros((b, h, CHUNK, d), np.float32)
            kc[:, :, :min(CHUNK, n - j)] = kn[:, :, j:j + CHUNK]
            vc[:, :, :min(CHUNK, n - j)] = vn[:, :, j:j + CHUNK]
            s = product(qn, kc, tf32).astype(np.float32)
            s[..., max(0, n - j):] = -np.inf              # keys past N
            m2_new = np.maximum(m2, (s.max(-1) * c).astype(np.float32))
            alpha = np.exp2(m2 - m2_new).astype(np.float32)
            lane_l = (lane_l * alpha[..., None]).astype(np.float32)
            acc = (acc * alpha[..., None]).astype(np.float32)
            m2 = m2_new
            arg = (s.astype(np.float64) * c - m2[..., None].astype(np.float64)).astype(np.float32)
            p = np.exp2(arg).astype(np.float32)
            for step in LANE_COLS:
                lane_l = (lane_l + p[..., step]).astype(np.float32)
            vt = np.swapaxes(vc, -1, -2)
            if tf32:
                acc = add(acc, product(p, vt, True).astype(np.float32))
            else:
                acc = add(acc, product(bf16(p), vt, False))
        m2s.append(m2)
        ls.append(lane_l)
        accs.append(acc)
    mt = np.max(m2s, axis=0)

    def fma(a, x, f):
        return (a.astype(np.float64) + x.astype(np.float64) * f).astype(np.float32)

    f0 = np.exp2(m2s[0] - mt).astype(np.float32)[..., None]
    lane_l = (ls[0] * f0).astype(np.float32)
    acc = (accs[0] * f0).astype(np.float32)
    for p in range(1, split):   # a part that saw no key: exp2(-inf) = 0 times 0
        f = np.exp2(m2s[p] - mt).astype(np.float32)[..., None]
        lane_l = fma(lane_l, ls[p], f)
        acc = fma(acc, accs[p], f)
    l_row = ((lane_l[..., 0] + lane_l[..., 1]).astype(np.float32)
             + (lane_l[..., 2] + lane_l[..., 3]).astype(np.float32)).astype(np.float32)
    out = (acc / l_row[..., None]).astype(np.float32)
    lse = ((mt * LN2).astype(np.float32) + np.log(l_row).astype(np.float32)).astype(np.float32)
    return torch.from_numpy(out).transpose(1, 2).to(q.dtype), torch.from_numpy(lse)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


def test_model_follows_the_source():
    """The constants and steps the model takes from the source's forward:
    16-column chunks, staged tiles of 128 keys (64 in f32 at D = 128),
    splits of 1, 2 or 4 merged in part order, the max on the raw scores and
    the scale folded into the exponent's fused multiply-add, the lanes'
    shares of l added at the end, lse in natural-log units, scale > 0."""
    src = open(fk.SOURCE).read()
    fwd = src[src.index("flash_fwd_kernel(const T*"):src.index("// dK/dV: one block")]
    assert f"constexpr int kChunk = {CHUNK};" in src
    assert "fcols() { return sizeof(T) == 4 && D == 128 ? 64 : 128; }" in src
    assert "(split != 1 && split != 2 && split != 4)" in src
    assert "!(scale > 0.0f)" in src
    for step in ("const float c = scale * kLog2e;",
                 "if (k0 + j + 8 * nb + 2 * t4 + (i & 1) >= N) s[nb][i] = -INFINITY;",
                 "mx[i >> 1] = fmaxf(mx[i >> 1], s[nb][i]);",
                 "mx[r] = fmaxf(m2[r], mx[r] * c);",
                 "const float alpha = exp2f(m2[r] - mx[r]);",
                 "s[nb][i] = exp2f(fmaf(s[nb][i], c, -m2[i >> 1]));",
                 "l[i >> 1] += s[nb][i];",
                 "accumulate_chunk<T, D>(acc, s, tv, j, lane);",
                 "l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);",
                 "l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);",
                 "acc[a][i] /= l[i >> 1];",
                 "m2[r] * kLn2 + logf(l[r])",
                 "l[0] = fmaf(ml[64 + lane], f[0], l[0]);"):
        assert step in fwd, step
    # one barrier a staged tile, none inside the walk over its chunks
    loop = fwd[fwd.index("for (int t = 0; t < tiles; ++t)"):fwd.index("if (split > 1)")]
    assert loop.count("__syncthreads") == 1
    for d in fk.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert CHUNK * max(SPLITS) <= fcols(dtype, d)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1024, 4, 32), (2, 300, 3, 64), (2, 5, 2, 32)])
def test_model_meets_the_card_gate(shape, dtype, split):
    """The model's out against the plain version within
    ``chip_smoke.flash_limit`` (float32: 2e-5; bf16: 4 ulps of the
    reference's largest magnitude) and its lse within the card's 2e-4, every
    split the source takes (at N = 5 parts 1 to 3 see no key); the 3xTF32
    model within 5e-6."""
    smoke = _smoke()
    name = str(dtype).replace("torch.", "")
    q, k, v = _inputs(shape, dtype, 20)
    scale = shape[-1] ** -0.5
    ref, ref_lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
    out, lse = model_forward(q, k, v, scale, split)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    e = float((out.float() - ref.float()).abs().max())
    assert e <= smoke.flash_limit(ref, name)
    assert float((lse - ref_lse.float()).abs().max()) <= 10 * smoke.FLASH_TOL[0]
    if dtype == torch.float32:
        assert e <= 5e-6


def test_forward_refuses_a_scale_it_cannot_take():
    """The kernel keeps the max of the raw scores, which is the max of the
    scaled ones only for scale > 0: the wrapper refuses other scales for a
    CUDA tensor before any launch (the CPU's plain version takes any)."""
    q, k, v = _inputs((1, 16, 1, 32), torch.float32, 1)
    out, _ = fk.flash_attention_forward(q, k, v, -0.5)
    assert torch.allclose(out, softmax_attention_plain(q, k, v, -0.5))
    meta = [t.to("meta") for t in (q, k, v)]
    for scale in (0.0, -0.5, float("nan")):
        with pytest.raises(ValueError):
            fk.flash_attention_forward(*meta, scale)


def test_the_gate_sees_a_dropped_chunk():
    """A control of the comparison above: in bf16 the model's out and the
    plain version's agree within half the gate, and the model with one
    chunk of 16 keys left out is at least twice the gate away."""
    smoke = _smoke()
    shape, scale = (1, 1024, 4, 32), 32 ** -0.5
    q, k, v = _inputs(shape, torch.bfloat16, 7)
    ref = softmax_attention_plain(q, k, v, scale)
    limit = smoke.flash_limit(ref, "bfloat16")
    err = lambda a: float((a.float() - ref.float()).abs().max())   # noqa: E731
    assert err(model_forward(q, k, v, scale, 1)[0]) <= limit / 2
    assert err(model_forward(q, k, v, scale, 1, drop=512)[0]) >= 2 * limit
