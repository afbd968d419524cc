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
import re

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


PLAN_SHAPES = [(1, 1024, 4, 32), (8, 1024, 4, 32), (1, 1000, 4, 32),
               (1, 1, 1, 32), (2, 64, 2, 32), (1, 128, 1, 128), (2, 300, 3, 64),
               (64, 4096, 8, 32)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_gives_every_token_one_rank(shape):
    """Every token of a (batch, head) is owned by exactly one rank of its
    cluster; C is a power of two up to the portable 8 (16 only where the
    grid has at most one block per SM) and keeps ~32 tokens a rank; the grid
    is whole clusters; the block's shared memory fits."""
    b, n, h, d = shape
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            p = lak.plan(b, n, h, d, dtype, backward=backward)
            assert p.cluster in (1, 2, 4, 8, 16)
            assert p.cluster < 16 or p.blocks <= lak.SMS
            assert p.cluster == 1 or p.rows >= lak.MIN_ROWS
            owner = np.zeros(n, dtype=int)
            for r in range(p.cluster):
                owner[r * p.rows:(r + 1) * p.rows] += 1
            assert (owner == 1).all()
            assert p.rows * (p.cluster - 1) < n or p.cluster == 1
            assert p.blocks == b * h * p.cluster and p.blocks % p.cluster == 0
            short = lak.SHORT_ROWS.get(d, 0)
            assert p.tile_rows == (short if p.rows <= short
                                   else lak.TILE_ROWS[d][backward])
            assert 0 < p.smem_bytes <= lak.SMEM_LIMIT
            lak.plan.cache_clear()
            assert lak.plan(b, n, h, d, dtype, backward=backward) == p


def _source() -> str:
    with open(lak.SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("d", lak.HEAD_DIMS)
def test_plan_constants_match_the_source(d):
    """The plan's tile rows, padding, threads and buffers are the source's,
    and its tiles meet the source's static_asserts (a tile is whole passes of
    16-byte loads and of the row-tile product's threads; the reduction's
    scratch fits in two tiles)."""
    src = _source()
    tiles = re.search(
        rf"struct Tiles<{d}> {{\s*static constexpr int kFwdRows = (\d+), "
        r"kBwdRows = (\d+), kShortRows = (\d+);", src)
    assert tiles, f"no Tiles<{d}> in the source"
    fwd, bwd, short = map(int, tiles.groups())
    assert (fwd, bwd) == lak.TILE_ROWS[d] and short == lak.SHORT_ROWS.get(d, 0)
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == lak.THREADS
    assert int(re.search(r"constexpr int kPad = (\d+);", src).group(1)) == lak.PAD
    assert int(re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1)) \
        == lak.KERNEL_MAX_CLUSTER
    assert int(re.search(r"constexpr int kBarrierFloats = (\d+);", src).group(1)) \
        == lak.BARRIER_FLOATS
    ti = 8 if d >= 128 else 4
    groups = lak.THREADS // (d // ti) ** 2
    for rows, backward in ((fwd, False), (bwd, True), (short, False), (short, True)):
        if not rows:
            continue
        for elems in (4, 8):                     # 16 bytes of f32, of bf16
            assert rows * (d // elems) % lak.THREADS == 0
        assert rows * (d // 8) % lak.THREADS == 0     # 8 columns a thread
        assert (2 * rows * (d + lak.PAD)
                >= (groups * d * d if groups > 1 else 0) + lak.THREADS)
        assert lak.smem_bytes(d, rows, backward) <= lak.SMEM_LIMIT


def test_source_has_no_atomics_and_one_launch_per_call():
    src = _source()
    assert not re.search(r"\batomic[A-Z]\w*\(", src)    # atomicAdd, atomicCAS, ...
    assert "<<<" not in src
    assert src.count("cudaLaunchKernelEx(") == 1       # in launch(), once
    assert "cudaLaunchAttributeClusterDimension" in src
    # the cluster's reduction: pushes into the owners' shared memory and bulk
    # copies of the sums back, each counted on the receiver's mbarrier
    assert "st.async.shared::cluster.mbarrier::complete_tx::bytes" in src
    assert "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx" in src
    assert "cudaMalloc" not in src


def _phi(x):
    return np.where(x > 0, x + 1, np.exp(np.minimum(x, 0))).astype(np.float32)


def _cluster_reduce(parts):
    """The kernel's reduce-scatter and all-gather over the ranks' flattened
    partials (kv [D, D] row-major, then the column sums [D]): rank o owns the
    16-byte chunks [o·S4, (o+1)·S4), sums them over the ranks -- ranks 4q ..
    4q+3 in order for each quarter q, then the quarters' sums as the tree
    ((0 + 1) + (2 + 3)) -- and copies the sums to every rank. Returns the
    reduced buffer once every slice has an owner."""
    c = len(parts)
    kv4 = parts[0].size // 4
    s4 = -(-kv4 // c)
    reduced = np.full_like(parts[0], np.nan)
    for owner in range(c):
        lo, hi = 4 * owner * s4, 4 * min((owner + 1) * s4, kv4)
        if lo >= hi:
            continue
        quarters = []
        for r0 in range(0, c, 4):
            acc = parts[r0][lo:hi].copy()
            for part in parts[r0 + 1:r0 + 4]:
                acc = acc + part[lo:hi]
            quarters.append(acc)
        while len(quarters) > 1:
            quarters = [quarters[i] + quarters[i + 1]
                        for i in range(0, len(quarters), 2)]
        reduced[lo:hi] = quarters[0]
    assert not np.isnan(reduced).any()
    return reduced


def _rank_partial(a, b, w, d):
    """A rank's flattened partial: Σ aᵀb over its tokens taken by the
    kernel's token groups (every G-th token, the groups summed in order),
    then Σ a·w by column-sum parts (every (256/D)-th token, in order)."""
    ti = 8 if d >= 128 else 4
    groups = lak.THREADS // (d // ti) ** 2
    parts = lak.THREADS // d
    kv = np.zeros((d, d), np.float32)
    for g in range(groups):
        kv = kv + a[g::groups].T @ b[g::groups]
    cs = np.zeros(d, np.float32)
    for p in range(parts):
        cs = cs + (a[p::parts] * w[p::parts, None]).sum(0)
    return np.concatenate([kv.reshape(-1), cs]).astype(np.float32)


def _split(r, d):
    return r[:d * d].reshape(d, d), r[d * d:]


def _ranks(n, p):
    return [(min(n, r * p.rows), min(n, (r + 1) * p.rows)) for r in range(p.cluster)]


def _emulate_forward(q, k, v, eps=1e-6):
    """The forward kernel's dataflow in float32: per rank a partial kv and
    ksum, the cluster's reduction, then the rank's rows of
    φ(q)·kv / (φ(q)·ksum + eps)."""
    b, n, h, d = q.shape
    p = lak.plan(b, n, h, d, torch.float32)
    out = np.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            pk, vv, pq = _phi(k[bi, :, hi]), v[bi, :, hi], _phi(q[bi, :, hi])
            ones = np.ones(n, np.float32)
            kv, ks = _split(_cluster_reduce(
                [_rank_partial(pk[lo:e], vv[lo:e], ones[lo:e], d)
                 for lo, e in _ranks(n, p)]), d)
            for lo, e in _ranks(n, p):
                den = pq[lo:e] @ ks + np.float32(eps)
                out[bi, lo:e, hi] = (pq[lo:e] @ kv) / den[:, None]
    return out


def _emulate_backward(q, k, v, g, eps=1e-6):
    """The backward kernel's dataflow in float32: kv reduced over the
    cluster; per rank num, den, d_num, d_den, dq and a partial d_kv and
    d_ksum; those reduced over the cluster; then dk and dv."""
    b, n, h, d = q.shape
    p = lak.plan(b, n, h, d, torch.float32, backward=True)
    dq, dk, dv = (np.zeros_like(q) for _ in range(3))
    eps = np.float32(eps)
    for bi in range(b):
        for hi in range(h):
            pk, vv = _phi(k[bi, :, hi]), v[bi, :, hi]
            pq, gg = _phi(q[bi, :, hi]), g[bi, :, hi]
            ones = np.ones(n, np.float32)
            kv, ks = _split(_cluster_reduce(
                [_rank_partial(pk[lo:e], vv[lo:e], ones[lo:e], d)
                 for lo, e in _ranks(n, p)]), d)
            parts = []
            for lo, e in _ranks(n, p):
                num = pq[lo:e] @ kv
                den = pq[lo:e] @ ks + eps
                d_num = gg[lo:e] / den[:, None]
                d_den = -(gg[lo:e] * num).sum(1) / (den * den)
                dphi = d_num @ kv.T + d_den[:, None] * ks
                dq[bi, lo:e, hi] = dphi * np.minimum(pq[lo:e], 1)
                parts.append(_rank_partial(pq[lo:e], d_num, d_den, d))
            dkv, dks = _split(_cluster_reduce(parts), d)
            for lo, e in _ranks(n, p):
                dphi = vv[lo:e] @ dkv.T + dks
                dk[bi, lo:e, hi] = dphi * np.minimum(pk[lo:e], 1)
                dv[bi, lo:e, hi] = pk[lo:e] @ dkv
    return dq, dk, dv


@pytest.mark.parametrize("shape", [(1, 1024, 4, 32), (1, 1000, 4, 32)])
def test_cluster_reduction_emulated_matches_plain_forward(shape):
    q, k, v = _qkv(shape, 12)
    got = _emulate_forward(q, k, v)
    ref = linear_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got, ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 1024, 4, 32), (1, 1000, 4, 32)])
def test_cluster_reduction_emulated_matches_plain_backward(shape):
    q, k, v = _qkv(shape, 13)
    g = np.random.default_rng(14).normal(size=shape).astype(np.float32)
    got = _emulate_backward(q, k, v, g)
    ref = linear_attention_backward_plain(*map(torch.from_numpy, (q, k, v, g)))
    for a, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a, r.numpy(), atol=5e-4, err_msg=f"d{name}")


class _StandIn:
    """A library that records each entry point's arguments."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        if name.startswith("linear_attention_") and name != "linear_attention_error_string":
            return lambda *args: self.calls.append((name, args)) or self.err
        raise AttributeError(name)

    @staticmethod
    def linear_attention_error_string(err):
        return b"stand-in error"


@pytest.mark.parametrize("backward", [False, True])
def test_launch_passes_the_plan_and_allocates_only_outputs(backward):
    shape = (2, 1000, 4, 32)
    ts = [torch.from_numpy(x) for x in _qkv(shape, 15) + _qkv(shape, 16)[:1]]
    lib = _StandIn()
    if backward:
        outs = lak._launch_backward(lib, 7, *ts, 1e-6)
    else:
        outs = (lak._launch_forward(lib, 7, *ts[:3], 1e-6),)
    (name, args), = lib.calls
    p = lak.plan(*shape, torch.float32, backward=backward)
    n_ptr = 7 if backward else 4
    assert name == ("linear_attention_bwd_f32" if backward else "linear_attention_f32")
    assert args[:n_ptr] == tuple(t.data_ptr() for t in ts[:n_ptr - len(outs)] + list(outs))
    assert args[n_ptr:] == (*shape, p.cluster, p.rows, 1e-6, 7)
    assert all(o.shape == shape and o.dtype == torch.float32 for o in outs)
    with pytest.raises(RuntimeError, match=f"clusters of {p.cluster} blocks"):
        (lak._launch_backward if backward else lak._launch_forward)(
            _StandIn(err=7), 7, *ts[:4 if backward else 3], 1e-6)


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
