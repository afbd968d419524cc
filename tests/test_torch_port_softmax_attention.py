"""The port's softmax attention against the JAX package's, on the CPU.

The plain versions of the flash-attention kernels (the wrappers' CPU
branch) are held against JAX's stock Pallas TPU flash attention itself, run
in interpret mode (``pl.pallas_call`` patched in the stock module through
``monkeypatch``; nothing of JAX or the JAX package changes), forward and
``jax.vjp`` through its two backward kernels, and against
``standard_attention`` and ``jax.grad`` of it, at the JAX tests' gradient
tolerances: float32 forward 2e-5, gradients 5e-4, bfloat16 2e-2 (the bf16
references compiled with XLA's excess precision off). Then
``StandardAttentionBlock``, its weight entries, and a UNet with
``use_linear_attention=False`` at 128² (so that ``mid_attn`` and the
level-3 blocks see 256 tokens and JAX takes the flash path) against the
JAX package with ``use_pallas`` on and off: in float64 on both sides (the
stock kernel's float32 casts patched too) at 1e-9, in float32 at the UNet's
1e-3; and one train step's loss and gradient norm. The CUDA kernels are
held against the plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.experimental.pallas.ops.tpu.flash_attention as stock
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cv_diffusion_tpu.models import blocks as jblocks
from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.unet import EfficientUNet
from cv_diffusion_tpu.ops.attention import (standard_attention,
                                            standard_attention_flash)
from cv_diffusion_tpu.utils.torch_compat import export_unet_state_dict
from cv_diffusion_tpu_torch.models import blocks as tblocks
from cv_diffusion_tpu_torch.models.diffusion import diffusion_loss, train_forward
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.ops import flash_attention_kernel as fk
from cv_diffusion_tpu_torch.ops.attention import (
    row_dot, softmax_attention, softmax_attention_backward_rows,
    softmax_attention_plain)
from cv_diffusion_tpu_torch.weights import (state_dict_from_jax,
                                            unet_state_dict_from_jax)

from test_torch_port_training import _flat_port
from test_torch_port_weights import (jax_in_float64, load_block, nchw, nhwc,  # noqa: F401
                                     one_torch_thread, port_model,
                                     random_jax_params)

NO_EXCESS = {"xla_allow_excess_precision": False}
TOL = {"float32": (2e-5, 5e-4), "bfloat16": (2e-2, 2e-2)}   # forward, gradients
SIZE = 128
# the tiny UNet with its widths cut: channels 8, 16, 32, 64; attention (2
# heads of 32) at 16² (level 3 and the middle), 256 tokens
UNET = dict(base_channels=8, use_linear_attention=False)


@pytest.fixture
def interpret(monkeypatch):
    """The stock flash kernel in Pallas interpret mode."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(stock.pl, "pallas_call", patched)


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _torch(x, dtype):
    return torch.from_numpy(np.asarray(jnp.asarray(x).astype(jnp.float32))).to(dtype)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _jax_vjp(fn, q, k, v, do):
    """(out, (dq, dk, dv)) of ``fn`` at q, k, v for the cotangent do, jitted
    and compiled with excess precision off, as float32 numpy."""
    def f(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    out, grads = jax.jit(f).lower(q, k, v, do).compile(NO_EXCESS)(q, k, v, do)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))   # noqa: E731
    return as_np(out), tuple(map(as_np, grads))


def _port(q, k, v, do, scale):
    out, lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
    grads = softmax_attention_backward_rows(q, k, v, do, lse, row_dot(out, do),
                                            scale)
    return out.float().numpy(), tuple(g.float().numpy() for g in grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 256, 4, 32), (2, 384, 2, 64)])
def test_plain_matches_the_stock_flash_kernel(shape, dtype, interpret):
    """Forward and gradients against the stock Pallas kernel in interpret
    mode (its forward, dK/dV and dQ kernels), and against
    ``standard_attention`` and its gradients."""
    scale = shape[-1] ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    q, k, v, do = (jnp.asarray(x).astype(jdt) for x in _inputs(shape, 0))
    got = _port(*(_torch(x, tdt) for x in (q, k, v, do)), scale)
    tol_out, tol_grad = TOL[dtype]
    for fn in (lambda a, b, c: standard_attention_flash(a, b, c, scale),
               lambda a, b, c: standard_attention(a, b, c, scale)):
        out, grads = _jax_vjp(fn, q, k, v, do)
        assert _err(got[0], out) <= tol_out
        for g, want in zip(got[1], grads):
            assert _err(g, want) <= tol_grad


@pytest.mark.parametrize("n", [1, 5, 100, 127, 200])
def test_plain_matches_standard_attention_where_jax_does_not_tile(n):
    """Below 128 tokens JAX's ``standard_attention_flash`` runs
    ``standard_attention`` itself; at 200 its stock kernel cannot tile (N
    not a multiple of 128) and JAX's ``use_pallas=False`` path is that same
    function. float32, the forward and gradients at their tolerances."""
    shape = (2, n, 2, 32)
    q, k, v, do = _inputs(shape, n)
    scale = 32 ** -0.5
    out, grads = _jax_vjp(lambda a, b, c: standard_attention(a, b, c, scale),
                          *map(jnp.asarray, (q, k, v, do)))
    got = _port(*map(torch.from_numpy, (q, k, v, do)), scale)
    assert _err(got[0], out) <= TOL["float32"][0]
    for g, want in zip(got[1], grads):
        assert _err(g, want) <= TOL["float32"][1]
    if n >= 128:
        with pytest.raises(ValueError, match="divisible"):
            standard_attention_flash(*map(jnp.asarray, (q, k, v)), scale)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """The wrappers' CPU branch: the plain versions exactly, no launch
    counted, no lse computed without a gradient; the dQ wrapper (run first,
    on the forward's output) returns di equal to ``row_dot`` bit for bit,
    which the dK/dV wrapper takes; the autograd function's gradients pass
    ``gradcheck`` in float64; every other device is refused before any
    kernel is built."""
    q, k, v, do = map(torch.from_numpy, _inputs((2, 70, 3, 32), 7))
    scale = 0.2
    counts = (fk.flash_attention_forward.launches,
              fk.flash_attention_backward_dkv.launches,
              fk.flash_attention_backward_dq.launches)
    out, lse = fk.flash_attention_forward(q, k, v, scale, with_lse=True)
    want, want_lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert lse.shape == (2, 3, 70) and lse.dtype == torch.float32
    assert fk.flash_attention_forward(q, k, v, scale)[1] is None
    dq, di = fk.flash_attention_backward_dq(q, k, v, do, lse, out, scale)
    assert torch.equal(di, row_dot(want, do))
    assert torch.equal(di, (want * do).sum(-1).transpose(1, 2).contiguous())
    dk, dv = fk.flash_attention_backward_dkv(q, k, v, do, lse, di, scale)
    for a, b in zip((dq, dk, dv),
                    softmax_attention_backward_rows(q, k, v, do, lse, di, scale)):
        assert torch.equal(a, b)
    assert counts == (fk.flash_attention_forward.launches,
                      fk.flash_attention_backward_dkv.launches,
                      fk.flash_attention_backward_dq.launches)
    q64, k64, v64 = (t[:1, :9].double().requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: softmax_attention(a, b, c, 0.3), (q64, k64, v64))
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fk.flash_attention_forward(q.to("meta"), k.to("meta"), v.to("meta"), scale)
    with pytest.raises(ValueError, match="head dim"):
        fk._check(*(torch.zeros(1, 64, 1, 16) for _ in range(3)))


def test_source_uses_exact_exp_and_no_atomics():
    """The source computes exp with ``expf``/``exp2f`` (``__expf`` misses
    the float32 gate), accumulates the backward with no atomics (gradients
    bit for bit run to run) on the tensor cores (``mma.sync`` in bf16 and in
    TF32, B fragments by ``ldmatrix``, staging by ``cp.async``), exports
    every C entry point the wrapper declares, and builds an instance for
    every head dim the wrapper takes."""
    import re
    import types

    class Declared:
        def __init__(self):
            self.names = set()

        def __getattr__(self, name):
            self.names.add(name)
            return types.SimpleNamespace()

    src = open(fk.SOURCE).read()
    assert "__expf(" not in src and "atomicAdd(" not in src
    assert "expf(" in src or "exp2f(" in src
    for instruction in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                        "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                        "cp.async.cg.shared.global"):
        assert instruction in src
    lib = Declared()
    fk._declare(lib)
    exported = src[src.index('extern "C" {'):]
    for name in lib.names:
        assert re.search(rf"\b(cudaError_t|int|const char\*) {name}\(", exported), name
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        for suffix in ("f32", "bf16"):
            assert f"{name}_{suffix}" in lib.names
    for d in fk.HEAD_DIMS:
        assert f"case {d}:" in src


@pytest.mark.parametrize("tokens", [1024, 4096])
def test_bf16_card_gate_fails_a_dropped_key_tile(tokens):
    """``chip_smoke.py``'s bf16 gate (4 bf16 ulps of the reference's largest
    magnitude) on mid_attn's shapes: the plain bf16 outputs with one 64-key
    tile dropped, and dK scaled by 0.7, fail it at least fivefold; a
    reading of one ulp of the largest value passes it."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shape, scale = (1, tokens, 4, 32), 32 ** -0.5
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(shape, 5))
    err = lambda a, b: float((a.float() - b.float()).abs().max())   # noqa: E731
    out, lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
    dq, dk, _ = softmax_attention_backward_rows(q, k, v, do, lse, row_dot(out, do), scale)
    keep = torch.ones(tokens, dtype=torch.bool)
    keep[tokens // 2:tokens // 2 + 64] = False
    out2, lse2 = softmax_attention_plain(q, k[:, keep], v[:, keep], scale, return_lse=True)
    dq2 = softmax_attention_backward_rows(q, k[:, keep], v[:, keep], do, lse2,
                                          row_dot(out2, do), scale)[0]
    limit = smoke.flash_limit(out, "bfloat16")
    limit_b = smoke.flash_limit(dq, "bfloat16", backward=True)
    assert err(out2, out) >= 5 * limit and err(dq2, dq) >= 5 * limit_b
    assert err(0.7 * dk.float(), dk) >= 5 * smoke.flash_limit(dk, "bfloat16", True)
    peak = float(out.float().abs().max())
    assert 2.0 ** (np.floor(np.log2(peak)) - 7) <= limit / 2


def _block_case(float64, use_pallas, act_quant=False, side=16):
    """(port block, flax result, input) for ``mid_attn`` of the cut UNet on
    x [2, side, side, 64]."""
    jcfg, tcfg, params = random_jax_params("tiny", SIZE, seed=3, **UNET)
    u = jcfg.unet
    block = load_block(tblocks.StandardAttentionBlock(
        64, u.num_attention_heads, u.attention_head_dim, act_quant=act_quant),
        _state_dict(tcfg, params), "unet.mid_attn")
    dt = np.float64 if float64 else np.float32
    x = np.random.default_rng(4).standard_normal((2, side, side, 64)).astype(dt)
    variables = {"params": jax.tree.map(lambda a: jnp.asarray(a, dt),
                                        params["unet"]["mid_attn"])}
    if act_quant:   # never calibrated: both sides take the dynamic scale
        variables["act_scales"] = {m: {"amax": jnp.zeros((), dt)}
                                   for m in ("to_qkv", "to_out")}
    ref = jblocks.StandardAttentionBlock(
        num_heads=u.num_attention_heads, dim_head=u.attention_head_dim,
        use_pallas=use_pallas, act_quant=act_quant, dtype=dt).apply(
        variables, jnp.asarray(x))
    if float64:
        block.double()
    with torch.no_grad():
        got = nhwc(block(nchw(x)))
    return got, np.asarray(ref)


def _state_dict(tcfg, params):
    return state_dict_from_jax(params, tcfg)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("float64", [True, False])
def test_block_matches_flax(float64, use_pallas, interpret, monkeypatch):
    """``StandardAttentionBlock`` on 256 tokens against flax's, which runs
    the stock flash kernel with ``use_pallas`` and ``standard_attention``
    without: float64 on both sides at 1e-9, float32 at 1e-3."""
    if float64:
        with jax_in_float64(monkeypatch, extra=(stock,)):
            got, ref = _block_case(True, use_pallas)
        np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)
    else:
        got, ref = _block_case(False, use_pallas)
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_int8_block_matches_flax_in_float64(interpret, monkeypatch):
    """``act_quant=True``: the block's two QConvs in int8 compute (dynamic
    scales, never calibrated) around the softmax attention, against flax's
    in float64 (no quantization boundary flips between the two), 1e-9."""
    from cv_diffusion_tpu.ops import qconv as jqconv
    with jax_in_float64(monkeypatch, extra=(stock, jqconv)):
        got, ref = _block_case(True, True, act_quant=True)
    np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)


@pytest.mark.parametrize("side", [8, 12])
def test_block_runs_the_kernel_wrapper_where_jax_runs_standard_attention(
        side, interpret, monkeypatch):
    """64 tokens (below the stock kernel's 128) and 144 (not a multiple of
    128: JAX's stock kernel raises, ``use_pallas=False`` runs
    ``standard_attention``): the port's block goes through the forward
    kernel's wrapper at every N and computes JAX's ``use_pallas=False``
    block, float64 at 1e-9."""
    calls = []
    forward = fk.flash_attention_forward

    def counted(q, *args, **kwargs):
        calls.append(q.shape[1])
        return forward(q, *args, **kwargs)

    monkeypatch.setattr(fk, "flash_attention_forward", counted)
    with jax_in_float64(monkeypatch, extra=(stock,)):
        got, ref = _block_case(True, False, side=side)
        if side == 12:
            with pytest.raises(ValueError, match="divisible"):
                _block_case(True, True, side=side)
    np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)
    assert calls and set(calls) == {side * side}


def test_weight_entries_equal_export_unet_state_dict():
    """``unet_state_dict_from_jax`` of a softmax-attention UNet equals the
    JAX package's ``export_unet_state_dict`` name for name and bit for bit
    (``to_out.weight``, no ``to_out.1``), and loads with ``strict=True``."""
    jcfg, tcfg, params = random_jax_params("tiny", SIZE, **UNET)
    ref = export_unet_state_dict(params["unet"], jcfg.unet)
    got = unet_state_dict_from_jax(params["unet"], tcfg.unet)
    assert list(got) == list(ref)
    assert "mid_attn.to_out.weight" in got and "mid_attn.to_out.1.weight" not in got
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    model = port_model(tcfg, params)
    assert sum(isinstance(m, tblocks.StandardAttentionBlock)
               for m in model.modules()) == 4


def _unet(float64, use_pallas):
    """(port, flax) UNet outputs at 128² on one random input."""
    jcfg, tcfg, params = random_jax_params("tiny", SIZE, seed=5, **UNET)
    model = port_model(tcfg, params)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, SIZE, SIZE, 6))
    t = np.asarray([10, 900], dtype=np.int32)
    ucfg = dataclasses.replace(jcfg.unet, use_pallas=use_pallas)
    dt = np.float32
    if float64:
        ucfg, dt = dataclasses.replace(ucfg, dtype="float64"), np.float64
        model.double()
    ref = jax.jit(EfficientUNet(ucfg).apply)(
        {"params": jax.tree.map(lambda a: jnp.asarray(a, dt), params["unet"])},
        jnp.asarray(x, dt), jnp.asarray(t))
    with torch.no_grad():
        got = nhwc(model.unet(nchw(x.astype(dt)), torch.from_numpy(t)))
    return got, np.asarray(ref)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("float64", [True, False])
def test_unet_matches_flax(float64, use_pallas, interpret, monkeypatch):
    """The whole UNet with softmax attention at 128² (four attention blocks
    of 256 tokens) against flax's, with the stock flash kernel in interpret
    mode (``use_pallas``) or ``standard_attention``: float64 at 1e-9,
    float32 at the UNet's 1e-3."""
    if float64:
        with jax_in_float64(monkeypatch, extra=(stock,)):
            got, ref = _unet(True, use_pallas)
        np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)
    else:
        got, ref = _unet(False, use_pallas)
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_train_step_matches_jax(interpret, monkeypatch):
    """One train step's loss and gradients (their global norm and each
    tensor) of the UNet above through the autograd function, against JAX's
    ``train_forward`` + ``diffusion_loss`` differentiated through the stock
    flash kernel's own backward (``use_pallas``), both in float64 at 1e-9;
    the attention blocks' gradients are not zero."""
    jcfg, tcfg, params = random_jax_params("tiny", SIZE, seed=9, use_pallas=True,
                                           **UNET)
    jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, dtype="float64"))
    rng = np.random.default_rng(10)
    low, high = (rng.uniform(-1, 1, (1, SIZE, SIZE, 3)) for _ in range(2))
    t = np.asarray([500], np.int32)
    eps = rng.standard_normal((1, SIZE, SIZE, 3))
    with jax_in_float64(monkeypatch, extra=(stock, jdiffusion)):
        jmodel, jschedule = jax_create_model(jcfg)

        def loss_fn(p):
            res = jdiffusion.train_forward(
                jmodel, jschedule, {"params": p}, jax.random.key(0),
                jnp.asarray(low), jnp.asarray(high), timesteps=jnp.asarray(t),
                noise=jnp.asarray(eps))
            return jdiffusion.diffusion_loss(res["noise_pred"], res["target"])

        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p64)
        grads = jax.tree.map(np.asarray, grads)
    model = port_model(tcfg, params).double().train()
    out = train_forward(model, make_schedule(tcfg.scheduler),
                        torch.from_numpy(low), torch.from_numpy(high),
                        timesteps=torch.from_numpy(t), noise=torch.from_numpy(eps))
    got = diffusion_loss(out["noise_pred"], out["target"])
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=1e-9, rtol=0)
    want = _flat_port(grads, tcfg, monkeypatch)
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in want.values()))
    got_norm = float(torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters())))
    np.testing.assert_allclose(got_norm, norm, rtol=1e-9)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name], atol=1e-9,
                                   rtol=0, err_msg=name)
    assert float(model.unet.mid_attn.to_qkv.weight.grad.abs().max()) > 0
