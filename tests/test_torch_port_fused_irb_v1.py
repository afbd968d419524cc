"""The port's ``fused_irb`` (v1: both GroupNorms' statistics inside the kernel)
against the JAX package's.

``fused_irb_v1_plain`` (the CUDA kernel's CPU branch) is held against
``pallas_irb.fused_irb`` in Pallas interpret mode at 2e-4, the per-IRB
tolerance of ``tests/test_pallas_kernels.py``, on that file's four
``TestFusedIRB`` cases and a 24-row image, all with ``tile_h=8``. In float64
it equals the port's unfused block and ``fused_irb_v2_plain`` (the Gram fold)
to 1e-9: direct statistics and the fold are one function. A stand-in library
shows that the CUDA branch hands the kernel the modules' own tensors and runs
no tensor op of its own. The kernel itself is held against the plain version
on the card by ``chip_smoke.py``.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import cv_diffusion_tpu.ops.pallas_irb as pirb
from cv_diffusion_tpu_torch.ops import fused_irb_kernel as fik
from cv_diffusion_tpu_torch.ops.fused_irb import (fused_irb_v1_plain,
                                                  fused_irb_v2_plain, irb_args)

from test_torch_port_fused_irb import BLOCK_CASES, IRB_TOL, _block_case
from test_torch_port_weights import one_torch_thread  # noqa: F401
from test_torch_port_weights import nchw, nhwc

F64_TOL = dict(atol=1e-9, rtol=0)


def _film(block, temb):
    with torch.no_grad():
        return block.time_mlp(torch.from_numpy(temb)).chunk(2, dim=-1)


# --- against the JAX kernel ---------------------------------------------------------

@pytest.mark.parametrize("case", ["identity", "skip_32_64", "no_se_silu",
                                  "cin48_16_groups", "size24_uneven_tile"])
def test_v1_plain_matches_pallas_interpret(monkeypatch, case):
    """JAX's v1 has no ``interpret`` argument: its ``pallas_call`` is patched
    as ``tests/test_pallas_kernels.py`` patches it."""
    orig = pirb.pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pirb.pl, "pallas_call", interpret)
    kw = BLOCK_CASES[case]
    params, x, temb, block = _block_case(**kw)
    quant, use_se = kw.get("quant", True), kw.get("use_se", True)
    t = params["time_mlp"]
    film = jax.nn.silu(jnp.asarray(temb)) @ t["kernel"] + t["bias"]
    fs, fb = jnp.split(film, 2, axis=-1)
    ref = pirb.fused_irb(jnp.asarray(x), film_scale=fs, film_shift=fb,
                         silu=not quant, use_se=use_se, tile_h=8,
                         **pirb.irb_params_from_flax(params))
    with torch.no_grad():
        got = fused_irb_v1_plain(nchw(x), film_scale=torch.from_numpy(np.array(fs)),
                                 film_shift=torch.from_numpy(np.array(fb)),
                                 tile_h=8, **irb_args(block))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **IRB_TOL)


# --- one function, two ways to its statistics ---------------------------------------

@pytest.mark.parametrize("case", ["identity", "skip_32_64", "no_se_silu",
                                  "cin48_16_groups", "skip_96_384_32"])
def test_v1_plain_float64_is_the_block_and_the_gram_fold(case):
    """In float64 GN2's statistics taken from h1 itself (v1), through the
    Gram of x̂ (v2's fold) and by the unfused block are one function."""
    _, x, temb, block = _block_case(**BLOCK_CASES[case])
    block = block.double()
    fs, fb = _film(block, temb.astype(np.float64))
    x64 = nchw(x).double()
    with torch.no_grad():
        got = fused_irb_v1_plain(x64, film_scale=fs, film_shift=fb, tile_h=8,
                                 **irb_args(block))
        unfused = block(x64, torch.from_numpy(temb).double())
        folded = fused_irb_v2_plain(x64, film_scale=fs, film_shift=fb,
                                    **irb_args(block))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), **F64_TOL)
    np.testing.assert_allclose(got.numpy(), folded.numpy(), **F64_TOL)


def test_tile_h_must_divide_the_rows():
    """As the TPU kernel: ``min(tile_h, H)`` must divide H (24 rows, tiles of
    16 do not), and a tile taller than the image is the image."""
    _, x, temb, block = _block_case(size=24)
    fs, fb = _film(block, temb)
    kw = dict(film_scale=fs, film_shift=fb, **irb_args(block))
    with torch.no_grad():
        for fn in (fused_irb_v1_plain, fik.fused_irb_v1):
            with pytest.raises(ValueError, match="tile_h 16 .* 24 rows"):
                fn(nchw(x), tile_h=16, **kw)
        whole = fused_irb_v1_plain(nchw(x), tile_h=24, **kw)
        taller = fused_irb_v1_plain(nchw(x), tile_h=64, **kw)
        tiled = fused_irb_v1_plain(nchw(x), tile_h=8, **kw)
    assert torch.equal(taller, whole) and torch.equal(tiled, whole)


def test_bf16_rounds_only_the_output():
    """v1 computes in float32 and casts only its output to x's dtype (the TPU
    kernel's ``o_ref[0] = out.astype(o_ref.dtype)``)."""
    _, x, temb, block = _block_case(cout=64)
    fs, fb = _film(block, temb)
    xb = nchw(x).to(torch.bfloat16)
    with torch.no_grad():
        got = fused_irb_v1_plain(xb, film_scale=fs, film_shift=fb, **irb_args(block))
        ref = fused_irb_v1_plain(xb.float(), film_scale=fs, film_shift=fb,
                                 **irb_args(block))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_v1_wrapper_cpu_branch_is_the_plain_version():
    _, x, temb, block = _block_case(cout=64, size=16)
    fs, fb = _film(block, temb)
    before = fik.fused_irb_v1.launches
    with torch.no_grad():
        out = fik.fused_irb_v1(nchw(x), film_scale=fs, film_shift=fb,
                               **irb_args(block))
        ref = fused_irb_v1_plain(nchw(x), film_scale=fs, film_shift=fb,
                                 **irb_args(block))
    assert torch.equal(out, ref)
    assert fik.fused_irb_v1.launches == before     # the CPU branch launches nothing


# --- what the CUDA branch hands the kernel --------------------------------------------

class _RecordingLib:
    """Stands in for the kernel library: records what a v1 launch is given."""

    def fused_irb_v1_f32(self, ptrs, ints, eps, stream):
        self.ptrs = dict(zip(fik._PTRS, ptrs))
        self.dims = dict(zip(fik._DIMS, ints))
        self.eps = eps
        return 0


class _Ops(TorchDispatchMode):
    """Records every ATen op run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


# what the CUDA branch may run besides the kernel: allocations and views
_NOT_COMPUTE = {"empty", "detach", "view", "alias", "_reshape_alias", "slice",
                "select", "unsqueeze", "squeeze", "as_strided"}


@pytest.mark.parametrize("case", ["skip_32_64", "no_se_silu"])
def test_v1_launch_hands_the_kernel_the_modules_own_tensors(case):
    """The v1 launch gets x, every weight, the norms' parameters and FiLM as
    the module holds them (FiLM as the two halves of ``time_mlp``'s output,
    row stride 2·Chid), and fresh scratch for the affines the kernel writes:
    no folded affine is computed on the host, and nothing but allocations
    and views runs between the input and the launch."""
    kw = BLOCK_CASES[case]
    _, x, temb, block = _block_case(**kw)
    with torch.no_grad():
        film = block.time_mlp(torch.from_numpy(temb))
    fs, fb = film.chunk(2, dim=-1)
    x = nchw(x).contiguous()
    lib = _RecordingLib()
    args = irb_args(block)
    with torch.no_grad(), _Ops() as ops:
        fik._launch_v1(lib, None, x, film_scale=fs, film_shift=fb, **args)
    assert set(ops.ops) <= _NOT_COMPUTE, sorted(set(ops.ops) - _NOT_COMPUTE)
    assert "empty" in ops.ops
    own = dict(x=x, wexp=block.expand.weight, wdw=block.depthwise.weight,
               wproj=block.project.weight, gn1_scale=block.norm1.weight,
               gn1_bias=block.norm1.bias, gn2_scale=block.norm2.weight,
               gn2_bias=block.norm2.bias, film_scale=fs, film_shift=fb)
    if block.skip is not None:
        own["wskip"] = block.skip.weight
    if block.se is not None:
        own.update(se_w1=block.se.fc1.weight, se_b1=block.se.fc1.bias,
                   se_w2=block.se.fc2.weight, se_b2=block.se.fc2.bias)
    assert {k: lib.ptrs[k] for k in own} == {k: t.data_ptr() for k, t in own.items()}
    scratch = ("a1", "b1", "a2", "b2", "stats1", "stats2", "out")
    assert all(lib.ptrs[k] for k in scratch)
    assert not {lib.ptrs[k] for k in scratch} & {t.data_ptr() for t in own.values()}
    assert (lib.ptrs["wskip"] is None) == (block.skip is None)
    assert (lib.ptrs["gate"] is None) == (block.se is None)
    chid = block.expand.weight.shape[0]
    d = lib.dims
    assert d["fs_stride"] == d["fb_stride"] == 2 * chid      # the halves, uncopied
    assert (d["g1"], d["g2"]) == (block.norm1.num_groups, block.norm2.num_groups)
    assert (d["batch"], d["cin"], d["chid"]) == (x.shape[0], x.shape[1], chid)
    assert d["stat_groups"] == fik.plan(*(x.shape[0], chid, d["cout"]) + x.shape[2:]).stat_groups
    assert lib.eps == pytest.approx(block.norm1.eps)


def _enum(src, name):
    """The names of ``enum <name>`` in the source, as the wrapper spells
    them (kGn1Scale → gn1_scale), without the closing count."""
    body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",") if n.strip()]
    return [re.sub(r"(?<!^)(?=[A-Z])", "_", n[1:]).lower() for n in names[:-1]]


def test_argument_layout_matches_the_source():
    """``_PTRS`` and ``_DIMS`` name the source's ``enum Ptr`` and ``enum Dim``
    in order (the counts are also checked when the library loads), and the
    v1 entry points take eps as a float before the stream."""
    with open(fik.SOURCE) as f:
        src = f.read()
    assert _enum(src, "Ptr") == list(fik._PTRS)
    assert _enum(src, "Dim") == list(fik._DIMS)
    for name in ("fused_irb_v1_f32", "fused_irb_v1_bf16"):
        assert re.search(rf"cudaError_t {name}\(const void\* const\* ptr, const int\* dim, "
                         r"float eps, void\* stream\)", src), name

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

        def fused_irb_num_ptrs(self):
            return len(fik._PTRS)

        def fused_irb_num_dims(self):
            return len(fik._DIMS)

    lib = Lib()
    fik._declare(lib)
    assert lib.fused_irb_v1_f32.argtypes[2] is ctypes.c_float
    assert lib.fused_irb_v1_bf16.argtypes[3] is ctypes.c_void_p
    assert lib.fused_irb_f32.argtypes[2] is ctypes.c_void_p
    assert os.path.basename(fik.SOURCE) == "fused_irb.cu"
