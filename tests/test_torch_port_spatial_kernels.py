"""The token-sharded linear-attention entries of ``csrc/linear_attention.cu``
(``kv``, ``apply``, ``bwd_partial``, ``bwd_finish``, f32 and bf16) on the
CPU: their dataflow, emulated in numpy with the cluster reduction of
``tests/test_torch_port_attention.py`` and the group's sum between two
launches, against the plain whole-sequence forward and backward; their
plain versions in float64; the wrappers' launches through a stand-in
library; and the entries' C signatures against the wrapper's. The kernels
themselves are held against their plain versions on the card by
``chip_smoke.py``'s ``dp`` phase.
"""

import re

import numpy as np
import pytest
import torch

from cv_diffusion_tpu_torch.ops import attention as att
from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak

from test_torch_port_attention import (_StandIn, _cluster_reduce, _phi, _qkv,
                                       _rank_partial, _ranks, _split)
from test_torch_port_weights import one_torch_thread  # noqa: F401

PROCESSES = 2


def _blocks(n_local, dtype=torch.float32, backward=False):
    p = lak.plan(1, n_local, 1, 32, dtype, backward=backward)
    return p, _ranks(n_local, p)


def _emulate(q, k, v, g, eps=np.float32(1e-6)):
    """The sharded entries' dataflow over PROCESSES processes, each a
    contiguous share of the tokens: per process ``kv`` (the cluster's
    reduction of its blocks' partials), the group's sum, ``apply``; then
    ``bwd_partial`` (dq, and the cluster-reduced d_kv and d_ksum), the sum,
    ``bwd_finish``."""
    b, n, h, d = q.shape
    share = n // PROCESSES
    out, dq, dk, dv = (np.zeros_like(q) for _ in range(4))
    for bi in range(b):
        for hi in range(h):
            pk, vv, pq, gg = (_phi(k[bi, :, hi]), v[bi, :, hi], _phi(q[bi, :, hi]),
                              g[bi, :, hi])
            ones = np.ones(n, np.float32)
            procs = [slice(r * share, (r + 1) * share) for r in range(PROCESSES)]
            sums = sum(_cluster_reduce([
                _rank_partial(pk[s][lo:e], vv[s][lo:e], ones[lo:e], d)
                for lo, e in _blocks(share)[1]]) for s in procs)
            kv, ks = _split(sums, d)
            partials = []
            for s in procs:
                out[bi, s, hi] = (pq[s] @ kv) / (pq[s] @ ks + eps)[:, None]
                parts = []
                for lo, e in _blocks(share, backward=True)[1]:
                    rows = slice(s.start + lo, s.start + e)
                    num, den = pq[rows] @ kv, pq[rows] @ ks + eps
                    d_num = gg[rows] / den[:, None]
                    d_den = -(gg[rows] * num).sum(1) / (den * den)
                    dq[bi, rows, hi] = ((d_num @ kv.T + d_den[:, None] * ks)
                                        * np.minimum(pq[rows], 1))
                    parts.append(_rank_partial(pq[rows], d_num, d_den, d))
                partials.append(_cluster_reduce(parts))
            dkv, dks = _split(sum(partials), d)
            dk[bi, :, hi] = (vv @ dkv.T + dks) * np.minimum(pk, 1)
            dv[bi, :, hi] = pk @ dkv
    return out, dq, dk, dv


@pytest.mark.parametrize("shape", [(1, 1024, 4, 32), (2, 256, 2, 32), (1, 200, 2, 32)])
def test_sharded_entries_emulated_match_plain(shape, one_torch_thread):  # noqa: F811
    """Over two processes (512, 128 and a ragged 100 tokens each) the
    emulated entries give the whole sequence's linear attention (atol
    2e-5) and its gradients (atol 5e-4), the kernels' tolerances."""
    q, k, v = _qkv(shape, 21)
    g = np.random.default_rng(22).normal(size=shape).astype(np.float32)
    out, dq, dk, dv = _emulate(q, k, v, g)
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    np.testing.assert_allclose(out, att.linear_attention_plain(*t[:3]).numpy(), atol=2e-5)
    for got, want, name in zip((dq, dk, dv), att.linear_attention_backward_plain(*t), "qkv"):
        np.testing.assert_allclose(got, want.numpy(), atol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("processes", [2, 4])
def test_sharded_plain_versions_are_the_whole_sequence(processes, one_torch_thread):  # noqa: F811
    """The four plain versions, chained with the group's sum, equal the
    whole sequence's plain forward and backward in float64 (1e-12); each
    output has its input's dtype, and the sums are float32 for bf16
    tokens."""
    shape = (2, 64, 2, 32)
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn(shape, generator=gen, dtype=torch.float64) for _ in range(4))
    parts = [slice(r * 64 // processes, (r + 1) * 64 // processes) for r in range(processes)]
    kvs = sum(att.linear_attention_kv_plain(k[:, s], v[:, s]) for s in parts)
    assert kvs.shape == (2, 2, 32 * 33)
    out = torch.cat([att.linear_attention_apply_plain(q[:, s], kvs) for s in parts], 1)
    partial = [att.linear_attention_bwd_partial_plain(q[:, s], g[:, s], kvs) for s in parts]
    dkvs = sum(p[1] for p in partial)
    finish = [att.linear_attention_bwd_finish_plain(k[:, s], v[:, s], dkvs) for s in parts]
    dq = torch.cat([p[0] for p in partial], 1)
    dk, dv = (torch.cat([f[i] for f in finish], 1) for i in (0, 1))
    torch.testing.assert_close(out, att.linear_attention_plain(q, k, v), atol=1e-12, rtol=0)
    for got, want in zip((dq, dk, dv), att.linear_attention_backward_plain(q, k, v, g)):
        torch.testing.assert_close(got, want, atol=1e-12, rtol=0)
    b16 = [t.to(torch.bfloat16) for t in (q, k, v, g)]
    sums = att.linear_attention_kv_plain(b16[1], b16[2])
    assert sums.dtype == torch.float32
    assert att.linear_attention_apply_plain(b16[0], sums).dtype == torch.bfloat16
    dq16, dsums = att.linear_attention_bwd_partial_plain(b16[0], b16[3], sums)
    assert dq16.dtype == torch.bfloat16 and dsums.dtype == torch.float32
    assert all(t.dtype == torch.bfloat16
               for t in att.linear_attention_bwd_finish_plain(b16[1], b16[2], dsums))


def test_sharded_function_in_one_process_is_linear_attention(one_torch_thread):  # noqa: F811
    """With a group of one the sharded autograd function is linear
    attention, forward and backward (float64, ``gradcheck``), and its CPU
    path runs the plain versions without counting a launch."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 13, 2, 8, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    before = lak.sharded_launches()
    torch.testing.assert_close(lak.linear_attention_sharded_trainable(q, k, v, None),
                               att.linear_attention_plain(q, k, v), atol=1e-12, rtol=0)
    assert torch.autograd.gradcheck(
        lambda a, b, c: lak.linear_attention_sharded_trainable(a, b, c, None), (q, k, v))
    assert lak.sharded_launches() == before


@pytest.mark.parametrize("entry", lak.SHARDED_ENTRIES)
def test_sharded_launch_passes_the_plan(entry):
    """A launch hands the entry of its dtype the pointers (inputs, then
    outputs), the shape, the plan of its direction and the stream; a
    failed launch raises with the plan."""
    shape = (2, 300, 4, 32)
    q, k = (torch.from_numpy(x) for x in _qkv(shape, 23)[:2])
    sums = torch.zeros(2, 4, 32 * 33)
    ins = {"kv": (q, k), "apply": (q, sums), "bwd_partial": (q, k, sums),
           "bwd_finish": (q, k, sums)}[entry]
    outs = (torch.empty_like(q),) if entry == "apply" else (sums,) if entry == "kv" else (
        (torch.empty_like(q), torch.empty_like(sums)) if entry == "bwd_partial"
        else (torch.empty_like(q), torch.empty_like(q)))
    eps = 1e-6 if entry in ("apply", "bwd_partial") else None
    lib = _StandIn()
    lak._launch_sharded(lib, 7, entry, q, ins, outs, eps)
    (name, args), = lib.calls
    p = lak.plan(*shape, torch.float32, backward=lak.SHARDED_BACKWARD[entry])
    n_ptr = len(ins) + len(outs)
    assert name == f"linear_attention_{entry}_f32"
    assert args[:n_ptr] == tuple(t.data_ptr() for t in ins + outs)
    assert args[n_ptr:] == (*shape, p.cluster, p.rows) + (() if eps is None else (eps,)) + (7,)
    with pytest.raises(RuntimeError, match=f"{entry} kernel launch failed"):
        lak._launch_sharded(_StandIn(err=3), 7, entry, q, ins, outs, eps)


def test_sharded_entries_match_the_wrappers_signatures():
    """Each of the eight C entries takes as many arguments as ``_declare``
    gives it, and the wrapper checks the sums' layout."""

    class Recorder:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("Fn", (), {})())

    lib = Recorder()
    lak._declare(lib)
    with open(lak.SOURCE) as f:
        src = f.read()
    macro = src[src.index("#define LA_SHARDED"):src.index("#undef LA_SHARDED")]
    for entry in lak.SHARDED_ENTRIES:
        sig = re.search(rf"linear_attention_{entry}_##SUFFIX\(([^)]*)\)", macro).group(1)
        for dt in ("f32", "bf16"):
            assert f"LA_SHARDED({dt}," in src
            assert len(lib.fns[f"linear_attention_{entry}_{dt}"].argtypes) == sig.count(",") + 1
    q = torch.zeros(2, 8, 2, 32)
    lak._check_sums(torch.zeros(2, 2, 32 * 33), q)
    for bad in (torch.zeros(2, 2, 32 * 32), torch.zeros(2, 2, 32 * 33, dtype=torch.float64)):
        with pytest.raises(ValueError, match="sums"):
            lak._check_sums(bad, q)
