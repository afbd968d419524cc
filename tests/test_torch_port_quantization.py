"""The port's weight quantization (``cv_diffusion_tpu_torch/export/
quantization.py``) against the JAX package's (``cv_diffusion_tpu/export/
quantization.py``), bit for bit, on the tiny model's random JAX params and
their ``state_dict_from_jax``.

Each JAX result is carried into the torch layout by the same conversion as
the weights (``weights.model_entries``) and compared exactly: bf16 bits
(both ``skip_norm_params`` settings), int8 values, scales and mask,
dequantized weights, the codec dispatch and its error, the size report and
the relative error. The skip rule is decided on JAX paths: with a small
``min_size`` the attention blocks' output GroupNorm (``…/out_norm/scale``,
``….to_out.1.weight`` in torch) stays float, as in JAX.
"""

import numpy as np
import pytest
import torch

from cv_diffusion_tpu.export import quantization as jq
from cv_diffusion_tpu_torch.export import quantization as tq
from cv_diffusion_tpu_torch.weights import (jax_paths, model_entries,
                                            state_dict_from_jax)

from test_torch_port_weights import one_torch_thread  # noqa: F401
from test_torch_port_weights import random_jax_params

CONFIGS = {
    "default": (jq.QuantizationConfig(), tq.QuantizationConfig()),
    # small enough that the 128-channel GroupNorms pass the size rule and
    # only their JAX paths keep them float
    "min_size_16": (jq.QuantizationConfig(min_size=16),
                    tq.QuantizationConfig(min_size=16)),
}


@pytest.fixture(scope="module")
def tiny():
    """(port config, JAX params, port state dict): the tiny model at 32²,
    every leaf random (GroupNorm scales and biases too)."""
    _, tcfg, params = random_jax_params("tiny", 32, seed=11)
    return tcfg, params, state_dict_from_jax(params, tcfg)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _in_torch_layout(tree, tcfg, names):
    """{torch name: the JAX leaf of ``tree`` converted to the torch layout
    (float32) and its JAX dtype}; 0-d leaves (per-tensor scales) as they
    are."""
    out = {}
    for name, path, convert, _ in model_entries(tcfg):
        if name in names:
            leaf = _leaf(tree, path)
            out[name] = ((convert(leaf) if leaf.ndim else leaf.astype(np.float32)),
                         str(leaf.dtype))
    return out


def _assert_equal(jax_tree, torch_dict, tcfg):
    want = _in_torch_layout(jax_tree, tcfg, torch_dict)
    assert set(want) == set(torch_dict)
    for name, t in torch_dict.items():
        value, dtype = want[name]
        assert str(t.dtype).replace("torch.", "") == dtype, name
        assert tuple(t.shape) == value.shape, name
        np.testing.assert_array_equal(t.float().numpy(), value, err_msg=name)


@pytest.mark.parametrize("skip_norm_params", [False, True])
def test_quantize_bf16_bits_equal_jax(tiny, skip_norm_params):
    tcfg, params, sd = tiny
    got = tq.quantize_bf16(sd, tcfg, skip_norm_params=skip_norm_params)
    ref = jq.quantize_bf16(params, skip_norm_params=skip_norm_params)
    _assert_equal(ref, got, tcfg)
    kept = [k for k, t in got.items() if t.dtype == torch.float32]
    assert bool(kept) == skip_norm_params
    # bf16 bits: float32 equality above is equality of the bits, as every
    # bf16 value is one float32 value
    assert all(t.dtype in (torch.bfloat16, torch.float32) for t in got.values())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_quantize_int8_equals_jax(tiny, config):
    tcfg, params, sd = tiny
    jcfg, tcfg_q = CONFIGS[config]
    got = tq.quantize_int8(sd, tcfg, tcfg_q)
    ref = jq.quantize_int8(params, jcfg)
    _assert_equal(ref["values"], got["values"], tcfg)
    _assert_equal(ref["scales"], got["scales"], tcfg)
    mask = _in_torch_layout(ref["quantized"], tcfg, sd)
    assert {k: bool(v[0]) for k, v in mask.items()} == got["quantized"]
    assert any(got["quantized"].values()) and not all(got["quantized"].values())
    for name, q in got["quantized"].items():
        assert (got["values"][name].dtype == torch.int8) == q, name
    # the attention blocks' output GroupNorm stays float by its JAX path
    out_norm = "unet.mid_attn.to_out.1.weight"
    assert got["quantized"][out_norm] is False
    assert got["values"][out_norm].dtype == torch.float32
    # dequantized weights
    _assert_equal(jq.dequantize_int8(ref), tq.dequantize_int8(got), tcfg)


def test_quantize_int8_per_tensor_equals_jax(tiny):
    """``per_channel=False``: one scale a tensor, on the middle blocks (JAX
    compiles its eager ops once per shape; these few shapes keep it short)."""
    tcfg, params, sd = tiny
    blocks = ("mid_block1", "mid_attn")
    sub = {k: t for k, t in sd.items() if k.split(".")[1] in blocks}
    got = tq.quantize_int8(sub, tcfg, tq.QuantizationConfig(per_channel=False))
    ref = jq.quantize_int8({"unet": {b: params["unet"][b] for b in blocks}},
                           jq.QuantizationConfig(per_channel=False))
    _assert_equal(ref["values"], got["values"], tcfg)
    _assert_equal(ref["scales"], got["scales"], tcfg)
    assert all(s.dim() == 0 for s in got["scales"].values())
    assert any(got["quantized"].values())


def test_the_skip_rule_reads_jax_paths(tiny):
    """A torch name would quantize the 128-channel ``out_norm`` scale at
    ``min_size=16``; its JAX path does not."""
    tcfg, _, sd = tiny
    config = tq.QuantizationConfig(min_size=16)
    name = "unet.mid_attn.to_out.1.weight"
    path = jax_paths(tcfg, [name])[name]
    assert path == ("unet", "mid_attn", "out_norm", "scale")
    assert tq.should_skip_quant(path, sd[name], config)
    assert not tq.should_skip_quant(name.split("."), sd[name], config)
    with pytest.raises(KeyError):
        jax_paths(tcfg, ["unet.no_such.weight"])


@pytest.mark.parametrize("dtype", ["bf16", "bfloat16", "fp16", "int8",
                                   "int8_dynamic", "fp32", "float32", "none"])
def test_quantize_model_dispatch_equals_jax(tiny, dtype):
    tcfg, params, sd = tiny
    got, codec = tq.quantize_model(sd, tcfg, dtype)
    ref, jax_codec = jq.quantize_model(params, dtype)
    assert codec == jax_codec
    if codec == "int8":
        _assert_equal(ref["values"], got["values"], tcfg)
    else:
        _assert_equal(ref, got, tcfg)
    # the size report and the weights' relative error
    assert tq.quantization_report(sd, got) == jq.quantization_report(params, ref)
    deq = tq.dequantize_int8(got) if codec == "int8" else got
    jdeq = jq.dequantize_int8(ref) if codec == "int8" else ref
    assert tq.quantization_error(sd, deq) == jq.quantization_error(params, jdeq)


def test_quantize_model_refuses_an_unknown_codec(tiny):
    tcfg, params, sd = tiny
    with pytest.raises(ValueError, match="Unknown quantization dtype"):
        jq.quantize_model(params, "int4")
    with pytest.raises(ValueError, match="Unknown quantization dtype"):
        tq.quantize_model(sd, tcfg, "int4")
