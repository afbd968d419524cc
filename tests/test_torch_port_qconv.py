"""The port's quantizing convolution against the JAX package's ``QConv``.

Same numpy inputs and kernels on both sides, one ``QConv`` at a time:

- the int8 path equals JAX's bit for bit (1×1 and 3×3, stride 1 and 2,
  depthwise, channels that are not a multiple of 4, float32 and bfloat16
  compute, calibrated, statically bound and dynamic amax), with one
  exception that is XLA's: on the CPU it contracts a float32 epilogue
  ``y · s + bias`` into one FMA, where the JAX source (and the port, on the
  CPU and in its CUDA kernels) rounds the product and then the sum; the
  test holds both to their own formulas on equal int32 accumulators;
- on the adversarial accumulation (K = 2,048, partial sums past 2²⁴, an odd
  result) too, where a float32 convolution of the same int8 values differs
  (the control);
- the calibrating path records JAX's amax bit for bit, and a bound module
  runs the int8 path while calibrating, as in JAX;
- the fake-quant path's quantized input equals JAX's, and its gradients
  JAX's, ties at ±127 (``jnp.clip``'s half gradient) included;
- ``fake_quant_tensor``'s values and gradients (through the scale, the
  issue's example) and ``fake_quant_params``' skip rule.

JAX's scales run compiled: XLA turns ``/ 127`` into a multiplication by
float32(1/127), and the port computes them so (``ops/qconv.py``).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cv_diffusion_tpu.export import qat as jqat
from cv_diffusion_tpu.ops.qconv import QConv as JaxQConv
from cv_diffusion_tpu_torch.export import qat as tqat
from cv_diffusion_tpu_torch.ops import qconv as tq
from cv_diffusion_tpu_torch.ops import qconv_kernel as qk
from cv_diffusion_tpu_torch.ops.qconv import QConv

from test_torch_port_weights import one_torch_thread, random_jax_params  # noqa: F401

PAD1 = ((1, 1), (1, 1))


def _jax_qconv(cin, cout, k, stride, groups, bias, dtype, act_quant=True, bound=None):
    return JaxQConv(cout, (k, k), strides=(stride, stride),
                    padding=PAD1 if k == 3 else "VALID", feature_group_count=groups,
                    use_bias=bias, dtype=jnp.dtype(dtype), act_quant=act_quant,
                    act_bound=bound)


def _port_qconv(kern, b, stride, groups, dtype, act_quant=True, bound=None):
    k, _, cin_g, cout = kern.shape
    m = QConv(cin_g * groups, cout, k, stride=stride, padding=k // 2, groups=groups,
              bias=b is not None, act_quant=act_quant, act_bound=bound)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
        if b is not None:
            m.bias.copy_(torch.from_numpy(b))
    m.compute_dtype = None if dtype == "float32" else torch.bfloat16
    return m


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _case(rng, cin, cout, k, groups, bias, bound, b=2, hw=9, scale=2.0):
    x = (rng.standard_normal((b, hw, hw, cin)) * scale).astype(np.float32)
    if bound is not None:
        x = np.clip(x, 0.0, bound)
    kern = (rng.standard_normal((k, k, cin // groups, cout)) * 0.2).astype(np.float32)
    bvec = rng.standard_normal(cout).astype(np.float32) if bias else None
    return x, kern, bvec


def _run_int8(x, kern, bvec, stride, groups, dtype, amax, bound=None):
    """(JAX's int8 output, the port's), float32 NHWC numpy."""
    k, _, cin_g, cout = kern.shape
    jm = _jax_qconv(cin_g * groups, cout, k, stride, groups, bvec is not None, dtype,
                    bound=bound)
    params = {"kernel": kern} if bvec is None else {"kernel": kern, "bias": bvec}
    v = {"params": params,
         "act_scales": {"amax": np.float32(amax if bound is None else bound)}}
    want = np.asarray(jax.jit(jm.apply)(v, x).astype(jnp.float32))
    m = _port_qconv(kern, bvec, stride, groups, dtype, bound=bound)
    if bound is None:
        m.set_amax(amax)
    with torch.no_grad():
        got = _nhwc(m(_nchw(x)))
    return want, got


# (cin, cout, k, stride, groups, bias): the small UNet's QConv classes
SHAPES = {
    "1x1": (16, 32, 1, 1, 1, False),            # expand / project / skip / qkv / out
    "init_conv_3x3_cin6": (6, 16, 3, 1, 1, True),
    "down_3x3_s2": (16, 16, 3, 2, 1, True),
    "up_3x3": (12, 12, 3, 1, 1, True),
    "depthwise": (16, 16, 3, 1, 16, False),
    "depthwise_s2": (16, 16, 3, 2, 16, False),
    "depthwise_c12": (12, 12, 3, 1, 12, False),
}


@pytest.mark.parametrize("amax", [3.0, 0.0], ids=["calibrated", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_int8_path_equals_jax_bit_for_bit(shape, dtype, amax):
    cin, cout, k, stride, groups, bias = SHAPES[shape]
    rng = np.random.default_rng(zlib.crc32(f"{shape} {dtype} {amax}".encode()))
    x, kern, bvec = _case(rng, cin, cout, k, groups, bias, None)
    if bias and dtype == "float32":
        # XLA contracts the float32 epilogue into an FMA (see the module
        # docstring and test_float32_bias_epilogue_rounds_twice)
        bvec = None
    want, got = _run_int8(x, kern, bvec, stride, groups, dtype, amax)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_bound_int8_path_equals_jax(dtype):
    rng = np.random.default_rng(5)
    for shape in ("1x1", "depthwise"):
        cin, cout, k, stride, groups, _ = SHAPES[shape]
        x, kern, _ = _case(rng, cin, cout, k, groups, False, 6.0, scale=4.0)
        want, got = _run_int8(x, kern, None, stride, groups, dtype, 0.0, bound=6.0)
        np.testing.assert_array_equal(got, want)


def test_float32_bias_epilogue_rounds_twice():
    """The JAX source adds the bias after the float32 product is rounded;
    XLA's CPU backend fuses the two into an FMA. On the same int32
    accumulators (JAX's bias-free output divided by the scale) JAX's biased
    output is the FMA and the port's is the product rounded, then the sum
    rounded, as the source writes it and the CUDA kernels compute it."""
    rng = np.random.default_rng(7)
    cin, cout, k, stride, groups, _ = SHAPES["up_3x3"]
    x, kern, bvec = _case(rng, cin, cout, k, groups, True, None)
    want0, got0 = _run_int8(x, kern, None, stride, groups, "float32", 3.0)
    np.testing.assert_array_equal(got0, want0)
    want, got = _run_int8(x, kern, bvec, stride, groups, "float32", 3.0)
    s_x = np.float32(np.float32(3.0) * np.float32(1 / 127))
    s_w = np.maximum(np.abs(kern).max(axis=(0, 1, 2)) * np.float32(1 / 127),
                     np.float32(1e-12)).astype(np.float32)
    scale = (s_x * s_w).astype(np.float32)
    acc = np.round(want0.astype(np.float64) / scale)
    np.testing.assert_array_equal((acc * scale).astype(np.float32), want0)
    fma = (acc * scale.astype(np.float64) + bvec).astype(np.float32)
    np.testing.assert_array_equal(want, fma)
    np.testing.assert_array_equal(got, (want0 + bvec).astype(np.float32))
    assert np.abs(got - want).max() <= np.spacing(np.abs(want).max())


def test_adversarial_accumulation_is_exact_where_float32_is_not():
    """K = 2,048 (the decoder's widest project): every input at its amax
    (q = 127) and one output channel's weights at 127 but the last at 126,
    so the int32 sum 127·(127·2047 + 126) = 33,032,065 is odd and past
    2²⁴. The int8 path equals JAX's bit for bit; a float32 convolution of
    the same int8 values cannot hold that odd sum and differs (the
    control)."""
    cin, cout = 2048, 8
    x = np.full((1, 2, 2, cin), 3.0, np.float32)
    rng = np.random.default_rng(11)
    kern = (rng.standard_normal((1, 1, cin, cout)) * 0.05).astype(np.float32)
    kern[0, 0, :, 0] = 1.0
    kern[0, 0, -1, 0] = 126.0 / 127.0
    want, got = _run_int8(x, kern, None, 1, 1, "float32", 3.0)
    np.testing.assert_array_equal(got, want)
    xq = tq.quantize_plain(_nchw(x), torch.tensor(3.0))
    wq, s_w = tq.quantize_weight(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
    assert int(wq[0, -1]) == 126 and bool((wq[0, :-1] == 127).all())
    exact = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double())
    assert float(exact[0, 0, 0, 0]) == 127 * (127 * 2047 + 126) == 33_032_065
    f32 = F.conv2d(xq.permute(0, 3, 1, 2).float(), wq.float())
    assert float(f32[0, 0, 0, 0]) != 33_032_065        # the control fails
    np.testing.assert_array_equal(
        got[0, 0, 0, 0], np.float32(np.float32(33_032_065) * (np.float32(
            np.float32(3.0) * np.float32(1 / 127)) * s_w[0].numpy())))


def test_dynamic_amax_is_the_whole_batchs():
    """An uncalibrated module quantizes with max |x| over the whole batch
    (``qconv.py:163-164``): image 0's output changes when image 1 does."""
    rng = np.random.default_rng(13)
    cin, cout, k, stride, groups, _ = SHAPES["1x1"]
    x, kern, _ = _case(rng, cin, cout, k, groups, False, None)
    x2 = x.copy()
    x2[1] *= 3.0
    want, got = _run_int8(x2, kern, None, stride, groups, "float32", 0.0)
    np.testing.assert_array_equal(got, want)
    _, alone = _run_int8(x, kern, None, stride, groups, "float32", 0.0)
    assert not np.array_equal(alone[0], got[0])


@pytest.mark.parametrize("bound", [None, 6.0], ids=["calibrating", "bound"])
def test_calibrating_path_matches_jax(bound):
    """While calibrating, a module without a bound records max(amax, max|x|)
    bit for bit and runs its float path; a bound module keeps its amax and
    runs the int8 path (``qconv.py:149-158``)."""
    rng = np.random.default_rng(17)
    cin, cout, k, stride, groups, bias = SHAPES["up_3x3"]
    x, kern, bvec = _case(rng, cin, cout, k, groups, bias, bound)
    jm = _jax_qconv(cin, cout, k, stride, groups, True, "float32", bound=bound)
    start = np.float32(1.5 if bound is None else bound)
    y, mutated = jax.jit(lambda v, x: jm.apply(v, x, mutable=["act_scales"]))(
        {"params": {"kernel": kern, "bias": bvec}, "act_scales": {"amax": start}}, x)
    m = _port_qconv(kern, bvec, stride, groups, "float32", bound=bound)
    m.set_amax(float(start))
    m.calibrating = True
    with torch.no_grad():
        got = _nhwc(m(_nchw(x)))
    assert m.amax.item() == float(mutated["act_scales"]["amax"])
    if bound is None:
        assert m.amax.item() == float(np.abs(x).max()) > start
        np.testing.assert_allclose(got, np.asarray(y), rtol=0, atol=1e-5)
    else:
        # the int8 output; its bias add contracted into an FMA by XLA
        m.calibrating = False
        with torch.no_grad():
            np.testing.assert_array_equal(got, _nhwc(m(_nchw(x))))
        assert np.abs(got - np.asarray(y)).max() <= np.spacing(np.abs(got).max())


def _jax_fake_grads(jm, kern, x, g, bias=None):
    params = {"kernel": kern} if bias is None else {"kernel": kern, "bias": bias}

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x).astype(jnp.float32) * g)
    y = jm.apply({"params": params}, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return np.asarray(y.astype(jnp.float32)), np.asarray(gx), np.asarray(gp["kernel"])


def _port_fake_grads(m, x, g):
    xt = _nchw(x).requires_grad_(True)
    y = m(xt)
    (y.float() * _nchw(g)).sum().backward()
    return _nhwc(y), _nhwc(xt.grad), m.weight.grad.numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("bound", [None, 6.0], ids=["dynamic", "bound"])
def test_fake_quant_input_and_gradients_equal_jax(bound):
    """With a 1×1 identity kernel the output is the fake-quantized input
    itself: equal to JAX's bit for bit, and so is the gradient to x, where
    every element at ±127 (the dynamic amax always lands there; here also
    inputs clipped to the bound) passes half the upstream gradient, as
    ``jnp.clip`` does."""
    rng = np.random.default_rng(19)
    c = 8
    x = (rng.standard_normal((2, 6, 6, c)) * 2.0).astype(np.float32)
    if bound is not None:
        x = np.clip(x, 0.0, 7.0)     # some inputs past the bound, some at it
        x[0, 0, 0, :2] = 6.0
    kern = np.eye(c, dtype=np.float32).reshape(1, 1, c, c)
    g = rng.standard_normal((2, 6, 6, c)).astype(np.float32)
    jm = _jax_qconv(c, c, 1, 1, 1, False, "float32", act_quant="fake", bound=bound)
    y, gx, _ = _jax_fake_grads(jm, kern, x, g)
    m = _port_qconv(kern, None, 1, 1, "float32", act_quant="fake", bound=bound)
    got_y, got_gx, _ = _port_fake_grads(m, x, g)
    np.testing.assert_array_equal(got_y, y)
    np.testing.assert_array_equal(got_gx, gx)
    amax = 6.0 if bound is not None else np.abs(x).max()
    q = np.round(x / np.float32(np.float32(amax) * np.float32(1 / 127)))
    ties = np.abs(q) == 127
    assert ties.any()
    at = ties & (np.abs(x) <= amax)
    # half the upstream gradient (to the rounding of · s_x / s_x)
    np.testing.assert_allclose(gx[at], 0.5 * g[at], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_conv_matches_jax(dtype):
    """A 3×3 fake-quant convolution with bias, float32 conv inside in both
    compute dtypes: output and gradients to x and the kernel within float32
    rounding of JAX's (bf16: the output cast, 1 bf16 ulp)."""
    rng = np.random.default_rng(23)
    cin, cout, k, stride, groups, bias = SHAPES["up_3x3"]
    x, kern, bvec = _case(rng, cin, cout, k, groups, bias, None)
    g = rng.standard_normal((2, 9, 9, cout)).astype(np.float32)
    jm = _jax_qconv(cin, cout, k, stride, groups, True, dtype, act_quant="fake")
    y, gx, gk = _jax_fake_grads(jm, kern, x, g, bvec)
    m = _port_qconv(kern, bvec, stride, groups, dtype, act_quant="fake")
    got_y, got_gx, got_gk = _port_fake_grads(m, x, g)
    if dtype == "float32":
        np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_gx, gx, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got_gk, gk, rtol=0, atol=2e-4)
    else:
        assert np.abs(got_y - y).max() <= np.abs(y).max() * 2 ** -7
        np.testing.assert_allclose(got_gk, gk, rtol=0, atol=0.05 * np.abs(gk).max())


def test_clip_passes_half_the_gradient_at_a_bound():
    x = torch.tensor([-128.0, -127.0, 0.0, 127.0, 130.0], requires_grad=True)
    tq.clip(x, -127.0, 127.0).sum().backward()
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]
    jg = jax.grad(lambda v: jnp.sum(jnp.clip(v, -127.0, 127.0)))(
        jnp.asarray(x.detach().numpy()))
    assert np.asarray(jg).tolist() == x.grad.tolist()


def test_fake_quant_tensor_gradient_goes_through_the_scale():
    """The issue's example: w = [[0.5, -1.0], [0.25, 2.0]] (JAX layout,
    per-channel over columns), upstream [[1, 2], [3, 4]]: JAX gives
    [[1.011811, 2], [3, 3.992126]], the port the same (its layout is the
    transpose: the channel axis first)."""
    w = np.array([[0.5, -1.0], [0.25, 2.0]], np.float32)
    g = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    jv, jvjp = jax.vjp(jqat.fake_quant_tensor, jnp.asarray(w))
    (jg,) = jvjp(jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(jg), [[1.011811, 2], [3, 3.992126]], rtol=1e-6)
    wt = torch.from_numpy(w.T.copy()).requires_grad_(True)
    out = tqat.fake_quant_tensor(wt)
    out.backward(torch.from_numpy(g.T.copy()))
    np.testing.assert_array_equal(out.detach().numpy().T, np.asarray(jv))
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(jg), rtol=1e-6, atol=0)


def test_fake_quant_tensor_matches_jax_on_a_conv_kernel():
    rng = np.random.default_rng(29)
    k = (rng.standard_normal((3, 3, 8, 16)) * 0.3).astype(np.float32)
    g = rng.standard_normal(k.shape).astype(np.float32)
    jv, jvjp = jax.vjp(jax.jit(jqat.fake_quant_tensor), jnp.asarray(k))
    (jg,) = jvjp(jnp.asarray(g))
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    out = tqat.fake_quant_tensor(kt)
    out.backward(torch.from_numpy(g.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(out.detach().numpy().transpose(2, 3, 1, 0), np.asarray(jv))
    np.testing.assert_allclose(kt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(jg),
                               rtol=1e-5, atol=1e-6)


def test_fake_quant_params_skip_rule_matches_jax():
    """On the tiny model's params: the tensors JAX fake-quantizes and their
    values, name for name (the skip rule applied on JAX paths)."""
    from cv_diffusion_tpu_torch.weights import state_dict_from_jax

    jcfg, tcfg, params = random_jax_params("tiny", 16, seed=3)
    want = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jqat.fake_quant_params)(params)), tcfg)
    state = state_dict_from_jax(params, tcfg)
    got = tqat.fake_quant_params(state, tcfg)
    changed = sorted(k for k in state if not torch.equal(got[k], state[k]))
    assert changed == sorted(k for k in state if not torch.equal(want[k], state[k]))
    assert any(k.endswith("depthwise.weight") for k in changed)
    assert not any("norm" in k or k.endswith(".bias") for k in changed)
    for k in state:
        assert torch.equal(got[k], want[k]), k


def test_kernel_wrappers_run_their_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper is its plain version and counts nothing;
    a device without a kernel raises."""
    before = (qk.quantize.launches, qk.int8_conv.launches, qk.int8_depthwise.launches)
    x = torch.randn(1, 6, 5, 5)
    amax = torch.tensor(2.0)
    xq = qk.quantize(x, amax)
    assert xq.shape == (1, 5, 5, 32) and xq.dtype == torch.int8
    assert torch.equal(xq, tq.quantize_plain(x, amax)) and not bool(xq[..., 6:].any())
    wq, s_w = tq.quantize_weight(torch.randn(4, 6, 3, 3))
    dense = qk.int8_conv(xq, tq.dense_weight_layout(wq), amax, s_w, None, 1, 1, torch.float32)
    assert dense.shape == (1, 4, 5, 5)
    wd, s_d = tq.quantize_weight(torch.randn(6, 1, 3, 3))
    dw = qk.int8_depthwise(xq, tq.depthwise_weight_layout(wd), 6, amax, s_d, None, 2,
                           torch.bfloat16)
    assert dw.shape == (1, 6, 3, 3) and dw.dtype == torch.bfloat16
    assert (qk.quantize.launches, qk.int8_conv.launches,
            qk.int8_depthwise.launches) == before
    with pytest.raises(ValueError, match="no quantize kernel"):
        qk.quantize(x.to("meta"), amax.to("meta"))
